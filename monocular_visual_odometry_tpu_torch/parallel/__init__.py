"""Process-group parallelism: the sharded windowed BA and its mesh helpers.

Port of ``monocular_visual_odometry_tpu.parallel``. The JAX package runs
the sharded LM as one program over a device mesh (``shard_map``); here
every rank is a process that runs the LM body on its own shard and calls
``torch.distributed`` collectives where JAX calls ``psum``,
``psum_scatter`` and ``all_gather``.

- ``mesh``       init_distributed, points_mesh, the placements and the
                 three collectives of the ``points`` axis (with a record)
- ``dist_ba``    the sharded LM, ``ba_update_state_dist`` for the live step
- ``scaling``    the live-shape problem, the communication model, FLOPs
- ``multihost``  ``python -m`` entry: one process per rank, checked
                 against the single-device solver
"""
