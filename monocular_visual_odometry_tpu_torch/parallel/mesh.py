"""Process groups, the ``points`` mesh and its collectives.

Port of ``monocular_visual_odometry_tpu.parallel.mesh``. In JAX a mesh is
a set of devices that one program drives, and ``psum`` / ``psum_scatter`` /
``all_gather`` inside ``shard_map`` name its axis. Here every rank is a
process with one device: :func:`init_distributed` joins the processes,
:func:`points_mesh` builds the 1-D mesh over them, and the mesh's methods
:meth:`PointsMesh.psum`, :meth:`PointsMesh.psum_scatter` and
:meth:`PointsMesh.all_gather` take the rank's local tensor and return what
the JAX primitive returns on that device.

Every collective appends a :class:`Collective` to ``mesh.record``: the JAX
primitive and the bytes of its result on this rank, which
``scaling.collective_inventory`` prices with ring factors as the JAX module
prices the HLO.

Both backends run the three collectives natively on the tensors they take
(gloo: CPU and CUDA tensors, reduce-scatter included, on the card's torch
2.11 as on 2.13; NCCL: CUDA tensors), so each primitive has one call. A
tensor a backend does not take raises before any call is made.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

POINTS_AXIS = "points"
# A collective that waits longer than this raises (gloo) or aborts the
# process (NCCL's watchdog): a split collective schedule fails instead of
# hanging.
DEFAULT_TIMEOUT_S = 180.0

# the device types each backend's collectives take
DEVICES = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",)}

# torch 2.13 renames the single-tensor forms; older versions have only the
# old names (same arguments)
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class Collective(NamedTuple):
    """One collective as the mesh ran it."""

    op: str              # the JAX primitive: "psum", "psum_scatter" or "all_gather"
    result_bytes: int    # bytes of the primitive's result on one rank


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``)
    is taken as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "gloo",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the world: ``torch.distributed.init_process_group``
    with ``backend`` ("gloo" or "nccl") and a collective timeout. The
    arguments default to ``MVO_COORDINATOR`` (``host:port`` or a
    ``tcp://`` / ``file://`` URL), ``MVO_NUM_PROCESSES`` and
    ``MVO_PROCESS_ID``; without a coordinator this is a no-op."""
    coordinator = coordinator or os.environ.get("MVO_COORDINATOR")
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("MVO_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MVO_PROCESS_ID", "0"))
    dist.init_process_group(backend, init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


class PointsMesh:
    """The 1-D ``points`` mesh: a ``DeviceMesh`` over a process group, the
    rank's place in it, and the record of the collectives run on it."""

    def __init__(self, device_mesh, group):
        self.device_mesh = device_mesh
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.record: list[Collective] = []

    def __repr__(self):
        return f"PointsMesh(size={self.size}, rank={self.rank}, backend={self.backend})"

    def local(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's contiguous block of ``x`` along ``dim`` (the layout
        ``psum_scatter`` / ``all_gather`` with ``tiled=True`` use)."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)

    def _check(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type not in DEVICES.get(self.backend, ()):
            raise ValueError(f"the {self.backend} backend takes no {x.device.type} tensors")
        return x

    def _log(self, op: str, result: torch.Tensor) -> None:
        self.record.append(Collective(op, result.numel() * result.element_size()))

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.lax.psum``: the sum of every rank's ``x``, on every rank."""
        y = self._check(x).contiguous().clone()
        dist.all_reduce(y, group=self.group)
        self._log("psum", y)
        return y

    def psum_scatter(self, x: torch.Tensor, dim: int = 0, tiled: bool = True) -> torch.Tensor:
        """``jax.lax.psum_scatter(x, scatter_dimension=dim, tiled=tiled)``: the
        sum over ranks, of which this rank keeps block ``rank`` along ``dim``
        (``tiled``: contiguous blocks of size/D; otherwise ``dim`` has size D
        and is dropped)."""
        D = self.size
        if x.shape[dim] % D or (not tiled and x.shape[dim] != D):
            raise ValueError(f"psum_scatter: dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {D} ranks")
        front = self._check(x).movedim(dim, 0).contiguous()  # the blocks contiguous
        out = front.new_empty((front.shape[0] // D,) + front.shape[1:])
        _reduce_scatter_single(out, front, group=self.group)
        out = out.movedim(0, dim)
        if not tiled:
            out = out.squeeze(dim)
        self._log("psum_scatter", out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int = 0, tiled: bool = True) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis=dim, tiled=tiled)``: every rank's ``x``
        in rank order, concatenated along ``dim`` (``tiled``) or stacked on a
        new axis ``dim``."""
        if not tiled:
            x = x.unsqueeze(dim)
        front = self._check(x).movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] * self.size,) + front.shape[1:])
        _all_gather_single(out, front, group=self.group)
        out = out.movedim(0, dim)
        self._log("all_gather", out)
        return out


def points_mesh(n: Optional[int] = None, *,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[PointsMesh]:
    """The 1-D ``points`` mesh over the world's ranks, or over its first
    ``n`` (a group of its own, with collective timeout ``timeout_s``). Needs
    an initialized world (:func:`init_distributed`). Every rank must call it
    (making a group is collective); a rank outside the first ``n`` gets
    None. The ``DeviceMesh`` is on "cuda" under NCCL, else on "cpu"."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("points_mesh: no process group; call init_distributed first")
    world = dist.get_world_size()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"points_mesh: {n} ranks asked of a world of {world}")
    if n == world:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_rank() >= n:
        return None
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = DeviceMesh.from_group(group, device_type, mesh_dim_names=(POINTS_AXIS,))
    return PointsMesh(dm, group)


def replicated(mesh: PointsMesh):
    """DTensor placements of a value every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def points_sharded(mesh: PointsMesh):
    """DTensor placements of a value split in contiguous blocks along its
    first axis over the ``points`` ranks."""
    from torch.distributed.tensor import Shard

    return [Shard(0)]
