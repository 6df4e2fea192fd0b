"""PyTorch/CUDA port of the monocular visual odometry engine.

A second implementation of ``monocular_visual_odometry_tpu`` for one NVIDIA
H100, written in PyTorch with the descriptor matcher as a hand-written
CUDA kernel. The JAX package stays the reference; this package imports
nothing of it (nor of JAX) and keeps its own copies of the host-side
helpers it needs.

- ``ops``       geometry / feature functions (torch) and the CUDA matcher
- ``models``    state records, the per-frame VO step with windowed BA, the
                batched multi-stream step
- ``utils``     config and its YAML loader, trajectory I/O and metrics,
                checkpoints, stage timing
- ``data``      the synthetic benchmark renderer (numpy)
- ``runtime``   PNG decode/encode and the prefetching frame loader
- ``viz``       annotated frames, trajectory plots, the HTML viewer
- ``cli``       the command-line entry point
- ``convert``   numpy <-> port state, for starting both packages alike

Entry points take an explicit ``device`` (default ``"cuda"``); asking for
CUDA without a card raises.
"""

__version__ = "0.1.0"

from monocular_visual_odometry_tpu_torch.utils.config import VOConfig, load_config

__all__ = ["VOConfig", "load_config", "__version__"]
