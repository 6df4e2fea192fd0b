"""True-fp32 matrix products for the geometry code.

The geometry stack solves small Gram systems (triangulation B'B, 8-point
A'A, the PnP normal equations) whose accuracy collapses at reduced matmul
precision: the JAX reference pins every f32 contraction to "highest" for
this reason (a one-pass bf16 product cost it 2.7x in ATE). On an H100 the
reduced-precision path is TF32 (about three decimal digits), which PyTorch
may take for fp32 matrix products and, by default, for cuDNN. Both are
switched off when this module is imported; every module of the port that
multiplies fp32 matrices imports it.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
