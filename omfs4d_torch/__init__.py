"""omfs4d_torch — the PyTorch / CUDA port of omfs4d for one NVIDIA H100.

The JAX package `omfs4d` is the reference this package is held to.  The
layout mirrors it module for module (`omfs4d.render.rasterize` <->
`omfs4d_torch.render.rasterize`, ...).  This package imports `torch` and
never `jax`, `omfs4d` or `cv2`.

Hand-written CUDA kernels live in `csrc/` and are built with `nvcc` at first
use (`omfs4d_torch._build`).  Every kernel has a plain PyTorch version beside
it in the same module; the wrapper takes the plain version for a CPU tensor
and launches the kernel (or raises) for a CUDA tensor.  The composite's
gradient is a `torch.autograd.Function` whose backward is a kernel too.

Float32 precision is pinned here, once, for the whole package: the reference
runs its matmuls at `Precision.HIGHEST` (models/flame.py, ops/camera.py), and
TF32 keeps only ~10 mantissa bits, which moves projected gaussian centres by
a visible fraction of a pixel.  So TF32 is off for both matmuls and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
