"""imagemagick_tpu_torch: the ImageMagick pipeline on PyTorch and CUDA.

The port of ``imagemagick_tpu`` (JAX) to PyTorch, with hand-written CUDA
kernels for Hopper (``csrc/``, built on first use by ``_build.py``).  The
JAX package is the reference this package is tested against; nothing here
imports it or JAX.

Pixels are NHWC float32 in [0, 1] at every public function, on the device
of the tensor given.
"""

import torch

# Full FP32 everywhere: the fused route is held at >= 100 dB against
# float64, which TF32 (about three decimal digits) cannot reach.  cuDNN
# convolutions default to TF32 and would otherwise use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.image import Image, stack  # noqa: E402
from .core.spec import ImageSpec  # noqa: E402

__all__ = ["Image", "ImageSpec", "stack"]
