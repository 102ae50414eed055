"""imagemagick_tpu_torch: the ImageMagick pipeline on PyTorch and CUDA.

The port of ``imagemagick_tpu`` (JAX) to PyTorch, with hand-written CUDA
kernels for Hopper (``csrc/``, built on first use by ``_build.py``).  The
JAX package is the reference this package is tested against; nothing here
imports it or JAX.

Pixels are NHWC float32 in [0, 1] at every public function, on the device
of the tensor given.

Public surface, as the JAX package's:
  * ``Image`` / ``ImageSpec`` / ``stack``  — core container (core/)
  * ``read`` / ``write``                   — files through ``io``
  * ``imagemagick_tpu_torch.ops``          — the op families
  * ``imagemagick_tpu_torch.io``           — coders and pseudo formats
  * ``imagemagick_tpu_torch.wand``         — the MagickWand-style API
  * ``python -m imagemagick_tpu_torch``    — the magick-compatible CLI
"""

import torch

# Full FP32 everywhere: the fused route is held at >= 100 dB against
# float64, which TF32 (about three decimal digits) cannot reach.  cuDNN
# convolutions default to TF32 and would otherwise use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.image import Image, stack  # noqa: E402
from .core.spec import ImageSpec  # noqa: E402
from .core.geometry import parse_geometry, parse_meta_geometry  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Image",
    "ImageSpec",
    "stack",
    "parse_geometry",
    "parse_meta_geometry",
    "read",
    "write",
]


def read(path, device="cuda", **kw):
    """The first image that ``path`` reads (``io.read_image``), on
    ``device``: the card unless the caller asks for the CPU."""
    from .io import read_image

    return read_image(path, device=device, **kw)


def write(image, path, **kw):
    """Write one image or a list to ``path`` (``io.write_image``)."""
    from .io import write_image

    return write_image(image, path, **kw)
