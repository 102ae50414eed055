"""Canned benchmark pipelines (BASELINE.md configs #1-#4).

Port of ``imagemagick_tpu/models/pipelines.py``.  Each returns a function
over an (N, H, W, C) float32 batch that runs the configuration's ops one
after another on the batch's device: the op route of each config.  On a
CUDA batch, config #4 (``fft_wiener``) runs kernels K6a -> K6b -> K6c.
"""

from __future__ import annotations


def thumbnail_gray(out_h: int = 256, out_w: int = 256):
    """Config #1: Lanczos resize + sRGB->Gray."""
    from ..ops import colorspace as cs
    from ..ops import resize as rz

    def fn(batch):
        x = rz.resize(batch, out_h, out_w, "lanczos")
        return cs.convert(x, "srgb", "gray")

    return fn


def blur_unsharp_lab(sigma: float = 2.0):
    """Config #2: Gaussian σ=2 + unsharp + sRGB<->Lab round-trip."""
    from ..ops import blur as bl
    from ..ops import colorspace as cs

    def fn(batch):
        x = bl.gaussian_blur(batch, 0.0, sigma)
        x = bl.unsharp_mask(x, 0.0, 1.0, 1.0, 0.05)
        lab = cs.convert(x, "srgb", "lab")
        return cs.convert(lab, "lab", "srgb")

    return fn


def document_binarize():
    """Config #3: Otsu + 3x3 open/close morphology + edge detect.  The
    Otsu values come from one launch of kernel K4 over the batch."""
    from ..ops import blur as bl
    from ..ops import morphology as mo
    from ..ops import threshold as th

    def fn(batch):
        x = th.auto_threshold(batch, "otsu")
        x = mo.morphology(x, "open", "square:1")
        x = mo.morphology(x, "close", "square:1")
        return bl.edge_image(x, 1.0)

    return fn


def fft_wiener(noise: float = 0.01):
    """Config #4: forward DFT + Wiener-style filter + inverse DFT."""
    from ..ops import fourier as ft

    def fn(batch):
        return ft.wiener_deconvolve(batch, noise=noise)

    return fn


PIPELINES = {
    "thumbnail_gray": thumbnail_gray,
    "blur_unsharp_lab": blur_unsharp_lab,
    "document_binarize": document_binarize,
    "fft_wiener": fft_wiener,
}
