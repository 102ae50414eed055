"""Enhance ops (the enhance.c family): the subset the port runs so far.

Port of ``imagemagick_tpu/ops/enhance.py``.  Only ``grayscale`` is here:
the auto-thresholds measure the intensity of an image of three or more
channels with it.  The rest of the family waits for its queue item.
"""

from __future__ import annotations

import torch

from . import colorspace as cs


def grayscale(img: torch.Tensor, method: str = "rec709luma") -> torch.Tensor:
    """GrayscaleImage (enhance.c) with the pixel-intensity method set
    (pixel-accessor.h GetPixelIntensity variants): (..., C >= 3) ->
    (..., 1)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    m = method.lower()
    if m == "average":
        y = (r + g + b) / 3.0
    elif m == "brightness":
        y = torch.amax(img[..., :3], dim=-1)
    elif m == "lightness":
        y = (torch.amax(img[..., :3], -1) + torch.amin(img[..., :3], -1)) / 2.0
    elif m == "ms":
        # quantum-domain mean square (enhance.c:2569): (r²+g²+b²)/3 in
        # quantum units lands at quantum² scale — normalized that is a
        # ×QuantumRange blow-up (saturates all but near-black pixels)
        y = (r * r + g * g + b * b) / 3.0 * 65535.0
    elif m == "rms":
        y = torch.sqrt((r * r + g * g + b * b) / 3.0)
    elif m == "rec601luma":
        y = 0.298839 * r + 0.586811 * g + 0.114350 * b
    elif m == "rec601luminance":
        lin = cs.srgb_to_linear(img[..., :3])
        y = (0.298839 * lin[..., 0] + 0.586811 * lin[..., 1] +
             0.114350 * lin[..., 2])
    elif m == "rec709luminance":
        lin = cs.srgb_to_linear(img[..., :3])
        y = (0.212656 * lin[..., 0] + 0.715158 * lin[..., 1] +
             0.072186 * lin[..., 2])
    else:  # rec709luma default
        y = 0.212656 * r + 0.715158 * g + 0.072186 * b
    return y[..., None]
