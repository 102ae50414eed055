"""Hand-written CUDA kernels of the port: wrappers, plain versions, counts.

Counterpart of ``imagemagick_tpu/ops/pallas_kernels.py``.  Holds K3, the
separable blur (``csrc/separable_blur.cu``), and the launch counts of every
kernel of the package; the wrappers of K1 and K2 live in
``fused_pipeline.py`` beside their planners.

A wrapper runs its kernel's plain PyTorch version only when the tensor it
is given lies on the CPU.  For a CUDA tensor it launches the kernel or
raises: there is no fallback.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .. import _build

# Launches of each kernel, counted where the wrapper launches it.
LAUNCHES = {"k1": 0, "k2": 0, "k3": 0}

K3_MAX_TAPS = 33
# K3 holds a (32+2r) x (32+2r) x C tile and a 32 x (32+2r) x C intermediate
# in shared memory: 196 KB at C=8 and 33 taps, within the 227 KB a block
# may use
K3_MAX_CHANNELS = 8


def on_card(x: torch.Tensor) -> bool:
    """False for a CPU tensor, True for a CUDA tensor; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return True


def stream_of(x: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``x``'s device."""
    return torch.cuda.current_stream(x.device).cuda_stream


@lru_cache(maxsize=64)
def constant_on(values: tuple, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """A small host constant as a tensor on ``device``, uploaded once."""
    return torch.tensor(values, dtype=dtype, device=device)


def _separable_blur_plain(x: torch.Tensor, taps: Sequence[float]
                          ) -> torch.Tensor:
    """K3's plain version: the two `_depthwise_conv` passes (rows, then
    columns) with edge padding, as the JAX package runs off the TPU."""
    from .blur import _depthwise_conv

    k = np.asarray(taps, np.float32)
    out = _depthwise_conv(x, k.reshape(1, -1), "edge")
    return _depthwise_conv(out, k.reshape(-1, 1), "edge")


def separable_blur(x: torch.Tensor, taps: Sequence[float]) -> torch.Tensor:
    """K3: blur an (N, H, W, C) float32 tensor (C <= 8) by the odd 1-D
    kernel ``taps`` (at most 33) along H and along W, edge-replicate
    borders."""
    taps = tuple(float(t) for t in np.asarray(taps, np.float32))
    if not on_card(x):
        return _separable_blur_plain(x, taps)
    if x.dim() != 4 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("separable_blur takes a contiguous (N, H, W, C) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if (len(taps) % 2 != 1 or len(taps) > K3_MAX_TAPS or x.numel() == 0 or
            x.shape[-1] > K3_MAX_CHANNELS):
        raise ValueError(f"separable_blur: {len(taps)} taps on "
                         f"{tuple(x.shape)}")
    N, H, W, C = x.shape
    y = torch.empty_like(x)
    t = constant_on(taps, torch.float32, x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k3_separable_blur(x.data_ptr(), y.data_ptr(), t.data_ptr(),
                                    N, H, W, C, len(taps), stream_of(x))
    _build.check(err, "k3_separable_blur")
    LAUNCHES["k3"] += 1
    return y
