"""Hand-written CUDA kernels of the port: wrappers, plain versions, counts.

Counterpart of ``imagemagick_tpu/ops/pallas_kernels.py``.  Holds three
kernels and the launch counts of every kernel of the package (the wrappers
of K1, K2 and K2p live in ``fused_pipeline.py`` beside their planners,
those of K6a-K6c in ``fourier_kernels.py``, those of the palette walks,
which replace no Pallas kernel, in ``quantize.py``):

* K3, ``separable_blur`` (``csrc/separable_blur.cu``): the odd-tap
  Gaussian of the blur ops.
* K4, ``histogram256`` (``csrc/histogram256.cu``): one exact 256-bin
  histogram per row, ``bin = clip(int(v*255 + 0.5), 0, 255)``.  Config #3
  (``-auto-threshold otsu``) takes the per-image Otsu values from one
  launch over the (N, H*W) batch.
* K5, ``fused_bilevel_morph_edge`` (``csrc/morph_edge.cu``): config #3's
  tail, threshold -> open square:1 -> close square:1 -> edge 1, in one
  pass with one threshold per image read from device memory.

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
LAUNCHES = {"k1": 0, "k2": 0, "k2p": 0, "k3": 0, "k4": 0, "k5": 0, "k6a": 0,
            "k6b": 0, "k6c": 0, "walk_fs": 0, "walk_riemersma": 0}

K3_MAX_TAPS = 33
# K3's generic kernel holds a (32+2r) x (32+2r) x C window and a
# 32 x (32+2r) x C vertical pass in shared memory: 198 KB at C=8 and 33
# taps, within the 227 KB a block may use
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
    """A small host constant as a tensor on ``device``, uploaded once:
    calls with equal arguments return the same tensor, which callers do
    not write to."""
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
    # on the host: the C entry copies them into the kernel's arguments
    t = constant_on(taps, torch.float32, torch.device("cpu"))
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k3_separable_blur(x.data_ptr(), y.data_ptr(), t.data_ptr(),
                                    N, H, W, C, len(taps), stream_of(x))
    _build.check(err, "k3_separable_blur")
    LAUNCHES["k3"] += 1
    return y


def histogram256_plain(x: torch.Tensor) -> torch.Tensor:
    """K4's plain version: (R, L) float32 -> (R, 256) float32 counts of
    ``clip(int(v*255 + 0.5), 0, 255)`` per row.  The product and the sum
    round one at a time (the kernel's ``__fmul_rn`` / ``__fadd_rn``).  NaN
    lands in bin 0 and the float is clamped to [-1, 256] before the cast,
    so out-of-range values clip to bin 0 or 255 as the kernel's saturating
    ``__float2int_rz`` makes them."""
    from .histogram import _bin_index, _histogram_fixed_batched

    return _histogram_fixed_batched(_bin_index(x, 256), 256)


# K4's scratch: the int32 accumulators of up to this many rows, then their
# tickets; a row is shared by several blocks only when there are fewer
# rows than half the card's SMs x 4 (264 on an H100)
K4_SCRATCH_ROWS = 2048


@lru_cache(maxsize=16)
def _k4_scratch(device: torch.device, stream: int) -> torch.Tensor:
    """K4's zeroed scratch for one stream of one device, made once: the
    kernel leaves it zero, so calls on one stream, which run in turn,
    share it."""
    return torch.zeros(K4_SCRATCH_ROWS * 257, dtype=torch.int32,
                       device=device)


def histogram256(x: torch.Tensor) -> torch.Tensor:
    """K4: one 256-bin histogram of each row of an (R, L) float32 tensor,
    as (R, 256) float32 counts (exact: the kernel counts in int32), in one
    launch."""
    if not on_card(x):
        return histogram256_plain(x)
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("histogram256 takes a contiguous (R, L) float32 "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    rows, rowlen = x.shape
    if rows < 1 or rowlen < 1 or rowlen >= 2 ** 31:
        raise ValueError(f"histogram256: shape {tuple(x.shape)}")
    counts = torch.empty((rows, 256), dtype=torch.float32, device=x.device)
    stream = stream_of(x)
    scratch = _k4_scratch(x.device, stream)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.k4_histogram256(x.data_ptr(), counts.data_ptr(),
                                  scratch.data_ptr(), K4_SCRATCH_ROWS, rows,
                                  rowlen, stream)
    _build.check(err, "k4_histogram256")
    LAUNCHES["k4"] += 1
    return counts


def _thresholds(threshold, n: int, device: torch.device) -> torch.Tensor:
    """One float32 threshold per image on ``device``: a scalar is
    broadcast, an (N,) tensor is taken as it is."""
    if not isinstance(threshold, torch.Tensor):
        return torch.full((n,), float(threshold), dtype=torch.float32,
                          device=device)
    t = threshold.to(device=device, dtype=torch.float32)
    if t.dim() == 0:
        return t.expand(n).contiguous()
    if t.shape != (n,):
        raise ValueError(f"{tuple(t.shape)} thresholds for {n} images")
    return t.contiguous()


def _morph_edge_reference(x3: torch.Tensor, threshold) -> torch.Tensor:
    """K5's plain version, the op chain with each stage padding its own
    input: bilevel -> open square:1 -> close square:1 -> edge 1 on an
    (N, H, W) float32 tensor, one threshold per image (or one for all)."""
    from . import blur as _bl
    from . import morphology as _mo
    from . import threshold as _th

    t = _thresholds(threshold, x3.shape[0], x3.device)
    y = _th.bilevel(x3[..., None], t.view(-1, 1, 1, 1))
    y = _mo.morphology(y, "open", "square:1")
    y = _mo.morphology(y, "close", "square:1")
    return _bl.edge_image(y, 1.0)[..., 0]


def fused_bilevel_morph_edge(img: torch.Tensor, threshold) -> torch.Tensor:
    """K5: bilevel(threshold) -> open(square:1) -> close(square:1) ->
    edge(1) of an (N, H, W, 1) or (N, H, W) float32 batch, as the op chain
    computes it (``x > threshold``, every stage edge-replicated).
    ``threshold`` is a scalar or one value per image, e.g. the (N,)
    tensor of ``threshold.auto_threshold_values``; the kernel reads it
    from device memory."""
    if img.dim() == 4 and img.shape[-1] == 1:
        x3 = img[..., 0]
    elif img.dim() == 3:
        x3 = img
    else:
        raise ValueError("fused_bilevel_morph_edge takes (N, H, W, 1) or "
                         f"(N, H, W), got {tuple(img.shape)}")
    if x3.numel() == 0:           # no pixel: nothing to threshold
        return torch.empty_like(img)
    if not on_card(img):
        out = _morph_edge_reference(x3, threshold)
        return out[..., None] if img.dim() == 4 else out
    if img.dtype != torch.float32:
        raise ValueError("fused_bilevel_morph_edge takes a float32 batch, "
                         f"got {img.dtype} {tuple(img.shape)}")
    N, H, W = x3.shape
    x3 = x3.contiguous()
    t = _thresholds(threshold, N, img.device)
    y = torch.empty_like(x3)
    lib = _build.load()
    with torch.cuda.device(img.device):
        err = lib.k5_morph_edge(x3.data_ptr(), t.data_ptr(), y.data_ptr(),
                                N, H, W, stream_of(img))
    _build.check(err, "k5_morph_edge")
    LAUNCHES["k5"] += 1
    return y[..., None] if img.dim() == 4 else y
