"""Dispatch of tagged op chains onto the fused kernel K1.

Port of ``imagemagick_tpu/ops/dispatch.py``.  A pipeline interpreter (the
serve sessions' batched call, the wand/CLI per-image call) pattern-matches
its pending op queue against chains the banded-block-product kernel covers
(resize / separable gaussian blur / linear channel mix, in any order) and
runs the matched chain as ONE kernel launch instead of an op chain.

Chain composition is exact: each tagged op contributes its (out, in)
banded operator on each axis (the same matrices the op path applies),
composed host-side into a single (Mv, Mw, mix) triple.  The one semantic
deviation: the op path clips to [0,1] after each op while the kernel clips
once at the end (a chain of clips is not linear); tests gate the
difference at >=60dB on representative content.

Unlike the JAX package, nothing here catches an error: a chain or shape
outside the kernel's envelope returns None, and an error of the kernel,
its build or its launch propagates to the caller.  So ``COUNTS`` has no
``error`` count.  It counts ``fused``, each chain or batch that ran as one
K1 launch (here), and ``op``, each lazy chain remainder that ran as
PyTorch ops (counted by the CLI's ``LazyImage``); the JAX CLI's ``pallas``
and ``xla`` counts are these two.  ``sharded`` counts each remainder that
ran with its image split over a ``-define tpu:mesh`` mesh (the JAX CLI's
``gspmd``); such a chain counts one ``op`` too, as the JAX CLI's counts
one ``xla``.

Plans and device operands are cached per (shape, chain, device), so
repeated requests pay host planning and the operator upload once.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# dispatch outcome counter (inspected by tests and tooling)
COUNTS = {"fused": 0, "op": 0, "sharded": 0}

_MAX_DIM = 4096          # dense host-side operator composition bound
_MAX_CHANNELS = 4
_TO = 64                 # K1 row tile, fused_linear_pipeline's default


def _fully_opaque(data: torch.Tensor) -> bool:
    """True when the trailing (alpha) channel is 1 everywhere.

    Alpha-carrying chains are only dispatched when the image is fully
    opaque: the reference resizes/interpolates alpha-PREMULTIPLIED
    (resize.c BlendPixelTrait) and premultiplication is the identity
    exactly there, making the whole chain linear on the straight
    channels.  One scalar readback; callers only pay it for alpha specs."""
    return bool(data[..., -1].min().item() >= 1.0 - 1e-6)


def _aligned_dims(H: int, W: int, C: int) -> Tuple[int, int]:
    """Smallest (H', W') >= (H, W) with H'%8 == 0 and (W'·C)%128 == 0."""
    step = 128 // math.gcd(128, C)
    return -(-H // 8) * 8, -(-W // step) * step


@functools.lru_cache(maxsize=64)
def _plan_chain(H: int, W: int, C: int, prefix: tuple):
    """Compose a tagged chain into (Mv, Mw, mix, Hout, Wout, Cout).

    Tags (hashable): ("resize", (h, w, filter)) · ("gblur", (radius,
    sigma, rule)) · ("mix", ((row...), ...)).  Returns None when the
    chain leaves the kernel's envelope (upscale, bad op).
    """
    from .fused_pipeline import blur_band_matrix
    from .resize import resize_matrix

    hcur, wcur = H, W
    Av: Optional[np.ndarray] = None   # None = identity
    Aw: Optional[np.ndarray] = None
    mix: Optional[np.ndarray] = None
    ccur = C
    for kind, params in prefix:
        if kind == "resize":
            h, w, filt = params
            if h > hcur or w > wcur or h < 1 or w < 1:
                return None
            Rv = resize_matrix(hcur, h, filt).astype(np.float64).T
            Rw = resize_matrix(wcur, w, filt).astype(np.float64).T
            Av = Rv if Av is None else Rv @ Av
            Aw = Rw if Aw is None else Rw @ Aw
            hcur, wcur = h, w
        elif kind == "gblur":
            radius, sigma, rule = params
            if sigma <= 0:
                continue
            Bv = blur_band_matrix(hcur, sigma, radius, width_rule=rule)
            Bw = blur_band_matrix(wcur, sigma, radius, width_rule=rule) \
                if wcur != hcur else Bv
            Av = Bv if Av is None else Bv @ Av
            Aw = Bw if Aw is None else Bw @ Aw
        elif kind == "mix":
            m = np.asarray(params, np.float64)
            if m.ndim != 2 or m.shape[1] != ccur:
                return None
            mix = m if mix is None else m @ mix
            ccur = m.shape[0]
        else:
            return None
    if Av is None:
        Av = np.eye(hcur)
    if Aw is None:
        Aw = np.eye(wcur)
    return Av, Aw, mix, hcur, wcur, ccur


@functools.lru_cache(maxsize=64)
def _batch_array_runner(N: int, H: int, W: int, C: int, prefix: tuple,
                        device: torch.device):
    """A runner (N, H, W, C) -> (N, Hout, Wout, Cout) on ``device`` for
    one chain, or None when the chain leaves the kernel's envelope.  The
    image is zero-padded to the kernel's alignment (rows %8, W·C %128) and
    the operators are zero-extended over the pad, so any shape runs as a
    born-aligned one."""
    from .fused_pipeline import flat_r0, linear_plan, plan_to_tensors, run_plan

    plan = _plan_chain(H, W, C, prefix)
    if plan is None:
        return None
    Mv, Mw, mix, Hout, Wout, Cout = plan
    Hp, Wp = _aligned_dims(H, W, C)
    if (Hp, Wp) != (H, W):
        Mv = np.pad(Mv, ((0, 0), (0, Hp - H)))
        Mw = np.pad(Mw, ((0, 0), (0, Wp - W)))
    mix = np.asarray(np.eye(C) if mix is None else mix, np.float64)
    kplan = linear_plan([(Mv, Mw)], C, mix, _TO, Hp, Wp * C)
    ops = plan_to_tensors(kplan.WV, kplan.GB, flat_r0(kplan.r0s, N, Hp),
                          device)

    def run(x: torch.Tensor) -> torch.Tensor:
        if (Hp, Wp) != (H, W):
            x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
        return run_plan(x.reshape(N * Hp, Wp * C).contiguous(), N, kplan,
                        ops)

    return run


def _in_envelope(H: int, W: int, C: int) -> bool:
    return not (H < 8 or W * C < 128 or C > _MAX_CHANNELS
                or H > _MAX_DIM or W > _MAX_DIM)


def try_fused_batch_array(x: torch.Tensor, tags: List[Optional[tuple]],
                          alpha: bool = False) -> Optional[torch.Tensor]:
    """Run a fully tagged chain over one (N, H, W, C) float32 tensor (the
    serve sessions' batched call).  Returns the (N, Hout, Wout, Cout)
    result, or None when the chain or shape leaves the kernel envelope."""
    if x.dim() != 4 or x.dtype != torch.float32:
        return None
    N, H, W, C = map(int, x.shape)
    if not _in_envelope(H, W, C):
        return None
    if alpha and not _fully_opaque(x):
        return None
    n = match_prefix(tags)
    if n != len(tags) or n == 0:
        return None
    run = _batch_array_runner(N, H, W, C, tuple(tags), x.device)
    if run is None:
        return None
    out = run(x)
    COUNTS["fused"] += 1
    return out


def try_fused_batch(datas: Sequence[torch.Tensor],
                    tags: List[Optional[tuple]],
                    alpha: bool = False) -> Optional[torch.Tensor]:
    """Batch variant of try_fused_chain (the CLI's grouped call): ``datas``
    is a sequence of N same-shape (H, W, C) float32 tensors on one device
    sharing one FULLY tagged chain, run as one stacked batch
    (``try_fused_batch_array``)."""
    return try_fused_batch_array(torch.stack(list(datas)), tags, alpha)


def match_prefix(tags: List[Optional[tuple]]) -> int:
    """Length of the leading run of kernel-expressible tags — at least
    one spatial op (resize/gblur) required for dispatch to pay."""
    n = 0
    for t in tags:
        if t is None or t[0] not in ("resize", "gblur", "mix"):
            break
        n += 1
    if not any(t[0] in ("resize", "gblur") for t in tags[:n]):
        return 0
    return n


def try_fused_chain(data: torch.Tensor, tags: List[Optional[tuple]],
                    alpha: bool = False
                    ) -> Optional[Tuple[torch.Tensor, int]]:
    """Dispatch the longest expressible prefix of a tagged lazy chain (the
    wand/CLI per-image call).

    data: (H, W, C) float32 tensor.  tags: one entry per pending op
    (None = not expressible).  alpha: the image spec carries alpha (the
    trailing channel) — dispatch requires it fully opaque, see
    _fully_opaque.  Returns (out, n_ops_consumed) or None when nothing
    dispatches (the caller runs the op chain).  The image runs as a batch
    of one.
    """
    if data.dim() != 3 or data.dtype != torch.float32:
        return None
    H, W, C = map(int, data.shape)
    if not _in_envelope(H, W, C):
        return None
    if alpha and not _fully_opaque(data):
        return None
    n = match_prefix(tags)
    if n == 0:
        return None
    run = _batch_array_runner(1, H, W, C, tuple(tags[:n]), data.device)
    if run is None:
        return None
    out = run(data[None])[0]
    COUNTS["fused"] += 1
    return out, n
