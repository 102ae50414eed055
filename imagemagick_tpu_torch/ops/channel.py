"""Channel ops: separate/combine/swap, alpha ops, channel-fx (channel.c).

Port of ``imagemagick_tpu/ops/channel.py``, whole (the reference's
MagickCore/channel.c: ChannelFxImage (:196) with its ``red=>blue`` and
compact ``rgba=>bgra`` forms and ``<=>``, SeparateImage(s), CombineImages
and the SetImageAlphaChannel operations).  Every op is a slice, an index
or a concatenation of the tensor on its own device, so each is bit-exact
to the JAX function.

One difference: a ``channel_fx`` clause that names a channel the image
lacks (``k`` on an RGB image) raises ValueError.  The JAX function reads
such a channel clamped to the last one and drops the write
(``jnp``'s out-of-range indexing).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

_CHANNEL_INDEX = {
    "r": 0, "red": 0, "c": 0, "cyan": 0, "gray": 0, "k": 3,
    "g": 1, "green": 1, "m": 1, "magenta": 1,
    "b": 2, "blue": 2, "y": 2, "yellow": 2,
    "black": 3,
    "a": -1, "alpha": -1, "o": -1, "opacity": -1,
}


def separate(img: torch.Tensor, channel: str) -> torch.Tensor:
    """SeparateImage: extract one channel as grayscale."""
    idx = _CHANNEL_INDEX[channel.lower()]
    if idx == -1:
        idx = img.shape[-1] - 1
    return img[..., idx:idx + 1]


def separate_all(img: torch.Tensor) -> List[torch.Tensor]:
    """SeparateImages: one grayscale image per channel."""
    return [img[..., i:i + 1] for i in range(img.shape[-1])]


def combine(channels: Sequence[torch.Tensor]) -> torch.Tensor:
    """CombineImages: stack grayscale images into channels."""
    return torch.cat([c[..., :1] for c in channels], dim=-1)


def swap_channels(img: torch.Tensor, order: Sequence[int]) -> torch.Tensor:
    return img[..., list(order)]


def channel_fx(img: torch.Tensor, expression: str,
               has_alpha: bool = False) -> torch.Tensor:
    """ChannelFxImage (channel.c:196): '<src>=><dst>[,...]', 'a<=>b' or
    the compact 'rgba=>bgra'.  Every clause reads the input image; the
    compact form replaces what earlier clauses wrote."""
    expr = expression.strip().lower()
    nch = img.shape[-1]
    out = img

    def resolve(tok: str) -> int:
        tok = tok.strip()
        if tok not in _CHANNEL_INDEX:
            raise ValueError(f"unknown channel {tok!r}")
        i = _CHANNEL_INDEX[tok]
        i = nch - 1 if i == -1 else i
        if i >= nch:
            raise ValueError(f"channel {tok!r} is not in a {nch}-channel "
                             f"image")
        return i

    def put(dst: torch.Tensor, idx: int, src: torch.Tensor) -> torch.Tensor:
        dst = dst.clone() if dst is img else dst
        dst[..., idx] = src
        return dst

    for clause in expr.split(","):
        clause = clause.strip()
        if "<=>" in clause:
            a, b = (resolve(t) for t in clause.split("<=>"))
            out = put(put(out, a, img[..., b]), b, img[..., a])
        elif "=>" in clause:
            src_s, dst_s = clause.split("=>")
            src_s, dst_s = src_s.strip(), dst_s.strip()
            if len(src_s) > 1 and len(dst_s) == len(src_s) and \
                    src_s.isalpha() and src_s not in _CHANNEL_INDEX:
                # compact form: rgba=>bgra
                out = img[..., [resolve(c) for c in dst_s]]
            else:
                out = put(out, resolve(dst_s), img[..., resolve(src_s)])
    return out


def channel_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=-1)`` as XLA computes it on the CPU: the
    channels summed in order, times the float32 reciprocal of their
    count (a 0-d tensor, so the card multiplies by the same bits)."""
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s * torch.tensor(np.float32(1.0) / np.float32(x.shape[-1]),
                            device=x.device)


def _plane(img: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full(img.shape[:-1] + (1,), value, dtype=img.dtype,
                      device=img.device)


def set_alpha(img: torch.Tensor, operation: str, has_alpha: bool,
              background: Optional[Sequence[float]] = None) -> torch.Tensor:
    """SetImageAlphaChannel ops (channel.c / image.h AlphaChannelOption)."""
    op = operation.lower()
    c = img.shape[-1]
    if op in ("set", "on", "activate", "opaque"):
        if has_alpha:
            if op == "opaque":
                return torch.cat([img[..., :-1], _plane(img, 1.0)], -1)
            return img
        return torch.cat([img, _plane(img, 1.0)], -1)
    if op in ("off", "deactivate", "remove", "flatten"):
        if not has_alpha:
            return img
        if op in ("remove", "flatten"):
            bg = list(background) if background is not None \
                else [1.0, 1.0, 1.0]
            bg = torch.tensor(bg, dtype=img.dtype, device=img.device)[: c - 1]
            a = img[..., -1:]
            return img[..., :-1] * a + bg * (1.0 - a)
        return img[..., :-1]
    if op == "extract":
        if has_alpha:
            return img[..., -1:]
        return _plane(img, 1.0)
    if op == "copy":
        inten = channel_mean(img[..., : c - (1 if has_alpha else 0)])[
            ..., None]
        if has_alpha:
            return torch.cat([img[..., :-1], inten], -1)
        return torch.cat([img, inten], -1)
    if op == "transparent":
        if has_alpha:
            return torch.cat([img[..., :-1], _plane(img, 0.0)], -1)
        return torch.cat([img, _plane(img, 0.0)], -1)
    raise ValueError(f"unknown alpha operation {operation!r}")
