"""Composite: Porter-Duff + blend-mode compositing (composite.c).

Port of ``imagemagick_tpu/ops/composite.py``, whole: CompositeImage
(MagickCore/composite.c:1424) and its operator set (composite.h:25-108)
as per-pixel math over aligned (..., H, W, C) float32 tensors on their
own device.  Gravity/offset placement pads or crops the source to the
destination canvas first, then the operator runs as PyTorch ops — the
thumbnailer's watermark path.

Conventions: inputs are non-premultiplied RGB(A) in [0,1].  ``src`` is the
composite (overlay) image, ``dst`` the canvas, matching the reference's
argument order CompositeImage(image=dst, composite=src).

Duff-Porter algebra uses premultiplied intermediates:
  Dca' = f(Sc,Dc)·Sa·Da + Sca·(1−Da) + Dca·(1−Sa)       (blend modes)
with the standard SVG-compositing f per operator.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

_EPS = 1e-12


def _split_rgba(x: torch.Tensor, has_alpha: bool):
    if has_alpha:
        return x[..., :-1], x[..., -1:]
    return x, torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)


def _sanitize(c, a):
    return c, a.clamp(0.0, 1.0)


def _div(n, d):
    return n / torch.where(d.abs() < _EPS, _EPS, d)


def _min1(x):
    return x.clamp(max=1.0)


# --- blend-mode channel functions f(Sc, Dc) (composite.c per-case math) ----

def _f_multiply(s, d):
    return s * d


def _f_screen(s, d):
    return s + d - s * d


def _f_overlay_correct(s, d):
    return torch.where(2.0 * d <= 1.0, 2.0 * s * d,
                       1.0 - 2.0 * (1.0 - s) * (1.0 - d))


def _f_darken(s, d):
    return torch.minimum(s, d)


def _f_lighten(s, d):
    return torch.maximum(s, d)


def _f_color_dodge(s, d):
    return torch.where(d <= 0.0, 0.0,
                       torch.where(s >= 1.0, 1.0, _min1(_div(d, 1.0 - s))))


def _f_color_burn(s, d):
    return torch.where(d >= 1.0, 1.0,
                       torch.where(s <= 0.0, 0.0,
                                   1.0 - _min1(_div(1.0 - d, s))))


def _f_hard_light(s, d):
    return _f_overlay_correct(d, s)


def _f_soft_light(s, d):
    """SVG soft-light (composite.c SoftLight)."""
    g = torch.where(d <= 0.25, ((16.0 * d - 12.0) * d + 4.0) * d,
                    torch.sqrt(d.clamp(min=0.0).double()).float())
    return torch.where(2.0 * s <= 1.0,
                       d - (1.0 - 2.0 * s) * d * (1.0 - d),
                       d + (2.0 * s - 1.0) * (g - d))


def _f_difference(s, d):
    return (s - d).abs()


def _f_exclusion(s, d):
    return s + d - 2.0 * s * d


def _f_linear_burn(s, d):
    return s + d - 1.0


def _f_linear_dodge(s, d):
    return s + d


def _f_linear_light(s, d):
    return 2.0 * s + d - 1.0


def _f_vivid_light(s, d):
    return torch.where(2.0 * s <= 1.0,
                       1.0 - _min1(_div(1.0 - d, 2.0 * s)),
                       _min1(_div(d, 2.0 * (1.0 - s))))


def _f_pin_light(s, d):
    return torch.where(2.0 * s <= 1.0,
                       torch.minimum(d, 2.0 * s),
                       torch.maximum(d, 2.0 * s - 1.0))


def _f_hard_mix(s, d):
    return torch.where(s + d >= 1.0, 1.0, 0.0)


def _f_minus_src(s, d):
    return s - d


def _f_minus_dst(s, d):
    return d - s


def _f_divide_src(s, d):
    return _div(s, d)


def _f_divide_dst(s, d):
    return _div(d, s)


def _f_modulus_add(s, d):
    # jnp.mod is a floored modulus: torch.remainder, not torch.fmod
    return torch.remainder(s + d, 1.0 + _EPS)


def _f_modulus_subtract(s, d):
    return torch.remainder(s - d + 1.0, 1.0 + _EPS)


def _f_freeze(s, d):
    """Freeze (composite.c:3017): 1 - (1-Sc)^2/Dc, clamped at 0."""
    return (1.0 - _div((1.0 - s) ** 2, d)).clamp(min=0.0)


def _f_interpolate(s, d):
    """Interpolate (composite.c:3178 region): cosine interpolation."""
    return 0.5 - 0.25 * torch.cos(math.pi * s) - 0.25 * torch.cos(math.pi * d)


def _f_negate(s, d):
    """Negate (composite.c:3299): 1 - |1 - Sc - Dc|."""
    return 1.0 - (1.0 - s - d).abs()


def _f_reflect(s, d):
    """Reflect (composite.c:3379): Sc^2/(1-Dc), clamped at 1."""
    return _min1(_div(s * s, 1.0 - d))


def _f_soft_burn(s, d):
    """SoftBurn (composite.c:3462)."""
    return torch.where(s + d < 1.0, 0.5 * _div(d, 1.0 - s),
                       1.0 - 0.5 * _div(1.0 - s, d))


def _f_soft_dodge(s, d):
    """SoftDodge (composite.c:3472)."""
    return torch.where(s + d < 1.0, 0.5 * _div(s, 1.0 - d),
                       1.0 - 0.5 * _div(1.0 - d, s))


def _f_stamp(s, d):
    """Stamp (composite.c:3501): Sc + Dc^2 - 1."""
    return s + d * d - 1.0


def _f_pegtop_light(s, d):
    """PegtopLight (composite.c:3328): Dc^2*(1-2Sc) + 2*Sc*Dc."""
    return d * d * (1.0 - 2.0 * s) + 2.0 * s * d


_BLEND_FNS = {
    "freeze": _f_freeze,
    "interpolate": _f_interpolate,
    "negate": _f_negate,
    "reflect": _f_reflect,
    "softburn": _f_soft_burn,
    "softdodge": _f_soft_dodge,
    "stamp": _f_stamp,
    "pegtoplight": _f_pegtop_light,
    "multiply": _f_multiply,
    "screen": _f_screen,
    "overlay": _f_overlay_correct,
    "darken": _f_darken,
    "lighten": _f_lighten,
    "colordodge": _f_color_dodge,
    "colorburn": _f_color_burn,
    "hardlight": _f_hard_light,
    "softlight": _f_soft_light,
    "difference": _f_difference,
    "exclusion": _f_exclusion,
    "linearburn": _f_linear_burn,
    "lineardodge": _f_linear_dodge,
    "linearlight": _f_linear_light,
    "vividlight": _f_vivid_light,
    "pinlight": _f_pin_light,
    "hardmix": _f_hard_mix,
    "minus": _f_minus_src,
    "minussrc": _f_minus_src,
    "minusdst": _f_minus_dst,
    "divide": _f_divide_src,
    "dividesrc": _f_divide_src,
    "dividedst": _f_divide_dst,
    "modulusadd": _f_modulus_add,
    "modulussubtract": _f_modulus_subtract,
}

# every operator name composite() takes, the blend modes last
OPERATORS = (
    "over", "srcover", "dstover", "in", "srcin", "dstin", "out", "srcout",
    "dstout", "atop", "srcatop", "dstatop", "xor", "plus", "copy", "src",
    "replace", "dst", "none", "clear", "dissolve", "blend", "mathematics",
    "threshold", "changemask", "stereo", "copyred", "copygreen",
    "copyblue", "copyalpha", "copyblack", "copycyan", "copymagenta",
    "copyyellow", "copyopacity", "hue", "saturate", "luminize", "colorize",
    "lightenintensity", "darkenintensity", "bumpmap", "alpha", "no", "rmse",
    "modulate", "displace", "distort") + tuple(_BLEND_FNS)


def _luma(x):
    """Rec709 luma (GetPixelIntensity default) over color channels."""
    if x.shape[-1] >= 3:
        return (0.212656 * x[..., :1] + 0.715158 * x[..., 1:2] +
                0.072186 * x[..., 2:3])
    return x[..., :1]


def _rgb3(x):
    """Three color channels for the HCL ops: a gray image's channel read
    as r, g and b (the JAX package's out-of-range channel index clamps
    to the last channel)."""
    c = x.shape[-1]
    if c >= 3:
        return x
    return x[..., [min(i, c - 1) for i in range(3)]]


def _hsl_ops(op, sc, dc):
    """Hue/Saturate/Luminize/Colorize component swaps in the HCL space —
    the reference's default compose colorspace (composite.c:1436)."""
    from . import colorspace as cs

    s_g = cs.rgb_to_hcl(_rgb3(sc))
    d_g = cs.rgb_to_hcl(_rgb3(dc))
    if op == "hue":
        out = torch.stack([s_g[..., 0], d_g[..., 1], d_g[..., 2]], -1)
    elif op == "saturate":
        out = torch.stack([d_g[..., 0], s_g[..., 1], d_g[..., 2]], -1)
    elif op == "luminize":
        out = torch.stack([d_g[..., 0], d_g[..., 1], s_g[..., 2]], -1)
    else:  # colorize: hue+chroma from src, luma from dst
        out = torch.stack([s_g[..., 0], s_g[..., 1], d_g[..., 2]], -1)
    return cs.hcl_to_rgb(out)


def _widen(x: torch.Tensor, nc: int) -> torch.Tensor:
    """gray -> color broadcast; only a 1-channel side can widen."""
    if x.shape[-1] >= nc:
        return x
    if x.shape[-1] == 1:
        return x[..., :1].expand(x.shape[:-1] + (nc,))
    return torch.cat([x, x[..., -1:].expand(
        x.shape[:-1] + (nc - x.shape[-1],))], -1)


def composite(dst: torch.Tensor, src: torch.Tensor, operator: str = "over",
              dst_alpha: bool = False, src_alpha: bool = False,
              args: Sequence[float] = ()) -> torch.Tensor:
    """Apply a composite operator; src must already be canvas-aligned.

    Returns a tensor with alpha iff dst or src carried alpha (caller
    tracks spec)."""
    op = operator.lower().replace("-", "").replace("_", "")
    sc, sa = _split_rgba(src, src_alpha)
    dc, da = _split_rgba(dst, dst_alpha)
    nc = max(sc.shape[-1], dc.shape[-1])
    sc = _widen(sc, nc)
    dc = _widen(dc, nc)
    any_alpha = dst_alpha or src_alpha

    sca = sc * sa  # premultiplied
    dca = dc * da

    def with_alpha(out_c, out_a):
        if any_alpha:
            return torch.cat([out_c.clamp(0.0, 1.0),
                              out_a.clamp(0.0, 1.0)], -1)
        return out_c.clamp(0.0, 1.0)

    def unpack(out_ca, out_a):
        out_c = _div(out_ca, out_a)
        out_c = torch.where(out_a < _EPS, 0.0, out_c)
        return with_alpha(out_c, out_a)

    # --- Duff-Porter set (composite.h:25-108 operator enum) ---
    if op in ("over", "srcover"):
        return unpack(sca + dca * (1.0 - sa), sa + da * (1.0 - sa))
    if op in ("dstover",):
        return unpack(dca + sca * (1.0 - da), da + sa * (1.0 - da))
    if op in ("in", "srcin"):
        return unpack(sca * da, sa * da)
    if op in ("dstin",):
        return unpack(dca * sa, da * sa)
    if op in ("out", "srcout"):
        return unpack(sca * (1.0 - da), sa * (1.0 - da))
    if op in ("dstout",):
        return unpack(dca * (1.0 - sa), da * (1.0 - sa))
    if op in ("atop", "srcatop"):
        return unpack(sca * da + dca * (1.0 - sa), da)
    if op in ("dstatop",):
        return unpack(dca * sa + sca * (1.0 - da), sa)
    if op in ("xor",):
        return unpack(sca * (1.0 - da) + dca * (1.0 - sa),
                      sa + da - 2.0 * sa * da)
    if op in ("plus",):
        return unpack(sca + dca, _min1(sa + da))
    if op in ("copy", "src", "replace"):
        # straight copy: channel value = Sc regardless of Sa, alpha = Sa
        # (composite.c Copy group alpha switch)
        return with_alpha(sc, sa)
    if op in ("dst", "none"):
        return unpack(dca, da)
    if op in ("clear",):
        return unpack(torch.zeros_like(dca), torch.zeros_like(da))
    if op in ("dissolve",):
        # composite.c:2056: rho>100 wraps into the canvas factor
        if args:
            sd, cd = args[0] / 100.0, 1.0
            sd = max(sd, 0.0)
            if sd > 1.0:
                cd, sd = 2.0 - sd, 1.0
            if len(args) > 1:
                cd = args[1] / 100.0
            cd = min(max(cd, 0.0), 1.0)
        else:
            sd = cd = 1.0
        return unpack(sd * sca + cd * dca * (1.0 - sd * sa),
                      sd * sa + cd * da * (1.0 - sd * sa))
    if op in ("blend",):
        # composite.c:2083: defaults 1.0/1.0; sigma defaults to 1-rho
        sw = (args[0] / 100.0) if args else 1.0
        dw = (args[1] / 100.0) if len(args) > 1 else \
            (1.0 - sw if args else 1.0)
        return unpack(sw * sca + dw * dca, _min1(sw * sa + dw * da))
    if op in ("mathematics",):
        a0, b0, c0, d0 = (list(args) + [0.0] * 4)[:4]
        f = a0 * sc * dc + b0 * sc + c0 * dc + d0
        out_ca = f * sa * da + sca * (1.0 - da) + dca * (1.0 - sa)
        return unpack(out_ca, sa + da - sa * da)
    if op in ("threshold",):
        t = args[0] if args else 0.05
        diff = dc - sc
        out = torch.where(diff.abs() < t, dc, diff.clamp(0.0, 1.0))
        return unpack(out * da, da)
    if op in ("changemask",):
        same = ((sc - dc).abs() < 0.003).all(dim=-1, keepdim=True)
        out_a = torch.where(same, 0.0, da)
        return unpack(dc * out_a, out_a)
    if op in ("stereo",):
        out = torch.cat([sc[..., :1], dc[..., 1:]], -1)
        return unpack(out * da, da)
    if op in ("copyred", "copygreen", "copyblue", "copyalpha", "copyblack",
              "copycyan", "copymagenta", "copyyellow", "copyopacity"):
        ch = {"copyred": 0, "copycyan": 0, "copygreen": 1, "copymagenta": 1,
              "copyblue": 2, "copyyellow": 2, "copyblack": 3}.get(op)
        if op == "copyopacity":   # IM6 alias (option.c maps both)
            op = "copyalpha"
        if op == "copyalpha":
            new_a = sa if src_alpha else sc[..., :1]
            return torch.cat([dc, new_a.clamp(0, 1)], -1)
        out = dc.clone()
        if ch < out.shape[-1]:      # the JAX scatter drops a channel
            out[..., ch] = sc[..., min(ch, sc.shape[-1] - 1)]   # past C
        return unpack(out * da, da)
    if op in ("hue", "saturate", "luminize", "colorize"):
        # straight color: Dc when Sa==0, Sc when Da==0, else the HCL mix;
        # alpha = max(Sa, Da) (composite.c alpha switch)
        mix_c = _hsl_ops(op, sc, dc)
        out_c = torch.where(sa <= _EPS, dc, torch.where(da <= _EPS, sc,
                                                        mix_c))
        return with_alpha(out_c, torch.maximum(sa, da))
    if op in ("lightenintensity", "darkenintensity"):
        # Sa*Si vs Da*Di with Si = Rec709 luma; the winning PIXEL
        # (color and alpha) is copied (composite.c DarkenIntensity)
        si = _luma(sc)
        di = _luma(dc)
        take_src = (sa * si > da * di) if op == "lightenintensity" \
            else (sa * si < da * di)
        out_c = torch.where(take_src, sc, dc)
        # the built reference zeroes the alpha channel for the intensity
        # compares whenever alpha participates (oracle-measured)
        if any_alpha:
            return torch.cat([out_c.clamp(0.0, 1.0),
                              torch.zeros_like(sa * da)], -1)
        return out_c.clamp(0.0, 1.0)
    if op in ("bumpmap",):
        inten = _luma(sc)
        out_c = torch.where(sa <= _EPS, dc, inten * dc)   # Sa==0 passthrough
        return with_alpha(out_c, inten * da)
    if op in ("alpha",):
        # AlphaComposite (composite.c:2544): colors from dst, alpha := Sa
        new_a = sa if src_alpha else sc.mean(dim=-1, keepdim=True)
        return torch.cat([dc, new_a.clamp(0.0, 1.0)], -1)
    if op in ("no",):
        return unpack(dca, da)
    if op in ("rmse",):
        # RMSEComposite (composite.c:3387): per-pixel color distance as gray
        # (the reference's literal expression divides only the blue term
        # by 3 — reproduced for parity)
        n3 = min(3, sc.shape[-1])
        diff = dc[..., :n3] - sc[..., :n3]
        terms = diff * diff
        if n3 == 3:
            gray = torch.sqrt((terms[..., 0] + terms[..., 1]
                               + terms[..., 2] / 3.0).double())
            gray = gray.float()[..., None]
        else:
            gray = torch.sqrt(terms.sum(dim=-1, keepdim=True).double()) \
                .float()
        out = gray.expand(gray.shape[:-1] + (dc.shape[-1],))
        return unpack(out * da, da)
    if op in ("modulate",):
        # ModulateComposite (composite.c:3226): shift dst luma by the src
        # intensity around midpoint, scale chroma; args = (luma%, chroma%)
        from . import colorspace as cs

        pl = (args[0] if args else 100.0)
        pc = (args[1] if len(args) > 1 else 100.0)
        si = sc.mean(dim=-1, keepdim=True)
        hcl = cs.rgb_to_hcl(_rgb3(dc[..., :3]))
        luma = hcl[..., 2:3] + (0.01 * pl * (si - 0.5)) / 0.5
        chroma = hcl[..., 1:2] * 0.01 * pc
        out = cs.hcl_to_rgb(torch.cat([hcl[..., :1], chroma, luma], -1))
        out = torch.where((si - 0.5).abs() < 1e-6, dc[..., :3], out)
        if dc.shape[-1] > 3:
            out = torch.cat([out, dc[..., 3:]], -1)
        return unpack(out * da, da)
    if op in ("displace", "distort"):
        # the overlay is a displacement map: red -> X shift, green -> Y
        # shift, scaled by args (percent of the canvas size); dst sampled
        # at the displaced position (CompositeImage Displace/Distort).
        # A batch samples each image at its own map.
        from .distort import sample_bilinear

        h, w = dc.shape[-3], dc.shape[-2]
        xscale = (args[0] if args else 20.0) / 100.0 * w
        yscale = (args[1] if len(args) > 1 else
                  (args[0] if args else 20.0)) / 100.0 * h
        dev = dc.device
        yy = torch.arange(h, dtype=dc.dtype, device=dev)[:, None] * \
            torch.ones((1, w), dtype=dc.dtype, device=dev)
        xx = torch.ones((h, 1), dtype=dc.dtype, device=dev) * \
            torch.arange(w, dtype=dc.dtype, device=dev)[None, :]
        dx = (sc[..., 0] - 0.5) * xscale
        dy = (sc[..., min(1, sc.shape[-1] - 1)] - 0.5) * yscale
        out = sample_bilinear(dc, xx + dx, yy + dy)
        # outside the overlay's support (sa==0) keep dst
        out = torch.where(sa > 0, out, dc)
        return unpack(out * da, da)
    if op in ("difference",):
        # colors use the premultiplied SVG difference normalized by the
        # UNION alpha, but the written alpha channel is |Sa - Da|
        # (composite.c:2637)
        union = sa + da - sa * da
        out_c = _div(sca + dca - 2.0 * torch.minimum(sca * da, dca * sa),
                     union)
        if any_alpha:
            return torch.cat([out_c.clamp(0.0, 1.0), (sa - da).abs()], -1)
        return out_c.clamp(0.0, 1.0)
    if op in ("hardmix",):
        # threshold on the PREMULTIPLIED sum, normalized by union alpha
        union = sa + da - sa * da
        out_c = _div(torch.where(sca + dca < 1.0, 0.0, 1.0), union)
        return with_alpha(out_c, union)
    if op in ("modulusadd", "modulussubtract"):
        # wrap on the premultiplied values, stored straight (no gamma)
        if op == "modulusadd":
            v = sca + dca
            out_c = torch.where(v <= 1.0, v, v - 1.0)
            out_a = _min1(sa + da - sa * da)
        else:
            v = sca - dca
            out_c = torch.where(v >= 0.0, v, v + 1.0)
            out_a = sa * (1.0 - da)        # OUT-group alpha (oracle)
        return with_alpha(out_c, out_a)
    # --- SVG blend modes through the general alpha formula ---
    if op in _BLEND_FNS:
        f = _BLEND_FNS[op](sc, dc)
        out_ca = f * sa * da + sca * (1.0 - da) + dca * (1.0 - sa)
        out_a = sa + da - sa * da
        return unpack(out_ca, out_a)

    raise ValueError(f"unsupported composite operator {operator!r}")


GRAVITIES = ("northwest", "north", "northeast", "west", "center", "east",
             "southwest", "south", "southeast", "forget", "undefined")


def gravity_offset(gravity: str, dst_w: int, dst_h: int,
                   src_w: int, src_h: int, x: int = 0, y: int = 0
                   ) -> Tuple[int, int]:
    """Resolve a gravity + offset to absolute placement (gravity semantics
    from GravityAdjustGeometry, MagickCore/geometry.c)."""
    g = (gravity or "northwest").lower()
    if g in ("forget", "undefined", "northwest"):
        return x, y
    cx = (dst_w - src_w) // 2
    cy = (dst_h - src_h) // 2
    ex = dst_w - src_w
    ey = dst_h - src_h
    table = {
        "north": (cx + x, y),
        "northeast": (ex - x, y),
        "west": (x, cy + y),
        "center": (cx + x, cy + y),
        "east": (ex - x, cy + y),
        "southwest": (x, ey - y),
        "south": (cx + x, ey - y),
        "southeast": (ex - x, ey - y),
    }
    return table[g]


def place(dst: torch.Tensor, src: torch.Tensor, x: int, y: int,
          fill_alpha: float = 0.0) -> torch.Tensor:
    """Align src onto dst's canvas at (x, y), zero/transparent elsewhere.

    Returns a tensor shaped like dst (channel count of src) — the aligned
    overlay CompositeImage works from."""
    dh, dw = dst.shape[-3], dst.shape[-2]
    sh, sw = src.shape[-3], src.shape[-2]
    c = src.shape[-1]
    canvas = torch.zeros(dst.shape[:-3] + (dh, dw, c), dtype=src.dtype,
                         device=src.device)
    sx0, sy0 = max(-x, 0), max(-y, 0)
    dx0, dy0 = max(x, 0), max(y, 0)
    cw = min(sw - sx0, dw - dx0)
    ch = min(sh - sy0, dh - dy0)
    if cw <= 0 or ch <= 0:
        return canvas
    canvas[..., dy0:dy0 + ch, dx0:dx0 + cw, :] = \
        src[..., sy0:sy0 + ch, sx0:sx0 + cw, :]
    return canvas


def composite_at(dst: torch.Tensor, src: torch.Tensor, operator: str = "over",
                 x: int = 0, y: int = 0, gravity: str = "northwest",
                 dst_alpha: bool = False, src_alpha: bool = False,
                 args: Sequence[float] = ()) -> torch.Tensor:
    """CompositeImage with placement: aligns src then applies the operator.

    Outside the src region the overlay is fully transparent, so
    Duff-Porter operators behave exactly as the reference's region-limited
    loop."""
    dh, dw = dst.shape[-3], dst.shape[-2]
    sh, sw = src.shape[-3], src.shape[-2]
    gx, gy = gravity_offset(gravity, dw, dh, sw, sh, x, y)
    if not src_alpha:
        src = torch.cat([src, torch.ones(src.shape[:-1] + (1,),
                                         dtype=src.dtype,
                                         device=src.device)], -1)
    aligned = place(dst, src, gx, gy)
    return composite(dst, aligned, operator, dst_alpha=dst_alpha,
                     src_alpha=True, args=args)
