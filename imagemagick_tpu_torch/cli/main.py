"""The magick-compatible option interpreter: the ``config1_cli`` subset.

Port of ``imagemagick_tpu/cli/main.py``'s engine: a sequential
interpreter over an image list that *accumulates* ops per image
(``LazyImage``) and runs the whole chain at materialization.  Ops that
kernel K1 covers carry a dispatch tag (``ops/dispatch.py``): a fully
tagged chain over a group of same-shape images runs as ONE K1 launch
(``materialize_all`` -> ``dispatch.try_fused_batch``), a single image's
tagged prefix as one launch (``LazyImage.materialize`` ->
``dispatch.try_fused_chain``), and the rest as PyTorch ops on the
images' device (K3 for a blur on a card), eagerly: there is no jit and
no mesh.

Ported: parentheses, ``-resize`` (its tag; ``+resize`` is the same op),
``-colorspace``, ``-gaussian-blur`` and ``-blur``.  The settings keep the
JAX defaults and no option here changes them, so ``-filter`` is
``undefined``, ``-virtual-pixel`` ``edge`` and ``-channel`` ``default``;
write masks (``-region``) are not ported.  A file name, or any other
option, raises NotImplementedError naming its ROADMAP.md entry.  The
tags equal the JAX CLI's for the same arguments.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.color import parse_color
from ..core.geometry import parse_geometry, parse_meta_geometry
from ..core.image import Image
from ..core.spec import ImageSpec, normalize_colorspace

_IO_GAP = ("file names need the codecs and readers of io/, which are not "
           "ported yet: ROADMAP.md Queue 1, 'Host layers' (io/)")
_RESIZE_GAP = ("is not ported yet: ROADMAP.md Queue 1, 'The rest of the "
               "modules that the slices touched' (ops/resize.py)")
_OPS_GAP = ("is not ported yet: ROADMAP.md Queue 1, 'The rest of the "
            "modules that the slices touched' and 'The other op families "
            "under ops/'")


class CLIError(Exception):
    pass


class LazyImage:
    """An image plus a queue of pending ops (for whole-chain fusion).

    Shape-changing ops (resize) stay lazy too: they pass their statically
    known output (h, w) to push(), so later options compute geometry
    against the *pending* dimensions without materializing.

    Ops that kernel K1 covers pass a ``tag``; at materialization the
    tagged prefix of the chain runs as one K1 launch (ops/dispatch.py)
    and the remainder as PyTorch ops.
    """

    __slots__ = ("image", "pending", "_shape")

    def __init__(self, image: Image, pending=None):
        self.image = image
        self.pending = list(pending or [])
        self._shape = None  # (h, w) after pending ops; None = unchanged

    @property
    def height(self) -> int:
        return self._shape[0] if self._shape else self.image.height

    @property
    def width(self) -> int:
        return self._shape[1] if self._shape else self.image.width

    @property
    def spec(self) -> ImageSpec:
        """Spec AFTER pending ops (folds queued spec updates)."""
        return _fold_spec(self.image.spec, self.pending)

    def push(self, fn, spec_update=None, new_shape=None, tag=None):
        self.pending.append((fn, spec_update, tag))
        if new_shape is not None:
            self._shape = new_shape

    def _settle(self, data: torch.Tensor) -> Image:
        """Install ``data`` as the result of every pending op."""
        img = self.image
        out = Image(data, _fold_spec(img.spec, self.pending), img.properties,
                    img.profiles, img.page, img.delay)
        self.image = out
        self.pending = []
        self._shape = None
        return out

    def materialize(self) -> Image:
        if not self.pending:
            return self.image
        from ..ops import dispatch as _dispatch

        ops = self.pending
        data = self.image.data
        consumed = 0
        res = _dispatch.try_fused_chain(data, [t for _, _, t in ops],
                                        alpha=self.image.spec.alpha)
        if res is not None:
            data, consumed = res
        rest = ops[consumed:]
        if rest:
            data = _run_ops(data, rest)
        return self._settle(data)


def _fold_spec(spec: ImageSpec, ops) -> ImageSpec:
    for _, upd, _ in ops:
        if upd is not None:
            spec = upd(spec)
    return spec


def _run_ops(data: torch.Tensor, ops) -> torch.Tensor:
    """Run a chain's ops as PyTorch ops, eagerly, on ``data``'s device
    (one image or a stack of them); counts one ``op`` run."""
    from ..ops import dispatch as _dispatch

    _dispatch.COUNTS["op"] += 1
    for fn, _, _ in ops:
        data = fn(data)
    return data


class CLIState:
    def __init__(self):
        self.images: List[LazyImage] = []
        self.stack: List[List[LazyImage]] = []
        self.settings: Dict[str, str] = {
            "background": "white",
            "fill": "black",
            "gravity": "undefined",
            "filter": "undefined",
            "quality": "92",
            "virtual-pixel": "edge",
            "bordercolor": "#dfdfdf",
            "mattecolor": "#bdbdbd",
            "colorspace-setting": "",
            "interpolate": "bilinear",
            "channel": "default",
            "noise-attenuate": "1.0",
        }

    # -- helpers --
    def require_images(self, opt):
        if not self.images:
            raise CLIError(f"no images for option {opt}")

    def bg(self):
        return parse_color(self.settings["background"])

    def fill(self):
        return parse_color(self.settings["fill"])


def _geom_args(arg: str) -> Tuple[float, float]:
    """Parse 'AxB' op arguments like -blur 0x2 -> (radius, sigma)."""
    g = parse_geometry(arg)
    radius = g.width if g.width is not None else 0.0
    sigma = g.height if g.height is not None else 1.0
    return radius, sigma


# ---------------------------------------------------------------------------
# Option implementations.  Each handler: (state, arg, plus_form) -> None.
# ---------------------------------------------------------------------------

def _op_resize(st, arg, plus):
    """Resize stays LAZY: output dims are static, so the op joins the
    pending chain.  It is a separable linear map, tagged for K1 (alpha
    images too: dispatch checks full opacity, where premultiplied
    sampling equals straight sampling exactly)."""
    from ..ops import resize as rz

    filt = st.settings["filter"]
    for li in st.images:
        alpha = li.spec.alpha
        cw, ch = li.width, li.height
        w, h, _, _ = parse_meta_geometry(arg, cw, ch)
        rf = filt if filt not in ("undefined", "", None) else \
            rz._default_filter(ch, cw, h, w, alpha)
        li.push(lambda x, h=h, w=w, a=alpha: rz.resize(x, h, w, filt,
                                                       has_alpha=a),
                new_shape=(h, w), tag=("resize", (h, w, rf)))


def _op_blur(fname: str, rule: str):
    """A lazy -blur / -gaussian-blur handler.  A separable gaussian with
    edge-replicate pads is exactly what K1's band matrices encode
    (fused_pipeline.blur_band_matrix), so the op is tagged for K1 unless
    it is the + form, sigma is 0 or the virtual pixel is not ``edge``."""

    def handler(st, arg, plus):
        from ..ops import blur as bl

        fn = getattr(bl, fname)
        r, s = _geom_args(arg)
        vp = st.settings["virtual-pixel"]
        tag = None if plus or s <= 0 or vp != "edge" else \
            ("gblur", (float(r), float(s), rule))
        for li in st.images:
            li.push(lambda x: fn(x, radius=r, sigma=s, virtual_pixel=vp),
                    tag=tag)

    return handler


def _op_colorspace(st, arg, plus):
    """-colorspace stays LAZY (per-pixel math, spec update queued);
    sRGB->gray is a linear luma mix, tagged for K1."""
    from ..ops import colorspace as cs

    target = normalize_colorspace(arg)
    for li in st.images:
        src = li.spec.colorspace
        if src == target:
            continue
        nc = li.spec.color_channels

        def fn(x, src=src, tgt=target, nc=nc):
            color = cs.convert(x[..., :nc], src, tgt)
            rest = x[..., nc:]
            return torch.cat([color, rest], dim=-1) \
                if rest.shape[-1] else color

        tag = None
        if src == "srgb" and target == "gray" and nc == 3:
            luma = tuple(cs.REC709_LUMA)
            if li.spec.alpha:
                # gray+alpha: luma row with zero alpha weight + identity
                # alpha row (commutes with unpremultiplication)
                tag = ("mix", (luma + (0.0,), (0.0, 0.0, 0.0, 1.0)))
            else:
                tag = ("mix", (luma,))
        li.push(fn, spec_update=lambda s, t=target: s.with_(colorspace=t),
                tag=tag)


# option name -> (number of arguments, handler)
OPS: Dict[str, Tuple[int, Callable]] = {
    "resize": (1, _op_resize),
    "colorspace": (1, _op_colorspace),
    "blur": (1, _op_blur("blur", "1d")),
    "gaussian-blur": (1, _op_blur("gaussian_blur", "2d")),
}

_RESIZE_FAMILY = ("sample", "scale", "thumbnail", "adaptive-resize")


def process(args: Sequence[str], st: Optional[CLIState] = None) -> CLIState:
    """ProcessCommandOptions analog: sequential option interpreter over
    the images already in ``st`` (a new state has none)."""
    if st is None:
        st = CLIState()
    args = list(args)
    i = 0
    while i < len(args):
        tok = args[i]
        i += 1
        if tok == "(":
            st.stack.append(st.images)
            st.images = []
            continue
        if tok == ")":
            if not st.stack:
                raise CLIError("unbalanced parenthesis")
            parent = st.stack.pop()
            st.images = parent + st.images
            continue
        if not tok.startswith(("-", "+")) or tok == "-":
            raise unported(tok)
        plus = tok.startswith("+")
        name = tok[1:]
        if name in OPS:
            n_args, handler = OPS[name]
            if i + n_args > len(args):
                raise CLIError(f"option requires an argument {tok!r}")
            arg = args[i] if n_args else None
            i += n_args
            st.require_images("-" + name)
            handler(st, arg, plus)
            continue
        raise unported(tok)
    return st


def unported(tok: str) -> NotImplementedError:
    """The error for a file name or an option this subset lacks, naming
    the ROADMAP.md entry that ports it."""
    if not tok.startswith(("-", "+")) or tok == "-":
        return NotImplementedError(f"{tok!r}: {_IO_GAP}")
    gap = _RESIZE_GAP if tok[1:] in _RESIZE_FAMILY else _OPS_GAP
    return NotImplementedError(f"option {tok!r} {gap}")


def materialize_all(lazies: List[LazyImage]) -> List[Image]:
    """Materialize a list of lazy images, batching same-shape images whose
    full pending chain is tagged into ONE K1 launch
    (``dispatch.try_fused_batch``).  A group that dispatch declines runs
    its chain once on the stacked group as PyTorch ops; every other image
    materializes alone."""
    from ..ops import dispatch as _dsp

    groups: Dict[tuple, List[int]] = {}
    for idx, li in enumerate(lazies):
        if not li.pending:
            continue
        d = li.image.data
        if d.dim() != 3:
            continue
        tags = tuple(t for _, _, t in li.pending)
        if any(t is None for t in tags):
            continue
        key = (tuple(map(int, d.shape)), d.device, tags,
               bool(li.image.spec.alpha))
        groups.setdefault(key, []).append(idx)
    for (_, _, tags, has_alpha), idxs in groups.items():
        if len(idxs) < 2:
            continue
        datas = [lazies[i].image.data for i in idxs]
        out = _dsp.try_fused_batch(datas, list(tags), alpha=has_alpha)
        if out is None:
            # equal tags mean equal ops: run the first image's chain on all
            out = _run_ops(torch.stack(datas), lazies[idxs[0]].pending)
        for j, i in enumerate(idxs):
            lazies[i]._settle(out[j])
    return [li.materialize() for li in lazies]
