"""The magick-compatible command line: every option of the JAX CLI's
table, from files to files.

Port of ``imagemagick_tpu/cli/main.py``'s engine: a sequential
interpreter over an image list that *accumulates* ops per image
(``LazyImage``) and runs the whole chain at materialization.  Ops that
kernel K1 covers carry a dispatch tag (``ops/dispatch.py``).  The tagged
prefix of the chains of a group of same-shape images runs as ONE K1
launch (``materialize_all`` -> ``dispatch.try_fused_batch``), a single
image's tagged prefix as one launch (``LazyImage.materialize`` ->
``dispatch.try_fused_chain``), and the rest as PyTorch ops on the
images' device, eagerly, image by image: there is no jit.  Under
``-define tpu:mesh=SYxSX`` (or ``DPxSYxSX``) a single image of at least
``tpu:shard-threshold`` pixels that the mesh divides runs the rest with
its pixels split into the mesh's blocks (``parallel/``): the ops with a
sharded form (``-gaussian-blur``/``-blur``, ``-morphology`` of a bounded
method, ``-median``/``-statistic``, ``-resize`` and ``-auto-threshold
otsu``) on the blocks, any other on the gathered image on the mesh's
first device.
``-auto-threshold`` materializes every image and thresholds each group
of same-shape images with one launch of kernel K4.

Ported: parentheses; the resize family ``-resize`` (``+resize`` is the
same op), ``-sample``, ``-scale``, ``-thumbnail``, ``-adaptive-resize``
and ``-magnify``; ``-colorspace`` (all 41 colorspaces of
``ops/colorspace.py``), ``-gaussian-blur`` and ``-blur``; the tone
options ``-negate``, ``-gamma``, ``-level``, ``-auto-level``,
``-auto-gamma``, ``-normalize``, ``-equalize``, ``-contrast-stretch``,
``-linear-stretch``, ``-sigmoidal-contrast``, ``-brightness-contrast``,
``-modulate``, ``-white-balance``, ``-enhance`` and ``-clahe``; the
thresholds ``-threshold``, ``-black-threshold``, ``-white-threshold``,
``-auto-threshold``, ``-ordered-dither``, ``-random-threshold``, ``-lat``
and ``-clamp``; blur's effects ``-sharpen``, ``-unsharp``, ``-edge``,
``-adaptive-blur``, ``-adaptive-sharpen``, ``-motion-blur``,
``-rotational-blur``, ``-bilateral-blur``, ``-kuwahara``, ``-despeckle``,
``-emboss``, ``-shade``, ``-spread`` and ``-selective-blur``; the rank
and value options ``-statistic``, ``-median``, ``-evaluate`` and
``-function``; the list operator ``-composite``; the geometry options
``-crop`` (tiles, the ``@`` form and gravity), ``-chop``, ``-extent``,
``-shave``, ``-splice``, ``-roll``, ``-trim``, ``-flip``, ``-flop``,
``-transpose``, ``-transverse``, ``-rotate``, ``-border`` and
``-auto-orient``; the distortions ``-distort``/``+distort``,
``-sparse-color``, ``-liquid-rescale``, ``-transform``, ``-implode``,
``-swirl``, ``-wave``, ``-shear`` and ``-deskew``; the channel options
``-separate``, ``-combine``, ``-alpha``, ``-matte``/``+matte`` and
``-channel-fx``; the list operators ``-compare``, ``-fx``, ``-morph``,
``-evaluate-sequence``, ``-average``, ``-maximum`` and ``-minimum``; and
the quantizers and attributes ``-posterize``, ``-colors``, ``-kmeans``,
``-unique-colors`` and ``-type``; the paint options ``-paint``/
``-oil-paint``, ``-opaque``/``+opaque``, ``-transparent``/
``+transparent`` and ``-floodfill``; the analysis options ``-canny``,
``-mean-shift``, ``-connected-components`` (with its defines
``connected-components:verbose``, ``:mean-color`` and
``:area-threshold``), ``-segment``, ``-hough-lines`` and ``-features``;
``-draw``, ``-annotate``, ``-frame`` and ``-raise``/``+raise``; the layer
and list operators ``-layers`` (every method but ``composite``, whose
``null:`` separator needs io/), ``-coalesce``, ``-deconstruct``,
``-flatten``, ``-mosaic``, ``-append``/``+append``, ``-smush``/``+smush``
and ``-montage``; the visual effects ``-sketch``, ``-charcoal``,
``-wavelet-denoise``, ``-sepia-tone``, ``-solarize``, ``-blue-shift``,
``-tint``, ``-colorize``, ``-color-matrix``/``-recolor``, ``-vignette``,
``-noise``/``+noise``, ``-shadow``, ``-polaroid``, ``-stegano`` and
``-stereo``; and the options that need no file: ``-morphology``,
``-convolve``, ``-fft``/``+fft``, ``-ift``/``+ift``, ``-complex``,
``-clut``, ``-hald-clut``, ``-cdl``, ``-level-colors``, ``-levelize``,
``-contrast``/``+contrast``, ``-local-contrast``, ``-grayscale``,
``-monochrome``, ``-range-threshold``, ``-color-threshold``,
``-perceptible``, ``-integral``, ``-moments``, ``-sort-pixels``,
``-resample``, ``-interpolative-resize``, ``-gaussian``, ``-poly``,
``-noop``, ``-orient``, ``-duplicate``, ``-insert``, ``-cycle`` and
``-preview``, and the list and metadata options of the JAX CLI's loop,
``-clone``/``+clone``, ``-delete``/``+delete``, ``-swap``/``+swap``,
``-reverse``, ``-set``, ``-comment``, ``-strip`` and ``-copy``.  None of
these but the resize family, the blurs, ``-gaussian``, ``-colorspace``
and ``-grayscale``'s two luma methods carries a K1 tag, as in the JAX
CLI.  The geometry options stay lazy, with their new shapes pushed; the
options that read pixels or whose output shape depends on them (``-rotate``,
``-border``, ``-trim``, ``-distort``, ``-deskew``, the channel, list,
quantizer and layer options, ...) materialize the list through
``materialize_all``, so a resize before them still runs as one K1 launch
for a group.  ``-posterize`` with a dither, ``-colors`` on an RGB frame
and ``-kmeans``'s seeds run the native octree library on the host, as in
the JAX CLI.

Settings: ``-virtual-pixel``, ``-gravity``/``+gravity``,
``-compose``/``+compose``, ``-geometry`` (stored as
``compose-geometry``, read by ``-composite``), ``-define key=value``
(``CLIState.defines``; ``-composite`` reads ``compose:args``),
``-background``, ``-bordercolor``, ``-affine`` (read by ``-transform``,
default ``1,0,0,1,0,0``), ``-channel`` (the mask that ``-separate`` and
every per-pixel option of ``_op_simple`` honour; default ``default``),
``-metric`` (read by ``-compare``, default ``rmse``), ``-dither``/
``+dither`` (read by ``-posterize`` and ``-colors``, default
``riemersma``; ``+dither`` is ``none``), ``-quantize`` (the colorspace
``-colors`` quantizes in), ``-fill`` (default black), ``-fuzz`` (read as
a percentage by every option that matches colors), ``-stroke``,
``-strokewidth``, ``-pointsize``, ``-font`` (read by ``-draw``,
``-annotate`` and ``-hough-lines``), ``-mattecolor`` (read by ``-frame``,
default ``#bdbdbd``), ``-direction`` (read by ``-annotate``),
``-tile`` (read by ``-montage``), ``-filter`` (read by the resize family
and ``-resample``; default ``undefined``), ``-interpolate`` (read by
``-clut`` and ``-interpolative-resize``; default ``bilinear``),
``-density`` (read by ``-resample``, default 72), ``-attenuate`` (read
by ``+noise``, default 1), and ``-page`` and ``-delay``, stored as the
JAX CLI stores them (it applies them to images it reads).  ``-label``
sets the images' ``label`` property and ``-repage``/``+repage`` their
page (ResetImagePage's rules), each on a new Image: the caller's Images
are not changed.  ``-seed N`` seeds the generators that ``-spread``,
``-random-threshold``, ``-sketch``, ``-fx``'s ``rand``, ``+noise`` and
the noise operators of ``-evaluate`` draw from (0 by default: each call a
new generator seeded so on the images' device); the JAX CLI stores it and
draws from ``PRNGKey(0)`` whatever it says (its ``+noise`` seeds from the
clock).  Every other setting of the JAX CLI's ``_SETTINGS`` and
``_FLAGS`` is stored.

Files: a bare token reads a file (``io.read_images``: any format of the
port's ``io/``, a pseudo image, ``mpr:``, ``-`` for stdin) onto the list,
on ``CLIState.device``; the last token, where it looks like an output
name (``_looks_like_output``), writes the list there through
``materialize_all`` (so same-shape images share their K1 launch) and
``io.write_image`` (``%d`` names, ``-`` for stdout).  With them:
``-size``, ``-read``, ``-extract``, ``-depth``, ``-quality``, ``-write``,
``-texture``, ``-script``, ``-identify``, ``-format``, ``-print``,
``-list``, ``-version``, ``-limit``, ``-debug``, ``-monitor``,
``-verbose`` and ``-exit``; ``-profile``/``+profile`` (LittleCMS on the
host, ``core/profile.py``); the write masks of ``-mask``,
``-clip-mask``, ``-read-mask``, ``-write-mask`` (their + forms take no
argument) and ``-clip``/``-clip-path``, which every option built by
``_op_simple`` and the blurs honour, as in the JAX CLI;
``-encipher``/``-decipher``; ``-process`` (no modules, a CLIError as in
the JAX CLI); ``-remap``/``-map``/``-affinity`` under every dither (the
native octree library on the host, as in the JAX CLI); ``-layers
composite`` with its ``null:`` separator; ``-region``/``+region`` (a
write mask by gravity-adjusted geometry, built on the image's device);
``-bench N`` (the rest of the command N times, a ``Performance`` line on
stderr).  An option neither CLI knows raises the JAX CLI's CLIError,
``unrecognized option``.

``main(argv, device)`` runs the magick/convert dialect and the JAX CLI's
other tools by their first word: ``identify``, ``compare`` and
``stream`` here, ``mogrify``, ``composite``, ``montage``, ``conjure``,
``display``/``animate`` and ``-bench`` in ``cli/tools.py``; ``import``
prints the JAX CLI's refusal.  The tags equal the JAX CLI's for the same
arguments.
"""

from __future__ import annotations

import importlib
import math
import re
import sys
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.color import parse_color
from ..core.geometry import (parse_geometry, parse_meta_geometry,
                             parse_page_geometry)
from ..core.image import Image
from ..core.policy import enforce_path
from ..core.spec import ImageSpec, normalize_colorspace

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

    __slots__ = ("image", "pending", "_shape", "shard")

    def __init__(self, image: Image, pending=None):
        self.image = image
        self.pending = list(pending or [])
        self._shape = None  # (h, w) after pending ops; None = unchanged
        # (mesh, min_pixels) of the state's -define tpu:mesh, or None;
        # ``process`` sets it before each option
        self.shard = None

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

    def _settle(self, data: torch.Tensor, n: Optional[int] = None
                ) -> Image:
        """Install ``data`` as the result of the first ``n`` pending ops
        (all of them by default); the rest stay pending."""
        n = len(self.pending) if n is None else n
        img = self.image
        out = Image(data, _fold_spec(img.spec, self.pending[:n]),
                    img.properties, img.profiles, img.page, img.delay)
        self.image = out
        self.pending = self.pending[n:]
        if not self.pending:
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
            mesh = _shard_mesh(self.shard, data, rest)
            data = _run_ops(data, rest) if mesh is None else \
                _run_sharded(data, rest, mesh)
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


def _cli_spec():
    """How the CLI splits one (1, H, W, C) image over a mesh: rows over
    sy, columns over sx, copies along dp (the JAX CLI's P("sy", "sx",
    None))."""
    from ..parallel.mesh import P

    return P(None, "sy", "sx", None)


def _sharded_form(fn, form):
    """Mark the op ``fn`` with its sharded form: ``form(mesh, shape)``
    returns a function over a (1, H, W, C) image split ``_cli_spec()``
    (a ShardedArray or a tensor), or None where the op cannot run on
    that shape's blocks."""
    fn.sharded = form
    return fn


def _halo_fits(mesh, shape, hy: int, hx: int) -> bool:
    """Whether blocks of ``shape`` on ``mesh`` are at least as tall and
    wide as the halos an op takes from their neighbours."""
    sy, sx = mesh.shape["sy"], mesh.shape["sx"]
    return (sy == 1 or shape[1] // sy >= hy) and \
        (sx == 1 or shape[2] // sx >= hx)


def _shard_mesh(shard, data: torch.Tensor, ops):
    """The mesh a chain's remainder runs split over, or None: a
    ``-define tpu:mesh`` is set, ``data`` is one (H, W, C) image of at
    least the threshold's pixels that the mesh divides (the JAX CLI's
    ``_auto_shard_sharding``), and an op of the remainder has a sharded
    form."""
    if data.dim() != 3 or not _fits_mesh(shard, int(data.shape[0]),
                                         int(data.shape[1])):
        return None
    if not any(getattr(fn, "sharded", None) for fn, _, _ in ops):
        return None
    return shard[0]


def _fits_mesh(shard, h: int, w: int) -> bool:
    """Whether an h x w image runs split over the ``-define tpu:mesh``
    (``shard``, or None): at least the threshold's pixels, and the mesh
    divides it."""
    if shard is None:
        return False
    mesh, minpx = shard
    return h * w >= minpx and h % mesh.shape["sy"] == 0 and \
        w % mesh.shape["sx"] == 0


def _run_sharded(data: torch.Tensor, ops, mesh) -> torch.Tensor:
    """Run a chain's remainder with the image split over ``mesh``: an op
    with a sharded form runs on the blocks, any other on the image
    gathered on the mesh's first device.  The result goes back to
    ``data``'s device.  Counts one ``sharded`` and one ``op`` run."""
    from ..ops import dispatch as _dispatch
    from ..parallel.mesh import ShardedArray

    _dispatch.COUNTS["op"] += 1
    _dispatch.COUNTS["sharded"] += 1
    x = data[None]
    sy, sx = mesh.shape["sy"], mesh.shape["sx"]
    for fn, _, _ in ops:
        form = getattr(fn, "sharded", None)
        run = None
        if form is not None and (isinstance(x, ShardedArray) or
                                 (x.shape[1] % sy == 0 and
                                  x.shape[2] % sx == 0)):
            run = form(mesh, tuple(x.shape))
        if run is not None:
            x = run(x)
        else:
            x = (x.gather() if isinstance(x, ShardedArray) else x)[0]
            x = fn(x)[None]
    x = x.gather() if isinstance(x, ShardedArray) else x
    return x[0].to(data.device)


def _blur_form(taps):
    """The sharded form of a clipped separable blur by ``taps``."""
    from ..parallel import spatial as sp

    r = (len(taps) - 1) // 2

    def form(mesh, shape):
        if not _halo_fits(mesh, shape, r, r):
            return None
        blur = sp._sharded_separable(mesh, taps, _cli_spec())
        return lambda x: sp._pointwise(blur(x),
                                       lambda t: t.clamp(0.0, 1.0))

    return form


def _statistic_form(stat: str, w: int, h: int):
    """The sharded form of ``statistic(x, stat, w, h)``."""
    from ..parallel import spatial as sp

    def form(mesh, shape):
        if not _halo_fits(mesh, shape, h // 2, w // 2):
            return None
        return sp.sharded_statistic(mesh, stat, w, h, _cli_spec())

    return form


class CLIState:
    """The interpreter's state: the image list, the settings, and the
    device that read files and pseudo images go to (the card unless the
    caller passes ``device="cpu"``)."""

    def __init__(self, device="cuda"):
        # checked where a reader first puts pixels there
        self.device = torch.device(device)
        self.images: List[LazyImage] = []
        self.stack: List[List[LazyImage]] = []
        self.settings_stack: List[Dict[str, str]] = []
        self.size: Optional[str] = None
        self.depth: Optional[int] = None
        self.seed = 0
        self.exit_code = 0
        self.defines: Dict[str, str] = {}
        # -define tpu:mesh=...: (parallel.mesh.Mesh, min_pixels) or None;
        # a state is one invocation, so the mesh is too
        self.shard: Optional[Tuple[object, int]] = None
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

def _op_resize(st, arg, plus, op="resize"):
    """The resize family stays LAZY: output dims are static, so the op
    joins the pending chain.  A resize, a scale and a thumbnail without
    its pre-sample stages are separable linear maps, tagged for K1 (alpha
    images too: dispatch checks full opacity, where premultiplied
    sampling equals straight sampling exactly)."""
    from ..ops import resize as rz

    filt = st.settings["filter"]
    for li in st.images:
        alpha = li.spec.alpha
        cw, ch = li.width, li.height
        w, h, _, _ = parse_meta_geometry(arg, cw, ch)
        tag = None
        if op == "adaptive-resize":
            # resize.c:1331: a mesh-interpolated lookup, not a filter
            fn = lambda x, h=h, w=w: rz.interpolative_resize(x, h, w, "mesh")
        elif op == "resize":
            fn = lambda x, h=h, w=w, a=alpha: rz.resize(x, h, w, filt,
                                                        has_alpha=a)
            rf = filt if filt not in ("undefined", "", None) else \
                rz._default_filter(ch, cw, h, w, alpha)
            tag = ("resize", (h, w, rf))
            fn = _sharded_form(fn, _resize_form(h, w, filt, alpha))
        elif op == "scale":
            fn = lambda x, h=h, w=w: rz.scale(x, h, w)
            tag = ("resize", (h, w, "box"))
        elif op == "sample":
            fn = lambda x, h=h, w=w: rz.sample(x, h, w)
        else:   # thumbnail; resize.c:3692: its filter defaults to LanczosSharp
            tf_ = filt if filt not in ("undefined", "", None) else \
                "lanczossharp"
            fn = lambda x, h=h, w=w, a=alpha, f=tf_: rz.thumbnail(
                x, h, w, has_alpha=a, filter_name=f)
            if not alpha and not ((cw // w) > 2 and (ch // h) > 2):
                tag = ("resize", (h, w, tf_))
        li.push(fn, new_shape=(h, w), tag=tag)


def _resize_form(h: int, w: int, filt: str, alpha: bool):
    """The sharded form of ``resize(x, h, w, filt, has_alpha=alpha)``: the
    filter ``resize`` would pick for the shape, as dense operators split
    over the blocks.  None for the point filter (an identity where the
    size stays) and where a filter's support is wider than a block."""
    from ..ops import resize as rz
    from ..parallel import spatial as sp

    def form(mesh, shape):
        f = filt if filt not in ("undefined", "", None) else \
            rz._default_filter(shape[1], shape[2], h, w, alpha)
        if f.lower() == "point":
            return None
        try:
            return sp.sharded_resize(mesh, (shape[1], shape[2]), (h, w), f,
                                     alpha, _cli_spec())
        except ValueError:      # a support halo wider than one block
            return None

    return form


def _op_magnify(st, arg, plus):
    """-magnify: the EPX 2x upscale.  The JAX CLI queues it without its
    new shape, so a later option there computes its geometry against the
    size before the magnify; the port passes the doubled shape."""
    from ..ops import resize as rz

    for li in st.images:
        li.push(rz.magnify, new_shape=(2 * li.height, 2 * li.width))


def _op_blur(fname: str, rule: str):
    """A lazy -blur / -gaussian-blur handler under the -channel mask.  A
    separable gaussian with edge-replicate pads is exactly what K1's band
    matrices encode (fused_pipeline.blur_band_matrix), so the op is
    tagged for K1 unless it is the + form, sigma is 0, the virtual pixel
    is not ``edge`` or a channel mask is set (``cli/main.py:432-434`` of
    the JAX CLI, which reads the mask of a 4-channel image)."""

    def handler(st, arg, plus):
        from ..ops import blur as bl

        fn = getattr(bl, fname)
        r, s = _geom_args(arg)
        vp = st.settings["virtual-pixel"]
        setting = st.settings.get("channel", "default")
        any_mask = any(_wmask(li) is not None for li in st.images)
        tag = None if plus or s <= 0 or vp != "edge" or any_mask or \
            _channel_indices(setting, 4) is not None else \
            ("gblur", (float(r), float(s), rule))
        # the blocks' halos repeat the image's edge: a sharded form for
        # the 'edge' virtual pixel without a mask
        shardable = s > 0 and vp == "edge" and \
            _channel_indices(setting, 4) is None
        taps = bl.gaussian_kernel_1d(r, s) if fname == "blur" else \
            bl.gaussian_blur_taps(r, s)
        for li in st.images:
            op = _masked(lambda x: fn(x, radius=r, sigma=s,
                                      virtual_pixel=vp),
                         setting, _wmask(li))
            if shardable and _wmask(li) is None:
                op = _sharded_form(op, _blur_form(taps))
            li.push(op, tag=tag)

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


_CHANNEL_LETTERS = {"r": 0, "g": 1, "b": 2, "c": 0, "m": 1, "y": 2,
                    "k": 3, "a": -1, "o": -1}


def _channel_indices(setting: str, nch: int):
    """Parse a -channel setting ('RGB', 'Red,Green', 'All', ...) to the
    sorted indices it selects in an ``nch``-channel image, or None for
    every channel."""
    s = (setting or "default").strip().lower()
    if s in ("default", "all", "sync", ""):
        return None
    idx = set()
    for name in re.split(r"[,|\s]+", s):
        if name in ("red", "green", "blue", "cyan", "magenta", "yellow",
                    "black", "alpha", "opacity", "gray"):
            i = _CHANNEL_LETTERS[name[0]]
            idx.add(nch - 1 if i == -1 else i)
        elif name and all(ch in _CHANNEL_LETTERS for ch in name):
            for ch in name:
                i = _CHANNEL_LETTERS[ch]
                idx.add(nch - 1 if i == -1 else i)
    return sorted(i for i in idx if i < nch) or None


def _masked(fn, setting: str, wmask=None):
    """``fn`` under a -channel mask and a write mask: where ``fn`` keeps
    the shape, the channels outside the -channel mask keep their input
    values, and so do the pixels where the write mask (``wmask``, an
    (H, W) host array from -mask, -clip or their kin, or a tensor on the
    image's device from -region) is not above 0.5 (the JAX CLI's
    ``_op_simple``, ``cli/main.py:438-452``)."""

    def run(x):
        out = fn(x)
        if out.shape != x.shape:
            return out
        sel = _channel_indices(setting, x.shape[-1])
        if sel is not None:
            mask = torch.zeros(x.shape[-1], dtype=torch.bool,
                               device=x.device)
            mask[sel] = True
            out = torch.where(mask, out, x)
        if wmask is not None and \
                tuple(wmask.shape[:2]) == tuple(x.shape[-3:-1]):
            m = wmask if isinstance(wmask, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(wmask, np.float32))
            out = torch.where(m.to(x.device)[..., None] > 0.5, out, x)
        return out

    return run


def _wmask(li: LazyImage):
    return li.image.properties.get("wand:mask")


def _seeded(fn, seed: int):
    """``fn`` given a new generator seeded ``seed`` on its input's device
    at each call (-seed; 0 by default)."""
    return lambda x, **kw: fn(
        x, generator=torch.Generator(device=x.device).manual_seed(seed),
        **kw)


def _op_simple(module: str, fname: str, argmap=None, seeded=False):
    """A lazy per-pixel or neighborhood op: ``ops.<module>.<fname>(x,
    **argmap(st, arg, plus))`` on each image, under the -channel mask and
    the image's write mask (``_masked``).  A ``seeded`` op draws from a
    generator seeded with -seed.  None of these ops carries a K1 tag, as
    in the JAX CLI."""

    def handler(st, arg, plus):
        fn = getattr(importlib.import_module(f"..ops.{module}", __package__),
                     fname)
        if seeded:
            fn = _seeded(fn, st.seed)
        kwargs = argmap(st, arg, plus) if argmap else {}
        setting = st.settings.get("channel", "default")
        for li in st.images:
            li.push(_masked(lambda x: fn(x, **kwargs), setting, _wmask(li)))

    return handler


def _op_auto_threshold(st, arg, plus):
    """-auto-threshold: each image materialized, then one launch of K4
    for the histograms of each group of same-shape images; every image
    is thresholded at its own value (``threshold.auto_threshold`` of a
    batch).  Under ``-define tpu:mesh`` an image that the mesh takes
    (``_fits_mesh``) gets Otsu lazily instead, so that it runs split over
    the mesh with the chain before it (one ``sharded`` run).  The result
    is a gray image that keeps the properties, as in the JAX CLI."""
    from ..ops import threshold as th

    lazy = [li for li in st.images if arg.lower() == "otsu" and
            li.image.data.dim() == 3 and
            _fits_mesh(st.shard, li.height, li.width)]
    for li in lazy:
        li.push(_sharded_form(
            lambda x: th.auto_threshold(x[None], arg)[0], _otsu_form))
        img = li.materialize()
        li.image = Image(img.data, ImageSpec(colorspace="gray"),
                         img.properties)
    rest = [li for li in st.images if all(li is not o for o in lazy)]
    imgs = materialize_all(rest)
    groups: Dict[tuple, List[int]] = {}
    for i, img in enumerate(imgs):
        key = (tuple(img.data.shape), img.data.device)
        groups.setdefault(key, []).append(i)
    for idxs in groups.values():
        out = th.auto_threshold(torch.stack([imgs[i].data for i in idxs]),
                                arg)
        for j, i in enumerate(idxs):
            rest[i].image = Image(out[j], ImageSpec(colorspace="gray"),
                                  imgs[i].properties)


def _otsu_form(mesh, shape):
    """The sharded form of ``-auto-threshold otsu``."""
    from ..parallel import spatial as sp

    return sp.sharded_otsu_threshold(mesh, _cli_spec())


_GEOMINFO_RE = re.compile(
    r"^\s*(?P<rho>[-+]?[\d.]+(?:[eE][-+]?\d+)?)?"
    r"(?:[x,:](?P<sigma>[-+]?[\d.]+(?:[eE][-+]?\d+)?))?"
    r"(?P<xi>[-+][\d.]+(?:[eE][-+]?\d+)?)?"
    r"(?P<psi>[-+][\d.]+(?:[eE][-+]?\d+)?)?"
    r"(?P<chi>[-+][\d.]+(?:[eE][-+]?\d+)?)?"
    r"\s*(?P<percent>%)?\s*$")


def _geometry_info(a):
    """ParseGeometry (geometry.c) float semantics: RHOxSIGMA+XI+PSI+CHI,
    all doubles — unlike the pixel-geometry parser, offsets keep their
    fractional part.  Returns (rho, sigma, xi, psi, chi, percent) with
    None for absent fields."""
    m = _GEOMINFO_RE.match(a.replace("%", "") + ("%" if "%" in a else ""))
    if not m:
        return None, None, None, None, None, False
    f = lambda s: float(s) if s is not None else None
    return (f(m.group("rho")), f(m.group("sigma")), f(m.group("xi")),
            f(m.group("psi")), f(m.group("chi")),
            m.group("percent") is not None)


def _op_clahe(st, arg, plus):
    """-clahe WxH{%}+bins+clip-limit (operation.c:2006): the exact
    integer pipeline (``enhance.clahe_reference``) on each materialized
    image, its L channel on the host and its Lab conversions on the
    image's device.  The tile size goes through META geometry semantics
    (ParseRegionGeometry, operation.c:2011): "2x2" on 92x60 fits the
    aspect ratio and yields 2x1 tiles."""
    from ..ops import enhance as en

    g = parse_geometry(arg)
    _, _, _, psi, _, _ = _geometry_info(arg)
    bins = int(g.x) if g.x else 128
    clip = psi if psi is not None else 3.0
    for li, img in zip(st.images, materialize_all(st.images)):
        tw, th_, _, _ = parse_meta_geometry(arg, li.width, li.height)
        li.image = img.replace(data=en.clahe_reference(img.data, tw, th_,
                                                       bins, clip))


def _percent(a: str) -> float:
    a = a.strip()
    if a.endswith("%"):
        return float(a[:-1]) / 100.0
    v = float(a)
    return v if v <= 1.0 else v / 100.0 if v <= 100.0 else v / 65535.0


def _parse_level_arg(arg):
    # "black,white,gamma" with % support: "10%,90%,1.5"
    parts = [p.strip() for p in arg.replace(",", " ").split()]

    def pv(p):
        return float(p[:-1]) / 100.0 if p.endswith("%") else float(p)

    black = pv(parts[0]) if parts else 0.0
    white = pv(parts[1]) if len(parts) > 1 else 1.0
    gamma = pv(parts[2]) if len(parts) > 2 else 1.0
    return black, white, gamma


def _split_x(a: str) -> List[str]:
    return [p for p in a.replace(",", "x").split("x") if p]


def _stretch_args(a):
    parts = _split_x(a)
    return {"black_point": _percent(parts[0]) if parts else 0.0,
            "white_point": _percent(parts[1]) if len(parts) > 1 else None}


def _sigmoidal_args(a, sharpen):
    parts = _split_x(a)
    return {"sharpen": sharpen,
            "contrast": float(parts[0]) if parts else 3.0,
            "midpoint": _percent(parts[1]) if len(parts) > 1 else 0.5}


def _bc_args(a):
    parts = _split_x(a)
    return {"brightness": float(parts[0]) if parts else 0.0,
            "contrast": float(parts[1]) if len(parts) > 1 else 0.0}


def _modulate_args(a):
    parts = [p for p in a.replace(",", " ").replace("/", " ").split() if p]
    return {"brightness": float(parts[0]) if parts else 100.0,
            "saturation": float(parts[1]) if len(parts) > 1 else 100.0,
            "hue": float(parts[2]) if len(parts) > 2 else 100.0}


def _dither_args(a):
    name, _, lv = a.partition(",")
    return {"map_name": name, "levels": int(lv) if lv else 2}


def _random_thresh_args(a):
    parts = _split_x(a)
    return {"low": _percent(parts[0]) if parts else 0.0,
            "high": _percent(parts[1]) if len(parts) > 1 else 1.0}


def _lat_args(a):
    g = parse_geometry(a)
    return {"width": int(g.width or 3),
            "height": int(g.height or g.width or 3),
            "bias": (float(g.x) / 100.0) if g.x is not None else 0.0}


def _gamma_arg(a):
    # operation.c:2479: StringToDouble stops at the comma, so "2.2,1,0.8"
    # applies 2.2 to every channel
    return {"value": float(re.match(r"[-+]?[\d.]*(?:[eE][-+]?\d+)?",
                                    a.strip()).group() or 0)}


def _threshold_arg(st, a, p):
    return {"threshold": _percent(a)}


def _rs(st, a, p):
    return dict(zip(("radius", "sigma"), _geom_args(a)))


def _rs_vp(st, a, p):
    return dict(_rs(st, a, p), virtual_pixel=st.settings["virtual-pixel"])


def _unsharp_args(a):
    # operation.c:3625 — xi=gain (default 1.0), psi=threshold (default
    # 0.05, a raw fraction of QuantumRange — NOT a percentage)
    rho, sigma, xi, psi, _, _ = _geometry_info(a)
    return {"radius": rho or 0.0,
            "sigma": sigma if sigma is not None else 1.0,
            "gain": xi if xi is not None else 1.0,
            "threshold": psi if psi is not None else 0.05}


def _motion_args(a):
    g = parse_geometry(a)
    return {"radius": g.width or 0.0,
            "sigma": g.height if g.height is not None else 1.0,
            "angle": float(g.x or 0)}


def _bilateral_args(a):
    # operation.c:1849-1864: rho=width, sigma=height (defaults to rho),
    # xi=intensity sigma (default sqrt(w²+h²)), psi=spatial (default xi/4)
    g = parse_geometry(a)
    w = int(g.width or 5)
    h = int(g.height if g.height is not None else w)
    kw = {"width": w, "height": h}
    if g.x is not None:
        kw["intensity_sigma"] = float(g.x)
    if g.y is not None:
        kw["spatial_sigma"] = float(g.y)
    return kw


def _shade_args(a):
    g = parse_geometry(a)
    return {"azimuth": g.width or 30.0,
            "elevation": g.height if g.height is not None else 30.0}


def _kuwahara_args(a):
    # operation.c:2634 — sigma defaults to rho-0.5 when absent
    g = parse_geometry(a)
    radius = g.width if g.width is not None else 0.0
    sigma = g.height if g.height is not None else radius - 0.5
    return {"radius": radius, "sigma": sigma}


def _selective_args(a):
    g = parse_geometry(a)
    kw = {"radius": g.width or 0.0, "sigma": g.height or 1.0}
    if g.x is not None:
        kw["threshold"] = (g.x or 10) / 100.0
    return kw


def _op_median(st, arg, plus):
    """-median R: the median over a (2R+1)^2 window, under the -channel
    mask and the write mask; without a mask it has a sharded form."""
    from ..ops import statistic as stx

    w = 2 * int(float(arg)) + 1
    setting = st.settings.get("channel", "default")
    for li in st.images:
        op = _masked(lambda x: stx.statistic(x, "median", w, w), setting,
                     _wmask(li))
        if _wmask(li) is None and _channel_indices(setting, 4) is None:
            op = _sharded_form(op, _statistic_form("median", w, w))
        li.push(op)


def _op_statistic(st, arg, plus):
    """-statistic type WxH (two arguments)."""
    from ..ops import statistic as stx

    parts = arg.split(None, 1)
    stat = parts[0]
    g = parse_geometry(parts[1]) if len(parts) > 1 else None
    w = int(g.width or 3) if g else 3
    h = int(g.height or w) if g else 3
    for li in st.images:
        li.push(_sharded_form(lambda x: stx.statistic(x, stat, w, h),
                              _statistic_form(stat, w, h)))


def _op_evaluate(st, arg, plus):
    """-evaluate operator value (two arguments).  StringToDoubleInterval
    (arg, QuantumRange+1): raw numbers are quantum counts, percents are
    fractions of 65536 (operation.c:2356)."""
    from ..ops import statistic as stx

    parts = arg.split(None, 1)
    op = parts[0]
    if len(parts) > 1 and parts[1].strip().endswith("%"):
        val = float(parts[1].strip()[:-1]) * 65536.0 / 100.0
    else:
        val = float(parts[1]) if len(parts) > 1 else 0.0
    evaluate = _seeded(stx.evaluate, st.seed)
    for li in st.images:
        li.push(lambda x: evaluate(x, operator=op, value=val))


def _op_function(st, arg, plus):
    """-function name parameters (two arguments)."""
    from ..ops import statistic as stx

    parts = arg.split(None, 1)
    fname = parts[0]
    params = [float(p) for p in parts[1].replace(",", " ").split()] \
        if len(parts) > 1 else []
    for li in st.images:
        li.push(lambda x: stx.function(x, fname, params))


_NUMBER_RE = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


def _op_composite_list(st, arg, plus):
    """-composite: images[0] is the canvas, images[1] the overlay; both
    materialize, and the list becomes their composite under the
    ``-compose`` operator, ``-gravity``, the ``-geometry`` offset and the
    ``compose:args`` define."""
    from ..ops import composite as comp

    if len(st.images) < 2:
        raise CLIError("-composite needs at least two images")
    dst = st.images[0].materialize()
    src = st.images[1].materialize()
    op = st.settings.get("compose", "over")
    g = st.settings.get("compose-geometry")
    x = y = 0
    if g:
        gg = parse_geometry(g)
        x, y = gg.x or 0, gg.y or 0
    cargs = ()
    art = st.defines.get("compose:args")
    if art:
        cargs = tuple(float(v) for v in _NUMBER_RE.findall(art))
    out = comp.composite_at(dst.data, src.data, op, x, y,
                            st.settings["gravity"],
                            dst_alpha=dst.spec.alpha,
                            src_alpha=src.spec.alpha, args=cargs)
    alpha = out.shape[-1] > dst.spec.color_channels
    st.images = [LazyImage(Image(out, dst.spec.with_(alpha=alpha),
                                 dst.properties, dst.profiles))]


def _materialized(st) -> List[Tuple[LazyImage, Image]]:
    """Every image of the list materialized (``materialize_all``: a
    group's tagged prefix in one K1 launch), beside its LazyImage."""
    return list(zip(st.images, materialize_all(st.images)))


def _pixel_round(x: float) -> int:
    """PixelRoundOffset (transform.c:780): round-half-away via floor/ceil
    distance compare."""
    return int(math.floor(x)) if (x - math.floor(x)) < (math.ceil(x) - x) \
        else int(math.ceil(x))


def _crop_tiles(arg, cw, ch, gravity):
    """CropImageToTiles (transform.c:790) geometry resolution: returns a
    list of (x, y, w, h) crop rects — one for offset crops, a full tiling
    for offset-less WxH, an NxM split for the '@' form."""
    from ..ops.composite import gravity_offset

    has_xy = bool(re.search(r"[-+][\d.]", arg))
    at_form = "@" in arg
    w, h, x, y = parse_page_geometry(arg.replace("@", "").replace("!", ""),
                                     cw, ch)
    if at_form:
        nx, ny = max(w, 1) if w else 1, max(h, 1) if h else 1
        # NxM tiles: delta stepping with PixelRoundOffset boundaries
        dx = max(cw / nx, 1.0)
        dy = max(ch / ny, 1.0)
        tiles = []
        oy = 0.0
        while oy < ch:
            ty = _pixel_round(oy)
            oy += dy
            th = _pixel_round(oy) - ty
            ox = 0.0
            while ox < cw:
                tx = _pixel_round(ox)
                ox += dx
                tw = _pixel_round(ox) - tx
                tiles.append((tx, ty, tw, th))
        return tiles
    if (w == 0 and h == 0) or has_xy:
        gx, gy = gravity_offset(gravity, cw, ch, w, h, x, y)
        return [(gx, gy, w, h)]
    if cw > w or ch > h:
        w = w or cw
        h = h or ch
        return [(tx, ty, min(w, cw - tx), min(h, ch - ty))
                for ty in range(0, ch, h) for tx in range(0, cw, w)]
    return [(0, 0, min(w, cw), min(h, ch))]


def _op_geometry_slice(st, arg, plus, op):
    """The geometry slices stay LAZY with their new shapes pushed (static
    output shapes), but for trim, whose bounding box is data-dependent
    (the box is read back), and a -crop that tiles, which materializes
    the images it splits."""
    from ..ops import transform as tf
    from ..ops.composite import gravity_offset

    gravity = st.settings.get("gravity", "northwest")

    if op == "crop":
        # CropImageToTiles (transform.c:790): offset-less geometry tiles
        # the image; '@' tiles into NxM pieces; offsets = one gravity-
        # adjusted region
        tiles = [_crop_tiles(arg, li.width, li.height, gravity)
                 for li in st.images]
        split = [li for li, t in zip(st.images, tiles) if len(t) > 1]
        imgs = dict(zip(map(id, split), materialize_all(split)))
        new_images = []
        for li, tl in zip(st.images, tiles):
            if len(tl) == 1:
                x, y, w, h = tl[0]
                li.push(lambda d, a=(x, y, w, h): tf.crop(d, *a),
                        new_shape=(h, w))
                new_images.append(li)
            else:
                img = imgs[id(li)]
                for x, y, w, h in tl:
                    new_images.append(LazyImage(img.replace(
                        data=tf.crop(img.data, x, y, w, h))))
        st.images = new_images
        return

    if op == "trim":
        for li, img in _materialized(st):
            li.image = img.replace(data=tf.trim(img.data))
        return

    for li in st.images:
        cw, ch = li.width, li.height
        nch = li.spec.channels
        if op == "chop":
            w, h, x, y = parse_page_geometry(arg, cw, ch)
            x, y = gravity_offset(gravity, cw, ch, w, h, x, y)
            out_h = ch - (min(y + h, ch) - max(y, 0))
            out_w = cw - (min(x + w, cw) - max(x, 0))
            li.push(lambda d, a=(x, y, w, h): tf.chop(d, *a),
                    new_shape=(out_h, out_w))
        elif op == "extent":
            w, h, x, y = parse_page_geometry(arg, cw, ch)
            gx, gy = gravity_offset(st.settings["gravity"], w, h,
                                    cw, ch, -x, -y)
            bgc = st.bg()[:nch]
            li.push(lambda d, a=(-gx, -gy, w, h), b=bgc:
                    tf.extent(d, *a, background=b), new_shape=(h, w))
        elif op == "shave":
            g = parse_geometry(arg)
            sx = int(g.width or 0)
            sy = int(g.height or g.width or 0)
            li.push(lambda d, a=(sx, sy): tf.shave(d, *a),
                    new_shape=(max(ch - 2 * sy, 1), max(cw - 2 * sx, 1)))
        elif op == "splice":
            w, h, x, y = parse_page_geometry(arg, cw, ch)
            bgc = st.bg()[:nch]
            li.push(lambda d, a=(x, y, w, h), b=bgc:
                    tf.splice(d, *a, background=b),
                    new_shape=(ch + h, cw + w))
        else:   # roll
            g = parse_geometry(arg, offsets_first=True)
            li.push(lambda d, a=(g.x or 0, g.y or 0): tf.roll(d, *a))


def _op_transpose(fname: str):
    """-transpose / -transverse: lazy, with the swapped shape pushed (the
    JAX CLI queues them without it, so a later option there computes its
    geometry against the shape before the swap); under the -channel mask
    where the image is square."""

    def handler(st, arg, plus):
        from ..ops import transform as tf

        run = _masked(getattr(tf, fname),
                      st.settings.get("channel", "default"))
        for li in st.images:
            li.push(run, new_shape=(li.width, li.height))

    return handler


def _op_rotate(st, arg, plus):
    """-rotate DEG (the ``<`` and ``>`` suffixes are stripped, as in the
    JAX CLI): every image materialized, then rotated on its device."""
    from ..ops import distort as dt

    deg = float(arg.rstrip("<>"))
    for li, img in _materialized(st):
        li.image = img.replace(data=dt.rotate(
            img.data, deg, background=st.bg()[: img.channels]))


def _op_border(st, arg, plus):
    """-border WxH: an extent in the -bordercolor setting (default
    #dfdfdf, image-private.h:33), not -background."""
    from ..ops import transform as tf

    g = parse_geometry(arg)
    bw = int(g.width or 0)
    bh = int(g.height if g.height is not None else bw)
    bc = parse_color(st.settings.get("bordercolor", "#dfdfdf"))
    for li, img in _materialized(st):
        li.image = img.replace(data=tf.extent(
            img.data, -bw, -bh, img.width + 2 * bw, img.height + 2 * bh,
            background=bc[: img.channels]))


def _op_auto_orient(st, arg, plus):
    """-auto-orient: applies and resets ``exif:Orientation``."""
    from ..ops import transform as tf

    for li, img in _materialized(st):
        o = int(img.properties.get("exif:Orientation", 1))
        li.image = img.replace(data=tf.auto_orient(img.data, o))
        li.image.properties["exif:Orientation"] = 1


def _op_sparse_color(st, arg, plus):
    """-sparse-color METHOD 'x,y,color ...' (two arguments)."""
    from ..ops import distort as dt

    parts = arg.split(None, 1)
    method = parts[0]
    toks = parts[1].replace(",", " ").split() if len(parts) > 1 else []
    pts = []
    i = 0
    while i + 2 <= len(toks):
        pts.append((float(toks[i]), float(toks[i + 1]),
                    parse_color(toks[i + 2])))
        i += 3
    for li, img in _materialized(st):
        li.image = img.replace(data=dt.sparse_color(img.data, method, pts))


def _op_liquid(st, arg, plus):
    from ..ops import distort as dt

    for li, img in _materialized(st):
        w, h, _, _ = parse_meta_geometry(arg, img.width, img.height)
        li.image = img.replace(data=dt.liquid_rescale(img.data, w, h))


def _op_deskew(st, arg, plus):
    from ..ops import shear as sh

    thr = _percent(arg) if arg else 0.4
    for li, img in _materialized(st):
        li.image = img.replace(data=sh.deskew(
            img.data, thr, background=st.bg()[: img.channels]))


def _op_shear(st, arg, plus):
    from ..ops import shear as sh

    g = parse_geometry(arg)
    xdeg = g.width or 0.0
    # operation.c:3430 — sigma defaults to rho when absent
    ydeg = g.height if g.height is not None else xdeg
    for li, img in _materialized(st):
        li.image = img.replace(data=sh.shear(
            img.data, xdeg, ydeg, background=st.bg()[: img.channels]))


def _op_distort(st, arg, plus):
    """-distort METHOD 'args' (two arguments); +distort takes the bestfit
    viewport.  The transparent virtual pixel returns an image with
    alpha."""
    from ..ops import distort as dt

    parts = arg.split(None, 1)
    method = parts[0]
    args = [float(x) for x in parts[1].replace(",", " ").split()] \
        if len(parts) > 1 else []
    vp = st.settings.get("virtual-pixel", "edge").lower()
    for li, img in _materialized(st):
        bg = None if vp in ("edge", "") else st.bg()[: img.channels]
        data = dt.distort(img.data, method, args, background=bg,
                          bestfit=bool(plus), vp=vp)
        li.image = img.replace(data=data)
        if data.shape[-1] != img.channels:   # transparent vp adds alpha
            li.image.spec = img.spec.with_(alpha=True)


def _op_transform(st, arg, plus):
    """-transform: apply the -affine matrix (AffineTransformImage)."""
    from ..ops import distort as dt

    aff = st.settings.get("affine", "1,0,0,1,0,0")
    vals = [float(v) for v in aff.replace(",", " ").split()]
    for li, img in _materialized(st):
        li.image = img.replace(data=dt.affine_transform(img.data, vals))


def _op_wave(st, arg, plus):
    """-wave AxL: lazy, with the grown canvas (H + 2|A| rows) pushed; the
    JAX CLI queues it without its new shape.  The background is the
    setting's first three channels, as the JAX CLI passes it."""
    from ..ops import distort as dt

    amp, lam = _geom_args(arg)
    bg = st.bg()[:3]
    for li in st.images:
        li.push(lambda x: dt.wave(x, amp, lam, bg),
                new_shape=(li.height + int(2.0 * abs(amp)), li.width))


def _op_separate(st, arg, plus):
    """-separate: SeparateImages (channel.c), one gray image per channel
    in the -channel mask ("-channel R -separate" yields one image)."""
    from ..ops import channel as chan

    setting = st.settings.get("channel", "default")
    new_images = []
    for li, img in _materialized(st):
        comps = chan.separate_all(img.data)
        sel = _channel_indices(setting, img.data.shape[-1])
        if sel is not None:
            comps = [comps[i] for i in sel]
        gspec = img.spec.with_(colorspace="gray", alpha=False)
        new_images += [LazyImage(Image(comp, gspec)) for comp in comps]
    st.images = new_images


def _op_combine(st, arg, plus):
    """-combine: CombineImages, the list's first channels stacked into
    one image."""
    from ..ops import channel as chan

    imgs = materialize_all(st.images)
    data = chan.combine([im.data for im in imgs])
    cs_name = "srgb" if data.shape[-1] >= 3 else "gray"
    alpha = data.shape[-1] in (2, 4)
    st.images = [LazyImage(Image(data, imgs[0].spec.with_(
        colorspace=cs_name, alpha=alpha)))]


def _op_alpha(st, arg, plus):
    """-alpha OP (and -matte / +matte): SetImageAlphaChannel; the
    background of ``remove`` and ``flatten`` is the -background
    setting."""
    from ..ops import channel as chan

    op = arg.lower()
    for li, img in _materialized(st):
        data = chan.set_alpha(img.data, arg, img.spec.alpha,
                              background=st.bg()[:3])
        if op == "extract":
            li.image = Image(data, ImageSpec(colorspace="gray"))
            continue
        alpha = op in ("set", "on", "activate", "opaque", "copy",
                       "transparent")
        li.image = Image(data, img.spec.with_(alpha=alpha), img.properties,
                         img.profiles, img.page, img.delay)


def _op_channel_fx(st, arg, plus):
    from ..ops import channel as chan

    for li, img in _materialized(st):
        li.image = img.replace(data=chan.channel_fx(img.data, arg,
                                                    img.spec.alpha))


def _op_compare_list(st, arg, plus):
    """-compare: the last two images become their difference image
    (CompareImages), and the distortion under the -metric setting
    (default rmse) goes to stderr."""
    from ..ops import compare as cmx

    if len(st.images) < 2:
        raise CLIError("-compare needs two images")
    a, b = materialize_all(st.images[-2:])
    st.images.pop()
    metric = st.settings.get("metric", "rmse")
    dist = float(cmx.get_distortion(a.data, b.data, metric))
    diff = cmx.compare_images(a.data, b.data, metric)[0]
    print(f"{dist:g}", file=sys.stderr)
    st.images[-1].image = a.replace(data=diff)


def _op_fx(st, arg, plus):
    """-fx EXPR over the whole list (u the first image, v the second);
    the list becomes one image.  ``rand`` draws from a generator seeded
    0, as the JAX CLI draws from ``PRNGKey(0)``."""
    from ..ops import fx as fxm

    imgs = materialize_all(st.images)
    data = fxm.fx([im.data for im in imgs], arg, generator=torch.Generator(
        device=imgs[0].data.device).manual_seed(st.seed))
    st.images = [LazyImage(Image(data, imgs[0].spec, imgs[0].properties))]


def _normalize_list_channels(imgs):
    """Promote a mixed image list to a common layout (gray -> RGB when any
    member is color, opaque alpha added when any member carries alpha)
    so that sequence reductions can stack them; returns (datas, spec)."""
    any_color = any(im.spec.color_channels >= 3 for im in imgs)
    any_alpha = any(im.spec.alpha for im in imgs)
    datas = []
    for im in imgs:
        d = im.data
        a = d[..., -1:] if im.spec.alpha else None
        col = d[..., :-1] if im.spec.alpha else d
        if any_color and col.shape[-1] == 1:
            col = col.repeat_interleave(3, dim=-1)
        if any_alpha:
            if a is None:
                a = torch.ones(col.shape[:-1] + (1,), dtype=col.dtype,
                               device=col.device)
            col = torch.cat([col, a], -1)
        datas.append(col)
    spec = imgs[0].spec.with_(alpha=any_alpha)
    if any_color and spec.colorspace == "gray":
        spec = spec.with_(colorspace="srgb")
    return datas, spec


def _op_eval_seq(st, arg, plus):
    """-evaluate-sequence OP (and -average, -maximum, -minimum): the list
    reduced to one image (``statistic.evaluate_images``)."""
    from ..ops import statistic as stx

    datas, spec = _normalize_list_channels(materialize_all(st.images))
    st.images = [LazyImage(Image(stx.evaluate_images(torch.stack(datas),
                                                     arg), spec))]


def _op_morph(st, arg, plus):
    """-morph N: N crossfaded frames between each neighbouring pair
    (MorphImages, fx.c)."""
    n = int(arg)
    datas, spec = _normalize_list_channels(materialize_all(st.images))
    out = []
    for a, b in zip(datas, datas[1:]):
        out.append(Image(a, spec))
        for k in range(1, n + 1):
            t = k / (n + 1)
            out.append(Image((1 - t) * a + t * b, spec))
    out.append(Image(datas[-1], spec))
    st.images = [LazyImage(im) for im in out]


_DITHER = {"none": "none", "false": "none", "": "none",
           "floydsteinberg": "fs", "fs": "fs"}


def _op_posterize(st, arg, plus):
    """-posterize N: dithers by default with the Riemersma walk (native,
    on the host) like the reference; +dither or -dither none rounds,
    -dither FloydSteinberg takes the serpentine walk and -dither ordered
    the o8x8 threshold map."""
    from ..ops import quantize as qz

    levels = int(arg)
    meth = st.settings.get("dither", "riemersma").lower()
    dither = {"none": False, "false": False, "": False,
              "ordered": "ordered", "floydsteinberg": "floydsteinberg",
              "fs": "floydsteinberg"}.get(meth, True)
    for li, img in _materialized(st):
        li.image = img.replace(data=qz.posterize(img.data, levels, dither))


def _op_colors(st, arg, plus):
    """-colors N: the reference octree quantizer (native, on the host)
    for an RGB frame, with the -dither setting (Riemersma by default) and
    the -quantize colorspace; k-means on the device for other layouts,
    the JAX CLI's routes by shape."""
    from .. import native
    from ..ops import colorspace as cs
    from ..ops import quantize as qz

    n = int(arg.split()[0])
    dither = _DITHER.get(st.settings.get("dither", "riemersma").lower(),
                         "riemersma")
    qspace = normalize_colorspace(st.settings["quantize"]) \
        if st.settings.get("quantize") else None
    for li, img in _materialized(st):
        nc = img.spec.color_channels
        data = img.data[..., :nc] if img.spec.alpha else img.data
        src_cs = img.spec.colorspace
        if qspace and qspace != src_cs:
            data = cs.convert(data[..., :3], src_cs, qspace)
        if data.dim() == 3 and data.shape[-1] == 3:
            out, _ = native.octree_quantize(
                data.detach().cpu().numpy(), n, dither)
            out = torch.from_numpy(out).to(data.device)
        else:
            out = qz.kmeans_quantize(data, n)
        if qspace and qspace != src_cs:
            out = cs.convert(out, qspace, src_cs)
        if img.spec.alpha:
            out = torch.cat([out, img.data[..., -1:]], -1)
        li.image = img.replace(data=out)


def _op_kmeans(st, arg, plus):
    """-kmeans COLORSxITERATIONS+TOLERANCE (operation.c:2618-2632: 300
    iterations and 0.0001 by default; no dither)."""
    from ..ops import quantize as qz

    g = parse_geometry(arg)
    n = int(g.width or 8)
    iters = int(g.height) if g.height is not None else 300
    tol = float(g.x) if g.x is not None else 0.0001
    for li, img in _materialized(st):
        li.image = img.replace(data=qz.kmeans_reference(
            img.data, n, max_iters=iters, tolerance=tol))


def _op_unique_colors(st, arg, plus):
    """-unique-colors: each image becomes one row of its distinct colors
    in the reference's order (``histogram.unique_colors``, on the host)."""
    from ..ops import histogram as hg

    for li, img in _materialized(st):
        colors, _ = hg.unique_colors(img.data)
        li.image = Image(torch.from_numpy(colors.reshape(
            1, -1, colors.shape[-1])).to(img.data.device), img.spec)


def _op_type(st, arg, plus):
    """-type TYPE: SetImageType (``attribute.set_image_type``)."""
    from ..ops import attribute as at

    t = arg.lower()
    for li, img in _materialized(st):
        data = at.set_image_type(img.data, t, img.spec.alpha)
        spec = img.spec
        if t.startswith(("bilevel", "grayscale")):
            spec = spec.with_(colorspace="gray")
        elif data.shape[-1] >= 3 and spec.color_channels == 1:
            spec = spec.with_(colorspace="srgb")
        li.image = Image(data, spec, img.properties, img.profiles)


# -- paint, feature, vision, segment, draw and decorate ------------------------

def _fuzz(st) -> float:
    """The -fuzz setting as a fraction (``_percent``: "10%" and "10" are
    both 0.1)."""
    return _percent(st.settings.get("fuzz", "0") or "0")


def _canny_args(a):
    g = parse_geometry(a)
    kw = {"radius": g.width or 0.0,
          "sigma": g.height if g.height is not None else 1.0}
    if g.x is not None:
        kw["lower_percent"] = abs(g.x) / 100.0
    if g.y is not None:
        kw["upper_percent"] = abs(g.y) / 100.0
    return kw


def _meanshift_args(a):
    g = parse_geometry(a)
    kw = {"width": int(g.width or 7), "height": int(g.height or g.width or 7)}
    if g.x is not None:
        kw["color_distance"] = abs(g.x) / 100.0
    return kw


def _op_opaque(st, arg, plus):
    """-opaque COLOR: the matching pixels take -fill (+opaque: the others)."""
    from ..ops import paint as pt

    target = parse_color(arg)
    for li, img in _materialized(st):
        li.image = img.replace(data=pt.opaque_paint(
            img.data, target[: img.channels], st.fill()[: img.channels],
            fuzz=_fuzz(st), invert=plus))


def _op_transparent(st, arg, plus):
    """-transparent COLOR: the matching pixels become transparent (an
    alpha channel is added first where the image has none)."""
    from ..ops import paint as pt

    target = parse_color(arg)
    for li, img in _materialized(st):
        if not img.spec.alpha:
            img = img.set_alpha(True)
        li.image = img.replace(data=pt.transparent_paint(
            img.data, target[:3], 0.0, fuzz=_fuzz(st), invert=plus))


def _op_floodfill(st, arg, plus):
    """-floodfill +X+Y COLOR (two arguments): FloodfillPaintImage from the
    seed, through the pixels within -fuzz of COLOR, with -fill."""
    from ..ops import paint as pt

    geom, _, color_s = arg.partition(" ")
    g = parse_geometry(geom)
    target = parse_color(color_s.strip()) if color_s.strip() else None
    for li, img in _materialized(st):
        li.image = img.replace(data=pt.floodfill(
            img.data, int(g.x or 0), int(g.y or 0),
            st.fill()[:img.channels], fuzz=_fuzz(st), target_color=target))


def _op_ccl(st, arg, plus):
    """-connected-components 4|8 with the defines
    ``connected-components:area-threshold`` (merge smaller objects into
    their dominant neighbour), ``:verbose`` (print each object) and
    ``:mean-color`` (paint each object its mean color, else the gray ramp
    id/65535).  -fuzz is read with ``_percent``, as every other option
    reads it (the JAX CLI's ``float(fuzz)/100`` raises on "10%")."""
    from ..ops import vision as vi

    conn = int(arg) if arg and arg.strip().isdigit() else 4
    verbose = st.defines.get("connected-components:verbose", "") == "true"
    mean_color = st.defines.get("connected-components:mean-color",
                                "") == "true"
    area_thresh = st.defines.get("connected-components:area-threshold", "")
    for li, img in _materialized(st):
        labels = vi.connected_components(img.data, connectivity=conn,
                                         fuzz=_fuzz(st))
        seq = vi.relabel_sequential(labels)
        if area_thresh:
            seq = vi.relabel_sequential(vi.merge_small_components(
                seq, int(float(area_thresh)), conn))
        if verbose:
            for s in vi.component_statistics(img.data, seq):
                bx, by, bw, bh = s["bbox"]
                print(f"  {s['id']}: {bw}x{bh}+{bx}+{by} "
                      f"{s['centroid'][0]:.1f},{s['centroid'][1]:.1f} "
                      f"{s['area']} "
                      f"srgb{tuple(round(c, 3) for c in s['mean_color'])}")
        if mean_color:
            # each object its mean color (vision.c:717), float64 sums on
            # the host as in the JAX CLI
            arr = img.data.cpu().numpy()
            flat = seq.cpu().numpy().reshape(-1)
            n = int(flat.max()) + 1
            cnt = np.bincount(flat, minlength=n).astype(np.float64)
            out = np.empty_like(arr)
            for c in range(arr.shape[-1]):
                s = np.bincount(flat, weights=arr[..., c].reshape(-1),
                                minlength=n)
                out[..., c] = (s / np.maximum(cnt, 1))[flat] \
                    .reshape(arr.shape[:-1])
            li.image = img.replace(data=torch.from_numpy(
                out.astype(np.float32)).to(img.data.device))
        else:
            # the default gray colormap ramp: value = id / 65535
            norm = seq.to(torch.float32) / torch.tensor(
                65535.0, device=seq.device)
            li.image = Image(norm[..., None], ImageSpec(colorspace="gray"))


def _op_segment(st, arg, plus):
    """-segment CLUSTERxSMOOTH: SegmentImage, each image on its own."""
    from ..ops import segment as sg

    parts = [p for p in arg.replace(",", "x").split("x") if p]
    ct = float(parts[0]) if parts else 1.0
    sm = float(parts[1]) if len(parts) > 1 else 1.5
    for li, img in _materialized(st):
        li.image = img.replace(data=sg.segment(img.data, cluster_threshold=ct,
                                               smooth_threshold=sm))


def _stroke_prelude(st) -> List[str]:
    prelude = [f"fill '{st.settings.get('fill', 'black')}'"]
    if st.settings.get("stroke"):
        prelude.append(f"stroke '{st.settings['stroke']}'")
    if st.settings.get("strokewidth"):
        prelude.append(f"stroke-width {st.settings['strokewidth']}")
    return prelude


def _op_hough(st, arg, plus):
    """-hough-lines WxH+THRESHOLD: HoughLineImage finds each image's lines
    and draws them as MVG ``line`` primitives (-fill, -stroke,
    -strokewidth) on a -background canvas of the image's size."""
    from ..ops import draw as dw
    from ..ops import feature as ft

    g = parse_geometry(arg)
    w = int(g.width or 5)
    h = int(g.height or w)
    thr = int(g.x or 0)
    for li, img in _materialized(st):
        segs = ft.hough_line_segments(img.data, w, h, thr)
        canvas = torch.tensor(list(st.bg()[:3]), dtype=torch.float32,
                              device=img.data.device) \
            .expand(img.height, img.width, 3).contiguous()
        mvg = " ".join(_stroke_prelude(st)) + " " + " ".join(
            f"line {x1:g},{y1:g} {x2:g},{y2:g}"
            for x1, y1, x2, y2, _, _, _ in segs)
        out = dw.draw(canvas, mvg, False) if segs else canvas
        li.image = Image(out, img.spec.with_(colorspace="srgb", alpha=False))


def _op_features(st, arg, plus):
    """-features DISTANCE: prints each image's Haralick metrics."""
    from ..ops import feature as ft

    dist = int(float(arg or 1))
    for _, img in _materialized(st):
        feats = ft.glcm_features(img.data, offset=(0, dist))
        for k, v in feats.items():
            print(f"  {k}: {v.cpu().numpy().ravel()[:4]}")


def _op_draw(st, arg, plus):
    """-draw MVG under the -fill, -stroke, -strokewidth, -pointsize, -font
    and -fuzz settings."""
    from ..ops import draw as dw

    prelude = _stroke_prelude(st)
    if st.settings.get("pointsize"):
        prelude.append(f"font-size {st.settings['pointsize']}")
    if st.settings.get("font"):
        prelude.append(f"font '{st.settings['font']}'")
    mvg = " ".join(prelude) + " " + arg
    for li, img in _materialized(st):
        li.image = img.replace(data=dw.draw(img.data, mvg, img.spec.alpha,
                                            fuzz=_fuzz(st)))


def _op_annotate(st, arg, plus):
    """-annotate GEOMETRY TEXT (two arguments) in -fill, at -pointsize
    (default 12) in -font, placed by -gravity, shaped in -direction."""
    from ..ops import draw as dw

    geom, _, text = arg.partition(" ")
    g = parse_geometry(geom)
    for li, img in _materialized(st):
        li.image = img.replace(data=dw.annotate(
            img.data, text.strip("'\""), g.x or 0, g.y or 0,
            color=st.fill(), size=float(st.settings.get("pointsize", "12")),
            font=st.settings.get("font"), gravity=st.settings["gravity"],
            direction=st.settings.get("direction")))


def _op_frame(st, arg, plus):
    """-frame WxH+OUTER+INNER in -mattecolor (default #bdbdbd)."""
    from ..ops import decorate as dec

    g = parse_geometry(arg)
    mc = parse_color(st.settings.get("mattecolor", "#bdbdbd"))
    for li, img in _materialized(st):
        li.image = img.replace(data=dec.frame(
            img.data, int(g.width or 6), int(g.height or g.width or 6),
            outer_bevel=abs(g.x) if g.x is not None else 2,
            inner_bevel=abs(g.y) if g.y is not None else 2,
            matte_color=mc))


def _op_raise(st, arg, plus):
    """-raise WxH (+raise: sunken)."""
    from ..ops import decorate as dec

    g = parse_geometry(arg)
    for li, img in _materialized(st):
        li.image = img.replace(data=dec.raise_image(
            img.data, int(g.width or 6), int(g.height or g.width or 6),
            not plus))


# -- layers, montage, visual effects and the options that need no file -------

def _replaced(li: LazyImage, **changes) -> Image:
    """``li``'s image as a new Image with ``changes`` to its properties,
    page or delay (the caller's Image is left as it was)."""
    img = li.image
    li.image = Image(img.data, img.spec,
                     changes.get("properties", img.properties),
                     img.profiles, changes.get("page", img.page),
                     changes.get("delay", img.delay))
    return li.image


def _op_label(st, value):
    """-label TEXT: set on the images already in the list."""
    for li in st.images:
        _replaced(li, properties=dict(li.image.properties, label=value))


def _op_repage(st, geom, plus):
    """+repage resets the page; -repage GEOM follows ResetImagePage
    (image.c:2171) field by field: only parsed components are
    overwritten, an omitted height defaults to the width, '!' ADDS the
    offsets, and a positive offset onto a zero canvas sets the canvas
    dimension to the image's plus the offset.  Page: (x, y, w, h)."""
    if plus:
        for li in st.images:
            _replaced(li, page=None)
        return
    gp = parse_geometry(geom, offsets_first=True)
    for li in st.images:
        im = li.image
        px, py, pw, ph = im.page if im.page else (0, 0, 0, 0)
        if gp.width is not None:
            pw = int(gp.width)
            ph = int(gp.height if gp.height is not None else gp.width)
        if gp.exact:        # '!' add-offset form
            if gp.x is not None:
                px += int(gp.x)
            if gp.y is not None:
                py += int(gp.y)
        else:
            if gp.x is not None:
                px = int(gp.x)
                if pw == 0 and px > 0:
                    pw = im.width + px
            if gp.y is not None:
                py = int(gp.y)
                if ph == 0 and py > 0:
                    ph = im.height + py
        _replaced(li, page=(px, py, pw, ph))


def _relist(st, images: List[Image]) -> None:
    st.images = [LazyImage(im) for im in images]


def _op_layers(st, arg, plus):
    """-layers METHOD (layer.c): every method of ``ops/layer.py``;
    ``composite`` needs a ``null:`` separator image, which comes from a
    reader of io/."""
    from ..ops import layer as ly

    method = arg.lower().replace("_", "-")
    frames = materialize_all(st.images)
    fuzz = _fuzz(st)
    if method == "coalesce":
        out = ly.coalesce(frames)
    elif method in ("optimize", "optimize-frame", "optimize-image",
                    "optimize-plus"):
        out = ly.optimize_layers(frames, fuzz)
    elif method == "optimize-transparency":
        out = ly.optimize_transparency(frames, fuzz)
    elif method in ("remove-dups", "removedups"):
        out = ly.remove_duplicate_layers(frames, fuzz)
    elif method in ("remove-zero", "removezero"):
        out = ly.remove_zero_delay_layers(frames)
    elif method in ("compare-any", "compare-clear", "compare-overlay"):
        out = ly.deconstruct(frames, fuzz)
    elif method in ("flatten", "merge"):
        out = [ly.flatten(frames, background=st.bg())]
    elif method in ("mosaic", "trim-bounds"):
        out = [ly.mosaic(frames)]
    elif method == "dispose":
        out = ly.dispose_images(frames)
    elif method == "composite":
        out = _layers_composite(st, frames)
    else:
        raise CLIError(f"unknown -layers method {arg!r}")
    _relist(st, out)


def _layers_composite(st, frames: List[Image]) -> List[Image]:
    """-layers composite (layer.c CompositeLayers): the frames before the
    ``null:`` image composited, one by one, with those after it (the last
    source frame repeated) under -compose and -gravity."""
    from ..ops.composite import composite_at

    sep = next((i for i, im in enumerate(frames)
                if im.properties.get("null-separator")), None)
    if sep is None:
        raise CLIError("-layers composite needs a null: separator "
                       "between the destination and source stacks")
    dst_stack, src_stack = frames[:sep], frames[sep + 1:]
    compose = st.settings.get("compose", "over")
    out = []
    for i, dst in enumerate(dst_stack):
        src = src_stack[min(i, len(src_stack) - 1)]
        out.append(dst.replace(data=composite_at(
            dst.data, src.data, compose, 0, 0,
            st.settings.get("gravity", "undefined"),
            dst_alpha=dst.spec.alpha, src_alpha=src.spec.alpha)))
    return out


def _op_layer_list(fname: str):
    """-coalesce, -deconstruct: the list through ``ops/layer.<fname>``."""

    def handler(st, arg, plus):
        from ..ops import layer as ly

        _relist(st, getattr(ly, fname)(materialize_all(st.images)))

    return handler


def _op_flatten(st, arg, plus):
    """-flatten: MergeImageLayers onto a -background canvas of the first
    frame's size, every frame at its page offsets (-mosaic: a canvas of
    their union)."""
    from ..ops import layer as ly

    _relist(st, [ly.flatten(materialize_all(st.images), background=st.bg())])


def _op_mosaic(st, arg, plus):
    from ..ops import layer as ly

    _relist(st, [ly.mosaic(materialize_all(st.images), background=st.bg())])


def _op_append(st, arg, plus):
    """-append (top to bottom) and +append (left to right): AppendImages
    on a -background canvas, placed by -gravity."""
    from ..ops import layer as ly

    _relist(st, [ly.append(materialize_all(st.images), stack=not plus,
                           background=st.bg(),
                           gravity=st.settings.get("gravity", "northwest"))])


def _op_smush(st, arg, plus):
    """-smush OFFSET (top to bottom) and +smush (left to right)."""
    from ..ops import layer as ly

    offset = int(float(arg)) if arg else 0
    _relist(st, [ly.smush(materialize_all(st.images), stack=not plus,
                          offset=offset, background=st.bg(),
                          gravity=st.settings.get("gravity", "northwest"))])


def _op_montage(st, arg, plus):
    """-montage: the list on a -tile grid of -geometry thumbnails
    (default 120x120+4+3)."""
    from ..ops import montage as mo

    geom = st.settings.get("compose-geometry") or "120x120+4+3"
    _relist(st, [mo.montage(materialize_all(st.images),
                            tile=st.settings.get("tile", ""),
                            geometry=geom)])


def _wavelet_args(a):
    """operation.c:3695 scales rho AND sigma by QuantumRange/100 under %;
    the threshold is in quantum units (normalized here), the softness the
    raw multiplier of visual-effects.c:3717."""
    g = parse_geometry(a)
    thr = g.width if g.width is not None else 0.0
    soft = g.height if g.height is not None else 0.0
    if g.percent:
        thr /= 100.0
        soft *= 65535.0 / 100.0
    else:
        thr /= 65535.0
    return {"threshold": thr, "softness": soft}


def _sketch_args(st, a, p):
    # the first image's alpha decides, as in the JAX CLI
    return dict(_motion_args(a), has_alpha=bool(
        st.images and st.images[0].spec.alpha))


def _op_noise(st, arg, plus):
    """+noise TYPE: AddNoiseImage at the -attenuate setting (default 1),
    drawn from a generator seeded 0, as the port's other noise options
    draw (the JAX CLI seeds from the clock and reads a setting that only
    its default sets); -noise RADIUS: the non-peak statistic over a
    (2R+1)^2 window."""
    if plus:
        from ..ops import visual_effects as vfx

        att = float(st.settings.get("attenuate", "1.0"))
        noise = _seeded(vfx.add_noise, st.seed)
        for li in st.images:
            li.push(lambda x: noise(x, noise_type=arg, attenuate=att))
    else:
        from ..ops import statistic as stx

        w = 2 * int(float(arg)) + 1
        for li in st.images:
            li.push(lambda x: stx.statistic(x, "nonpeak", w, w))


def _op_tint(st, arg, plus):
    """-tint RHO[xSIGMA+XI]: blend percentages toward -fill."""
    from ..ops import visual_effects as vfx

    g = parse_geometry(arg)
    rho = g.width if g.width is not None else 100.0
    blend = (rho, g.height if g.height is not None else rho,
             float(g.x) if g.x is not None else rho)
    fill = st.fill()[:3]
    for li in st.images:
        li.push(lambda x: vfx.tint(x, fill, blend))


def _op_vignette(st, arg, plus):
    """-vignette RxS+X+Y{%}: offsets default to a tenth of the image and
    round to integers (operation.c:3671); blends toward -background."""
    from ..ops import visual_effects as vfx

    r, s = _geom_args(arg)
    g = parse_geometry(arg)
    bg = st.bg()[:3]
    for li in st.images:
        w, h = li.width, li.height
        vx = float(g.x) if g.x is not None else 0.1 * w
        vy = float(g.y) if g.y is not None else 0.1 * h
        if g.percent:
            vx *= w / 100.0
            vy *= h / 100.0
        vx, vy = math.ceil(vx - 0.5), math.ceil(vy - 0.5)
        li.push(lambda d, a=(r, s, vx, vy): vfx.vignette(d, *a,
                                                         background=bg))


def _op_colorize(st, arg, plus):
    """-colorize R[,G,B] percentages toward -fill (no clamp, as in the
    JAX CLI)."""
    parts = [float(p.rstrip("%")) / 100.0
             for p in arg.replace("/", ",").split(",")]
    if len(parts) == 1:
        parts = parts * 3
    for li, img in _materialized(st):
        cc = img.spec.color_channels
        dev = img.data.device
        amounts = torch.tensor(parts[:cc], dtype=torch.float32, device=dev)
        fill = torch.tensor(st.fill()[:cc], dtype=torch.float32, device=dev)
        out = img.data[..., :cc] * (1 - amounts) + fill * amounts
        if img.spec.alpha:
            out = torch.cat([out, img.data[..., -1:]], -1)
        li.image = img.replace(data=out)


def _square_matrix(arg: str, what: str) -> np.ndarray:
    vals = [float(v) for v in arg.replace(",", " ").split()]
    n = int(round(len(vals) ** 0.5))
    if n * n != len(vals):
        raise CLIError(f"{what} needs a square matrix")
    return np.asarray(vals, np.float32).reshape(n, n)


def _op_color_matrix(st, arg, plus):
    from ..ops import visual_effects as vfx

    mat = _square_matrix(arg, "-color-matrix")
    for li in st.images:
        li.push(lambda x: vfx.color_matrix(x, mat))


def _op_shadow(st, arg, plus):
    """-shadow [PCTxSIGMA+X+Y] (default 80x3+5+5): each image becomes its
    shadow in the -background color, with alpha."""
    from ..ops import visual_effects as vfx

    g = parse_geometry(arg or "80x3+5+5")
    for li, img in _materialized(st):
        data = img.data
        if not img.spec.alpha:
            data = torch.cat([data, torch.ones_like(data[..., :1])], -1)
        out = vfx.shadow(data, g.width or 80.0, g.height or 3.0,
                         int(g.x or 5), int(g.y or 5), color=st.bg()[:3])
        li.image = Image(out, img.spec.with_(alpha=True))


def _op_polaroid(st, arg, plus):
    """-polaroid ANGLE (+polaroid: angle 0): a bent, framed, shadowed
    print on transparency."""
    from ..ops import visual_effects as vfx

    angle = 0.0 if plus or arg is None else float(arg)
    for li, img in _materialized(st):
        out = vfx.polaroid(img.data, angle, background=st.bg()[:3])
        li.image = Image(out, img.spec.with_(alpha=True))


def _op_stegano(st, arg, plus):
    """-stegano OFFSET: the last image is the watermark hidden in the
    others' low bits."""
    from ..ops import visual_effects as vfx

    if len(st.images) < 2:
        raise CLIError("-stegano needs an image and a watermark")
    wm = st.images.pop().materialize()
    offset = int(arg or 0)
    for li, img in _materialized(st):
        li.image = img.replace(data=vfx.stegano(img.data, wm.data, offset))


def _op_stereo(st, arg, plus):
    """-stereo +X+Y: the last two images become their anaglyph."""
    from ..ops import visual_effects as vfx

    if len(st.images) < 2:
        raise CLIError("-stereo needs two images")
    g = parse_geometry(arg or "+0+0", offsets_first=True)
    right = st.images.pop().materialize()
    left = st.images[-1].materialize()
    st.images[-1].image = left.replace(data=vfx.stereo(
        left.data, right.data, int(g.x or 0), int(g.y or 0)))


def _op_morphology(st, arg, plus):
    """-morphology METHOD[:ITERATIONS] KERNEL (two arguments)."""
    from ..ops import morphology as mo

    parts = arg.split(None, 1)
    method = parts[0]
    kernel = parts[1] if len(parts) > 1 else "square:1"
    iters = 1
    if ":" in method:
        method, _, it = method.partition(":")
        iters = int(it)
    vp = st.settings["virtual-pixel"]
    form = _morphology_form(method, kernel, iters, vp)
    for li in st.images:
        op = lambda x: mo.morphology(x, method, kernel, iterations=iters,
                                     virtual_pixel=vp)
        li.push(op if form is None else _sharded_form(op, form))


def _morphology_form(method: str, kernel: str, iters: int, vp: str):
    """The sharded form of ``-morphology method:iters kernel``
    (``parallel.spatial.sharded_morphology``, which equals
    ``morphology``), or None: a bounded method, at least one iteration
    (fewer converge), and for convolve and correlate, which read the
    virtual pixel beyond the border, the 'edge' one the blocks repeat."""
    from ..ops import morphology as mo
    from ..parallel import spatial as sp

    m = method.lower().replace("-", "").replace("_", "")
    if iters < 1 or m not in sp._METHOD_PRIMS and m not in sp._METHOD_DIFFS:
        return None
    if m in ("convolve", "correlate") and vp != "edge":
        return None
    kernels = mo.get_kernel(kernel)
    ry = max(k.shape[0] // 2 for k in kernels)
    rx = max(k.shape[1] // 2 for k in kernels)

    def form(mesh, shape):
        if not _halo_fits(mesh, shape, ry, rx):
            return None
        return sp.sharded_morphology(mesh, m, kernel, iters, _cli_spec())

    return form


def _op_convolve(st, arg, plus):
    """-convolve 'k11,k12,...': a normalized square kernel."""
    from ..ops import morphology as mo

    kern = _square_matrix(arg, "-convolve")
    vp = st.settings["virtual-pixel"]
    for li in st.images:
        li.push(lambda x: mo.convolve_kernel(x, kern, normalize=True,
                                             virtual_pixel=vp))


def _op_fft(st, arg, plus):
    """-fft (+fft: real and imaginary): each image becomes its magnitude
    and phase pair."""
    from ..ops import fourier as ff

    out = []
    for img in materialize_all(st.images):
        mag, ph = ff.forward_fft(img.data, modulus=not plus)
        out += [Image(mag, img.spec), Image(ph, img.spec)]
    _relist(st, out)


def _op_ift(st, arg, plus):
    """-ift (+ift): the first two images, a magnitude and phase pair (or
    real and imaginary), become one image."""
    from ..ops import fourier as ff

    if len(st.images) < 2:
        raise CLIError("-ift needs a magnitude/phase image pair")
    mag, ph = materialize_all(st.images[:2])
    _relist(st, [Image(ff.inverse_fft(mag.data, ph.data,
                                      modulus=not plus), mag.spec)])


def _op_complex(st, arg, plus):
    """-complex OP over (real, imaginary) pairs: images 0-1 with 2-3
    (zeros where absent)."""
    from ..ops import fourier as ff

    if len(st.images) < 2:
        raise CLIError("-complex needs image pairs")
    imgs = materialize_all(st.images)
    a_r, a_i = imgs[0], imgs[1]
    b_r = imgs[2].data if len(imgs) > 2 else torch.zeros_like(a_r.data)
    b_i = imgs[3].data if len(imgs) > 3 else torch.zeros_like(a_i.data)
    out_r, out_i = ff.complex_images(a_r.data, a_i.data, b_r, b_i,
                                     arg.lower())
    _relist(st, [a_r.replace(data=out_r), a_i.replace(data=out_i)])


def _op_clut(st, arg, plus):
    """-clut: the last image is the lookup, sampled by -interpolate
    (default bilinear); a lookup with alpha gives the images alpha."""
    from ..ops import enhance as en

    if len(st.images) < 2:
        raise CLIError("-clut needs an image and a lookup image")
    lut = st.images.pop().materialize()
    method = st.settings.get("interpolate", "bilinear") or "bilinear"
    if method.lower() in ("undefined", ""):
        method = "bilinear"
    for li, img in _materialized(st):
        out = en.clut(img.data, lut.data, method=method,
                      lut_alpha=lut.spec.alpha, has_alpha=img.spec.alpha)
        spec = img.spec
        if lut.spec.alpha and not spec.alpha:
            # ClutImage's tail: a clut with alpha activates the channel
            out = torch.cat([out, torch.ones_like(out[..., :1])], -1)
            spec = spec.with_(alpha=True)
        li.image = img.replace(data=out, spec=spec)


def _op_hald_clut(st, arg, plus):
    """-hald-clut: the last image is the Hald CLUT."""
    from ..ops import enhance as en

    if len(st.images) < 2:
        raise CLIError("-hald-clut needs an image and a Hald CLUT image")
    hald = st.images.pop().materialize()
    for li, img in _materialized(st):
        li.image = img.replace(data=en.hald_clut(img.data, hald.data))


def _op_cdl(st, arg, plus):
    """-cdl 'slope,offset,power[:saturation]' (3 or 9 numbers)."""
    from ..ops import enhance as en

    body, _, sat = arg.partition(":")
    nums = [float(v) for v in body.replace(",", " ").split()]
    if len(nums) == 3:
        slope, offset, power = ([nums[0]] * 3, [nums[1]] * 3, [nums[2]] * 3)
    elif len(nums) >= 9:
        slope, offset, power = nums[0:3], nums[3:6], nums[6:9]
    else:
        raise CLIError("-cdl needs 3 or 9 numbers")
    s = float(sat) if sat else 1.0
    for li in st.images:
        li.push(lambda x: en.color_decision_list(
            x, tuple(slope), tuple(offset), tuple(power), s))


def _op_level_colors(st, arg, plus):
    """-level-colors BLACK,WHITE: the color range stretched to the full
    range (+level-colors: the full range mapped into the colors).  The
    scale is PerceptibleReciprocal(white - black), sign-preserving: a
    reversed range inverts the channel (enhance.c:3244)."""
    lo_s, _, hi_s = arg.partition(",")
    lo = np.asarray(parse_color(lo_s or "black")[:3], np.float32)
    hi = np.asarray(parse_color(hi_s or "white")[:3], np.float32)
    diff = hi - lo
    tiny = np.abs(diff) < 1e-12
    scale = np.where(tiny, np.sign(diff) * np.float32(1e12)
                     + (diff == 0) * np.float32(1e12),
                     np.float32(1.0) / np.where(tiny, np.float32(1.0), diff)
                     ).astype(np.float32)

    def fn(x):
        c = x[..., :3]
        t = lambda v: torch.from_numpy(v).to(x.device)
        out = t(lo) + c * t(diff) if plus else (c - t(lo)) * t(scale)
        out = torch.clamp(out, 0.0, 1.0)
        return torch.cat([out, x[..., 3:]], -1) if x.shape[-1] > 3 else out

    for li in st.images:
        li.push(fn)


def _op_contrast(st, arg, plus):
    """-contrast (+contrast: reduce)."""
    from ..ops import enhance as en

    for li in st.images:
        li.push(lambda x: en.contrast(x, not plus))


def _op_grayscale(st, arg, plus):
    """-grayscale METHOD (default rec709luma): lazy; the two luma methods
    on a color image are a channel mix, tagged for K1 as in the JAX
    CLI."""
    from ..ops import colorspace as cs
    from ..ops import enhance as en

    method = arg or "rec709luma"
    lumas = {"rec709luma": cs.REC709_LUMA, "rec601luma": cs.REC601_LUMA}
    for li in st.images:
        tag = None
        if method.lower() in lumas and li.spec.color_channels == 3:
            luma = tuple(lumas[method.lower()])
            # en.grayscale drops alpha: one luma row either way
            tag = ("mix", (luma + (0.0,),)) if li.spec.alpha \
                else ("mix", (luma,))
        li.push(lambda x: en.grayscale(x, method),
                spec_update=lambda s: s.with_(colorspace="gray"), tag=tag)


def _op_monochrome(st, arg, plus):
    """-monochrome: SetImageType(BilevelType) = gray + NormalizeImage +
    BilevelImage(QuantumRange/2) (attribute.c:2320-2330)."""
    from ..ops import colorspace as cs
    from ..ops import enhance as en
    from ..ops import threshold as th

    for li, img in _materialized(st):
        gray = cs.convert(img.data[..., :img.spec.color_channels],
                          img.spec.colorspace, "gray")
        gray = th.bilevel(en.normalize(gray), 0.5)
        li.image = Image(gray, img.spec.with_(colorspace="gray",
                                              alpha=False))


def _op_range_threshold(st, arg, plus):
    from ..ops import threshold as th

    vals = [_percent(v) for v in arg.split(",")]
    while len(vals) < 4:
        vals.append(vals[-1])
    for li in st.images:
        li.push(lambda x: th.range_threshold(x, *vals[:4]))


def _op_color_threshold(st, arg, plus):
    """-color-threshold START-STOP: white inside the color box, black
    outside (a gray image)."""
    start_s, _, stop_s = arg.partition("-")
    lo = parse_color(start_s or "black")[:3]
    hi = parse_color(stop_s or "white")[:3]

    def fn(x):
        c = x[..., :3]
        t = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
        inside = ((c >= t(lo)) & (c <= t(hi))).all(dim=-1, keepdim=True)
        return torch.where(inside, 1.0, 0.0)

    for li in st.images:
        li.push(fn, spec_update=lambda s: s.with_(colorspace="gray",
                                                  alpha=False))


def _integral(x: torch.Tensor) -> torch.Tensor:
    """-integral: the summed-area table (IntegralImage, statistic.c)."""
    return torch.cumsum(torch.cumsum(x, dim=-3), dim=-2)


def _op_integral(st, arg, plus):
    for li in st.images:
        li.push(_integral)


def _op_moments(st, arg, plus):
    """-moments: prints each image's moments (the first 8 values of
    each), as the JAX CLI prints them."""
    from ..ops import statistic as stx

    def host(v):
        if isinstance(v, (tuple, list)):
            return np.asarray([host(u) for u in v])
        return v.cpu().numpy()

    for _, img in _materialized(st):
        for k, v in stx.get_moments(img.data).items():
            print(f"  {k}: {host(v).ravel()[:8]}")


def _sort_pixels(x: torch.Tensor) -> torch.Tensor:
    """-sort-pixels: the pixels in order of their mean intensity (a
    stable sort over the whole image, as in the JAX CLI)."""
    from ..ops.channel import channel_mean

    h, w, c = x.shape[-3:]
    order = torch.argsort(channel_mean(x[..., :3]).reshape(
        x.shape[:-3] + (-1,)), dim=-1, stable=True)
    flat = x.reshape(x.shape[:-3] + (h * w, c))
    out = torch.take_along_dim(flat, order[..., None], dim=-2)
    return out.reshape(x.shape)


def _op_sort_pixels(st, arg, plus):
    for li in st.images:
        li.push(_sort_pixels)


def _op_resample(st, arg, plus):
    """-resample XxY: a resize by the ratio to the -density setting
    (default 72), with -filter."""
    from ..ops import resize as rz

    g = parse_geometry(arg)
    dx = g.width or 72.0
    dy = g.height or dx
    cg = parse_geometry(st.settings.get("density", "72"))
    cdx, cdy = cg.width or 72.0, (cg.height or cg.width or 72.0)
    for li, img in _materialized(st):
        w = max(int(img.width * dx / cdx + 0.5), 1)
        h = max(int(img.height * dy / cdy + 0.5), 1)
        li.image = img.replace(data=rz.resize(
            img.data, h, w, st.settings.get("filter", "undefined")))


def _op_interpolative_resize(st, arg, plus):
    """-interpolative-resize GEOMETRY with the -interpolate method."""
    from ..ops import resize as rz

    for li, img in _materialized(st):
        w, h, _, _ = parse_meta_geometry(arg, img.width, img.height)
        li.image = img.replace(data=rz.interpolative_resize(
            img.data, h, w, st.settings.get("interpolate", "bilinear")))


def _op_poly(st, arg, plus):
    """-poly 'w1,e1 w2,e2 ...': the list becomes sum(w_i * img_i^e_i)."""
    from ..ops import statistic as stx

    terms = [float(v) for v in arg.replace(",", " ").split()]
    if len(terms) % 2:
        raise CLIError("-poly needs weight,exponent pairs")
    pairs = [(terms[j], terms[j + 1]) for j in range(0, len(terms), 2)]
    imgs = materialize_all(st.images)
    datas, spec = _normalize_list_channels(imgs)
    _relist(st, [Image(stx.polynomial_images(datas, pairs), spec,
                       imgs[0].properties, imgs[0].profiles)])


def _op_orient(st, arg, plus):
    """-orient NAME: the image turned as that EXIF orientation says."""
    from ..ops import transform as tf

    names = {"topleft": 1, "topright": 2, "bottomright": 3,
             "bottomleft": 4, "lefttop": 5, "righttop": 6,
             "rightbottom": 7, "leftbottom": 8}
    o = names.get(arg.lower().replace("-", ""), 1)
    for li, img in _materialized(st):
        li.image = img.replace(data=tf.auto_orient(img.data, o))


def _op_duplicate(st, arg, plus):
    """-duplicate N: N copies of the last image."""
    n = int(arg) if arg and arg.lstrip("+-").isdigit() else 1
    last = st.images[-1].materialize()
    st.images += [LazyImage(last) for _ in range(n)]


def _op_insert(st, arg, plus):
    """-insert INDEX: the last image moved to INDEX."""
    idx = int(arg)
    img = st.images.pop()
    st.images.insert(idx if idx >= 0 else len(st.images) + idx + 1, img)


def _op_cycle(st, arg, plus):
    """-cycle AMOUNT: on direct-class pixels, a modular intensity shift of
    AMOUNT/256 (the reference quantizes first, colormap.c)."""
    amount = float(arg) / 256.0
    for li in st.images:
        li.push(lambda x: torch.remainder(x + amount, 1.0))


def _op_preview(st, arg, plus):
    """-preview TYPE: nine variations of the first image (gamma, blur,
    brightness, saturation or hue) on a 3x3 montage."""
    from ..ops import blur as bl
    from ..ops import enhance as en
    from ..ops import montage as mo

    t = arg.lower()
    img = st.images[0].materialize()
    variants = []
    for k in range(9):
        if t == "blur":
            data = bl.blur(img.data, 0.0, 0.2 + 0.4 * k)
        elif t == "brightness":
            data = en.brightness_contrast(img.data, -40 + 10 * k, 0)
        elif t == "saturation":
            data = en.modulate(img.data, 100, 40 + 15 * k, 100)
        elif t == "hue":
            data = en.modulate(img.data, 100, 100, 60 + 10 * k)
        else:
            data = en.gamma(img.data, 0.3 + 0.3 * k)
        variants.append(Image(data, img.spec))
    _relist(st, [mo.montage(variants, tile="3x3", geometry="120x120+2+2")])


# -- the options that read or write files, and core/'s services ------------

def _op_profile(st, arg, plus):
    """-profile FILE: the ICC transform to the file's profile (LittleCMS on
    the host, ``core/profile.py``); +profile PATTERN removes the matching
    profiles, each image a new Image."""
    import fnmatch

    from ..core import profile as prof

    if plus:
        for li in st.images:
            img = li.image
            li.image = Image(img.data, img.spec, img.properties, {
                k: v for k, v in img.profiles.items()
                if not fnmatch.fnmatch(k.lower(), arg.lower())},
                img.page, img.delay)
        return
    enforce_path(arg)
    with open(arg, "rb") as f:
        blob = f.read()
    for li, img in _materialized(st):
        li.image = prof.profile_image(img, blob)


def _set_mask(li: LazyImage, img: Image, mask) -> None:
    props = {k: v for k, v in img.properties.items() if k != "wand:mask"}
    if mask is not None:
        props["wand:mask"] = mask
    li.image = Image(img.data, img.spec, props, img.profiles, img.page,
                     img.delay)


def _op_clip(st, arg, plus):
    """-clip / -clip-path: the image's 8BIM clip path (or its ``clip-path``
    property) rasterized as its write mask (ClipImage / ClipImagePath);
    +clip removes it."""
    from ..io.coders_r4 import _clip_path_mask

    for li, img in _materialized(st):
        if plus:
            _set_mask(li, img, None)
            continue
        m = _clip_path_mask(img)
        if m is None:
            raise CLIError("image does not have a clip mask")
        _set_mask(li, img, m)


def _op_clip_mask(st, arg, plus):
    """-mask / -clip-mask / -read-mask / -write-mask FILE: the file's
    intensity (its gray channel, or ``enhance.grayscale`` of its color, as
    the ``mask:`` reader takes it) as each image's write mask, an (H, W) array kept on the host; the +
    forms remove it.  The JAX CLI keeps the file's every channel, an
    (H, W, C) array that no per-pixel option can broadcast: each raises
    there."""
    if plus or arg in (None, ""):
        for li in st.images:
            _set_mask(li, li.image, None)
        return
    from .. import io as iio
    from ..ops.enhance import grayscale

    mask = iio.read_images(arg, device=st.device)[0].data
    m = (grayscale(mask) if mask.shape[-1] >= 3 else mask)[..., 0]
    m = m.cpu().numpy()
    for li in st.images:
        _set_mask(li, li.image, m)


def _list_region(st, vals, plus):
    """-region GEOMETRY: a write mask over the gravity-adjusted rectangle
    (operation.c:3212), built on each image's device, so that later
    options change only its pixels; +region removes it.  A mask turns off
    the K1 tags, as in the JAX CLI, so a blur under it runs its op route
    (K3 on the card)."""
    from ..ops.composite import gravity_offset

    for li, img in _materialized(st):
        if plus:
            _set_mask(li, img, None)
            continue
        w, h, x, y = parse_page_geometry(vals[0], img.width, img.height)
        gx, gy = gravity_offset(st.settings.get("gravity", "northwest"),
                                img.width, img.height, w, h, x, y)
        gx, gy = max(gx, 0), max(gy, 0)
        m = torch.zeros((img.height, img.width), dtype=torch.float32,
                        device=img.data.device)
        m[gy:gy + h, gx:gx + w] = 1.0
        _set_mask(li, img, m)


def _read_passphrase(arg: str) -> str:
    import os

    enforce_path(arg)
    if os.path.isfile(arg):
        with open(arg, "r") as f:
            return f.read()
    return arg


def _op_encipher(st, arg, plus, decipher=False):
    """-encipher / -decipher PASSPHRASE (or a file holding it): AES-CTR
    over each image's quantum rows (``utils/signature.py``), the keystream
    and the quantization on the host."""
    from ..utils.signature import decipher_image, encipher_image

    pp = _read_passphrase(arg)
    fn = decipher_image if decipher else encipher_image
    for li, img in _materialized(st):
        li.image = img.replace(data=fn(img.data, pp, depth=img.spec.depth))


def _op_process_module(st, arg, plus):
    raise CLIError("no filter modules are registered (-process); module.c "
                   "dynamic loading is replaced by Python imports")


def _op_map(st, arg, plus):
    """-remap / -map FILE: RemapImage onto the file's colors, as the JAX
    CLI runs it: the dither setting maps to "none" (+dither, false or
    empty), "fs" (FloydSteinberg) or "riemersma" (anything else, the
    default), and the native octree library (``native/riemersma.cpp``)
    remaps each (H, W, C) frame on the host; the result goes back to the
    image's device.  A frame that is not (H, W, C) takes
    ``quantize.remap``, which raises under a dither (the palette walks are
    not ported).  A library that does not build raises."""
    from .. import io as iio
    from .. import native
    from ..ops import quantize as qz

    pal_img = iio.read_images(arg, device=st.device)[0]
    pal = pal_img.data.reshape(-1, pal_img.channels)
    pal_np = pal.cpu().numpy().astype(np.float32)
    meth = st.settings.get("dither", "riemersma").lower()
    dither = {"none": "none", "false": "none", "": "none",
              "floydsteinberg": "fs", "fs": "fs"}.get(meth, "riemersma")
    for li, img in _materialized(st):
        if img.data.dim() == 3:
            res = native.octree_remap(img.to_numpy(), pal_np, dither)
            li.image = img.replace(
                data=torch.from_numpy(res).to(img.data.device))
        else:
            li.image = img.replace(data=qz.remap(
                img.data, pal[:, :img.channels].to(img.data.device),
                dither != "none"))


def _op_texture(st, path: str) -> None:
    """-texture FILE: each image replaced by the file tiled over it."""
    from .. import io as iio

    tex = iio.read_images(path, device=st.device)[0]
    for li, img in _materialized(st):
        ry = -(-img.height // tex.height)
        rx = -(-img.width // tex.width)
        tiled = tex.data.repeat(ry, rx, 1)[:img.height, :img.width]
        li.image = Image(tiled[..., :img.channels], img.spec)


def _read_into(st, target: str) -> None:
    """Read ``target`` onto the list (a bare file name or -read), on the
    state's device; a pending -extract crops each frame."""
    from .. import io as iio
    from ..ops import transform as tf

    frames = iio.read_images(target, size=st.size,
                             settings=dict(st.settings, defines=st.defines),
                             device=st.device)
    extract = st.settings.pop("extract", None)
    if extract:
        cut = []
        for im in frames:
            w, h, x, y = parse_page_geometry(extract, im.width, im.height)
            cut.append(im.replace(data=tf.excerpt(im.data, x, y, w, h)))
        frames = cut
    st.images += [LazyImage(im) for im in frames]


def _looks_like_output(tok: str) -> bool:
    """Whether the last bare token names where to write: a ``fmt:`` prefix
    of a format the port or the JAX package writes (the latter raise when
    written), a name with an extension, or ``-``."""
    if ":" in tok:
        from ..io import known_write_formats

        return tok.split(":", 1)[0].lower() in known_write_formats()
    return "." in tok or tok == "-"


def _write_output(st, target: str) -> None:
    """Write the list to ``target``: same-shape images share their K1
    launch (``materialize_all``), and the pixels come to the host once."""
    from .. import io as iio

    imgs = materialize_all(st.images)
    if not imgs:
        raise CLIError("no image to write")
    iio.write_image(imgs if len(imgs) > 1 else imgs[0], target,
                    quality=int(st.settings["quality"]),
                    depth=st.depth, settings={"defines": st.defines})


def _list_main(what: str) -> None:
    """-list: the registries that the port has (option.c MagickList)."""
    w = what.lower()
    if w == "format":
        from ..io import supported_read_formats, supported_write_formats

        reads = set(supported_read_formats())
        writes = set(supported_write_formats())
        for fmt in sorted(reads | writes):
            mode = ("r" if fmt in reads else "-") + \
                ("w" if fmt in writes else "-")
            print(f"{fmt.upper():12s} {mode}")
    elif w == "colorspace":
        from ..ops.colorspace import supported_colorspaces

        print("\n".join(supported_colorspaces()))
    elif w == "filter":
        from ..ops.resize import supported_filters

        print("\n".join(supported_filters()))
    elif w == "metric":
        from ..ops.compare import _METRICS

        print("\n".join(sorted(_METRICS)))
    elif w == "color":
        from ..core.color import color_names

        print("\n".join(color_names()))
    elif w == "kernel":
        print("\n".join(_KERNEL_NAMES))
    elif w == "threshold":
        from ..ops.threshold import threshold_map_names

        print("\n".join(threshold_map_names()))
    elif w == "morphology":
        print("\n".join(_MORPHOLOGY_METHODS))
    elif w == "resource":
        from ..core.resource import resources

        for k, v in resources.report().items():
            lim = "unlimited" if v["limit"] == float("inf") \
                else f"{v['limit']:.0f}"
            print(f"{k}: limit={lim}")
    elif w == "policy":
        from ..core.policy import policy as pol

        for d, pat, rights in pol.rules:
            print(f"domain={d} pattern={pat} "
                  f"rights={','.join(sorted(rights))}")
        if not pol.rules:
            print("(open policy: no restrictions)")
    elif w == "gravity":
        from ..ops.composite import GRAVITIES

        print("\n".join(GRAVITIES))
    elif w == "compose":
        from ..ops.composite import _BLEND_FNS

        print("\n".join(sorted(_COMPOSE_BASE + list(_BLEND_FNS))))
    elif w == "noise":
        print("\n".join(["uniform", "gaussian", "impulse", "laplacian",
                         "multiplicative", "poisson", "random"]))
    elif w == "delegate":
        from ..io.delegates import list_delegates

        for k, v in list_delegates().items():
            print(f"{k}: {'available' if v else 'missing'}")
    else:
        raise CLIError(f"unknown list type {what!r}")


_KERNEL_NAMES = ["unity", "gaussian", "dog", "log", "blur", "comet",
                 "laplacian", "sobel", "roberts", "prewitt", "compass",
                 "kirsch", "freichen", "diamond", "square", "octagon",
                 "disk", "plus", "cross", "ring", "rectangle", "corners",
                 "lineends", "linejunctions", "edges", "peaks", "skeleton",
                 "chebyshev", "manhattan", "euclidean"]
_MORPHOLOGY_METHODS = ["convolve", "correlate", "erode", "dilate",
                       "erodeintensity", "dilateintensity", "open", "close",
                       "openintensity", "closeintensity", "smooth", "edge",
                       "edgein", "edgeout", "tophat", "bottomhat",
                       "hitandmiss", "thinning", "thicken", "distance"]
_COMPOSE_BASE = ["over", "dstover", "in", "dstin", "out", "dstout", "atop",
                 "dstatop", "xor", "plus", "copy", "dst", "clear",
                 "dissolve", "blend", "mathematics", "threshold",
                 "changemask", "stereo", "bumpmap", "copyred", "copygreen",
                 "copyblue", "copyalpha", "hue", "saturate", "luminize",
                 "colorize", "lightenintensity", "darkenintensity"]


# option name -> (number of arguments, handler)
OPS: Dict[str, Tuple[int, Callable]] = {
    # the resize family
    "resize": (1, _op_resize),
    "adaptive-resize": (1, partial(_op_resize, op="adaptive-resize")),
    "scale": (1, partial(_op_resize, op="scale")),
    "sample": (1, partial(_op_resize, op="sample")),
    "thumbnail": (1, partial(_op_resize, op="thumbnail")),
    "magnify": (0, _op_magnify),
    # blurs and color
    "blur": (1, _op_blur("blur", "1d")),
    "gaussian-blur": (1, _op_blur("gaussian_blur", "2d")),
    "colorspace": (1, _op_colorspace),
    "negate": (0, _op_simple("enhance", "negate",
                             lambda st, a, p: {"grayscale_only": p})),
    "gamma": (1, _op_simple("enhance", "gamma",
                            lambda st, a, p: _gamma_arg(a))),
    "level": (1, _op_simple("enhance", "level", lambda st, a, p: dict(zip(
        ("black_point", "white_point", "gamma_"), _parse_level_arg(a))))),
    "auto-level": (0, _op_simple("enhance", "auto_level")),
    "auto-gamma": (0, _op_simple("enhance", "auto_gamma")),
    "normalize": (0, _op_simple("enhance", "normalize")),
    "equalize": (0, _op_simple("enhance", "equalize")),
    "contrast-stretch": (1, _op_simple("enhance", "contrast_stretch",
                                       lambda st, a, p: _stretch_args(a))),
    "linear-stretch": (1, _op_simple("enhance", "linear_stretch",
                                     lambda st, a, p: _stretch_args(a))),
    "sigmoidal-contrast": (1, _op_simple(
        "enhance", "sigmoidal_contrast",
        lambda st, a, p: _sigmoidal_args(a, not p))),
    "brightness-contrast": (1, _op_simple("enhance", "brightness_contrast",
                                          lambda st, a, p: _bc_args(a))),
    "modulate": (1, _op_simple("enhance", "modulate",
                               lambda st, a, p: _modulate_args(a))),
    "clahe": (1, _op_clahe),
    "white-balance": (0, _op_simple("enhance", "white_balance")),
    "enhance": (0, _op_simple("enhance", "enhance")),
    # thresholds
    "threshold": (1, _op_simple("threshold", "bilevel", _threshold_arg)),
    "black-threshold": (1, _op_simple("threshold", "black_threshold",
                                      _threshold_arg)),
    "white-threshold": (1, _op_simple("threshold", "white_threshold",
                                      _threshold_arg)),
    "auto-threshold": (1, _op_auto_threshold),
    "ordered-dither": (1, _op_simple("threshold", "ordered_dither",
                                     lambda st, a, p: _dither_args(a))),
    "random-threshold": (1, _op_simple(
        "threshold", "random_threshold",
        lambda st, a, p: _random_thresh_args(a), seeded=True)),
    "lat": (1, _op_simple("threshold", "adaptive_threshold",
                          lambda st, a, p: _lat_args(a))),
    "clamp": (0, _op_simple("threshold", "clamp")),
    # blur's effects
    "sharpen": (1, _op_simple("blur", "sharpen", _rs_vp)),
    "unsharp": (1, _op_simple("blur", "unsharp_mask",
                              lambda st, a, p: _unsharp_args(a))),
    "edge": (1, _op_simple("blur", "edge_image",
                           lambda st, a, p: {"radius": _geom_args(a)[0]})),
    "adaptive-blur": (1, _op_simple("blur", "adaptive_blur", _rs)),
    "adaptive-sharpen": (1, _op_simple("blur", "adaptive_sharpen", _rs)),
    "motion-blur": (1, _op_simple("blur", "motion_blur",
                                  lambda st, a, p: _motion_args(a))),
    "rotational-blur": (1, _op_simple("blur", "rotational_blur",
                                      lambda st, a, p: {"angle": float(a)})),
    "bilateral-blur": (1, _op_simple("blur", "bilateral_blur",
                                     lambda st, a, p: _bilateral_args(a))),
    "kuwahara": (1, _op_simple("blur", "kuwahara",
                               lambda st, a, p: _kuwahara_args(a))),
    "despeckle": (0, _op_simple("blur", "despeckle")),
    "emboss": (1, _op_simple("blur", "emboss", _rs)),
    "shade": (1, _op_simple("blur", "shade", lambda st, a, p: _shade_args(a))),
    "spread": (1, _op_simple("blur", "spread",
                             lambda st, a, p: {"radius": float(a)},
                             seeded=True)),
    "selective-blur": (1, _op_simple("blur", "selective_blur",
                                     lambda st, a, p: _selective_args(a))),
    # rank filters and value maps
    "statistic": (2, _op_statistic),
    "median": (1, _op_median),
    "evaluate": (2, _op_evaluate),
    "function": (2, _op_function),
    # list operators
    "composite": (0, _op_composite_list),
    "compare": (0, _op_compare_list),
    "fx": (1, _op_fx),
    "morph": (1, _op_morph),
    "evaluate-sequence": (1, _op_eval_seq),
    "average": (0, lambda st, a, p: _op_eval_seq(st, "mean", p)),
    "maximum": (0, lambda st, a, p: _op_eval_seq(st, "max", p)),
    "minimum": (0, lambda st, a, p: _op_eval_seq(st, "min", p)),
    # channels
    "separate": (0, _op_separate),
    "combine": (0, _op_combine),
    "alpha": (1, _op_alpha),
    "matte": (0, lambda st, a, p: _op_alpha(st, "off" if p else "set", p)),
    "channel-fx": (1, _op_channel_fx),
    # quantization and attributes
    "posterize": (1, _op_posterize),
    "colors": (1, _op_colors),
    "kmeans": (1, _op_kmeans),
    "unique-colors": (0, _op_unique_colors),
    "type": (1, _op_type),
    "remap": (1, _op_map),
    "map": (1, _op_map),
    # geometry
    "crop": (1, partial(_op_geometry_slice, op="crop")),
    "chop": (1, partial(_op_geometry_slice, op="chop")),
    "extent": (1, partial(_op_geometry_slice, op="extent")),
    "shave": (1, partial(_op_geometry_slice, op="shave")),
    "splice": (1, partial(_op_geometry_slice, op="splice")),
    "roll": (1, partial(_op_geometry_slice, op="roll")),
    "trim": (0, partial(_op_geometry_slice, op="trim")),
    "flip": (0, _op_simple("transform", "flip")),
    "flop": (0, _op_simple("transform", "flop")),
    "transpose": (0, _op_transpose("transpose")),
    "transverse": (0, _op_transpose("transverse")),
    "rotate": (1, _op_rotate),
    "border": (1, _op_border),
    "auto-orient": (0, _op_auto_orient),
    # distortions
    "implode": (1, _op_simple("distort", "implode",
                              lambda st, a, p: {"amount": float(a)})),
    "swirl": (1, _op_simple("distort", "swirl",
                            lambda st, a, p: {"degrees": float(a)})),
    "wave": (1, _op_wave),
    "distort": (2, _op_distort),
    "sparse-color": (2, _op_sparse_color),
    "liquid-rescale": (1, _op_liquid),
    "transform": (0, _op_transform),
    "shear": (1, _op_shear),
    "deskew": (1, _op_deskew),
    # paint, feature, vision and segment
    "paint": (1, _op_simple("paint", "oil_paint", lambda st, a, p: {
        "radius": max(_geom_args(a)[0], 1.0)})),
    "oil-paint": (1, _op_simple("paint", "oil_paint", lambda st, a, p: {
        "radius": max(_geom_args(a)[0], 1.0)})),
    "opaque": (1, _op_opaque),
    "transparent": (1, _op_transparent),
    "floodfill": (2, _op_floodfill),
    "canny": (1, _op_simple("feature", "canny_edge",
                            lambda st, a, p: _canny_args(a))),
    "mean-shift": (1, _op_simple("feature", "mean_shift",
                                 lambda st, a, p: _meanshift_args(a))),
    "connected-components": (1, _op_ccl),
    "segment": (1, _op_segment),
    "hough-lines": (1, _op_hough),
    "features": (1, _op_features),
    # draw and decorate
    "draw": (1, _op_draw),
    "annotate": (2, _op_annotate),
    "frame": (1, _op_frame),
    "raise": (1, _op_raise),
    # layers and montage
    "layers": (1, _op_layers),
    "coalesce": (0, _op_layer_list("coalesce")),
    "deconstruct": (0, _op_layer_list("deconstruct")),
    "flatten": (0, _op_flatten),
    "mosaic": (0, _op_mosaic),
    "append": (0, _op_append),
    "smush": (1, _op_smush),
    "montage": (0, _op_montage),
    # visual effects
    "sketch": (1, _op_simple("visual_effects", "sketch", _sketch_args,
                             seeded=True)),
    "charcoal": (1, _op_simple("visual_effects", "charcoal", _rs)),
    "wavelet-denoise": (1, _op_simple("visual_effects", "wavelet_denoise",
                                      lambda st, a, p: _wavelet_args(a))),
    "sepia-tone": (1, _op_simple("visual_effects", "sepia_tone",
                                 _threshold_arg)),
    "solarize": (1, _op_simple("visual_effects", "solarize",
                               _threshold_arg)),
    "blue-shift": (1, _op_simple("visual_effects", "blue_shift",
                                 lambda st, a, p: {"factor": float(a)})),
    "tint": (1, _op_tint),
    "colorize": (1, _op_colorize),
    "color-matrix": (1, _op_color_matrix),
    "recolor": (1, _op_color_matrix),
    "vignette": (1, _op_vignette),
    "noise": (1, _op_noise),
    "shadow": ("?", _op_shadow),
    "polaroid": (1, _op_polaroid),
    "stegano": (1, _op_stegano),
    "stereo": (1, _op_stereo),
    # the options that need no file
    "morphology": (2, _op_morphology),
    "convolve": (1, _op_convolve),
    "fft": (0, _op_fft),
    "ift": (0, _op_ift),
    "complex": (1, _op_complex),
    "clut": (0, _op_clut),
    "hald-clut": (0, _op_hald_clut),
    "cdl": (1, _op_cdl),
    "level-colors": (1, _op_level_colors),
    "levelize": (1, _op_simple("enhance", "levelize", lambda st, a, p: dict(
        zip(("black_point", "white_point", "gamma_"),
            _parse_level_arg(a))))),
    "contrast": (0, _op_contrast),
    "local-contrast": (1, _op_simple("enhance", "local_contrast",
                                     lambda st, a, p: dict(zip(
                                         ("radius", "strength"),
                                         _geom_args(a))))),
    "grayscale": (1, _op_grayscale),
    "monochrome": (0, _op_monochrome),
    "range-threshold": (1, _op_range_threshold),
    "color-threshold": (1, _op_color_threshold),
    "perceptible": (1, _op_simple("threshold", "perceptible",
                                  lambda st, a, p: {"epsilon": float(a)})),
    "integral": (0, _op_integral),
    "moments": (0, _op_moments),
    "sort-pixels": (0, _op_sort_pixels),
    "resample": (1, _op_resample),
    "interpolative-resize": (1, _op_interpolative_resize),
    "gaussian": (1, _op_blur("gaussian_blur", "2d")),
    "poly": (1, _op_poly),
    "noop": (0, lambda st, a, p: None),
    "orient": (1, _op_orient),
    "duplicate": (1, _op_duplicate),
    "insert": (1, _op_insert),
    "cycle": (1, _op_cycle),
    "preview": (1, _op_preview),
    "affinity": (1, _op_map),
    # core/'s services and the options that read files
    "profile": (1, _op_profile),
    "clip": (0, _op_clip),
    "clip-path": (1, _op_clip),
    "clip-mask": (1, _op_clip_mask),
    "read-mask": (1, _op_clip_mask),
    "write-mask": (1, _op_clip_mask),
    "mask": (1, _op_clip_mask),
    "encipher": (1, partial(_op_encipher, decipher=False)),
    "decipher": (1, partial(_op_encipher, decipher=True)),
    "process": (1, _op_process_module),
}

# the settings ``process`` stores (the JAX CLI's ``_SETTINGS``,
# ``cli/main.py:2357-2391``): the + forms of dither, gravity and compose
# reset theirs; -seed seeds the random options' generators
_SETTINGS = {
    "background", "fill", "gravity", "filter", "quality", "fuzz", "dither",
    "page", "tile", "texture-setting", "units", "weight", "style",
    "endian", "antialias", "transparent-color", "interlace",
    "colors-setting", "treedepth", "kerning", "direction",
    "virtual-pixel", "interpolate", "compose", "font", "pointsize",
    "bordercolor", "mattecolor", "stroke", "strokewidth", "density",
    "dispose", "delay", "loop", "channel", "intent", "interlace",
    "sampling-factor", "attenuate", "seed",
    "affine", "authenticate", "blue-primary", "green-primary",
    "red-primary", "white-point", "undercolor", "box", "compress",
    "encoding", "family", "intensity", "metric", "mode", "path",
    "precision", "quantize", "scene", "stretch", "tile-offset", "title",
    "view", "render", "black-point-compensation", "highlight-color",
    "lowlight-color", "gravity-setting", "blend", "displace", "dissolve",
    "watermark", "modulate-setting", "remap-setting", "caption-setting",
    "adjoin", "bias", "borderwidth", "cache", "caption",
    "dissimilarity-threshold", "similarity-threshold", "duration",
    "illuminant", "interline-spacing", "interword-spacing", "log",
    "scenes", "subimage", "subimage-search", "text-font", "word-break",
    "colormap", "reshape", "name", "sans", "sans1", "display",
}

# zero-argument flags: stored as "1" ("0" for the + form), no other effect
_FLAGS = {
    "quiet", "regard-warnings", "respect-parentheses", "respect-parenthesis",
    "synchronize", "taint", "ping", "antialias-flag", "render-flag",
    "concurrent", "flicker", "unique", "precision-flag", "sans0",
    "backdrop", "descend", "foreground", "iconic", "immutable", "remote",
    "screen", "shared-memory", "silent", "snaps", "update", "use-pixmap",
    "visual", "window", "window-group", "pause",
}

# options whose + form takes no argument, as in ImageMagick (the JAX CLI
# takes the next token as their argument: ``+mask -negate`` drops the
# -negate there)
_PLUS_TAKES_NONE = {"mask", "clip-mask", "read-mask", "write-mask"}


def _arg(args: List[str], i: int, tok: str, n: int = 1) -> List[str]:
    if i + n > len(args):
        raise CLIError(f"option requires an argument {tok!r}")
    return args[i:i + n]


# the options ``process`` runs itself, by their number of arguments
_INLINE_ARITY = {"size": 1, "read": 1, "script": 1, "extract": 1,
                 "bench": 1,
                 "texture": 1, "depth": 1, "write": 1, "list": 1,
                 "format": 1, "print": 1, "debug": 1, "limit": 2,
                 "identify": 0, "version": 0, "monitor": 0, "verbose": 0}


def option_arity(tok: str, args: Sequence[str], i: int) -> Optional[int]:
    """How many of the tokens ``args[i:]`` after option ``tok`` are its
    arguments, as ``process`` takes them; None for an option the CLI does
    not know.  The serve daemon's validators walk a request with it, so
    they count each option's arguments as ``process`` does."""
    plus = tok.startswith("+")
    name = tok[1:]
    nxt = args[i] if i < len(args) else None
    if name in _INLINE_ARITY:
        return _INLINE_ARITY[name]
    if name in _SETTINGS or name in ("define", "geometry"):
        return 0 if plus and name in ("dither", "gravity", "compose") else 1
    if name in _FLAGS or name in ("exit", "reverse", "strip"):
        return 0
    if name in ("sans2", "set", "copy"):
        return 2
    if name in ("label", "comment"):
        return 1
    if name in ("repage", "region"):
        return 0 if plus else 1
    if name in ("clone", "delete"):
        # an optional index list; +clone takes none
        return int(nxt is not None and not (plus and name == "clone")
                   and re.match(r"^-?\d", nxt) is not None)
    if name == "swap":
        return int(nxt is not None and ("," in nxt or
                                        nxt.lstrip("+-").isdigit()))
    if name in OPS:
        n = OPS[name][0]
        if n == "?":    # one optional argument (-shadow)
            return int(nxt is not None and _optional_arg(nxt))
        return 0 if plus and name in _PLUS_TAKES_NONE else n
    return None


def process(args: Sequence[str], st: Optional[CLIState] = None) -> CLIState:
    """ProcessCommandOptions analog: sequential option interpreter over
    the images already in ``st`` (a new state has none, on the card).  A
    bare token reads a file onto the list, or, where it is the last token
    and looks like an output name, writes the list there."""
    if st is None:
        st = CLIState()
    args = list(args)
    i = 0
    while i < len(args):
        tok = args[i]
        i += 1
        for li in st.images:
            li.shard = st.shard
        if tok == "(":
            st.stack.append(st.images)
            st.images = []
            if st.settings.get("respect-parentheses") == "1" or \
                    st.settings.get("respect-parenthesis") == "1":
                st.settings_stack.append(dict(st.settings))
            continue
        if tok == ")":
            if not st.stack:
                raise CLIError("unbalanced parenthesis")
            parent = st.stack.pop()
            st.images = parent + st.images
            if st.settings_stack:
                st.settings = st.settings_stack.pop()
            continue
        if not tok.startswith(("-", "+")) or tok == "-":
            if i == len(args) and st.images and _looks_like_output(tok):
                _write_output(st, tok)
            else:
                _read_into(st, tok)
            continue
        plus = tok.startswith("+")
        name = tok[1:]
        n = option_arity(tok, args, i)
        if n is None:
            raise CLIError(f"unrecognized option {tok!r}")
        vals = _arg(args, i, tok, n)
        i += n
        if name == "exit":
            break
        if name in _INLINE_ARITY:
            _inline(st, name, vals, args, i)
        elif name in _SETTINGS or name in ("define", "geometry"):
            _setting(st, name, vals, plus)
        elif name in _FLAGS:
            st.settings[name] = "0" if plus else "1"
        elif name in _LIST_OPTIONS:
            _LIST_OPTIONS[name](st, vals, plus)
        elif name == "label":
            _op_label(st, vals[0])
        elif name == "repage":
            _op_repage(st, vals[0] if vals else None, plus)
        elif name in OPS:
            st.require_images("-" + name)
            OPS[name][1](st, " ".join(vals) if vals else None, plus)
        # -sans2 takes two arguments and does nothing
    return st


def _setting(st: CLIState, name: str, vals: List[str], plus: bool) -> None:
    """Store a setting: the + forms of dither, gravity and compose reset
    theirs, +define removes its key, -seed seeds the random options."""
    if plus and name == "dither":
        st.settings[name] = "none"
    elif plus and name in ("gravity", "compose"):
        st.settings[name] = "undefined" if name == "gravity" else "over"
    elif name == "define":
        key, _, val = vals[0].partition("=")
        if plus:
            st.defines.pop(key, None)
        else:
            st.defines[key] = val
        if key == "tpu:mesh":
            _set_shard_mesh(st, None if plus else val,
                            st.defines.get("tpu:shard-threshold"))
        elif key == "tpu:shard-threshold" and "tpu:mesh" in st.defines:
            _set_shard_mesh(st, st.defines.get("tpu:mesh"),
                            None if plus else val)
    elif name == "geometry":
        st.settings["compose-geometry"] = vals[0]
    else:
        st.settings[name] = vals[0]
        if name == "seed":
            st.seed = int(vals[0])


def _set_shard_mesh(st: CLIState, spec: Optional[str],
                    threshold: Optional[str] = None) -> None:
    """Set (or clear) ``-define tpu:mesh=SYxSX`` (or ``DPxSYxSX``) and
    ``tpu:shard-threshold`` as the JAX CLI's ``_set_shard_mesh`` does:
    a wrong number of parts is its CLIError, a part or threshold that is
    no integer its ValueError, and a mesh of more devices than the port
    has (``parallel.mesh.local_devices`` of the state's device: the cards
    for a card run, one for the CPU) make_mesh's ValueError.  The mesh
    and the threshold (4 Mi pixels by default) go to ``st.shard``, which
    ``LazyImage.materialize`` reads (``_shard_mesh``)."""
    from ..parallel import mesh as pm

    if not spec:
        st.shard = None
        return
    parts = [int(p) for p in spec.lower().replace("x", ",").split(",") if p]
    if len(parts) == 2:
        dp, (sy, sx) = 1, parts
    elif len(parts) == 3:
        dp, sy, sx = parts
    else:
        raise CLIError(f"bad tpu:mesh geometry {spec!r} (want SYxSX)")
    mesh = pm.make_mesh(dp, sy, sx, devices=pm.local_devices(st.device))
    minpx = int(threshold) if threshold else 4 * 1024 * 1024
    st.shard = (mesh, minpx)


def _inline(st: CLIState, name: str, vals: List[str], args: List[str],
            i: int) -> None:
    """The options ``process`` handles itself: the readers' settings, the
    writers, the services of core/ and the informational options."""
    if name == "size":
        st.size = vals[0]
    elif name == "read":
        _read_into(st, vals[0])
    elif name == "script":
        # the script's tokens (shell-style, with comments) run next
        import shlex

        enforce_path(vals[0])
        with open(vals[0], "r", encoding="utf-8") as fh:
            args[i:i] = shlex.split(fh.read(), comments=True)
    elif name == "bench":
        _bench_rest(st, int(vals[0]), args[i:])
    elif name == "extract":
        st.settings["extract"] = vals[0]
    elif name == "texture":
        _op_texture(st, vals[0])
    elif name == "depth":
        st.depth = int(vals[0])
    elif name == "write":
        _write_output(st, vals[0])
    elif name == "list":
        _list_main(vals[0])
    elif name == "format":
        st.settings["format"] = vals[0]
    elif name == "print":
        from ..core.properties import interpret

        img = materialize_all(st.images[-1:])[0] if st.images else None
        print(interpret(vals[0], img) if img is not None else vals[0],
              end="")
    elif name == "debug":
        from ..core.log import log

        log.set_log_event_mask(vals[0])
    elif name == "limit":
        from ..core.resource import resources

        resources.set_limit(vals[0], vals[1])
    elif name == "identify":
        from ..io import identify as ident

        verbose = st.settings.get("verbose") == "1"
        for img in materialize_all(st.images):
            print(ident.describe(img, "image", verbose))
    elif name == "version":
        print("Version: imagemagick_tpu_torch (magick-compatible, PyTorch "
              "and CUDA)")
    elif name == "verbose":
        st.settings["verbose"] = "1"
    # -monitor: progress display is a no-op under batch execution


def _bench_rest(st, n: int, rest: List[str]) -> None:
    """-bench N inside a command: the rest of it runs N - 1 times, each in
    a new state with this one's settings, and then once more in this state
    (by ``process``, after this returns), as the JAX CLI does
    (utilities/magick.c -bench).  Prints ``Performance: Ni IPSips
    SECONDSu`` on stderr over the N - 1 runs.  Where the rest ends in a
    write, as a command does, each run's time holds the card's work,
    since a write brings the pixels to the host; the first run holds the
    kernels' first build, as the JAX CLI's holds XLA's compilation."""
    import time

    n = max(n, 1)
    start = time.time()
    for _ in range(n - 1):
        sub = CLIState(st.device)
        sub.settings.update(st.settings)
        process(list(rest), sub)
    if n > 1:
        elapsed = max(time.time() - start, 1e-9)
        print(f"Performance: {n}i {(n - 1) / elapsed:.3f}ips "
              f"{elapsed:.3f}u", file=sys.stderr)


# -- the list and metadata options the JAX CLI handles in its loop ---------

def _indices(spec: str, n: int) -> List[int]:
    """A comma list of indices and ranges ("0,2", "1-3", "-1") in a list of
    ``n``, in order, negative ones counted from the end (mogrify.c)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if "-" in part[1:]:
            lo, _, hi = part.rpartition("-")
            out += list(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def _list_clone(st, vals, plus):
    """+clone / bare -clone: a copy of the last image of the list before
    the parenthesis; -clone takes comma lists and ranges."""
    src = st.stack[-1] if st.stack else st.images
    picks = [src[k] for k in _indices(vals[0], len(src))] if vals \
        else [src[-1]]
    st.images += [LazyImage(im) for im in materialize_all(picks)]


def _list_delete(st, vals, plus):
    """-delete INDEXES (+delete, or no index: the last image)."""
    n = len(st.images)
    drop = {k if k >= 0 else n + k
            for k in _indices(vals[0] if vals else "-1", n)}
    st.images = [li for k, li in enumerate(st.images) if k not in drop]


def _list_swap(st, vals, plus):
    """-swap A,B (default -2,-1: the last two)."""
    a, _, b = (vals[0] if vals else "-2,-1").partition(",")
    ia, ib = int(a), int(b or -1)
    st.images[ia], st.images[ib] = st.images[ib], st.images[ia]


def _list_reverse(st, vals, plus):
    st.images.reverse()


def _list_set(st, vals, plus):
    """-set KEY VALUE: a property of every image of the list."""
    key, value = vals[0].lstrip("-+"), vals[1]
    for li in st.images:
        _replaced(li, properties=dict(li.image.properties, **{key: value}))


def _list_comment(st, vals, plus):
    for li in st.images:
        _replaced(li, properties=dict(li.image.properties,
                                      comment=vals[0]))


def _list_strip(st, vals, plus):
    """-strip: every image's properties and profiles dropped."""
    for li in st.images:
        img = li.image
        li.image = Image(img.data, img.spec, None, None, img.page, img.delay)


def _list_copy(st, vals, plus):
    """-copy GEOMETRY OFFSET: a region of the second-to-last image copied
    into the last at OFFSET."""
    geom, off = vals
    if len(st.images) >= 2:
        src, dst = materialize_all(st.images[-2:])
        w, h, sx, sy = parse_page_geometry(geom, src.width, src.height)
        og = parse_geometry(off)
        dx, dy = int(og.x or 0), int(og.y or 0)
        data = dst.data.clone()
        data[dy:dy + h, dx:dx + w, :] = \
            src.data[sy:sy + h, sx:sx + w, :dst.channels]
        st.images[-1].image = dst.replace(data=data)


# option name -> handler(state, its arguments, plus form); their counts
# are ``option_arity``'s
_LIST_OPTIONS = {"clone": _list_clone, "delete": _list_delete,
                 "swap": _list_swap, "reverse": _list_reverse,
                 "set": _list_set, "comment": _list_comment,
                 "strip": _list_strip, "copy": _list_copy,
                 "region": _list_region}


def _optional_arg(tok: str) -> bool:
    """Whether the token after an option of one optional argument is that
    argument: not an option and not what the JAX CLI takes for an output
    file name."""
    return not tok.startswith(("-", "+")) and "." not in tok and \
        ":" not in tok


def materialize_all(lazies: List[LazyImage]) -> List[Image]:
    """Materialize a list of lazy images, batching same-shape images
    whose chains share a tagged prefix into ONE K1 launch for that
    prefix (``dispatch.try_fused_batch``); the rest of each chain then
    runs image by image.  A fully tagged group that dispatch declines
    runs its chain once on the stacked group as PyTorch ops (its ops act
    on each image alone); every other image materializes alone."""
    from ..ops import dispatch as _dsp

    groups: Dict[tuple, List[int]] = {}
    for idx, li in enumerate(lazies):
        d = li.image.data
        if not li.pending or d.dim() != 3:
            continue
        tags = [t for _, _, t in li.pending]
        n = _dsp.match_prefix(tags)
        if n == 0:
            continue
        key = (tuple(map(int, d.shape)), d.device, tuple(tags[:n]),
               n == len(tags), bool(li.image.spec.alpha))
        groups.setdefault(key, []).append(idx)
    for (_, _, prefix, whole, has_alpha), idxs in groups.items():
        if len(idxs) < 2:
            continue
        datas = [lazies[i].image.data for i in idxs]
        out = _dsp.try_fused_batch(datas, list(prefix), alpha=has_alpha)
        if out is None:
            if not whole:
                continue      # each image runs its own chain below
            # equal tags mean equal ops: run the first image's chain on all
            out = _run_ops(torch.stack(datas), lazies[idxs[0]].pending)
        for j, i in enumerate(idxs):
            lazies[i]._settle(out[j], len(prefix))
    return [li.materialize() for li in lazies]


_TOOLS = ("convert", "mogrify", "identify", "compare", "composite",
          "montage", "conjure", "animate", "display", "stream", "import")


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    """The command line: ``argv`` (``sys.argv[1:]`` by default) on
    ``device``, as the JAX CLI's ``main`` takes it.  A first word that
    names a tool runs that tool (``_TOOLS``); anything else is the
    magick/convert dialect through ``process``, with ``-bench N`` (the
    whole command N times, ``tools.bench_run``) and ``-script FILE``
    taken first.  Returns the exit code; a CLI error, a missing file or
    a bad value prints ``tmagick: ...`` and returns 1."""
    argv = list(sys.argv[1:] if argv is None else argv)
    tool = argv.pop(0) if argv and argv[0] in _TOOLS else "magick"
    try:
        from . import tools

        if tool == "identify":
            return _identify_main(argv, device)
        if tool == "compare":
            return _compare_main(argv, device)
        if tool == "mogrify":
            return tools.mogrify_main(argv, device)
        if tool == "composite":
            return tools.composite_main(argv, device)
        if tool == "montage":
            return tools.montage_main(argv, device)
        if tool == "conjure":
            return tools.conjure_main(argv, device)
        if tool in ("animate", "display"):
            return tools.display_main(argv, tool == "animate", device)
        if tool == "stream":
            return _stream_main(argv, device)
        if tool == "import":
            # import.c captures an X11 screen region: there is no X server
            print("tmagick: import: X11 screen capture is not supported "
                  "in this headless build (utilities/magick.c:83-99 "
                  "multicall name)", file=sys.stderr)
            return 1
        if "-bench" in argv:
            i = argv.index("-bench")
            n = int(argv[i + 1])
            rest = [a for a in argv[:i] + argv[i + 2:] if a != "-concurrent"]
            return tools.bench_run(rest, n, device=device)
        if "-script" in argv:
            # the JAX main's rule: the options before -script, then the
            # script's tokens (one line after another, # comments out)
            i = argv.index("-script")
            enforce_path(argv[i + 1])
            with open(argv[i + 1]) as f:
                script_args = _tokenize_script(f.read())
            st = process(argv[:i], CLIState(device))
            process(script_args, st)
            return 0
        return process(argv, CLIState(device)).exit_code
    except (CLIError, FileNotFoundError, ValueError) as e:
        print(f"tmagick: {e}", file=sys.stderr)
        return 1


def _tokenize_script(text: str) -> List[str]:
    """magick -script tokenizer (MagickWand/script-token.c): whitespace
    separated, quotes and # comment lines honored."""
    import shlex

    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        out.extend(shlex.split(line))
    return out


def _stream_main(argv, device="cuda") -> int:
    """stream: a region of a file's first frame as raw samples, without
    the option chain (stream.c): ``-extract GEOMETRY``, ``-storage-type``
    (``char``, or ``short``/``uint16`` for 16 bits) and ``-map`` (``i``
    for gray, a map with ``a`` for RGBA where the image has alpha, else
    RGB) into ``encode_raw``; ``-`` writes stdout."""
    from .. import io as iio
    from ..io import extra_coders
    from ..ops import transform as tf

    extract = None
    storage = "char"
    cmap = "rgb"
    paths = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-extract":
            extract = argv[i + 1]
            i += 2
        elif a == "-storage-type":
            storage = argv[i + 1]
            i += 2
        elif a == "-map":
            cmap = argv[i + 1]
            i += 2
        elif a.startswith("-"):
            i += 1
        else:
            paths.append(a)
            i += 1
    if len(paths) < 2:
        print("stream: usage: stream input output", file=sys.stderr)
        return 2
    img = iio.read_images(paths[0], device=device)[0]
    if extract:
        w, h, x, y = parse_page_geometry(extract, img.width, img.height)
        img = img.replace(data=tf.crop(img.data, x, y, w, h))
    depth = 16 if storage in ("short", "uint16") else 8
    fmt = "rgba" if (img.spec.alpha and "a" in cmap.lower()) else \
        ("gray" if cmap.lower() == "i" or img.channels == 1 else "rgb")
    blob = extra_coders.encode_raw(img, fmt, depth)
    if paths[1] == "-":
        sys.stdout.buffer.write(blob)
    else:
        with open(paths[1], "wb") as f:
            f.write(blob)
    return 0


def _identify_main(argv, device="cuda") -> int:
    """identify: one line a frame (``io.identify.describe``; ``-verbose``
    adds the statistics), or ``-format`` text for each frame
    (``core.properties.interpret``) and a newline at the end."""
    from .. import io as iio
    from ..core.properties import interpret
    from ..io import identify as ident

    verbose = "-verbose" in argv
    fmt = None
    paths = []
    i = 0
    while i < len(argv):
        if argv[i] == "-format":
            fmt = argv[i + 1]
            i += 2
        elif argv[i].startswith("-"):
            i += 1
        else:
            paths.append(argv[i])
            i += 1
    for p in paths:
        frames = iio.read_images(p, device=device)
        for idx, im in enumerate(frames):
            if fmt:
                print(interpret(fmt, im, p, idx, len(frames)), end="")
            else:
                print(ident.describe(im, p, verbose))
    if fmt:
        print()
    return 0


def _compare_main(argv, device="cuda") -> int:
    """compare A B [DIFF]: the ``-metric`` distortion (rmse by default)
    on stderr as ``65535·d (d)`` (MEPP: its three numbers; ncc, dpc and
    phase as ``1 - corr``), exit 1 where it is above 1e-6, and the
    difference image written to DIFF.  Images of other sizes, or
    ``-subimage-search``, locate B inside A (``similarity_image``) and
    print ``score @ x,y``; a B larger than A exits 2."""
    from .. import io as iio
    from ..ops import compare as cmp_ops

    metric = "rmse"
    paths = []
    i = 0
    subimage_search = False
    while i < len(argv):
        if argv[i] == "-metric":
            metric = argv[i + 1].lower()
            i += 2
        elif argv[i] == "-subimage-search":
            subimage_search = True
            i += 1
        elif argv[i].startswith("-"):
            i += 1
        else:
            paths.append(argv[i])
            i += 1
    if len(paths) < 2:
        print("compare: need two images", file=sys.stderr)
        return 2
    a = iio.read_images(paths[0], device=device)[0]
    b = iio.read_images(paths[1], device=device)[0]
    if subimage_search or a.data.shape != b.data.shape:
        if a.height >= b.height and a.width >= b.width:
            (y, x), surface = cmp_ops.similarity_image(a.data, b.data)
            score = float(surface.max())
            print(f"{score:.6g} @ {int(x)},{int(y)}", file=sys.stderr)
            return 0
        print("compare: image sizes differ", file=sys.stderr)
        return 2
    if metric == "mepp":
        # MEPP prints "raw (normalized_mean, normalized_max)"
        # (MagickWand/compare.c:1303-1310)
        raw, nm, nx = (float(v) for v in
                       cmp_ops.mean_error_per_pixel(a.data, b.data))
        print(f"{raw:.6g} ({nm:.6g}, {nx:.6g})", file=sys.stderr)
        d = raw
    else:
        d = float(cmp_ops.get_distortion(a.data, b.data, metric))
        if metric in ("ncc", "dpc", "phase"):
            # correlation metrics report 1-corr (MagickWand/compare.c:1253)
            d = 1.0 - d
        print(f"{65535.0 * d:.6g} ({d:.6g})", file=sys.stderr)
    if len(paths) > 2:
        vis, _ = cmp_ops.compare_images(a.data, b.data, metric)
        iio.write_image(Image(vis, a.spec), paths[2])
    # CompareEpsilon (MagickWand/compare.c:1264): dissimilar above 1e-6
    return 0 if abs(d) <= 1.0e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
