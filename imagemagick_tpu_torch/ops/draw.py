"""Vector drawing: MVG interpreter + analytic coverage rasterizer (draw.c).

Port of ``imagemagick_tpu/ops/draw.py`` (DrawImage, RenderMVGContent,
DrawPolygonPrimitive, the TracePath SVG grammar and AnnotateImage of
MagickCore/draw.c and annotate.c).  Curves, arcs, ellipses, dashes and
stroke outlines are flattened to polylines on the host, as in the JAX
module (this module's own copy of that code).  Coverage is the
reference's model (``_ref_alphas``): fill winding plus the quadratic edge
ramp, and the stroke's distance ramp, at integer pixel centers.  The JAX
function computes it in numpy float64 on the host; here it runs on the
image's device in float64, each arithmetic step its own PyTorch op (IEEE
float64 then gives numpy's bits): the fill ramp and the stroke a run of
neighbouring segments at a time, on the run's box (outside it both are
zero), and the winding of each (row, segment) pair whose window holds
the row, at full width.  Text is rasterized on the host through
PIL, as in the JAX module, and composited on the device.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.color import parse_color
from ..core.image import checked_device

_SS = 4  # supersampling grid per axis (16 samples/pixel)
_CELLS = 1 << 23   # (row, pixel) float64 cells of one winding chunk
_RAMP_CELLS = 1 << 20   # (pixel, segment) cells of one ramp run


# ---------------------------------------------------------------------------
# Geometry helpers (host-side flattening)
# ---------------------------------------------------------------------------

def _trace_bezier(ctrl):
    """TraceBezier (draw.c): Bernstein evaluation at quantum*n steps,
    quantum = min(trunc(max pairwise |dx|,|dy|) // n, 200), exact end
    point appended — the reference's flattening density."""
    n = len(ctrl)
    q = float(n)
    for i in range(n):
        for j in range(i + 1, n):
            ax = abs(ctrl[j][0] - ctrl[i][0])
            ay = abs(ctrl[j][1] - ctrl[i][1])
            if ax > q:
                q = float(int(ax))
            if ay > q:
                q = float(int(ay))
    quantum = min(int(q) // n, 200)
    cp = max(quantum * n, 1)
    ts = np.arange(cp, dtype=np.float64) / cp
    coef = np.array([math.comb(n - 1, k) for k in range(n)], np.float64)
    px = np.array([c[0] for c in ctrl], np.float64)
    py = np.array([c[1] for c in ctrl], np.float64)
    basis = coef[None, :] * (ts[:, None] ** np.arange(n)[None, :]) *         ((1.0 - ts[:, None]) ** (n - 1 - np.arange(n))[None, :])
    xs = basis @ px
    ys = basis @ py
    out = list(zip(xs, ys))
    out.append((ctrl[-1][0], ctrl[-1][1]))
    return out


def _flatten_bezier(p0, p1, p2, p3, n=None):
    return _trace_bezier([p0, p1, p2, p3])


def _flatten_quad(p0, p1, p2, n=None):
    return _trace_bezier([p0, p1, p2])


def _flatten_arc(p0, rx, ry, rot, large, sweep, p1, n=32):
    """SVG elliptical arc -> polyline (W3C endpoint->center conversion)."""
    if rx == 0 or ry == 0:
        return [p0, p1]
    phi = math.radians(rot)
    cp, sp = math.cos(phi), math.sin(phi)
    dx2, dy2 = (p0[0] - p1[0]) / 2.0, (p0[1] - p1[1]) / 2.0
    x1p = cp * dx2 + sp * dy2
    y1p = -sp * dx2 + cp * dy2
    rx, ry = abs(rx), abs(ry)
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    num = rx ** 2 * ry ** 2 - rx ** 2 * y1p ** 2 - ry ** 2 * x1p ** 2
    den = rx ** 2 * y1p ** 2 + ry ** 2 * x1p ** 2
    co = math.sqrt(max(num / den, 0.0))
    if large == sweep:
        co = -co
    cxp = co * rx * y1p / ry
    cyp = -co * ry * x1p / rx
    cx = cp * cxp - sp * cyp + (p0[0] + p1[0]) / 2.0
    cy = sp * cxp + cp * cyp + (p0[1] + p1[1]) / 2.0

    def ang(ux, uy, vx, vy):
        d = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1.0, min(1.0, (ux * vx + uy * vy) / max(d, 1e-12))))
        return a if ux * vy - uy * vx >= 0 else -a

    th1 = ang(1, 0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry, (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    if sweep and dth < 0:
        dth += 2 * math.pi
    ts = np.linspace(0.0, 1.0, n)
    th = th1 + dth * ts
    x = cx + rx * np.cos(th) * cp - ry * np.sin(th) * sp
    y = cy + rx * np.cos(th) * sp + ry * np.sin(th) * cp
    return list(zip(x, y))


def parse_svg_path(d: str) -> List[List[Tuple[float, float]]]:
    """TracePath analog: SVG path data -> list of polylines (subpaths)."""
    tokens = re.findall(r"[MmLlHhVvCcSsQqTtAaZz]|[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?\d+)?", d)
    i = 0
    subpaths: List[List[Tuple[float, float]]] = []
    cur: List[Tuple[float, float]] = []
    pos = (0.0, 0.0)
    start = (0.0, 0.0)
    last_ctrl = None
    last_cmd = ""

    def num():
        nonlocal i
        v = float(tokens[i])
        i += 1
        return v

    while i < len(tokens):
        t = tokens[i]
        if re.match(r"[A-Za-z]", t):
            cmd = t
            i += 1
        else:
            cmd = last_cmd
            # implicit repeat: M->L, m->l
            if cmd in "Mm":
                cmd = "L" if cmd == "M" else "l"
        rel = cmd.islower()
        C = cmd.upper()
        if C == "M":
            x, y = num(), num()
            if rel:
                x, y = pos[0] + x, pos[1] + y
            if cur:
                subpaths.append(cur)
            cur = [(x, y)]
            pos = start = (x, y)
        elif C == "L":
            x, y = num(), num()
            if rel:
                x, y = pos[0] + x, pos[1] + y
            cur.append((x, y))
            pos = (x, y)
        elif C == "H":
            x = num()
            if rel:
                x = pos[0] + x
            cur.append((x, pos[1]))
            pos = (x, pos[1])
        elif C == "V":
            y = num()
            if rel:
                y = pos[1] + y
            cur.append((pos[0], y))
            pos = (pos[0], y)
        elif C in ("C", "S"):
            if C == "C":
                c1 = (num(), num())
                if rel:
                    c1 = (pos[0] + c1[0], pos[1] + c1[1])
            else:
                c1 = (2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1]) \
                    if last_ctrl and last_cmd.upper() in ("C", "S") else pos
            c2 = (num(), num())
            end = (num(), num())
            if rel:
                c2 = (pos[0] + c2[0], pos[1] + c2[1])
                end = (pos[0] + end[0], pos[1] + end[1])
            cur.extend(_flatten_bezier(pos, c1, c2, end)[1:])
            last_ctrl = c2
            pos = end
        elif C in ("Q", "T"):
            if C == "Q":
                c1 = (num(), num())
                if rel:
                    c1 = (pos[0] + c1[0], pos[1] + c1[1])
            else:
                c1 = (2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1]) \
                    if last_ctrl and last_cmd.upper() in ("Q", "T") else pos
            end = (num(), num())
            if rel:
                end = (pos[0] + end[0], pos[1] + end[1])
            cur.extend(_flatten_quad(pos, c1, end)[1:])
            last_ctrl = c1
            pos = end
        elif C == "A":
            rx, ry, rot = num(), num(), num()
            large, sweep = bool(num()), bool(num())
            end = (num(), num())
            if rel:
                end = (pos[0] + end[0], pos[1] + end[1])
            cur.extend(_flatten_arc(pos, rx, ry, rot, large, sweep, end)[1:])
            pos = end
        elif C == "Z":
            if cur:
                cur.append(start)
                subpaths.append(cur)
                cur = []
            pos = start
        last_cmd = cmd
    if cur:
        subpaths.append(cur)
    return subpaths

# ---------------------------------------------------------------------------
# Device-side coverage rasterization
# ---------------------------------------------------------------------------

def _sample_grid(h: int, w: int, device, dtype=torch.float32):
    """Subpixel sample coordinates: (h, w, SS*SS) x and y."""
    offs = (torch.arange(_SS, dtype=dtype, device=device) + 0.5) / _SS - 0.5
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)
    ys = torch.arange(h, dtype=dtype, device=device)[:, None, None] + \
        oy[None, None, :]
    xs = torch.arange(w, dtype=dtype, device=device)[None, :, None] + \
        ox[None, None, :]
    return xs.expand(h, w, _SS * _SS), ys.expand(h, w, _SS * _SS)


def _segment_dist2(X: torch.Tensor, Y: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared point-to-segment distances, GetFillAlpha's exact branch
    structure (draw.c:4845-4880): beta<=0 -> endpoint a; beta>=|ab|^2 ->
    endpoint b; else perpendicular via the cross product.  X (1, w, 1),
    Y (h, 1, 1), a and b (S, 2): (h, w, S)."""
    dx = b[:, 0] - a[:, 0]
    dy = b[:, 1] - a[:, 1]
    px = X - a[:, 0]
    py = Y - a[:, 1]
    beta = dx * px + dy * py
    seg2 = dx * dx + dy * dy
    qx = X - b[:, 0]
    qy = Y - b[:, 1]
    cross = dx * py - dy * px
    pp = px * px + py * py
    perp = torch.where(seg2 > 0.0, cross * cross / torch.where(
        seg2 > 0.0, seg2, torch.ones_like(seg2)), pp)
    return torch.where(beta <= 0.0, pp,
                       torch.where(beta >= seg2, qx * qx + qy * qy, perp))


def _stroke_ramp(d: torch.Tensor, mid: float) -> torch.Tensor:
    e = d - (mid + 0.75)
    return torch.where(d <= mid - 0.25, torch.ones_like(d),
                       torch.where(d <= mid + 0.75, e * e,
                                   torch.zeros_like(d)))


def _span(lo_excl: float, hi_incl: float, n: int) -> Tuple[int, int]:
    """[i0, i1) of the integers i in [0, n) with lo_excl < i <= hi_incl:
    i > lo exactly when i >= floor(lo) + 1, and i <= hi when i <=
    floor(hi), so the bounds are the JAX function's float64 masks'."""
    i0 = max(math.floor(lo_excl) + 1, 0)
    i1 = min(math.floor(hi_incl) + 1, n)
    return (i0, i1) if i1 > i0 else (0, 0)


def _ramp_chunks(ca: np.ndarray, cb: np.ndarray, pad: float,
                 ch: int, cw: int):
    """Runs [s, e) of consecutive segments whose box (grown by ``pad``,
    at most ch x cw) times their count fits ``_RAMP_CELLS``: the ramps'
    work is box x segments, so short runs of nearby segments cost
    least."""
    out = []
    s = 0
    n = len(ca)
    x0s, y0s = np.minimum(ca, cb).T.tolist()
    x1s, y1s = np.maximum(ca, cb).T.tolist()
    grow = 2 * pad + 1
    while s < n:
        bx0, by0, bx1, by1 = x0s[s], y0s[s], x1s[s], y1s[s]
        e = s + 1
        while e < n:
            nx0, ny0 = min(bx0, x0s[e]), min(by0, y0s[e])
            nx1, ny1 = max(bx1, x1s[e]), max(by1, y1s[e])
            area = min(nx1 - nx0 + grow, cw) * min(ny1 - ny0 + grow, ch)
            if area * (e + 1 - s) > _RAMP_CELLS:
                break
            bx0, by0, bx1, by1 = nx0, ny0, nx1, ny1
            e += 1
        out.append((s, e))
        s = e
    return out


def _winding(wind: torch.Tensor, a: np.ndarray, b: np.ndarray) -> None:
    """Add the winding numbers of the segments a -> b (float64 (S, 2))
    into ``wind`` (h, w): window (sy, ey], right-or-on sidedness
    (draw.c:4952-4962).  Only the (row, segment) pairs whose window holds
    the row are evaluated, each across the full width."""
    h, w = wind.shape
    dev = wind.device
    down = b[:, 1] > a[:, 1]
    sx = np.where(down, a[:, 0], b[:, 0])
    sy = np.where(down, a[:, 1], b[:, 1])
    ex = np.where(down, b[:, 0], a[:, 0])
    ey = np.where(down, b[:, 1], a[:, 1])
    dirs = np.where(down, 1, -1)
    # rows y with sy < y <= ey, inside the canvas; horizontal segments
    # (sy == ey) hold none
    r_lo = np.clip(np.floor(sy) + 1, 0, h).astype(np.int64)
    r_hi = np.clip(np.floor(ey) + 1, 0, h).astype(np.int64)
    n = np.maximum(r_hi - r_lo, 0)
    if not n.sum():
        return
    seg = np.repeat(np.arange(len(a)), n)
    rows = np.repeat(r_lo, n) + (np.arange(n.sum()) -
                                 np.repeat(np.cumsum(n) - n, n))
    X = torch.arange(w, dtype=torch.float64, device=dev)[None, :]
    cols = [torch.from_numpy(v[seg][:, None]).to(dev)
            for v in (sx, sy, ex, ey, dirs)]
    trow = torch.from_numpy(rows).to(dev)
    step = max(1, _CELLS // w)
    for p0 in range(0, len(rows), step):
        tsx, tsy, tex, tey, tdir = (c[p0:p0 + step] for c in cols)
        Y = trow[p0:p0 + step, None].to(torch.float64)
        side = ((tey - tsy) * (X - tsx) - (tex - tsx) * (Y - tsy)) >= 0.0
        wind.index_add_(0, trow[p0:p0 + step],
                        torch.where(side, tdir, torch.zeros_like(tdir)))


def _ref_alphas(h: int, w: int,
                subpaths: Sequence[Sequence[Tuple[float, float]]],
                mid: float = 0.5, fill_rule: str = "nonzero",
                want_fill: bool = True, want_stroke: bool = False,
                closed_flags: Optional[Sequence[bool]] = None,
                device="cpu"):
    """The reference rasterization model (DrawPolygonPrimitive +
    GetFillAlpha, draw.c:4803-5210), evaluated at integer pixel centers:

      fill   = 1 inside (winding) else max over segments of (1-d)^2, d<=1
      stroke = 1 where d <= mid-0.25 else (d-(mid+0.75))^2 for
               d <= mid+0.75   (mid = stroke_width/2)

    Open subpaths gain a GHOST closing edge (ConvertPrimitiveToPath,
    draw.c:886-900) that participates in fill winding and fill AA but
    never in the stroke.  Each segment's ramps count only inside its
    monotone chain's window (the chain bbox grown by mid+0.5, with
    <=/> boundary asymmetry) and its own y window; the segments of every
    chain are evaluated together, a run of neighbours at a time.  Returns
    (fill_alpha, stroke_alpha) float64 (h, w) tensors on ``device``."""
    dev = torch.device(device)
    f64 = torch.float64
    fill_sub = torch.zeros((h, w), dtype=f64, device=dev)
    stroke = torch.zeros((h, w), dtype=f64, device=dev)
    wind = torch.zeros((h, w), dtype=torch.int64, device=dev)
    reach = max(mid + 0.75, 1.0) + 1.0   # where a ramp can be non-zero
    seg_a: List[np.ndarray] = []     # every chain's segments, in order
    seg_b: List[np.ndarray] = []
    seg_win: List[np.ndarray] = []   # (ylo, yhi, xlo, xhi) of its chain
    seg_flags: List[np.ndarray] = []  # (fill, stroke)
    wind_a: List[np.ndarray] = []
    wind_b: List[np.ndarray] = []

    def coords(i0, i1):
        return torch.arange(i0, i1, dtype=f64, device=dev)

    def chains_of(a, b, ghosts):
        """Split a segment run into monotone-y chains like
        ConvertPathToPolygon: a segment whose y direction flips against
        the last non-zero one (kept across chains), or whose ghost flag
        differs, starts a new chain.  [(start, end)] index runs."""
        dy = b[:, 1] - a[:, 1]
        sign = np.where(dy > 0, 1, np.where(dy < 0, -1, 0))
        nz = np.nonzero(sign)[0]
        last = np.full(len(sign) + 1, -1, np.int64)
        last[nz + 1] = nz
        last = np.maximum.accumulate(last)[:-1]      # last non-zero before i
        prev = np.where(last >= 0, sign[np.maximum(last, 0)], 0)
        g = np.asarray(ghosts)
        cut = ((sign != 0) & (prev != 0) & (sign != prev))
        cut[1:] |= g[1:] != g[:-1]
        cut[0] = False
        starts = np.concatenate([[0], np.nonzero(cut)[0]])
        ends = np.concatenate([starts[1:], [len(a)]])
        return list(zip(starts.tolist(), ends.tolist()))

    for pi, pts in enumerate(subpaths):
        p = np.asarray(pts, np.float64).reshape(-1, 2)
        if len(p) == 0:
            continue
        if len(p) == 1:
            if want_stroke:
                r0, r1 = _span(p[0, 1] - reach - 1, p[0, 1] + reach, h)
                c0, c1 = _span(p[0, 0] - reach - 1, p[0, 0] + reach, w)
                if r1 > r0 and c1 > c0:
                    pt = torch.from_numpy(p).to(dev)
                    d2 = _segment_dist2(coords(c0, c1)[None, :, None],
                                        coords(r0, r1)[:, None, None],
                                        pt, pt)[..., 0]
                    s = _stroke_ramp(torch.sqrt(d2), mid)
                    stroke[r0:r1, c0:c1] = torch.maximum(
                        stroke[r0:r1, c0:c1], s)
            continue
        closed = bool(closed_flags[pi]) if closed_flags is not None else \
            bool(np.all(p[0] == p[-1]))
        a = p[:-1]
        b = p[1:]
        ghost_flags = [False] * len(a)
        ghost = not (closed and np.all(p[0] == p[-1]))
        if want_fill and ghost:
            a = np.concatenate([a, p[-1:]], 0)
            b = np.concatenate([b, p[:1]], 0)
            ghost_flags.append(True)
        runs = chains_of(a, b, ghost_flags)
        starts = np.asarray([r[0] for r in runs])
        counts = np.asarray([r[1] - r[0] for r in runs])
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        # each chain's bbox (ylo, yhi, xlo, xhi), given to its segments
        win = np.stack([np.minimum.reduceat(lo[:, 1], starts),
                        np.maximum.reduceat(hi[:, 1], starts),
                        np.minimum.reduceat(lo[:, 0], starts),
                        np.maximum.reduceat(hi[:, 0], starts)], 1)
        ghosted = np.asarray(ghost_flags)
        seg_a.append(a)
        seg_b.append(b)
        seg_win.append(np.repeat(win, counts, 0))
        seg_flags.append(np.stack([np.full(len(a), want_fill),
                                   want_stroke & ~ghosted], 1))
        if want_fill:
            wind_a.append(a)
            wind_b.append(b)
    if seg_a:
        A, B = np.concatenate(seg_a), np.concatenate(seg_b)
        WIN, FL = np.concatenate(seg_win), np.concatenate(seg_flags)
        tA, tB = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
        # the windows' bounds as the JAX function compares them
        tw = torch.from_numpy(np.stack([
            WIN[:, 0] - mid - 0.5, WIN[:, 1] + mid + 0.5,
            WIN[:, 2] - mid - 0.5, WIN[:, 3] + mid + 0.5,
            np.minimum(A[:, 1], B[:, 1]) - mid - 0.5,
            np.maximum(A[:, 1], B[:, 1]) + mid + 0.5], 1)).to(dev)
        tfl = torch.from_numpy(FL).to(dev)
        lo, hi = np.minimum(A, B), np.maximum(A, B)
        for s0, s1 in _ramp_chunks(A, B, max(mid + 0.5, reach + 1), h, w):
            # the run's box: the union of its segments' y windows, columns
            # within reach of its x range; outside, every ramp is zero
            r0, r1 = _span(lo[s0:s1, 1].min() - mid - 0.5,
                           hi[s0:s1, 1].max() + mid + 0.5, h)
            c0, c1 = _span(lo[s0:s1, 0].min() - reach - 1,
                           hi[s0:s1, 0].max() + reach, w)
            if r1 <= r0 or c1 <= c0:
                continue
            Y = coords(r0, r1)[:, None, None]
            X = coords(c0, c1)[None, :, None]
            bnd = tw[s0:s1]
            inside = (Y > bnd[:, 0]) & (Y <= bnd[:, 1]) & \
                (X > bnd[:, 2]) & (X <= bnd[:, 3]) & \
                (Y > bnd[:, 4]) & (Y <= bnd[:, 5])
            d2 = _segment_dist2(X, Y, tA[s0:s1], tB[s0:s1])
            d = torch.sqrt(d2)
            zero = torch.zeros_like(d)
            if want_fill:
                e = d - 1.0
                f = torch.where(d2 <= 1.0, e * e, zero)
                f = torch.where(d2 <= 0.0, torch.ones_like(d), f)
                f = torch.where(inside & tfl[s0:s1, 0], f, zero)
                fill_sub[r0:r1, c0:c1] = torch.maximum(
                    fill_sub[r0:r1, c0:c1], f.amax(-1))
            if want_stroke:
                sr = torch.where(inside & tfl[s0:s1, 1],
                                 _stroke_ramp(d, mid), zero)
                stroke[r0:r1, c0:c1] = torch.maximum(
                    stroke[r0:r1, c0:c1], sr.amax(-1))
    if wind_a:
        _winding(wind, np.concatenate(wind_a), np.concatenate(wind_b))
    if fill_rule in ("evenodd", "even-odd"):
        inside = (wind.abs() & 1) != 0
    else:
        inside = wind != 0
    fill = torch.where(inside, torch.ones_like(fill_sub), fill_sub)
    return fill, stroke


def polygon_coverage(h: int, w: int, points: Sequence[Tuple[float, float]],
                     fill_rule: str = "nonzero", device="cuda"
                     ) -> torch.Tensor:
    """Polygon fill alpha, the reference's winding + edge-AA model, a
    float32 (h, w) tensor on ``device``."""
    device = checked_device(device, "draw")
    pts = list(points)
    if len(pts) < 2:
        return torch.zeros((h, w), dtype=torch.float32, device=device)
    fill, _ = _ref_alphas(h, w, [pts], fill_rule=fill_rule, device=device)
    return fill.to(torch.float32)


def stroke_coverage(h: int, w: int, points: Sequence[Tuple[float, float]],
                    width: float, closed: bool = False,
                    linecap: str = "round", linejoin: str = "round",
                    miterlimit: float = 10.0, device="cuda") -> torch.Tensor:
    """Distance-field stroke coverage for a polyline, a float32 (h, w)
    tensor on ``device``.

    Caps and joins follow draw.c's DrawInfo semantics: caps butt/round/
    square shape the true polyline ends; joins miter/round/bevel unite
    the segments at interior vertices (round = capsule union, miter =
    wedge up to ``miterlimit``·width/2 then bevel — draw.c TraceStroke
    region).  The default round/round keeps the legacy capsule behavior
    for internal callers.
    """
    device = checked_device(device, "draw")
    pts = [(float(x), float(y)) for x, y in points]
    if len(pts) < 2:
        return torch.zeros((h, w), dtype=torch.float32, device=device)
    if closed and pts[0] != pts[-1]:
        pts = pts + [pts[0]]
    r = width / 2.0
    distance_model = linejoin == "round" and (linecap == "round" or closed)
    if r <= 1.0 or distance_model:
        # DrawPrimitive (draw.c:5830): thin strokes (mid <= 1) and
        # round-join strokes with round caps (or closed paths) render
        # with the distance model (endpoint balls = the round caps)
        _, stroke = _ref_alphas(h, w, [pts], mid=r, want_fill=False,
                                want_stroke=True, closed_flags=[closed],
                                device=device)
        return stroke.to(torch.float32)
    # wide strokes: trace the stroke outline polygon and FILL it
    # (DrawStrokePolygon -> TraceStrokePolygon -> DrawPolygonPrimitive);
    # round caps composite separately as stroke-point discs
    # (DrawRoundLinecap, draw.c:5938-5960)
    rings = _stroke_outline(pts, r, linecap, linejoin, miterlimit, closed)
    fill, _ = _ref_alphas(h, w, rings, mid=0.0, fill_rule="nonzero",
                          closed_flags=[True] * len(rings), device=device)
    alpha = fill
    if linecap == "round" and not closed:
        _, caps = _ref_alphas(h, w, [[pts[0]], [pts[-1]]], mid=r,
                              want_fill=False, want_stroke=True,
                              device=device)
        alpha = alpha + caps - alpha * caps   # over-composite, same ink
    return alpha.to(torch.float32)


def _stroke_outline(pts, r, linecap="butt", linejoin="miter",
                    miterlimit=10.0, closed=False):
    """TraceStrokePolygon analog: offset outline ring(s) of a stroked
    path — butt/square caps, miter-or-bevel joins (draw.c:6571+).
    Returns a list of closed polygons (closed paths yield outer+inner
    rings whose combined nonzero winding is the stroke band)."""
    P = [np.asarray(q, np.float64) for q in pts]
    # drop duplicate consecutive points
    Q = [P[0]]
    for q in P[1:]:
        if np.hypot(*(q - Q[-1])) > 1e-12:
            Q.append(q)
    if len(Q) < 2:
        return []
    if closed and np.hypot(*(Q[0] - Q[-1])) > 1e-12:
        Q.append(Q[0])

    def unit(v):
        n = np.hypot(*v)
        return v / n if n > 0 else v

    def miter_point(i, side):
        """Outer miter point at vertex Q[i] (prev segment -> next), or
        None when the turn is inner / bevel-limited."""
        pu = unit(Q[i] - Q[i - 1]) if i > 0 else unit(Q[0] - Q[-2])
        u = unit(Q[i + 1] - Q[i]) if i < len(Q) - 1 else unit(Q[1] - Q[0])
        cross = pu[0] * u[1] - pu[1] * u[0]
        if not ((cross * side) < 0) or linejoin != "miter":
            return None
        m = pu + u
        ml = np.hypot(*m)
        if ml <= 1e-9:
            return None
        cos_half = ml / 2.0
        miter_len = r / max(cos_half, 1e-9)
        if miter_len > miterlimit * r:
            return None
        mdir = unit(np.array([-m[1], m[0]]) * side)
        return Q[i] + mdir * miter_len

    def arc_points(center, a0, a1, ccw):
        """Arc vertex run at TraceEllipse density (step = 1/(8r))."""
        step = 1.0 / (8.0 * max(r, 1e-9))
        if ccw:
            while a1 < a0:
                a1 += 2.0 * math.pi
        else:
            while a1 > a0:
                a1 -= 2.0 * math.pi
        n = max(int(abs(a1 - a0) / step), 1)
        return [center + r * np.array([math.cos(a0 + (a1 - a0) * k / n),
                                       math.sin(a0 + (a1 - a0) * k / n)])
                for k in range(n + 1)]

    def offside_miter(side):
        """``offside`` for miter and bevel joins, the vertices at once:
        each offset segment, preceded by the miter point of its vertex
        where the turn is outer and within ``miterlimit``."""
        qa = np.asarray(Q)
        n = len(qa) - 1
        d = qa[1:] - qa[:-1]
        nd = np.hypot(d[:, 0], d[:, 1])
        u = d / np.where(nd > 0, nd, 1.0)[:, None]
        nrm = np.stack([-u[:, 1], u[:, 0]], 1) * side * r
        a = qa[:-1] + nrm
        b = qa[1:] + nrm
        if linecap == "square" and not closed:
            a[0] = a[0] - u[0] * r
            b[n - 1] = b[n - 1] + u[n - 1] * r
        pu, uu = u[:-1], u[1:]                       # vertices 1 .. n-1
        cross = pu[:, 0] * uu[:, 1] - pu[:, 1] * uu[:, 0]
        m = pu + uu
        ml = np.hypot(m[:, 0], m[:, 1])
        miter_len = r / np.maximum(ml / 2.0, 1e-9)
        mv = np.stack([-m[:, 1], m[:, 0]], 1) * side
        mn = np.hypot(mv[:, 0], mv[:, 1])
        mdir = mv / np.where(mn > 0, mn, 1.0)[:, None]
        mp = qa[1:-1] + mdir * miter_len[:, None]
        ok = ((cross * side) < 0) & (linejoin == "miter") & (ml > 1e-9) & \
            (miter_len <= miterlimit * r)
        rows = np.concatenate([np.zeros((1, 2)), mp], 0)
        keep = np.concatenate([[False], ok])
        trip = np.stack([rows, a, b], 1).reshape(-1, 2)
        out = list(trip[np.stack([keep, np.ones(n, bool), np.ones(n, bool)],
                                 1).reshape(-1)])
        if closed:
            # seam join at vertex 0 (between the last and first segments)
            mp0 = miter_point(0, side)
            if mp0 is not None:
                out.append(mp0)
        return out

    def offside(side):
        """One side of the outline (+1 left, -1 right), walked forward."""
        if linejoin != "round":
            return offside_miter(side)
        out = []
        n = len(Q) - 1
        for i in range(n):
            u = unit(Q[i + 1] - Q[i])
            nrm = np.array([-u[1], u[0]]) * side * r
            a = Q[i] + nrm
            b = Q[i + 1] + nrm
            if linecap == "square" and not closed:
                if i == 0:
                    a = a - u * r
                if i == n - 1:
                    b = b + u * r
            if out:
                if linejoin == "round":
                    pn = out[-1] - Q[i]       # previous offset end
                    an = a - Q[i]
                    out.extend(arc_points(
                        Q[i], math.atan2(pn[1], pn[0]),
                        math.atan2(an[1], an[0]), side < 0))
                else:
                    mp = miter_point(i, side)
                    if mp is not None:
                        out.append(mp)
                out.append(a)
            else:
                out.append(a)
            out.append(b)
        if closed:
            # seam join at vertex 0 (between the last and first segments)
            if linejoin == "round":
                u0 = unit(Q[1] - Q[0])
                a0 = Q[0] + np.array([-u0[1], u0[0]]) * side * r
                pn = out[-1] - Q[0]
                an = a0 - Q[0]
                out.extend(arc_points(Q[0], math.atan2(pn[1], pn[0]),
                                      math.atan2(an[1], an[0]), side < 0))
            else:
                mp = miter_point(0, side)
                if mp is not None:
                    out.append(mp)
        return out

    left = offside(1.0)
    right = offside(-1.0)
    if closed:
        left.append(left[0])
        right.append(right[0])
        return [left, right[::-1]]
    ring = left + right[::-1]
    ring.append(ring[0])
    return [ring]


def dash_polyline(points: Sequence[Tuple[float, float]],
                  dasharray: Sequence[float], offset: float = 0.0,
                  closed: bool = False) -> List[List[Tuple[float, float]]]:
    """Arc-length split of a polyline into dash sub-polylines.

    DrawDashPolygon (MagickCore/draw.c:2223): the dash
    pattern cycles along the path's arc length; an odd-length array
    repeats doubled (SVG semantics, matching the reference).
    """
    pts = [(float(x), float(y)) for x, y in points]
    if closed and len(pts) > 1 and pts[0] != pts[-1]:
        pts = pts + [pts[0]]
    pat = [float(d) for d in dasharray if float(d) >= 0]
    if not pat or all(p == 0 for p in pat):
        return [pts]
    if len(pat) % 2 == 1:
        pat = pat + pat
    total = sum(pat)
    # position inside the cycle, honoring dashoffset
    pos = float(offset) % total
    idx = 0
    while pos >= pat[idx]:
        pos -= pat[idx]
        idx = (idx + 1) % len(pat)
    on = idx % 2 == 0
    remaining = pat[idx] - pos
    dashes: List[List[Tuple[float, float]]] = []
    cur: List[Tuple[float, float]] = [pts[0]] if on else []
    for p0, p1 in zip(pts[:-1], pts[1:]):
        seglen = math.hypot(p1[0] - p0[0], p1[1] - p0[1])
        if seglen < 1e-12:
            continue
        ux, uy = (p1[0] - p0[0]) / seglen, (p1[1] - p0[1]) / seglen
        t = 0.0
        while seglen - t > remaining + 1e-9:
            t += remaining
            q = (p0[0] + ux * t, p0[1] + uy * t)
            if on:
                cur.append(q)
                if len(cur) >= 2:
                    dashes.append(cur)
                cur = []
            else:
                cur = [q]
            idx = (idx + 1) % len(pat)
            on = not on
            remaining = pat[idx]
        remaining -= seglen - t
        if on:
            cur.append(p1)
    if on and len(cur) >= 2:
        dashes.append(cur)
    return dashes

def ellipse_coverage(h: int, w: int, cx: float, cy: float,
                     rx: float, ry: float, device="cuda") -> torch.Tensor:
    """Supersampled (4x4) coverage of an axis-aligned ellipse."""
    device = checked_device(device, "draw")
    xs, ys = _sample_grid(h, w, device)
    dx = (xs - cx) / torch.tensor(max(rx, 1e-6), device=device)
    dy = (ys - cy) / torch.tensor(max(ry, 1e-6), device=device)
    return ((dx * dx + dy * dy) <= 1.0).to(torch.float32).mean(-1)


def _ellipse_distance(px: torch.Tensor, py: torch.Tensor, a: float, b: float,
                      iters: int = 6) -> torch.Tensor:
    """Euclidean distance from points to the ellipse boundary x²/a²+y²/b²=1
    (origin-centered), via Newton on the boundary parameter."""
    sx, sy = px.abs(), py.abs()
    t = torch.atan2(a * sy, b * sx)
    for _ in range(iters):
        ct, st = torch.cos(t), torch.sin(t)
        gx, gy = a * ct - sx, b * st - sy
        d1 = gx * (-a * st) + gy * (b * ct)
        d2 = (a * st) ** 2 + (b * ct) ** 2 - gx * (a * ct) - gy * (b * st)
        t = (t - d1 / torch.clamp(d2, min=1e-12)).clamp(0.0, math.pi / 2)
    return torch.hypot(a * torch.cos(t) - sx, b * torch.sin(t) - sy)


def ellipse_fill_stroke_alpha(h: int, w: int, cx: float, cy: float,
                              rx: float, ry: float, mid: float = 0.5,
                              device="cuda") -> torch.Tensor:
    """Coverage of a filled + stroked ellipse by the exact distance d to
    its boundary: draw.c:4803 GetFillAlpha's quadratic ramps, fill = 1
    inside else (1-d)² for d<1; stroke (width 2*mid) = 1 for d<=mid-0.25
    else (mid+0.75-d)² for d<mid+0.75; stroke composited over fill."""
    device = checked_device(device, "draw")
    yy, xx = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing="ij")
    px = xx.to(torch.float32) - cx
    py = yy.to(torch.float32) - cy
    d = _ellipse_distance(px, py, max(rx, 1e-6), max(ry, 1e-6))
    qx = px / torch.tensor(max(rx, 1e-6), device=device)
    qy = py / torch.tensor(max(ry, 1e-6), device=device)
    inside = qx * qx + qy * qy <= 1.0
    # GetFillAlpha culls samples beyond the path bbox expanded by mid+0.5
    # (draw.c:4835-4843) BEFORE the ramp test, truncating the outer band
    box = ((px > -rx - mid - 0.5) & (px <= rx + mid + 0.5)
           & (py > -ry - mid - 0.5) & (py <= ry + mid + 0.5))
    zero = torch.zeros_like(d)
    fill = torch.where(inside, torch.ones_like(d),
                       torch.where(box & (d < 1.0), (1.0 - d) ** 2, zero))
    sa = torch.where(box & (d <= mid - 0.25), torch.ones_like(d),
                     torch.where(box & (d < mid + 0.75),
                                 (mid + 0.75 - d) ** 2, zero))
    return sa + fill * (1.0 - sa)


def _blend(img: torch.Tensor, coverage: torch.Tensor, color) -> torch.Tensor:
    """Blend a coverage mask with a solid color or an (H, W, 4) color
    field (a tensor)."""
    c = img.shape[-1]
    if isinstance(color, torch.Tensor) and color.dim() >= 3:
        col = color[..., :c]
        alpha_field = color[..., 3] if color.shape[-1] > 3 else 1.0
        a = (alpha_field * coverage)[..., None]
        if c == 4:
            src_a = a
            dst_a = img[..., 3:4]
            out_a = src_a + dst_a * (1 - src_a)
            rgb = (col[..., :3] * src_a + img[..., :3] * dst_a * (1 - src_a)) \
                / torch.clamp(out_a, min=1e-6)
            return torch.cat([rgb, out_a], dim=-1)
        return img * (1.0 - a) + col * a
    col = torch.tensor(list(color[:c]), dtype=img.dtype, device=img.device)
    a = (color[3] if len(color) > 3 else 1.0) * coverage[..., None]
    if c == 4:
        # src-over with alpha
        src_a = a
        dst_a = img[..., 3:4]
        out_a = src_a + dst_a * (1 - src_a)
        rgb = (col[:3] * src_a + img[..., :3] * dst_a * (1 - src_a)) / \
            torch.clamp(out_a, min=1e-6)
        return torch.cat([rgb, out_a], dim=-1)
    return img * (1.0 - a) + col * a


# ---------------------------------------------------------------------------
# MVG interpreter
# ---------------------------------------------------------------------------

class _GC:
    """Graphic context (DrawInfo analog)."""

    _FIELDS = ("fill", "stroke", "stroke_width", "fill_opacity",
               "stroke_opacity", "fill_rule", "font_size", "font", "affine",
               "text_anchor", "fill_gradient", "stroke_gradient", "linecap",
               "linejoin", "miterlimit", "dasharray", "dashoffset",
               "clip_mask", "direction")

    def __init__(self):
        self.fill = (0.0, 0.0, 0.0, 1.0)
        self.fill_gradient = None  # name of gradient for url(#...) fills
        self.stroke_gradient = None  # name of gradient for url(#) strokes
        self.stroke = (0.0, 0.0, 0.0, 0.0)
        self.stroke_width = 1.0
        self.fill_opacity = 1.0
        self.stroke_opacity = 1.0
        self.fill_rule = "nonzero"
        self.font_size = 12.0
        self.font = None
        self.affine = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
        self.text_anchor = "start"
        self.direction = None        # draw.c "direction" keyword (raqm)
        # stroke geometry state (draw.c DrawInfo defaults: butt/miter/10)
        self.linecap = "butt"
        self.linejoin = "miter"
        self.miterlimit = 10.0
        self.dasharray = None        # list of lengths, or None
        self.dashoffset = 0.0
        self.clip_mask = None        # (H, W) coverage multiplier, or None

    def copy(self):
        g = _GC()
        for k in self._FIELDS:
            setattr(g, k, getattr(self, k))
        return g

    def xform(self, pts):
        sx, rx, ry, sy, tx, ty = self.affine
        return [(sx * x + ry * y + tx, rx * x + sy * y + ty) for x, y in pts]


_MVG_TOKEN = re.compile(r"""'[^']*'|"[^"]*"|[^\s,]+""")


def _tokenize_mvg(content: str) -> List[str]:
    # strip line-start comments only (a bare # elsewhere is a hex color)
    content = re.sub(r"(?m)^\s*#[^\n]*", " ", content)
    return _MVG_TOKEN.findall(content)


def _capture(toks: List[str], i: int, what: str) -> int:
    """Index of the ``pop WHAT`` closing the block that starts at ``i``."""
    depth = 1
    j = i
    while j < len(toks) - 1:
        if toks[j] == "push" and toks[j + 1] == what:
            depth += 1
        if toks[j] == "pop" and toks[j + 1] == what:
            depth -= 1
            if depth == 0:
                break
        j += 1
    return j


def _set_pixel(out: torch.Tensor, yi: int, xi: int, ch, value):
    out = out.clone()
    out[..., yi, xi, ch] = value
    return out


def _paint_method(out: torch.Tensor, cmd: str, method: str, xi: int,
                  yi: int, gc: "_GC", fuzz: float) -> torch.Tensor:
    """The pixel paint methods (DrawPrimitive, draw.c:5630-5700):
    point/replace/floodfill/filltoborder/reset on the fill color
    ("color") or the alpha channel ("matte"/"alpha"), each image at its
    own (xi, yi) pixel."""
    from . import paint as pt

    nc = out.shape[-1]
    if cmd == "color":
        fillc = torch.tensor(list(gc.fill[:nc]), dtype=out.dtype,
                             device=out.device)
        if method == "point":
            return _set_pixel(out, yi, xi, slice(None), fillc)
        if method == "replace":
            if out.dim() == 4:
                return torch.stack([_paint_method(o, cmd, method, xi, yi, gc,
                                                  fuzz) for o in out])
            target = out[yi, xi].tolist()
            return pt.opaque_paint(out, target, gc.fill[:nc], fuzz=fuzz)
        if method in ("floodfill", "filltoborder"):
            return pt.floodfill(out, xi, yi, gc.fill[:nc], fuzz=fuzz)
        if method == "reset":
            return fillc.expand(out.shape).clone()
        return out
    if nc not in (2, 4):        # matte/alpha need an alpha channel
        return out
    av = gc.fill[3] if len(gc.fill) > 3 else 1.0
    avt = torch.tensor(av, dtype=out.dtype, device=out.device)
    if method == "point":
        return _set_pixel(out, yi, xi, nc - 1, avt)
    if method == "replace":
        target = out[..., yi, xi, :nc - 1][..., None, None, :]
        m = ((out[..., :nc - 1] - target).abs() <= fuzz + 1e-6).all(-1)
    elif method in ("floodfill", "filltoborder"):
        filled = pt.floodfill(out[..., :nc - 1], xi, yi, [-1.0] * (nc - 1),
                              fuzz=fuzz)
        m = filled[..., 0] < 0
    elif method == "reset":
        m = torch.ones(out.shape[:-1], dtype=torch.bool, device=out.device)
    else:
        return out
    return torch.cat([out[..., :nc - 1],
                      torch.where(m, avt, out[..., nc - 1])[..., None]], -1)


def draw(img: torch.Tensor, mvg: str, has_alpha: bool = False,
         fuzz: float = 0.0) -> torch.Tensor:
    """DrawImage (draw.c:4554): interpret MVG content over an image (or
    each image of a batch: the coverage of a primitive is computed once
    and blended into every image)."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    toks = _tokenize_mvg(mvg)
    i = 0
    gc = _GC()
    stack: List[_GC] = []
    gradients: Dict[str, dict] = {}
    patterns: Dict[str, dict] = {}
    clip_paths: Dict[str, dict] = {}
    pending_gradient: Optional[dict] = None
    out = img

    def num():
        nonlocal i
        v = float(toks[i])
        i += 1
        return v

    def color_arg():
        nonlocal i
        t = toks[i].strip("'\"")
        i += 1
        return parse_color(t)

    def shape(pts, closed):
        return _draw_shape(out, h, w, pts, gc, closed=closed,
                           gradients=gradients)

    def capture_pattern():
        nonlocal i
        pname = toks[i]
        i += 1
        px, py, pw, ph = num(), num(), num(), num()
        j = _capture(toks, i, "pattern")
        patterns[pname] = {"name": pname, "x": px, "y": py, "w": int(pw),
                           "h": int(ph), "start": i,
                           "mvg": " ".join(toks[i:j])}
        i = j + 2  # past 'pop pattern'

    while i < len(toks):
        cmd = toks[i].lower()
        i += 1
        if cmd == "push":
            what = toks[i]; i += 1
            if what == "graphic-context":
                stack.append(gc)
                gc = gc.copy()
            elif what == "pattern":
                # skip tokens until 'pop pattern' (rendered lazily)
                capture_pattern()
            elif what == "gradient":
                # push gradient NAME linear x1,y1 x2,y2   (draw.c gradients)
                gname = toks[i]; i += 1
                gtype = toks[i]; i += 1
                coords = [num(), num(), num(), num()]
                pending_gradient = {"type": gtype, "coords": coords,
                                    "stops": []}
                gradients[gname] = pending_gradient
            elif what == "clip-path":
                # capture the definition's MVG until 'pop clip-path'
                # (draw.c clip-path defs); rendered lazily as a coverage
                # mask on first use
                cname = toks[i].strip("'\""); i += 1
                if cname.startswith("#"):
                    cname = cname[1:]
                j = _capture(toks, i, "clip-path")
                clip_paths[cname] = {"mvg": " ".join(toks[i:j])}
                i = j + 2  # past 'pop clip-path'
        elif cmd == "pop":
            what = toks[i]; i += 1
            if what == "graphic-context" and stack:
                gc = stack.pop()
            elif what == "pattern":
                capture_pattern()
            elif what == "gradient":
                pending_gradient = None
        elif cmd == "stop-color":
            col = color_arg()
            off = num() if i < len(toks) and re.match(r"^[0-9.]", toks[i]) \
                else None
            if pending_gradient is not None:
                pending_gradient["stops"].append((off, col))
        elif cmd == "fill":
            m_url = re.match(r"^'?url\(#([^)]+)\)'?$", toks[i])
            if m_url:
                i += 1
                name = m_url.group(1)
                gc.fill_gradient = name
                gc.fill = (0, 0, 0, 1)
                if name in patterns and name not in gradients:
                    pat = patterns[name]
                    if "field" not in pat:
                        tile = draw(torch.ones((pat["h"], pat["w"],
                                                img.shape[-1]),
                                               dtype=img.dtype, device=dev),
                                    pat["mvg"])
                        ry = -(-h // pat["h"])
                        rx = -(-w // pat["w"])
                        fld = tile.repeat(ry, rx, 1)[:h, :w]
                        if fld.shape[-1] < 4:
                            fld = torch.cat([fld, torch.ones(
                                fld.shape[:-1] + (4 - fld.shape[-1],),
                                dtype=fld.dtype, device=dev)], -1)
                        pat["field"] = fld
                    gradients[name] = {"type": "pattern",
                                       "field": pat["field"]}
            else:
                gc.fill_gradient = None
                gc.fill = color_arg()
        elif cmd == "stroke":
            m_url = re.match(r"^'?url\(#([^)]+)\)'?$", toks[i])
            if m_url:
                i += 1
                # gradient/pattern stroke: paint the stroke coverage with
                # the gradient field (draw.c stroke-pattern semantics)
                gc.stroke_gradient = m_url.group(1)
                gc.stroke = (0.0, 0.0, 0.0, 1.0)
            else:
                gc.stroke_gradient = None
                gc.stroke = color_arg()
        elif cmd == "stroke-width":
            gc.stroke_width = num()
        elif cmd == "fill-opacity":
            gc.fill_opacity = num()
        elif cmd == "stroke-opacity":
            gc.stroke_opacity = num()
        elif cmd == "fill-rule":
            gc.fill_rule = toks[i]; i += 1
        elif cmd == "font-size":
            gc.font_size = num()
        elif cmd == "font" or cmd == "font-family":
            gc.font = toks[i].strip("'\""); i += 1
        elif cmd == "text-anchor":
            gc.text_anchor = toks[i]; i += 1
        elif cmd == "translate":
            tx, ty = num(), num()
            sx, rx, ry, sy, ax, ay = gc.affine
            gc.affine = (sx, rx, ry, sy, ax + sx * tx + ry * ty,
                         ay + rx * tx + sy * ty)
        elif cmd == "scale":
            fx_, fy_ = num(), num()
            sx, rx, ry, sy, ax, ay = gc.affine
            gc.affine = (sx * fx_, rx * fx_, ry * fy_, sy * fy_, ax, ay)
        elif cmd == "rotate":
            th = math.radians(num())
            ct, st_ = math.cos(th), math.sin(th)
            sx, rx, ry, sy, ax, ay = gc.affine
            gc.affine = (sx * ct + ry * st_, rx * ct + sy * st_,
                         -sx * st_ + ry * ct, -rx * st_ + sy * ct, ax, ay)
        elif cmd == "affine":
            gc.affine = (num(), num(), num(), num(), num(), num())
        elif cmd == "line":
            # the reference composites FILL (ghost-closed AA) then STROKE
            # like any other primitive; with stroke unset the fill paints
            # the on-path pixels (DrawPrimitive default case)
            pts = gc.xform([(num(), num()), (num(), num())])
            if gc.stroke[3] > 0:
                out = shape(pts, False)
            else:
                cov = polygon_coverage(h, w, pts, gc.fill_rule, dev)
                out = _blend(out, _clip(cov, gc) * gc.fill_opacity, gc.fill)
        elif cmd == "rectangle":
            x1, y1, x2, y2 = num(), num(), num(), num()
            out = shape(gc.xform([(x1, y1), (x2, y1), (x2, y2), (x1, y2)]),
                        True)
        elif cmd == "roundrectangle":
            x1, y1, x2, y2, rx, ry = num(), num(), num(), num(), num(), num()
            out = shape(gc.xform(_roundrect_points(x1, y1, x2, y2, rx, ry)),
                        True)
        elif cmd == "circle":
            cx, cy, px, py = num(), num(), num(), num()
            r = math.hypot(px - cx, py - cy)
            out = _draw_ellipse(out, h, w, cx, cy, r, r, gc)
        elif cmd == "ellipse":
            cx, cy, rx, ry, a0, a1 = num(), num(), num(), num(), num(), num()
            out = _draw_ellipse(out, h, w, cx, cy, rx, ry, gc)
        elif cmd == "arc":
            # TraceArc (draw.c): ellipse about the midpoint of the two
            # given points, radii |center-start|, TraceEllipse density
            x1, y1, x2, y2, a0, a1 = num(), num(), num(), num(), num(), num()
            cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
            rx, ry = abs(cx - x1), abs(cy - y1)
            out = shape(gc.xform(_trace_ellipse(cx, cy, rx, ry, a0, a1)),
                        False)
        elif cmd in ("polyline", "polygon"):
            pts = []
            while i < len(toks) and re.match(r"^[-+0-9.]", toks[i]):
                pts.append((num(), num()))
            out = shape(gc.xform(pts), cmd == "polygon")
        elif cmd == "bezier":
            pts = []
            while i < len(toks) and re.match(r"^[-+0-9.]", toks[i]):
                pts.append((num(), num()))
            if len(pts) >= 2:
                out = shape(gc.xform(_trace_bezier(pts)), False)
        elif cmd == "path":
            d = toks[i].strip("'\""); i += 1
            for sub in parse_svg_path(d):
                out = shape(gc.xform(sub), len(sub) > 2 and sub[0] == sub[-1])
        elif cmd == "point":
            x, y = num(), num()
            (tx, ty), = gc.xform([(x, y)])
            xi, yi = int(round(tx)), int(round(ty))
            if 0 <= xi < w and 0 <= yi < h:
                out = _set_pixel(out, yi, xi, slice(None), torch.tensor(
                    list(gc.fill[:out.shape[-1]]), dtype=out.dtype,
                    device=dev))
        elif cmd == "direction":
            gc.direction = toks[i].strip("'\"").lower(); i += 1
        elif cmd == "text":
            x, y = num(), num()
            s = toks[i].strip("'\""); i += 1
            new = draw_text(out, s, x, y, gc.fill, gc.font_size, gc.font,
                            direction=gc.direction)
            out = new if gc.clip_mask is None else \
                out + (new - out) * gc.clip_mask[..., None]
        elif cmd == "stroke-linecap":
            gc.linecap = toks[i].strip("'\"").lower(); i += 1
        elif cmd == "stroke-linejoin":
            gc.linejoin = toks[i].strip("'\"").lower(); i += 1
        elif cmd == "stroke-miterlimit":
            gc.miterlimit = num()
        elif cmd == "stroke-dasharray":
            if i < len(toks) and toks[i].lower() in ("none", "0"):
                gc.dasharray = None
                i += 1
            else:
                arr = []
                while i < len(toks) and re.match(r"^[-+0-9.]", toks[i]):
                    arr.append(num())
                gc.dasharray = arr or None
        elif cmd == "stroke-dashoffset":
            gc.dashoffset = num()
        elif cmd == "clip-path":
            # apply a previously-defined clip path (draw.c:4554 clip-path
            # lookup; mask = coverage of the def's geometry)
            name = toks[i].strip("'\""); i += 1
            m_url = re.match(r"^url\(#([^)]+)\)$", name)
            if m_url:
                name = m_url.group(1)
            if name in clip_paths:
                cp = clip_paths[name]
                if "mask" not in cp:
                    cp["mask"] = draw(
                        torch.zeros((h, w, 1), dtype=img.dtype, device=dev),
                        "push graphic-context fill white stroke none " +
                        cp["mvg"] + " pop graphic-context")[..., 0]
                gc.clip_mask = cp["mask"]
        elif cmd in ("color", "matte", "alpha"):
            px, py = num(), num()
            method = toks[i].lower() if i < len(toks) else "point"
            i += 1
            xi = min(max(int(math.ceil(px - 0.5)), 0), w - 1)
            yi = min(max(int(math.ceil(py - 0.5)), 0), h - 1)
            out = _paint_method(out, cmd, method, xi, yi, gc, fuzz)
        elif cmd in ("clip-rule", "decorate",
                     "encoding", "gravity", "interline-spacing",
                     "interword-spacing", "kerning", "viewbox",
                     "class", "use", "compliance"):
            # consume this keyword's arguments
            i += 4 if cmd == "viewbox" else 1
        # an unknown token is skipped (MVG is forgiving)
    return out.clamp(0.0, 1.0)


def _roundrect_points(x1, y1, x2, y2, rx, ry, n=None):
    """TraceRoundRectangle (draw.c): clamp radii to half the extent,
    four quarter TraceEllipse arcs (270-360, 0-90, 90-180, 180-270),
    closed at the first point."""
    sx, sy = abs(x2 - x1), abs(y2 - y1)
    rx = min(rx, 0.5 * sx)
    ry = min(ry, 0.5 * sy)
    x0, y0 = min(x1, x2), min(y1, y2)
    pts = []
    pts += _trace_ellipse(x0 + sx - rx, y0 + ry, rx, ry, 270.0, 360.0)
    pts += _trace_ellipse(x0 + sx - rx, y0 + sy - ry, rx, ry, 0.0, 90.0)
    pts += _trace_ellipse(x0 + rx, y0 + sy - ry, rx, ry, 90.0, 180.0)
    pts += _trace_ellipse(x0 + rx, y0 + ry, rx, ry, 180.0, 270.0)
    pts.append(pts[0])
    return pts

def _gradient_field(h, w, grad: dict, dtype=torch.float32, device="cpu"
                    ) -> torch.Tensor:
    """Evaluate a two-(or multi-)stop gradient over the canvas -> (H,W,4)."""
    if grad.get("type") == "pattern":
        return grad["field"][:h, :w]
    x1, y1, x2, y2 = grad["coords"]
    yy = torch.arange(h, dtype=dtype, device=device)[:, None] * \
        torch.ones((1, w), dtype=dtype, device=device)
    xx = torch.ones((h, 1), dtype=dtype, device=device) * \
        torch.arange(w, dtype=dtype, device=device)[None, :]
    if grad["type"].startswith("radial"):
        r = math.hypot(x2 - x1, y2 - y1) or 1.0
        t = torch.sqrt((xx - x1) ** 2 + (yy - y1) ** 2) / torch.tensor(
            r, dtype=dtype, device=device)
    else:
        dx, dy = x2 - x1, y2 - y1
        d2 = dx * dx + dy * dy or 1.0
        t = ((xx - x1) * dx + (yy - y1) * dy) / torch.tensor(
            d2, dtype=dtype, device=device)
    t = t.clamp(0.0, 1.0)
    stops = grad["stops"] or [(0.0, (0, 0, 0, 1)), (1.0, (1, 1, 1, 1))]
    n = len(stops)
    offs = [s_[0] if s_[0] is not None else (k / max(n - 1, 1))
            for k, s_ in enumerate(stops)]
    cols = [torch.tensor(list(s_[1]), dtype=dtype, device=device)
            for s_ in stops]
    field = cols[0].expand(h, w, 4).to(dtype)
    for k in range(1, n):
        lo, hi = offs[k - 1], offs[k]
        seg = ((t - lo) / torch.tensor(max(hi - lo, 1e-6), dtype=dtype,
                                       device=device)).clamp(0.0, 1.0)[..., None]
        local = cols[k - 1] * (1 - seg) + cols[k] * seg
        field = torch.where((t >= lo)[..., None], local, field)
    return field


def _clip(cov, gc: _GC):
    return cov if gc.clip_mask is None else cov * gc.clip_mask


def _stroke_cov(h, w, pts, gc: _GC, closed: bool, device):
    """Stroke coverage honoring dash/cap/join state (TraceStroke +
    DrawDashPolygon, draw.c:2223)."""
    if gc.dasharray:
        cov = torch.zeros((h, w), dtype=torch.float32, device=device)
        for dash in dash_polyline(pts, gc.dasharray, gc.dashoffset, closed):
            cov = torch.maximum(cov, stroke_coverage(
                h, w, dash, gc.stroke_width, False, gc.linecap,
                gc.linejoin, gc.miterlimit, device))
        return cov
    return stroke_coverage(h, w, pts, gc.stroke_width, closed,
                           gc.linecap, gc.linejoin, gc.miterlimit, device)


def _draw_shape(img, h, w, pts, gc: _GC, closed: bool, gradients=None):
    # the reference fills OPEN paths too (ghost-closed winding + edge AA
    # — an unstroked 'line' paints its on-lattice pixels); fill applies
    # regardless of `closed`
    out = img
    dev = img.device
    if gc.fill_gradient and gradients and \
            gc.fill_gradient in gradients and gc.fill_opacity > 0:
        cov = polygon_coverage(h, w, pts, gc.fill_rule, dev)
        field = _gradient_field(h, w, gradients[gc.fill_gradient], img.dtype,
                                dev)
        out = _blend(out, _clip(cov, gc) * gc.fill_opacity, field)
    elif gc.fill[3] > 0 and gc.fill_opacity > 0:
        cov = polygon_coverage(h, w, pts, gc.fill_rule, dev)
        out = _blend(out, _clip(cov, gc) * gc.fill_opacity, gc.fill)
    if gc.stroke_gradient and gradients and \
            gc.stroke_gradient in gradients and gc.stroke_opacity > 0 \
            and gc.stroke_width > 0:
        cov = _stroke_cov(h, w, pts, gc, closed, dev)
        field = _gradient_field(h, w, gradients[gc.stroke_gradient],
                                img.dtype, dev)
        out = _blend(out, _clip(cov, gc) * gc.stroke_opacity, field)
    elif gc.stroke[3] > 0 and gc.stroke_opacity > 0 and gc.stroke_width > 0:
        cov = _stroke_cov(h, w, pts, gc, closed, dev)
        out = _blend(out, _clip(cov, gc) * gc.stroke_opacity, gc.stroke)
    return out


def _trace_ellipse(cx, cy, rx, ry, a0=0.0, a1=360.0):
    """TraceEllipse (draw.c): short segmented poly, step = 1/(8 max r)
    radians, endpoint appended at the exact stop angle."""
    step = 1.0 / (8.0 * max(max(abs(rx), abs(ry)), 1e-12))
    t0 = math.radians(a0)
    while a1 < a0:
        a1 += 360.0
    t1 = math.radians(a1)
    pts = []
    t = t0
    while t < t1:
        tm = math.fmod(t, 2.0 * math.pi)
        pts.append((cx + rx * math.cos(tm), cy + ry * math.sin(tm)))
        t += step
    tm = math.fmod(t1, 2.0 * math.pi)
    pts.append((cx + rx * math.cos(tm), cy + ry * math.sin(tm)))
    return pts

def _draw_ellipse(img, h, w, cx, cy, rx, ry, gc: _GC):
    out = img
    dev = img.device
    pts = _trace_ellipse(cx, cy, rx, ry)
    if gc.fill[3] > 0 and gc.fill_opacity > 0:
        cov = polygon_coverage(h, w, pts, gc.fill_rule, dev)
        out = _blend(out, _clip(cov, gc) * gc.fill_opacity, gc.fill)
    if gc.stroke[3] > 0 and gc.stroke_width > 0:
        cov = _stroke_cov(h, w, pts, gc, True, dev)
        out = _blend(out, _clip(cov, gc) * gc.stroke_opacity, gc.stroke)
    return out


# ---------------------------------------------------------------------------
# Text (annotate.c flow: host glyph rasterization + device composite)
# ---------------------------------------------------------------------------

_FONT_PATHS = (
    "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
    "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
    "/usr/share/fonts/TTF/DejaVuSans.ttf",
)


def _have_raqm() -> bool:
    from PIL import features

    return bool(features.check("raqm"))


def _load_font_from(font: Optional[str], size: float):
    """(face, source): the first of ``font`` and the JAX module's
    candidate paths that FreeType opens, else PIL's default font."""
    from PIL import ImageFont

    from ..core.policy import enforce_path

    engine = ImageFont.Layout.RAQM if _have_raqm() else \
        ImageFont.Layout.BASIC
    if font:
        enforce_path(font)
    candidates = ([font] if font else []) + list(_FONT_PATHS)
    for c in candidates:
        try:
            return ImageFont.truetype(c, int(round(size)),
                                      layout_engine=engine), c
        except Exception:
            continue
    return ImageFont.load_default(), "PIL default"


def _load_font(font: Optional[str], size: float):
    """FreeType face lookup; complex-text shaping via the raqm layout
    engine when libraqm is present — the same engine annotate.c:147
    RenderFreetype drives — falling back to basic layout."""
    return _load_font_from(font, size)[0]


def loaded_font(font: Optional[str] = None, size: float = 12.0) -> str:
    """The font file that text of ``font`` at ``size`` is drawn with, or
    "PIL default" when no candidate opens."""
    return _load_font_from(font, size)[1]


def _text_kwargs(direction: Optional[str], language: Optional[str]):
    """Map draw_info->direction / -direction values onto raqm's
    paragraph direction (annotate.c raqm_set_par_direction); shaping
    kwargs are only legal under the raqm engine."""
    if not _have_raqm():
        return {}
    kw = {}
    d = (direction or "").lower()
    if d in ("right-to-left", "rtl"):
        kw["direction"] = "rtl"
    elif d in ("left-to-right", "ltr"):
        kw["direction"] = "ltr"
    if language:
        kw["language"] = language
    return kw


def render_text_mask(text: str, font: Optional[str] = None,
                     size: float = 12.0,
                     direction: Optional[str] = None,
                     language: Optional[str] = None):
    """Host-side glyph rasterization -> (float32 coverage mask, ascent)
    (annotate.c RenderFreetype analog via FreeType, through PIL; complex
    scripts shaped by raqm when available)."""
    from PIL import Image as PImage
    from PIL import ImageDraw

    f = _load_font(font, size)
    kw = _text_kwargs(direction, language)
    probe = PImage.new("L", (4, 4))
    dr = ImageDraw.Draw(probe)
    try:
        bbox = dr.textbbox((0, 0), text, font=f, **kw)
    except Exception:       # bitmap default font: no shaping kwargs
        kw = {}
        bbox = dr.textbbox((0, 0), text, font=f)
    tw = max(bbox[2] - bbox[0], 1)
    th = max(bbox[3] - bbox[1], 1)
    canvas = PImage.new("L", (tw + 4, th + 4), 0)
    dr = ImageDraw.Draw(canvas)
    dr.text((2 - bbox[0], 2 - bbox[1]), text, fill=255, font=f, **kw)
    return np.asarray(canvas, np.float32) / 255.0, -bbox[1] + 2


def draw_text(img: torch.Tensor, text: str, x: float, y: float,
              color: Sequence[float], size: float = 12.0,
              font: Optional[str] = None,
              direction: Optional[str] = None) -> torch.Tensor:
    """AnnotateImage core: composite a glyph mask at the baseline point."""
    mask, ascent = render_text_mask(text, font, size, direction=direction)
    mh, mw = mask.shape
    h, w = img.shape[-3], img.shape[-2]
    x0 = int(round(x))
    y0 = int(round(y)) - ascent
    full = np.zeros((h, w), np.float32)
    sx0, sy0 = max(-x0, 0), max(-y0, 0)
    dx0, dy0 = max(x0, 0), max(y0, 0)
    cw = min(mw - sx0, w - dx0)
    ch = min(mh - sy0, h - dy0)
    if cw > 0 and ch > 0:
        full[dy0:dy0 + ch, dx0:dx0 + cw] = mask[sy0:sy0 + ch, sx0:sx0 + cw]
    return _blend(img, torch.from_numpy(full).to(img.device), color)


def annotate(img: torch.Tensor, text: str, x: float = 0, y: float = 0,
             color=(0, 0, 0, 1), size: float = 12.0,
             font: Optional[str] = None, gravity: str = "northwest",
             direction: Optional[str] = None) -> torch.Tensor:
    """AnnotateImage (annotate.c:229) with gravity placement."""
    from .composite import gravity_offset

    mask, ascent = render_text_mask(text, font, size, direction=direction)
    mh, mw = mask.shape
    h, w = img.shape[-3], img.shape[-2]
    gx, gy = gravity_offset(gravity, w, h, mw, mh, int(x), int(y))
    return draw_text(img, text, gx, gy + ascent, color, size, font,
                     direction=direction)


def get_type_metrics(text: str, font: Optional[str] = None,
                     size: float = 12.0) -> Dict[str, float]:
    """GetTypeMetrics (annotate.c:680) analog."""
    from PIL import Image as PImage
    from PIL import ImageDraw

    f = _load_font(font, size)
    probe = PImage.new("L", (4, 4))
    dr = ImageDraw.Draw(probe)
    bbox = dr.textbbox((0, 0), text, font=f)
    try:
        asc, desc = f.getmetrics()
    except Exception:
        asc, desc = int(size * 0.8), int(size * 0.2)
    return {"width": float(bbox[2] - bbox[0]),
            "height": float(bbox[3] - bbox[1]),
            "ascent": float(asc), "descent": float(-desc),
            "max_advance": float(size)}
