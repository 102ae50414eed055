#!/usr/bin/env python3
"""Time the per-pixel EWA sampler of this checkout against another's, and
split its calls into host and device time.

``ops/distort.sample_ewa_reference_var`` groups the output pixels into
power-of-two buckets and scans each bucket's taps on the card.  This
script loads the other checkout's ``imagemagick_tpu_torch`` under another
module name and gives both the same 8 x 1080 x 1920 x 3 frames (config
#2's shape) from ``--seed``.

1. For polar and perspective (``chip_smoke._distort_methods``'
   arguments), it requires the two checkouts' outputs to agree within
   ``chip_smoke.DISTORT_TOL`` but for ``SELECT_SHARE`` of the pixels,
   prints each bucket's size and the scan each checkout gives it, and
   times each in turns (other, this, this, other): per call
   (``chip_smoke.median_ms``: one event pair around one call, host work
   included) and the card's busy time in one call (the sum of its CUDA
   kernels, copies and memsets on ``torch.profiler``'s clock), with
   their number.
2. For every per-pixel-EWA method of ``chip_smoke._distort_methods``, one
   call of this checkout split into its host parts, each timed on the
   host's clock: the float64 maps up to the sampler, the per-pixel
   ellipses (``_clamped_ellipse_np``) and the buckets
   (``_ewa_buckets``), beside the call's wall time (synchronized before
   and after) and the card's busy time in a profiled call.  The card's
   idle share is 1 - busy / wall.

Run from the repository root on a machine with one CUDA card:
``python3 ewa_scan_ab.py OTHER [--seed N]``, OTHER the root of a checkout
of another commit (for example unpacked from ``git archive``).  It fails
without a card.
"""

import argparse
import importlib
import statistics
import time
from pathlib import Path

import torch

N2, H2, W2, C = 8, 1080, 1920, 3
AB_METHODS = ("polar", "perspective")
AB_ROUNDS = 2


def busy(fn) -> tuple:
    """(ms the card is busy, CUDA kernels, copies and memsets) in one
    call of fn, on the profiler's clock."""
    from chip_smoke import cuda_events

    ev = cuda_events(fn, 1)
    return sum(t for _, t in ev), len(ev)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ewa_scan_ab: no CUDA card")
    from chip_smoke import (DISTORT_TOL, SELECT_SHARE, _apart,
                            _distort_methods, card, ewa_scan, median_ms,
                            require)
    from k6_ab import load_other
    from imagemagick_tpu_torch.ops import distort as dt

    name_limit = card()
    print(name_limit)
    load_other(args.other.resolve())
    odt = importlib.import_module("other_imagemagick_tpu_torch.ops.distort")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    frames = torch.rand((N2, H2, W2, C), generator=gen, device=dev)
    methods = {m[0]: m for m in _distort_methods(H2, W2)}

    plans = []
    plan = dt._ewa_plan

    def spy(n, nbc, nvb, uwb):
        chunk, kb = plan(n, nbc, nvb, uwb)
        plans.append((nvb, uwb, n, ewa_scan(n, chunk, nvb, kb)))
        return chunk, kb

    dt._ewa_plan = spy
    for label in AB_METHODS:
        _, method, margs, bestfit, _ = methods[label]

        def this(mod=dt):
            return mod.distort(frames, method, margs, bestfit=bestfit)

        def other():
            return this(odt)

        plans.clear()
        got = this()
        kinds = list(plans)
        want = other()
        err, n_off, n_px = _apart(got, want.cpu(), DISTORT_TOL)
        require(n_off <= SELECT_SHARE * n_px,
                f"{label}: {n_off} of {n_px} pixels apart")
        del got, want
        # the other checkout's scan of each bucket, from its own constants
        seq = getattr(odt, "_EWA_SEQ_TAPS", None)
        other_kinds = []
        for nvb, uwb, n, _ in kinds:
            fits = n * N2 * C * nvb * uwb <= odt._EWA_BLOCK
            if seq is not None and not fits and nvb * uwb <= seq:
                other_kinds.append("tap by tap")
            else:
                other_kinds.append("one block" if fits else "blocks")
        print(f"{label}: this vs other max|d| {err:.3e}, {n_off} of {n_px} "
              f"px apart by more than {DISTORT_TOL}; buckets (scanlines, "
              f"taps a line, pixels): this / other scan: " + "; ".join(
                  f"({nvb}, {uwb}, {n}) {k} / {o}" for (nvb, uwb, n, k), o
                  in zip(kinds, other_kinds)))
        walls = {"other": [], "this": []}
        dev_ms = {"other": [], "this": []}
        for _ in range(AB_ROUNDS):
            for name, fn in (("other", other), ("this", this),
                             ("this", this), ("other", other)):
                walls[name].append(median_ms(fn, runs=1)[0])
                dev_ms[name].append(busy(fn))
        for name in ("other", "this"):
            print(f"{label} {name}: per call "
                  f"{[round(t, 4) for t in walls[name]]} ms (median "
                  f"{statistics.median(walls[name]):.4f}); card busy "
                  f"{[round(t, 4) for t, _ in dev_ms[name]]} ms (median "
                  f"{statistics.median(t for t, _ in dev_ms[name]):.4f}), "
                  f"{dev_ms[name][0][1]} CUDA kernels, copies and memsets "
                  f"a call [{name_limit}]")
    dt._ewa_plan = plan

    # host split of this checkout's per-pixel-EWA calls
    marks = {}
    sampler, ellipse, buckets = (dt.sample_ewa_reference_var,
                                 dt._clamped_ellipse_np, dt._ewa_buckets)

    def timed(key, fn):
        def wrap(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            marks[key] = marks.get(key, 0.0) + time.perf_counter() - t
            return out
        return wrap

    def at_sampler(*a, **k):
        marks.setdefault("sampler", time.perf_counter())
        return sampler(*a, **k)

    for label, method, margs, bestfit, var in _distort_methods(H2, W2):
        if not var:
            continue

        def call():
            return dt.distort(frames, method, margs, bestfit=bestfit)

        call()
        walls, parts = [], []
        dt.sample_ewa_reference_var = at_sampler
        dt._clamped_ellipse_np = timed("ellipse", ellipse)
        dt._ewa_buckets = timed("buckets", buckets)
        for _ in range(3):
            marks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            parts.append(((marks["sampler"] - t0) * 1e3,
                          marks.get("ellipse", 0.0) * 1e3,
                          marks.get("buckets", 0.0) * 1e3))
        dt.sample_ewa_reference_var = sampler
        dt._clamped_ellipse_np = ellipse
        dt._ewa_buckets = buckets
        i = walls.index(statistics.median(walls))
        b_ms, n_ev = busy(call)
        maps, ell, bk = parts[i]
        print(f"host split {label}{margs[:3]} on {tuple(frames.shape)}: "
              f"wall {walls[i]:.4f} ms (median of 3); host maps before the "
              f"sampler {maps:.4f}, ellipses {ell:.4f}, buckets {bk:.4f} "
              f"(together {maps + ell + bk:.4f}, "
              f"{(maps + ell + bk) / walls[i]:.1%}); card busy {b_ms:.4f} "
              f"in {n_ev} kernels, copies and memsets (idle "
              f"{1 - b_ms / walls[i]:.1%}) [{name_limit}]")


if __name__ == "__main__":
    main()
