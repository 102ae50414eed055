#!/usr/bin/env python3
"""Time kernels K4 and K2p of this checkout against another checkout's.

Loads the other checkout's ``imagemagick_tpu_torch`` under another module
name (it builds its own kernels into its own ``_build/``) and gives both
the same inputs from ``--seed``.

K4 (``csrc/histogram256.cu``) at config #3's 16 rows of 1056*816 values:
a uniform page, a 90 %-white page and a near-white page (values uniform in
[0.94, 1], about 16 bins), plus rows whose starts are not 16-byte aligned
(rowlen % 4 = 1, 2, 3).  Both checkouts must equal the plain version on
every count.  It times, in turns (other, this, this, other), each input
per call (``chip_smoke.median_ms``: one event pair around one call on an
idle stream), device-only (``chip_smoke.device_ms``: one event pair
around 20 back-to-back calls) and on the profiler's clock
(``chip_smoke.kernel_ms``: the kernel's own duration, which host work
between short launches does not stretch), beside ``torch.histc``; counts
the CUDA kernels one call of each checkout runs (``torch.profiler``); and
times config #3's fused route per call.

K2p (``csrc/blur_unsharp_pipe.cu``) at config #2's 8 x 1080x1920x3 with
15 + 9 taps and Lab: this K2p must equal this K2 and the other K2p on
every value.  It times the other K2p, this K2p and this K2 per call and
device-only, interleaved (other, this, K2, this, other), and config #2's
pipelined route per call.

Last it prints the registers, stack and spills that ptxas reported for
each checkout's K4 and K2p kernels (``_build/*.log``).

Run from the repository root on a machine with one CUDA card:
``python3 k4_k2p_ab.py OTHER [--seed N] [--only k4|k2p]``, OTHER the
root of a checkout of another commit (for example unpacked from ``git
archive``).  It fails without a card.
"""

import argparse
import importlib
import sys
from pathlib import Path

import torch

N3, H3, W3 = 16, 1056, 816
N2, H2, W2, C2 = 8, 1080, 1920, 3


def ab_k4(gen, dev, name_limit) -> None:
    from chip_smoke import (device_ms, kernel_ms, kernels_per_call,
                            median_ms, require)
    from imagemagick_tpu_torch.ops import gpu_kernels as gk
    from imagemagick_tpu_torch.ops import threshold as th

    ogk = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.gpu_kernels")
    oth = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.threshold")

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    rows = rand(N3, H3 * W3)
    pages = {
        "uniform": rows,
        "90 % white": torch.where(rand(N3, H3 * W3) < 0.9, 1.0, rows),
        "near-white": 0.94 + 0.06 * rows,
    }
    odd = {f"rowlen % 4 = {k}": rand(N3, H3 * W3 + k) for k in (1, 2, 3)}
    for name, x in {**pages, **odd}.items():
        ref = gk.histogram256_plain(x)
        got, want = gk.histogram256(x), ogk.histogram256(x)
        torch.cuda.synchronize()
        nd, nd_other = int((got != ref).sum()), int((want != ref).sum())
        print(f"k4 {name} {tuple(x.shape)}: {nd} counts differ from plain "
              f"(other checkout {nd_other}), bins "
              f"{int((ref > 0).sum(1).max())} a row at most")
        require(nd == 0 and nd_other == 0, f"k4 {name}")
    for tag, mod in (("this", gk), ("other", ogk)):
        per_call, names = kernels_per_call(lambda: mod.histogram256(rows),
                                           "histogram256")
        print(f"k4 {tag}: one call runs {per_call:g} CUDA kernels {names}")

    tags = ("other", "this", "this", "other")
    for name, x in pages.items():
        fns = [lambda m=m, x=x: m.histogram256(x)
               for m in (ogk, gk, gk, ogk)]
        for tag, pc, dv in zip(tags, median_ms(*fns), device_ms(*fns)):
            print(f"k4 {tag} {name} {tuple(x.shape)}: {pc:.4f} ms per call, "
                  f"{dv:.4f} ms device-only [{name_limit}]")
    for name, x in pages.items():
        for tag, mod in (("other", ogk), ("this", gk), ("this", gk),
                         ("other", ogk)):
            ms = kernel_ms(lambda: mod.histogram256(x), "histogram256")
            print(f"k4 {tag} {name}: kernel {ms:.4f} ms on the profiler's "
                  f"clock [{name_limit}]")
    histc = [lambda: torch.histc(rows, 256, -0.5 / 255, 255.5 / 255)]
    print(f"torch.histc {tuple(rows.shape)}: {median_ms(*histc)[0]:.4f} ms "
          f"per call, {device_ms(*histc)[0]:.4f} ms device-only "
          f"[{name_limit}]")
    batch3 = rows.reshape(N3, H3, W3, 1)

    def route3(m, t):
        return lambda: m.fused_bilevel_morph_edge(
            batch3, t.auto_threshold_values(batch3, "otsu"))

    fns = [route3(ogk, oth), route3(gk, th), route3(gk, th),
           route3(ogk, oth)]
    for tag, pc in zip(tags, median_ms(*fns)):
        print(f"config #3 fused route {tag}: {pc:.4f} ms per call "
              f"[{name_limit}]")


def ab_k2p(gen, dev, name_limit) -> None:
    from chip_smoke import device_ms, median_ms, require
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    ofp = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.fused_pipeline")
    x = torch.rand((N2, H2, W2, C2), generator=gen, device=dev)
    blur, unsharp = fp.blur_unsharp_taps(H2, W2, 2.0, 1.0)

    def k2p(m):
        return lambda: m.blur_unsharp_pipe_kernel(x, blur, unsharp, 1.0)

    def k2():
        return fp.blur_unsharp_kernel(x, blur, unsharp, 1.0, True)

    want = k2()
    for tag, fn in (("this", k2p(fp)), ("other", k2p(ofp))):
        got = fn()
        torch.cuda.synchronize()
        nd = int((got != want).sum())
        print(f"k2p {tag} {tuple(x.shape)} 15 + 9 taps: {nd} of "
              f"{got.numel()} values differ from this checkout's k2")
        require(nd == 0, f"k2p {tag} differs from k2")
    tags = ("other k2p", "this k2p", "this k2", "this k2p", "other k2p")
    fns = [k2p(ofp), k2p(fp), k2, k2p(fp), k2p(ofp)]
    for tag, pc, dv in zip(tags, median_ms(*fns), device_ms(*fns)):
        print(f"{tag} {tuple(x.shape)}: {pc:.4f} ms per call, {dv:.4f} ms "
              f"device-only [{name_limit}]")
    flat = x.reshape(N2 * H2, W2 * C2)

    def route(m):
        return lambda: m.fused_blur_unsharp_pipeline(
            flat, 2.0, 1.0, 1.0, C2, in_shape=(N2, H2, W2, C2),
            lab_roundtrip=True, pipelined=True)

    for tag, pc in zip(("other", "this", "this", "other"),
                       median_ms(route(ofp), route(fp), route(fp),
                                 route(ofp))):
        print(f"config #2 pipelined route {tag}: {pc:.4f} ms per call "
              f"[{name_limit}]")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--only", choices=("k4", "k2p"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_k2p_ab: no CUDA card")
    from chip_smoke import card
    from k2_ab import ptxas_report
    from k6_ab import load_other
    from imagemagick_tpu_torch import _build

    other_root = args.other.resolve()
    load_other(other_root)
    name_limit = card()
    print(name_limit)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.only in (None, "k4"):
        ab_k4(gen, dev, name_limit)
    if args.only in (None, "k2p"):
        ab_k2p(gen, dev, name_limit)
    for tag, build in (("this", _build._OUT),
                       ("other", other_root / "imagemagick_tpu_torch" /
                        "_build")):
        for name, regs, stack, st, ld in ptxas_report(
                build, "histogram256_kernel|blur_unsharp_pipe_kernel"):
            print(f"ptxas {tag}: {name}: {regs} registers, {stack} bytes "
                  f"stack, {st} bytes spill stores, {ld} bytes spill loads")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
