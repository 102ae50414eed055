#!/usr/bin/env python3
"""Time kernels K1 and K5 of this checkout against another checkout's.

Loads the other checkout's ``imagemagick_tpu_torch`` under another module
name (it builds its own kernels into its own ``_build/``) and gives both
the same inputs from ``--seed``.  K1 runs on the planner's operands (each
checkout derives its own tables from them) at config #1's shape, 32 x
512x768x3 -> 256x256 gray with a Lanczos resize and a sigma-2 blur, and at
config #5's thumbnail shape, 16 x 512x768x3 -> 256x256x3, Lanczos, no
blur, identity mix; K5 at config #3's 16 x 1056 x 816 with one Otsu value
per page.  It requires the two checkouts' K1 to agree on every value at
both shapes and their K5 on every pixel.  Then it times, in turns (other,
this, this, other), each kernel per call (``chip_smoke.median_ms``: one
event pair around one call on an idle stream) and device-only
(``chip_smoke.device_ms``: one event pair around 20 back-to-back calls),
and the fused routes of configs #1 and #3 per call; and this checkout's
K5 device-only beside two copies of its source with other strip heights
(strips of 8 and 32 rows at config #3 against the shipped 16), built
into ``imagemagick_tpu_torch/_build/k5strip/``.  Last it prints
the registers, stack and spills that ptxas reported for each checkout's
K1 and K5 kernels (``_build/*.log``).

Run from the repository root on a machine with one CUDA card:
``python3 k1_k5_ab.py OTHER [--seed N]``, OTHER the root of a checkout of
another commit (for example unpacked from ``git archive``).  It fails
without a card.
"""

import argparse
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

N1, H1, W1, C1 = 32, 512, 768, 3
N5 = 16
N3, H3, W3 = 16, 1056, 816
SIGMA = 2.0
GRAY = ((0.212656, 0.715158, 0.072186),)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_k5_ab: no CUDA card")
    from chip_smoke import card, device_ms, median_ms, require, thumbnail_plan
    from k2_ab import ptxas_report
    from k6_ab import load_other
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fused_pipeline as fp
    from imagemagick_tpu_torch.ops import gpu_kernels as gk
    from imagemagick_tpu_torch.ops import threshold as th

    other_root = args.other.resolve()
    load_other(other_root)
    ofp = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.fused_pipeline")
    ogk = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.gpu_kernels")
    oth = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.threshold")
    name_limit = card()
    print(name_limit)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # -- K1: the two shapes, each checkout on its own tables ----------------
    WV, r0s, BAND, ntiles, GB, c0s, *_ = fp._plan(
        H1, W1, C1, 256, 256, "lanczos", SIGMA, GRAY, 64)
    plan5 = thumbnail_plan(H1, W1)
    k1_cases = {}
    for name, n, wv, gb, r0, c0, guids, nt in (
            ("config #1", N1, WV, GB, r0s, c0s, tuple(range(len(c0s))),
             ntiles),
            ("config #5", N5, plan5.WV, plan5.GB, plan5.r0s, plan5.c0s,
             plan5.guids, plan5.ntiles)):
        x = torch.rand((n * H1, W1 * C1), generator=gen, device=dev)
        flat_r0 = fp.flat_r0(r0, n, H1)
        ops = fp.plan_to_tensors(wv, gb, flat_r0, dev)
        oops = ofp.plan_to_tensors(wv, gb, flat_r0, dev)
        k1_cases[name] = (
            lambda x=x, ops=ops, c0=c0, g=guids, nt=nt:
            fp.fused_kernel(x, ops, c0, g, nt),
            lambda x=x, ops=oops, c0=c0, g=guids, nt=nt:
            ofp.fused_kernel(x, ops, c0, g, nt))
    for name, (this, other) in k1_cases.items():
        want = other()
        got = this()
        torch.cuda.synchronize()
        ndiff = int((got != want).sum())
        print(f"k1 {name} {tuple(got.shape)}: {ndiff} of {got.numel()} "
              "values differ from the other checkout's, max|d| "
              f"{float((got - want).abs().max()):.3e}")
        require(ndiff == 0, f"k1 {name} differs")

    # -- K5 at config #3 ------------------------------------------------------
    batch3 = torch.rand((N3, H3, W3, 1), generator=gen, device=dev)
    t3 = th.auto_threshold_values(batch3, "otsu")
    want = ogk.fused_bilevel_morph_edge(batch3, t3)
    got = gk.fused_bilevel_morph_edge(batch3, t3)
    torch.cuda.synchronize()
    ndiff = int((got != want).sum())
    print(f"k5 config #3 {(N3, H3, W3)}: {ndiff} of {got.numel()} pixels "
          "differ from the other checkout's")
    require(ndiff == 0, "k5 differs")

    # -- times, interleaved (other, this, this, other) ------------------------
    tags = ("other", "this", "this", "other")
    for name, (this, other) in k1_cases.items():
        fns = [other, this, this, other]
        for tag, pc, dv in zip(tags, median_ms(*fns), device_ms(*fns)):
            print(f"k1 {tag} {name}: {pc:.4f} ms per call, {dv:.4f} ms "
                  f"device-only [{name_limit}]")
    fns = [lambda m=m: m.fused_bilevel_morph_edge(batch3, t3)
           for m in (ogk, gk, gk, ogk)]
    for tag, pc, dv in zip(tags, median_ms(*fns), device_ms(*fns)):
        print(f"k5 {tag} config #3 {(N3, H3, W3)}: {pc:.4f} ms per call, "
              f"{dv:.4f} ms device-only [{name_limit}]")

    flat1 = torch.rand((N1 * H1, W1 * C1), generator=gen, device=dev)
    mix = np.asarray(GRAY)

    def route1(m):
        return lambda: m.fused_resize_pipeline(
            flat1, 256, 256, "lanczos", SIGMA, mix, in_shape=(N1, H1, W1, C1))

    def route3(m, t):
        return lambda: m.fused_bilevel_morph_edge(
            batch3, t.auto_threshold_values(batch3, "otsu"))

    for name, fns in (
            ("config #1 fused route", [route1(ofp), route1(fp), route1(fp),
                                       route1(ofp)]),
            ("config #3 fused route", [route3(ogk, oth), route3(gk, th),
                                       route3(gk, th), route3(ogk, oth)])):
        for tag, pc in zip(tags, median_ms(*fns)):
            print(f"{name} {tag}: {pc:.4f} ms per call [{name_limit}]")

    # -- K5 at other strip heights: copies of this checkout's source whose
    # rule asks for 16 or 4 warps an SM (strips of 8 and 32 rows here) --
    rule = "132 * 8)"
    src = (_build._SRC / "morph_edge.cu").read_text()
    require(rule in src, "morph_edge.cu no longer holds its strip rule")
    out = _build._OUT / "k5strip"
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for per_sm in (16, 4):
        cu = out / f"morph_edge_{per_sm}.cu"
        cu.write_text(src.replace(rule, f"132 * {per_sm})"))
        so = cu.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.k5_morph_edge.argtypes = _build._SIGNATURES["k5_morph_edge"]
        lib.k5_morph_edge.restype = ctypes.c_int
        libs[per_sm] = lib
    x3 = batch3[..., 0].contiguous()
    ys = {per_sm: torch.empty_like(x3) for per_sm in libs}

    def k5_copy(per_sm):
        def run():
            _build.check(libs[per_sm].k5_morph_edge(
                x3.data_ptr(), t3.data_ptr(), ys[per_sm].data_ptr(), N3, H3,
                W3, gk.stream_of(x3)), "k5_morph_edge")
        return run

    fns = [lambda: gk.fused_bilevel_morph_edge(x3, t3), k5_copy(16),
           k5_copy(4)]
    for fn in fns[1:]:
        fn()
    torch.cuda.synchronize()
    for per_sm, y in ys.items():
        require(bool(torch.equal(y, got[..., 0])), f"k5 {per_sm} warps")
    for label, dv in zip(("shipped rule, 8 warps an SM", "16 warps an SM",
                          "4 warps an SM"), device_ms(*fns)):
        print(f"k5 this config #3, strips for {label}: {dv:.4f} ms "
              f"device-only [{name_limit}]")

    # -- registers and spills -------------------------------------------------
    for tag, build in (("this", _build._OUT),
                       ("other", other_root / "imagemagick_tpu_torch" /
                        "_build")):
        for name, regs, stack, st, ld in ptxas_report(
                build, "fused_pipeline_kernel|morph_edge_kernel"):
            print(f"ptxas {tag}: {name}: {regs} registers, {stack} bytes "
                  f"stack, {st} bytes spill stores, {ld} bytes spill loads")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
