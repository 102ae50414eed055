#!/usr/bin/env python3
"""Time kernel K1 at other blockings and staged-slice depths.

K1 (``imagemagick_tpu_torch/csrc/fused_pipeline.cu``) runs a block of
four warps per (program, LB-lane chunk); each warp multiplies its 8
output lanes over their own window of input lanes, and the block stages
the band and G in KC-deep slices of the chunk's range, which every warp
waits for.  This script builds copies of the source with other choices,
one ``nvcc`` per copy, all started together, into
``imagemagick_tpu_torch/_build/k1split/``: LB = 16 (two warps a lane
group, each half of the rows) or 32 (one warp a lane group, all the
rows), KC = 16 or 32.  It derives each copy's staged ranges for its LB
and KC, holds each copy's K1 to the shipped K1 on every value at config
#1's shape (32 x 512x768x3 -> 256x256 gray) and config #5's (16 x
512x768x3 -> 256x256x3), and times every copy device-only
(``chip_smoke.device_ms``, all interleaved, two rounds), with its
registers from ``ptxas``.  The first row is the choice the source ships
with.  The rows marked "timing only" change what the kernel computes, to
see where its time goes: no staging copies (the products run on whatever
shared memory holds), or no horizontal products (the staging and the
vertical product alone); their values are not checked.

Run from the repository root on a machine with one CUDA card:
``python3 k1_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

LB = "constexpr int LB = 32; "
KC = "constexpr int KC = 16; "
STAGE_BAND = """          cp_async16(band_s + i * BS + c,
                     in ? x + (row0 + rc + i) * WINC + c0 + k0 + c : x, in);"""
STAGE_G = """          cp_async16(g_s + s2 * LB + j, g + (size_t)(k0 + s2) * 128 + j,
                     true);"""
PRODUCTS = "for (int k = kb; k < ke; k += 4) {   // the warp's window only"
# timing-only changes: (old, new) pairs
NO_STAGING = ((STAGE_BAND, "          (void)in;"), (STAGE_G, ""))
NO_PRODUCTS = ((PRODUCTS, "for (int k = kb; k < kb; k += 4) {"),)
# name -> (LB, KC, timing-only changes)
SPLITS = {
    "LB 32, KC 16": (32, 16, ()),
    "LB 16, KC 16": (16, 16, ()),
    "LB 16, KC 32": (16, 32, ()),
    "LB 32, KC 32": (32, 32, ()),
    "timing only: LB 16, KC 16, no staging copies": (16, 16, NO_STAGING),
    "timing only: LB 16, KC 16, no horizontal products":
        (16, 16, NO_PRODUCTS),
    "timing only: LB 32, KC 16, no staging copies": (32, 16, NO_STAGING),
    "timing only: LB 32, KC 16, no horizontal products":
        (32, 16, NO_PRODUCTS),
}
GRAY = ((0.212656, 0.715158, 0.072186),)


def variant(src: str, lb: int, kc: int, timing_only=()) -> str:
    for old, new in (*timing_only, (LB, f"constexpr int LB = {lb}; "),
                     (KC, f"constexpr int KC = {kc}; ")):
        if old not in src:
            raise SystemExit(f"the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_split: no CUDA card")
    from chip_smoke import card, device_ms, require, thumbnail_plan
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "fused_pipeline.cu").read_text()
    out = _build._OUT / "k1split"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, split) in enumerate(SPLITS.items()):
        cu = out / f"k1_split_{i}.cu"
        cu.write_text(variant(src, *split))
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.FLAGS, "-shared", "-o", str(so),
               str(cu)]
        builds.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"fused_pipeline_kernel[^\n]*\n[^\n]*?(\d+) bytes "
                          r"spill stores[^\n]*\n[^\n]*Used (\d+) registers",
                          log)
        regs = [f"{r} ({st} bytes spilled)" if int(st) else r
                for st, r in regs]
        lib = ctypes.CDLL(str(so))
        lib.k1_fused_pipeline.argtypes = _build._SIGNATURES[
            "k1_fused_pipeline"]
        lib.k1_fused_pipeline.restype = ctypes.c_int
        libs[name] = (lib, "/".join(regs) or "?")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stream = torch.cuda.current_stream(dev).cuda_stream
    WV, r0s, BAND, ntiles, GB, c0s, *_ = fp._plan(
        512, 768, 3, 256, 256, "lanczos", 2.0, GRAY, 64)
    plan5 = thumbnail_plan(512, 768)
    cases = []
    for label, n, wv, gb, r0, c0, guids, nt in (
            ("config #1", 32, WV, GB, r0s, c0s, tuple(range(len(c0s))),
             ntiles),
            ("config #5", 16, plan5.WV, plan5.GB, plan5.r0s, plan5.c0s,
             plan5.guids, plan5.ntiles)):
        x = torch.rand((n * 512, 768 * 3), generator=gen, device=dev)
        ops = fp.plan_to_tensors(wv, gb, fp.flat_r0(r0, n, 512), dev)
        cases.append((label, x, ops, gb, c0, guids, nt))

    def launch(lib, lb, kc, x, ops, gb, c0, guids, nt):
        n, span, _ = gb.shape
        kr = torch.from_numpy(fp._windows(
            (gb.reshape(n, span, 128 // lb, lb) != 0).any(axis=3), kc)).to(
                dev)
        c0_t = torch.tensor(c0, dtype=torch.int32, device=dev)
        g_t = torch.tensor(guids, dtype=torch.int32, device=dev)
        _, TO, band = ops.WV.shape
        y = torch.empty((ops.r0.shape[0] * TO, len(c0) * 128), device=dev)
        # the tensors stay referenced for as long as run is: their memory
        # must not go back to the allocator while the kernel reads it
        args = (ops.r0, x, ops.WV, ops.GB, kr, ops.hwin, ops.vwin, c0_t,
                g_t, y)

        def run():
            _build.check(lib.k1_fused_pipeline(
                *(t.data_ptr() for t in args), ops.r0.shape[0], nt,
                ops.WV.shape[0] // nt, len(c0), TO, band, span, x.shape[1],
                len(c0) * 128, 1, stream), "k1_fused_pipeline")
            return y
        return run

    for label, x, ops, gb, c0, guids, nt in cases:
        want = fp.fused_kernel(x, ops, c0, guids, nt)
        fns = []
        for name, (lib, _) in libs.items():
            lb, kc, _ = SPLITS[name]
            fn = launch(lib, lb, kc, x, ops, gb, c0, guids, nt)
            if not name.startswith("timing only"):
                got = fn()
                torch.cuda.synchronize()
                require(bool(torch.equal(got, want)),
                        f"{name} differs from the shipped K1 at {label}")
            fns.append(fn)
        for rnd in range(2):
            times = device_ms(*fns)
            for t, (name, (_, regs)) in zip(times, libs.items()):
                held = ("values not checked" if name.startswith(
                    "timing only") else "equal to the shipped K1")
                print(f"round {rnd} {label} {name} ({regs} registers): k1 "
                      f"{t:.4f} ms device-only, {held} [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
