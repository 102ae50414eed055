#!/usr/bin/env python3
"""Time kernel K6b at other strip widths and block shapes.

K6b (``imagemagick_tpu_torch/csrc/wiener_fft.cu``) runs a persistent grid
of blocks over strips of 4 columns (2 or 1 where 4 do not fit), H / 4
threads a block up to 512, with ``__launch_bounds__`` asking for one
block an SM, each block bringing its next strip into L2 while it
transforms one; at H = 2160 (config #4) its plan is known at compile
time.  This script builds copies of the source with other choices, one
``nvcc`` per copy, all started together, into
``imagemagick_tpu_torch/_build/strip/``, holds
each copy's K6b to its plain version at config #4's shape (one 2160 x
4096 spectrum), and times every copy device-only (``chip_smoke.device_ms``,
all interleaved, two rounds) beside ``torch.fft.fft`` then
``torch.fft.ifft`` along H, with each copy's registers from ``ptxas``.
The first row is the choice the source ships with.  The rows marked
"timing only" change what the kernel computes, to see where its time
goes: no twiddle loads (a constant instead), or no device memory (the
strip made up from its indices, the results kept but not written); their
values are not checked.

Run from the repository root on a machine with one CUDA card:
``python3 k6b_strip_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

H, W = 2160, 4096
NOISE = 0.01
COLS4 = "if (h_mask_smem(H, 4) <= K6B_MAX_SMEM)"
COLS2 = "if (h_mask_smem(H, 2) <= K6B_MAX_SMEM)"
THREADS = "const int want = ((H + 3) / 4 + 31) / 32 * 32;"
MAX_THREADS = "constexpr int K6B_MAX_THREADS = 512;"
BLOCKS = "constexpr int K6B_BLOCKS_PER_SM = 1;"
PREFETCH = "prefetch_l2(nsrc + (long long)i * W);"
STATIC = "if (same_plan(plan, Plan2160{}, H))"
TWIDDLE = "const float2 w = __ldg(&tw[(r - 1) * ns + j0]);"
READ = "return c < cols ? __ldg(&src[(long long)i * W + c]) : zero;"
WRITE = "dst[(long long)i * W + c] = make_float2(v.x * scale, v.y * scale);"
# timing-only changes: (old, new) pairs
NO_TWIDDLES = ((TWIDDLE, "const float2 w = make_float2(0.6f, 0.8f);"),)
NO_MEMORY = ((READ, "return make_float2((float)i, (float)c);"),
             (WRITE, "if (v.x == 1234.5f) dst[0] = v;"))
# name -> (strip columns, threads per block as H / d, at most;
# blocks an SM asked of ptxas; the next strip brought into L2; timing-only
# changes, or other changes)
SPLITS = {
    "4 columns, H/4 threads (512), 1 block": (4, 4, 512, 1, True, ()),
    "4 columns, 512 threads, 1 block, no L2 prefetch":
        (4, 4, 512, 1, False, ()),
    "4 columns, 512 threads, 1 block, the plan at run time":
        (4, 4, 512, 1, True, ((STATIC, "if (false)"),)),
    "4 columns, H/4 threads (544), 1 block": (4, 4, 544, 1, True, ()),
    "4 columns, H/3 threads (736), 1 block": (4, 3, 736, 1, True, ()),
    "4 columns, H/8 threads (288), 1 block": (4, 8, 512, 1, True, ()),
    "4 columns, H/2 threads (1024), 1 block": (4, 2, 1024, 1, True, ()),
    "2 columns, H/4 threads (512), 2 blocks": (2, 4, 512, 2, True, ()),
    "timing only: no twiddle loads": (4, 4, 512, 1, True, NO_TWIDDLES),
    "timing only: no device memory": (4, 4, 512, 1, True, NO_MEMORY),
}


def variant(src: str, cols: int, d: int, most: int, blocks: int,
            prefetch: bool, timing_only=()) -> str:
    for old, new in (*timing_only,
            (PREFETCH, PREFETCH if prefetch else "(void)nsrc;"),
            (COLS4, COLS4 if cols >= 4 else "if (false)"),
            (COLS2, COLS2 if cols >= 2 else "if (false)"),
            (THREADS, f"const int want = ((H + {d - 1}) / {d} + 31) / 32 * "
                      "32;"),
            (MAX_THREADS, f"constexpr int K6B_MAX_THREADS = {most};"),
            (BLOCKS, f"constexpr int K6B_BLOCKS_PER_SM = {blocks};")):
        if old not in src:
            raise SystemExit(f"the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6b_strip_split: no CUDA card")
    from chip_smoke import card, device_ms
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "wiener_fft.cu").read_text()
    out = _build._OUT / "strip"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, split) in enumerate(SPLITS.items()):
        cu = out / f"k6b_strip_{i}.cu"
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
        regs = re.findall(r"h_mask_kernel[^\n]*\n[^\n]*?(\d+) bytes spill "
                          r"stores[^\n]*\n[^\n]*Used (\d+) registers", log)
        regs = [f"{r} ({st} bytes spilled)" if int(st) else r
                for st, r in regs]
        lib = ctypes.CDLL(str(so))
        lib.k6b_h_mask.argtypes = _build._SIGNATURES["k6b_h_mask"]
        lib.k6b_h_mask.restype = ctypes.c_int
        libs[name] = (lib, "/".join(regs) or "?")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((1, H, W), generator=gen, device=dev)
    spec = fk.w_forward(x)
    pmean = torch.sum(x * x, dim=(-2, -1))
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = fk._plan_on_host(H)
    tabs = [t.data_ptr() for t in (
        fk._roots_on(H, False, dev), fk._twiddles_on(H, False, dev),
        fk._roots_on(H, True, dev), fk._twiddles_on(H, True, dev))]

    def launch(lib):
        y = torch.empty_like(spec)
        _build.check(lib.k6b_h_mask(spec.data_ptr(), pmean.data_ptr(),
                                    y.data_ptr(), *tabs, plan.data_ptr(), 1,
                                    H, W, plan.numel(), NOISE, stream),
                     "k6b_h_mask")
        return y

    ref = fk._h_mask_plain(spec, pmean, NOISE)
    for name, (lib, _) in libs.items():
        if name.startswith("timing only"):
            continue
        rel = float(((launch(lib) - ref).abs().max() /
                     ref.abs().max()).item())
        if rel > 1e-5:
            raise SystemExit(f"{name}: k6b {rel} of max|F| from plain")
    fns = [lambda lib=lib: launch(lib) for lib, _ in libs.values()]
    fns.append(lambda: torch.fft.ifft(torch.fft.fft(spec, dim=-2), dim=-2))
    for rnd in range(2):
        times = device_ms(*fns)
        for i, (name, (_, regs)) in enumerate(libs.items()):
            held = ("values not checked" if name.startswith("timing only")
                    else "within 1e-5 of plain")
            print(f"round {rnd} {name} ({regs} registers): k6b "
                  f"{times[i]:.4f} ms device-only, {held} [{name_limit}]")
        print(f"round {rnd} torch.fft.fft then torch.fft.ifft along H "
              f"{times[-1]:.4f} ms device-only [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
