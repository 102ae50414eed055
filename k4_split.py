#!/usr/bin/env python3
"""Time kernel K4 beside copies of its source with one thing changed.

K4 (``imagemagick_tpu_torch/csrc/histogram256.cu``) counts config #3's
16 rows of 1056*816 values.  This script builds copies of the source,
one ``nvcc`` per copy, all started together, into
``imagemagick_tpu_torch/_build/k4split/``: other load depths (UNROLL),
other blocks an SM, and a timing-only copy whose threads compute each
value's bin but add nothing to shared memory (its counts are not
checked).  Every other copy must equal K4's plain version on every
count.  It times the shipped kernel and every copy device-only
(``chip_smoke.device_ms``: one event pair around 20 back-to-back calls),
interleaved, on a uniform and on a 90 %-white page, beside two PyTorch
yardsticks that read the same 55 MB: ``torch.sum`` and ``torch.histc``.

Run from the repository root on a machine with one CUDA card:
``python3 k4_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

N3, H3, W3 = 16, 1056, 816
COUNT = ("  auto count = [&](float v) {\n    atomicAdd(&hist[bin_of(v) * "
         "LANES + lane], 1);\n  };")
REDUCE = "  __syncthreads();\n\n  int total = 0;"
COPIES = {
    "as shipped": [],
    "UNROLL 8": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 8;")],
    "UNROLL 2": [("constexpr int UNROLL = 4;", "constexpr int UNROLL = 2;")],
    "6 blocks an SM": [("constexpr int BLOCKS_PER_SM = 4;",
                        "constexpr int BLOCKS_PER_SM = 6;")],
    "3 blocks an SM": [("constexpr int BLOCKS_PER_SM = 4;",
                        "constexpr int BLOCKS_PER_SM = 3;")],
    "no shared atomics (timing only)": [
        (COUNT, "  int sink = 0;\n  auto count = [&](float v) { sink += "
                "bin_of(v); };"),
        (REDUCE, "  if (sink == 0x7fffffff) hist[tid] = sink;\n" + REDUCE)],
}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_split: no CUDA card")
    from chip_smoke import card, device_ms, require
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import gpu_kernels as gk

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "histogram256.cu").read_text()
    out = _build._OUT / "k4split"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, edits) in enumerate(COPIES.items()):
        text = src
        for old, new in edits:
            require(old in text, f"histogram256.cu no longer holds {old!r}")
            text = text.replace(old, new)
        cu = out / f"k4_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.FLAGS, "-shared", "-o", str(so),
               str(cu)]
        builds.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for name, so, proc in builds:
        log = proc.communicate()[0]
        require(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.k4_histogram256.argtypes = _build._SIGNATURES["k4_histogram256"]
        lib.k4_histogram256.restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", log)
        libs[name] = (lib, regs[0] if regs else "?")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = torch.rand((N3, H3 * W3), generator=gen, device=dev)
    white = torch.where(torch.rand(rows.shape, generator=gen, device=dev)
                        < 0.9, 1.0, rows)
    stream = gk.stream_of(rows)
    scratch = gk._k4_scratch(dev, stream)

    def copy(lib, x):
        def run():
            y = torch.empty((N3, 256), device=dev)
            _build.check(lib.k4_histogram256(
                x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                gk.K4_SCRATCH_ROWS, N3, H3 * W3, stream), "k4_histogram256")
            return y
        return run

    for page, x in (("uniform", rows), ("90 % white", white)):
        ref = gk.histogram256_plain(x)
        for name, (lib, _) in libs.items():
            got = copy(lib, x)()
            torch.cuda.synchronize()
            if "timing only" not in name:
                require(torch.equal(got, ref), f"k4 copy {name} on {page}")
        names = ["shipped"] + list(libs) + ["torch.sum", "torch.histc"]
        fns = ([lambda x=x: gk.histogram256(x)] +
               [copy(lib, x) for lib, _ in libs.values()] +
               [lambda x=x: torch.sum(x),
                lambda x=x: torch.histc(x, 256, -0.5 / 255, 255.5 / 255)])
        for name, dv in zip(names, device_ms(*fns)):
            regs = f", {libs[name][1]} registers" if name in libs else ""
            print(f"k4 {page} {tuple(x.shape)} {name}: {dv:.4f} ms "
                  f"device-only{regs} [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
