#!/usr/bin/env python3
"""Time kernel K2p at other splits of its warps between the two roles.

K2p (``imagemagick_tpu_torch/csrc/blur_unsharp_pipe.cu``) gives a fixed
number of warps to the stencils (producers) and to the Lab epilogue and
the stores (consumers).  This script builds copies of the source with
other counts, one ``nvcc`` per copy, all started together, into
``imagemagick_tpu_torch/_build/split/``, runs each on config #2's batch
(8 x 1080 x 1920 x 3, blur 0x2, unsharp 0x1, gain 1, Lab), checks that its
output equals K2's bit for bit, and times K2 and every split with CUDA
events (median of 25 after a warm-up, all interleaved), beside each
copy's registers from ``ptxas``.  The first row is the split the source
ships with.

Run from the repository root on a machine with one CUDA card:
``python3 k2p_warp_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

SPLITS = ((16, 4), (8, 4), (12, 4), (20, 4), (16, 8), (24, 4))
N, H, W, C = 8, 1080, 1920, 3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2p_warp_split: no CUDA card")
    from chip_smoke import card, median_ms
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fused_pipeline as fp

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "blur_unsharp_pipe.cu").read_text()
    shipped = tuple(int(re.search(rf"constexpr int {role} = (\d+);",
                                  src).group(1)) // 32
                    for role in ("PRODUCERS", "CONSUMERS"))
    if shipped != SPLITS[0]:
        raise SystemExit(f"the source ships {shipped}, not {SPLITS[0]}")
    out = _build._OUT / "split"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for producers, consumers in SPLITS:
        text = re.sub(r"constexpr int PRODUCERS = \d+;",
                      f"constexpr int PRODUCERS = {producers * 32};", src)
        text = re.sub(r"constexpr int CONSUMERS = \d+;",
                      f"constexpr int CONSUMERS = {consumers * 32};", text)
        cu = out / f"k2p_{producers}_{consumers}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(_build._SRC),
               "-shared", "-o", str(so), str(cu)]
        builds.append(((producers, consumers), so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for split, so, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {split}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        lib = ctypes.CDLL(str(so))
        lib.k2p_blur_unsharp_pipe.argtypes = \
            _build._SIGNATURES["k2p_blur_unsharp_pipe"]
        lib.k2p_blur_unsharp_pipe.restype = ctypes.c_int
        libs[split] = (lib, regs[0] if regs else "?")

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((N, H, W, C), generator=gen, device=dev)
    blur, unsharp = fp.blur_unsharp_taps(H, W, 2.0, 1.0)
    taps = torch.tensor(blur + unsharp, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib):
        y = torch.empty_like(x)
        err = lib.k2p_blur_unsharp_pipe(x.data_ptr(), y.data_ptr(),
                                        taps.data_ptr(), N, H, W, len(blur),
                                        len(unsharp), 1.0, stream)
        _build.check(err, "k2p_blur_unsharp_pipe")
        return y

    def k2():
        return fp.blur_unsharp_kernel(x, blur, unsharp, 1.0, True)

    ref = k2()
    for split, (lib, _) in libs.items():
        if not torch.equal(launch(lib), ref):
            raise SystemExit(f"split {split} differs from K2")
    fns = [k2] + [lambda lib=lib: launch(lib) for lib, _ in libs.values()]
    times = median_ms(*fns)
    print(f"k2 {(N, H, W, C)} Lab: {times[0]:.4f} ms [{name_limit}]")
    for (split, (_, regs)), ms in zip(libs.items(), times[1:]):
        print(f"k2p {split[0]} producer + {split[1]} consumer warps "
              f"({32 * sum(split)} threads, {regs} registers): {ms:.4f} ms, "
              f"equal to K2 [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
