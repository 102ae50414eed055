#!/usr/bin/env python3
"""Time kernels K6a and K6c at other block shapes and without row padding.

K6a and K6c (``imagemagick_tpu_torch/csrc/wiener_fft.cu``) run W/16
threads a block, at most 256, with ``__launch_bounds__`` asking for three
blocks an SM, on shared-memory rows padded by one float2 after every 16.
This script builds copies of the source with other choices, one ``nvcc``
per copy, all started together, into ``imagemagick_tpu_torch/_build/
split/``, holds each copy's K6a and K6c to their plain versions at config
#4's shape (one 2160 x 4096 plane), and times every copy device-only
(``chip_smoke.device_ms``, all interleaved, two rounds) beside
``torch.fft.fft`` and ``torch.fft.ifft`` and each copy's registers from
``ptxas``.  The first row is the choice the source ships with.

Run from the repository root on a machine with one CUDA card:
``python3 k6_block_split.py [--seed N]``.  It fails without a card.
"""

import argparse
import ctypes
import re
import subprocess
import sys

import torch

H, W = 2160, 4096
THREADS = "const int t = ((n + 15) / 16 + 31) / 32 * 32;"
MAX_THREADS = "constexpr int FFT_MAX_THREADS = 256;"
BLOCKS = "constexpr int FFT_BLOCKS_PER_SM = 3;"
PAD = "return i + (i >> 4);"
# name -> (threads per block as W / d, at most; blocks an SM asked of
# ptxas; padded rows)
SPLITS = {
    "W/16 threads (256), 3 blocks, padded": (16, 256, 3, True),
    "W/16 threads (256), 3 blocks, unpadded": (16, 256, 3, False),
    "W/16 threads (256), 1 block": (16, 256, 1, True),
    "W/8 threads (512), 2 blocks": (8, 512, 2, True),
    "W/8 threads (512), 1 block": (8, 1024, 1, True),
    "W/16 threads (256), 4 blocks": (16, 256, 4, True),
}


def variant(src: str, d: int, most: int, blocks: int, pad: bool) -> str:
    for old, new in (
            (THREADS, f"const int t = ((n + {d - 1}) / {d} + 31) / 32 * 32;"),
            (MAX_THREADS, f"constexpr int FFT_MAX_THREADS = {most};"),
            (BLOCKS, f"constexpr int FFT_BLOCKS_PER_SM = {blocks};"),
            (PAD, PAD if pad else "return i;")):
        if old not in src:
            raise SystemExit(f"the source no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_block_split: no CUDA card")
    from chip_smoke import card, device_ms
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    name_limit = card()
    print(name_limit)
    src = (_build._SRC / "wiener_fft.cu").read_text()
    out = _build._OUT / "split"
    out.mkdir(parents=True, exist_ok=True)
    builds = []
    for i, (name, split) in enumerate(SPLITS.items()):
        cu = out / f"k6_split_{i}.cu"
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
        regs = [re.search(kernel + r"_kernel[^\n]*\n[^\n]*\n[^\n]*\n"
                          r"[^\n]*Used (\d+) registers", log)
                for kernel in ("w_forward", "w_inverse")]
        lib = ctypes.CDLL(str(so))
        for entry in ("k6a_w_forward", "k6c_w_inverse"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, [m.group(1) if m else "?" for m in regs])

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((1, H, W), generator=gen, device=dev)
    g = fk._w_forward_plain(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    plan = fk._plan_on_host(W)

    def launch(lib, inverse):
        roots = fk._roots_on(W, inverse, dev)
        tw = fk._twiddles_on(W, inverse, dev)
        entry = lib.k6c_w_inverse if inverse else lib.k6a_w_forward
        src_t = g if inverse else x
        y = torch.empty((1, H, W), device=dev,
                        dtype=torch.float32 if inverse else torch.complex64)
        _build.check(entry(src_t.data_ptr(), y.data_ptr(), roots.data_ptr(),
                           tw.data_ptr(), plan.data_ptr(), 1, H, W,
                           plan.numel(), stream), entry.__name__)
        return y

    spec_ref, out_ref = g, fk._w_inverse_plain(g)
    for name, (lib, _) in libs.items():
        rel = float(((launch(lib, False) - spec_ref).abs().max() /
                     spec_ref.abs().max()).item())
        err = float((launch(lib, True) - out_ref).abs().max().item())
        if rel > 1e-5 or err > 1e-5:
            raise SystemExit(f"{name}: k6a {rel}, k6c {err} from plain")
    fns = [lambda lib=lib, inv=inv: launch(lib, inv)
           for lib, _ in libs.values() for inv in (False, True)]
    fns += [lambda: torch.fft.fft(x, dim=-1),
            lambda: torch.fft.ifft(g, dim=-1)]
    for rnd in range(2):
        times = device_ms(*fns)
        for i, (name, (_, regs)) in enumerate(libs.items()):
            print(f"round {rnd} {name} ({regs[0]}, {regs[1]} registers): "
                  f"k6a {times[2 * i]:.4f} ms, k6c {times[2 * i + 1]:.4f} ms "
                  f"device-only, both within 1e-5 of plain [{name_limit}]")
        print(f"round {rnd} torch.fft.fft {times[-2]:.4f} ms, torch.fft.ifft "
              f"{times[-1]:.4f} ms device-only [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
