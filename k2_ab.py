#!/usr/bin/env python3
"""Time kernels K2 and K3 of this checkout against another checkout's.

Loads the other checkout's ``imagemagick_tpu_torch`` under another module
name (it builds its own kernels into its own ``_build/``) and gives both
the same batches from ``--seed``.  K2 runs at config #2's shape, 8 x 1080
x 1920 x 3, with config #2's 15 + 9 taps; K3 at config #2's shape with
the op route's 15 blur taps and 9 unsharp taps, and at config #1's op
route shape, 32 x 256 x 256 x 3, with 15 taps.  It requires the two
checkouts' K2 to agree on every value, with the Lab round trip and
without, and at 1 + 1 and 33 + 17 taps, and their K3 to agree on every
value at its three cases.  Then it times, in turns (other, this, this,
other), each case per call (``chip_smoke.median_ms``: one event pair
around one call on an idle stream) and device-only
(``chip_smoke.device_ms``: one event pair around 20 back-to-back calls):
K2 with and without Lab, K2 with Lab at 1 + 1, 15 + 9 and 33 + 17 taps,
and K3 at its three cases.  Last it prints the registers, stack and
spills that ptxas reported for each checkout's K2 and K3 kernels
(``_build/*.log``).

Run from the repository root on a machine with one CUDA card:
``python3 k2_ab.py OTHER [--seed N]``, OTHER the root of a checkout of
another commit (for example unpacked from ``git archive``).  It fails
without a card.
"""

import argparse
import importlib
import re
import subprocess
import sys
from pathlib import Path

import torch

N, H, W, C = 8, 1080, 1920, 3
SIGMA, SIGMA_UNSHARP, GAIN = 2.0, 1.0, 1.0
K3_CONFIG1 = (32, 256, 256, 3)


def ptxas_report(build_dir: Path, pattern: str):
    """(kernel, registers, stack bytes, spill stores, spill loads) of each
    entry whose name matches ``pattern`` in the ptxas logs of
    ``build_dir``."""
    rows, entry, frame = [], None, None
    for log in sorted(build_dir.glob("*.log")):
        for line in log.read_text().splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads", line)
            if m:
                frame = tuple(int(v) for v in m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m and entry and re.search(pattern, entry):
                rows.append((entry, int(m.group(1))) + (frame or (0, 0, 0)))
                frame = None
    names = [r[0] for r in rows]
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                             capture_output=True, timeout=60, check=True)
        names = out.stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        pass
    return [(name,) + r[1:] for name, r in zip(names, rows)]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_ab: no CUDA card")
    from chip_smoke import card, device_ms, gauss_taps, median_ms, require
    from k6_ab import load_other
    from imagemagick_tpu_torch import _build
    from imagemagick_tpu_torch.ops import fused_pipeline as fp
    from imagemagick_tpu_torch.ops import gpu_kernels as gk
    from imagemagick_tpu_torch.ops.blur import (gaussian_kernel_1d,
                                                optimal_kernel_width_2d)

    other_root = args.other.resolve()
    load_other(other_root)
    ofp = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.fused_pipeline")
    ogk = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.gpu_kernels")
    name_limit = card()
    print(name_limit)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((N, H, W, C), generator=gen, device=dev)
    bt, ut = fp.blur_unsharp_taps(H, W, SIGMA, SIGMA_UNSHARP)
    require((len(bt), len(ut)) == (15, 9), f"{len(bt)} + {len(ut)} taps")
    taps = {"1 + 1": ((1.0,), (1.0,)), "15 + 9": (bt, ut),
            "33 + 17": (gauss_taps(33, 33 / 7.0), gauss_taps(17, 17 / 9.0))}

    def this(b, u, lab):
        return lambda: fp.blur_unsharp_kernel(x, b, u, GAIN, lab)

    def other(b, u, lab):
        return lambda: ofp.blur_unsharp_kernel(x, b, u, GAIN, lab)

    # -- equality -----------------------------------------------------------
    for key, lab in (("15 + 9", True), ("15 + 9", False), ("1 + 1", True),
                     ("33 + 17", True)):
        b, u = taps[key]
        want = other(b, u, lab)()
        got = this(b, u, lab)()
        torch.cuda.synchronize()
        ndiff = int((got != want).sum())
        print(f"k2 {key} taps lab={lab}: {ndiff} of {got.numel()} values "
              "differ from the other checkout's, max|d| "
              f"{float((got - want).abs().max()):.3e}")
        require(ndiff == 0, f"k2 {key} lab={lab} differs")
        del got, want

    # -- K3: equality ---------------------------------------------------------
    taps15 = gauss_taps(optimal_kernel_width_2d(0.0, SIGMA), SIGMA)
    taps9 = gaussian_kernel_1d(0.0, SIGMA_UNSHARP)
    require((len(taps15), len(taps9)) == (15, 9),
            f"k3 {len(taps15)} and {len(taps9)} taps")
    x1 = torch.rand(K3_CONFIG1, generator=gen, device=dev)
    k3_cases = (("config #2", x, taps15), ("config #2", x, taps9),
                ("config #1", x1, taps15))
    for name, xk, tk in k3_cases:
        want = ogk.separable_blur(xk, tk)
        got = gk.separable_blur(xk, tk)
        torch.cuda.synchronize()
        ndiff = int((got != want).sum())
        print(f"k3 {name} {tuple(xk.shape)} {len(tk)} taps: {ndiff} of "
              f"{got.numel()} values differ from the other checkout's, "
              f"max|d| {float((got - want).abs().max()):.3e}")
        require(ndiff == 0, f"k3 {name} {len(tk)} taps differs")
        del got, want

    # -- times, interleaved (other, this, this, other) ------------------------
    tags = ("other", "this", "this", "other")
    for key, lab in (("15 + 9", True), ("15 + 9", False), ("1 + 1", True),
                     ("33 + 17", True)):
        b, u = taps[key]
        fns = [other(b, u, lab), this(b, u, lab), this(b, u, lab),
               other(b, u, lab)]
        per_call = median_ms(*fns)
        device = device_ms(*fns)
        for tag, pc, dv in zip(tags, per_call, device):
            print(f"k2 {tag} {(N, H, W, C)} {key} taps lab={lab}: {pc:.4f} "
                  f"ms per call, {dv:.4f} ms device-only [{name_limit}]")

    for name, xk, tk in k3_cases:
        fns = [lambda m=m: m.separable_blur(xk, tk)
               for m in (ogk, gk, gk, ogk)]
        per_call = median_ms(*fns)
        device = device_ms(*fns)
        for tag, pc, dv in zip(tags, per_call, device):
            print(f"k3 {tag} {name} {tuple(xk.shape)} {len(tk)} taps: "
                  f"{pc:.4f} ms per call, {dv:.4f} ms device-only "
                  f"[{name_limit}]")

    # -- registers and spills -------------------------------------------------
    for tag, build in (("this", _build._OUT),
                       ("other", other_root / "imagemagick_tpu_torch" /
                        "_build")):
        for name, regs, stack, st, ld in ptxas_report(
                build, "blur_unsharp_kernel|separable_blur_kernel"):
            print(f"ptxas {tag}: {name}: {regs} registers, {stack} bytes "
                  f"stack, {st} bytes spill stores, {ld} bytes spill loads")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
