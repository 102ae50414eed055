#!/usr/bin/env python3
"""Count how often torch's CPU cosine or square root differs between
fresh processes.

``ops/fourier.py``'s ``inverse_fft`` turns a (magnitude, phase) image
pair back into complex values.  On the CPU, ``torch.cos`` of a float32
tensor comes out to about 12 bits in some processes and to full precision
in others, so a seeded test of that function failed now and then; the
port now takes ``torch.polar``.  This script starts ``--processes`` fresh
interpreters (``--jobs`` at a time), each computing ``torch.cos``,
``torch.sin`` and ``torch.polar`` of the same 24 x 40 x 3 phase image (made
from ``--seed``) and the port's ``inverse_fft`` of it, and prints for each
how many processes gave each distinct result, and the largest error of
``torch.cos`` against float64 numpy.

With ``--target sqrt`` each process instead takes ``torch.sqrt`` of
the mean square of the 3x3 windows of ``tests/test_torch_statistic.py``'s
three images (the RMS statistic's last step), and the port's
``statistic(..., "rootmeansquare", 3, 3)`` of them, and the script prints
how many processes gave each result and the largest error of the float32
``torch.sqrt`` against the correctly rounded one (float64, rounded).

Run from the repository root: ``python3 cpu_phase_probe.py
[--target cos|sqrt] [--processes N] [--jobs J] [--seed S]``.  It needs
no card.
"""

import argparse
import collections
import concurrent.futures
import hashlib
import subprocess
import sys

CHILD = """
import math, sys, numpy as np, torch
from imagemagick_tpu_torch.ops import fourier
rng = np.random.default_rng(int(sys.argv[1]))
mag = torch.from_numpy(rng.random((24, 40, 3)).astype(np.float32) / 100)
phase = torch.from_numpy(rng.random((24, 40, 3)).astype(np.float32))
p = (torch.movedim(phase, -1, 0) - 0.5) * (2.0 * math.pi)
out = {"cos": torch.cos(p), "sin": torch.sin(p),
       "polar": torch.polar(torch.ones_like(p), p),
       "inverse_fft": fourier.inverse_fft(mag, phase)}
for k, v in out.items():
    print(k, v.numpy().tobytes().hex())
err = np.abs(out["cos"].numpy() - np.cos(p.numpy().astype(np.float64)))
print("cos_err", float(err.max()))
"""


CHILD_SQRT = """
import sys, numpy as np, torch
from imagemagick_tpu_torch.ops import statistic
def image(shape, seed, levels=None):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    if levels:
        x = (np.round(x * levels) / levels).astype(np.float32)
    return torch.from_numpy(x)
errs = []
for k, x in enumerate((image((2, 20, 26, 3), 1), image((2, 20, 26, 3), 2, 8),
                       image((17, 23, 1), 3, 4))):
    ms = (statistic._window_stack(x, 3, 3) ** 2).mean(dim=0)
    s = torch.sqrt(ms)
    print(f"sqrt{k}", s.numpy().tobytes().hex())
    print(f"statistic_rms{k}", statistic.statistic(
        x, "rootmeansquare", 3, 3).numpy().tobytes().hex())
    errs.append(float((s - torch.sqrt(ms.double()).float()).abs().max()))
print("sqrt_err", max(errs))
"""


def child(seed: int, source: str = CHILD) -> str:
    return subprocess.run([sys.executable, "-c", source, str(seed)],
                          capture_output=True, text=True, check=True).stdout


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--target", choices=("cos", "sqrt"), default="cos")
    parser.add_argument("--processes", type=int, default=300)
    parser.add_argument("--jobs", type=int, default=6)
    parser.add_argument("--seed", type=int, default=24)
    args = parser.parse_args()
    counts = collections.defaultdict(collections.Counter)
    worst = 0.0
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        source = CHILD if args.target == "cos" else CHILD_SQRT
        for text in pool.map(child, [args.seed] * args.processes,
                             [source] * args.processes):
            for line in text.splitlines():
                key, value = line.split()
                if key.endswith("_err"):
                    worst = max(worst, float(value))
                else:
                    digest = hashlib.sha256(value.encode()).hexdigest()[:8]
                    counts[key][digest] += 1
    for key, c in counts.items():
        print(f"{key}: {len(c)} distinct results over {args.processes} "
              f"processes, counts {sorted(c.values(), reverse=True)}")
    print(f"largest |torch.{args.target} - float64 {args.target}| in any "
          f"process: {worst:.3e}")


if __name__ == "__main__":
    main()
