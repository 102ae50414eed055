#!/usr/bin/env python3
"""Time kernels K6a, K6b and K6c of this checkout against another's.

Loads the other checkout's ``imagemagick_tpu_torch`` under another module
name (it builds its own kernels into its own ``_build/``) and gives both
the same inputs at config #4's shape, one 2160 x 4096 plane from
``--seed``: K6a the plane, K6b the spectrum that this checkout's K6a
makes of it, K6c the spectrum that this checkout's K6a and K6b make.  It
holds each kernel to its own checkout's plain version and the two
checkouts' kernels to each other, then times, in turns (other, this,
this, other), each kernel per call (``chip_smoke.median_ms``: one event
pair around one call on an idle stream) and device-only
(``chip_smoke.device_ms``: one event pair around 20 back-to-back calls),
with a library yardstick beside each: ``torch.fft.fft`` and
``torch.fft.ifft`` along W for K6a and K6c, ``torch.fft.fft`` then
``torch.fft.ifft`` along H (two cuFFT calls without the mask) for K6b.
Last it times config #4's fused route (``models.pipelines.fft_wiener``)
of each checkout end to end, with its fidelity against a float64 numpy
Wiener, beside the op route (``fourier.set_fft_mode("fft")``: cuFFT's
real transforms) of this checkout.

Run from the repository root on a machine with one CUDA card:
``python3 k6_ab.py OTHER [--seed N]``, OTHER the root of a checkout of
another commit (for example unpacked from ``git archive``).  It fails
without a card.
"""

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

import torch

H, W = 2160, 4096
NOISE = 0.01


def load_other(root: Path):
    """The other checkout's package as ``other_imagemagick_tpu_torch``."""
    pkg = root / "imagemagick_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_imagemagick_tpu_torch", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k6_ab: no CUDA card")
    from chip_smoke import card, device_ms, median_ms, psnr, wiener_f64
    from imagemagick_tpu_torch.models import pipelines
    from imagemagick_tpu_torch.ops import fourier as ft
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    load_other(args.other.resolve())
    ofk = importlib.import_module(
        "other_imagemagick_tpu_torch.ops.fourier_kernels")
    opipe = importlib.import_module(
        "other_imagemagick_tpu_torch.models.pipelines")
    name_limit = card()
    print(name_limit)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.rand((1, H, W), generator=gen, device=dev)
    pmean = torch.sum(x * x, dim=(-2, -1))
    spec_x = fk.w_forward(x)
    g = fk.h_mask(spec_x, pmean, NOISE)
    spec_ref = fk._w_forward_plain(x)
    out_ref = fk._w_inverse_plain(g)
    outs = {}
    for name, mod in (("other", ofk), ("this", fk)):
        spec, out = mod.w_forward(x), mod.w_inverse(g)
        torch.cuda.synchronize()
        rel = float(((spec - mod._w_forward_plain(x)).abs().max() /
                     spec_ref.abs().max()).item())
        err = float((out - mod._w_inverse_plain(g)).abs().max().item())
        print(f"{name}: k6a vs its plain version {rel:.3e} of max|F|, k6c "
              f"{err:.3e}")
        outs[name] = (spec, out)
    rel = float(((outs["this"][0] - outs["other"][0]).abs().max() /
                 spec_ref.abs().max()).item())
    err = float((outs["this"][1] - outs["other"][1]).abs().max().item())
    print(f"this vs other: k6a {rel:.3e} of max|F|, k6c {err:.3e}; this "
          f"k6c vs its plain version "
          f"{float((outs['this'][1] - out_ref).abs().max()):.3e}")

    gs = {}
    for name, mod in (("other", ofk), ("this", fk)):
        gs[name] = mod.h_mask(spec_x, pmean, NOISE)
        torch.cuda.synchronize()
        rel = float(((gs[name] - mod._h_mask_plain(spec_x, pmean, NOISE))
                     .abs().max() / g.abs().max()).item())
        print(f"{name}: k6b vs its plain version {rel:.3e} of max|g|")
    rel = float(((gs["this"] - gs["other"]).abs().max() /
                 g.abs().max()).item())
    print(f"this vs other: k6b {rel:.3e} of max|g|")
    del gs

    def fwd(mod):
        return lambda: mod.w_forward(x)

    def mask(mod):
        return lambda: mod.h_mask(spec_x, pmean, NOISE)

    def inv(mod):
        return lambda: mod.w_inverse(g)

    batch = x.reshape(1, H, W, 1)
    routes = {"other": opipe.fft_wiener(NOISE),
              "this": pipelines.fft_wiener(NOISE)}
    ref = wiener_f64(x[0].cpu().numpy(), NOISE)
    for name, route in routes.items():
        db = psnr(route(batch)[0, ..., 0].cpu().numpy(), ref)
        print(f"{name} fused route vs float64: {db:.2f} dB")

    order = (ofk, fk, fk, ofk)
    tags = ("other", "this", "this", "other")
    for kernel, make, lib_name, lib in (
            ("k6a", fwd, "torch.fft.fft", lambda: torch.fft.fft(x, dim=-1)),
            ("k6b", mask, "torch.fft.fft then torch.fft.ifft along H",
             lambda: torch.fft.ifft(torch.fft.fft(spec_x, dim=-2), dim=-2)),
            ("k6c", inv, "torch.fft.ifft", lambda: torch.fft.ifft(g, dim=-1))):
        fns = [make(mod) for mod in order] + [lib]
        per_call = median_ms(*fns)
        device = device_ms(*fns)
        for tag, pc, dv in zip(tags, per_call, device):
            print(f"{kernel} {tag} {(1, H, W)}: {pc:.4f} ms per call, "
                  f"{dv:.4f} ms device-only [{name_limit}]")
        print(f"{lib_name} {(1, H, W)}: {per_call[-1]:.4f} ms per call, "
              f"{device[-1]:.4f} ms device-only [{name_limit}]")
    def op_route():
        ft.set_fft_mode("fft")
        try:
            return routes["this"](batch)
        finally:
            ft.set_fft_mode("auto")

    fns = [lambda r=routes[t]: r(batch) for t in tags] + [op_route]
    per_call = median_ms(*fns)
    device = device_ms(*fns)
    for tag, pc, dv in zip(tags, per_call, device):
        print(f"config #4 fused route {tag}: {pc:.4f} ms per call, {dv:.4f} "
              f"ms device-only (back to back) [{name_limit}]")
    print(f"config #4 op route (cuFFT) this: {per_call[-1]:.4f} ms per call, "
          f"{device[-1]:.4f} ms device-only (back to back) [{name_limit}]")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
