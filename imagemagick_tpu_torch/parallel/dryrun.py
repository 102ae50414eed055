"""A dry run of the sharded ops over an n-device mesh, at tiny shapes.

Port of ``__graft_entry__.dryrun_multichip``: the same mesh factoring
(spatial axes first, so that halos are exchanged), a blur, a 64-bin
histogram, the statistics, resizes (including 1083x769 -> 541x385, which
the mesh does not divide), an open, a median and Otsu, then the resize
-> blur -> gray pipeline with the batch split over dp.  Where the JAX
function forces ``n`` CPU devices, ``devices`` defaults to ``n`` handles
of this process's cards, each card named in turn (``[cuda:0] * n`` on a
machine with one); without a card the mesh raises make_mesh's "needs N
devices, have 0".  The CPU runs it only when asked:
``devices=[torch.device("cpu")] * n``.

    python -m imagemagick_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from .mesh import (NamedSharding, P, batch_sharding, device_put,
                   local_devices, make_mesh)
from .spatial import (halo_map, sharded_gaussian_blur, sharded_histogram,
                      sharded_median, sharded_morphology,
                      sharded_otsu_threshold, sharded_resize,
                      sharded_statistics)


def _pipeline(b: torch.Tensor) -> torch.Tensor:
    from ..ops import blur as bl
    from ..ops import colorspace as cs
    from ..ops import resize as rz

    t = rz.resize(b, 32, 32, "lanczos")
    t = bl.gaussian_blur(t, 0.0, 1.0)
    return cs.convert(t, "srgb", "gray")


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """Run the sharded ops over an n-device mesh (tiny shapes)."""
    if devices is None:
        cards = local_devices("cuda")
        devices = [cards[i % len(cards)] for i in range(n_devices)] \
            if cards else []
    devices = list(devices)[:n_devices]
    # factor n into sx * sy * dp, preferring spatial axes so halo exchange
    # is actually exercised
    n = n_devices
    sx = 2 if n % 2 == 0 and n >= 8 else 1
    rem = n // sx
    sy = 2 if rem % 2 == 0 and rem >= 2 else 1
    dp = rem // sy
    mesh = make_mesh(dp=dp, sy=sy, sx=sx, devices=devices)
    dev = mesh.first_device
    gen = torch.Generator(device=dev).manual_seed(0)

    batch, h, w, c = dp * 2, sy * 16, sx * 16, 3
    x = device_put(torch.rand((batch, h, w, c), generator=gen, device=dev),
                   batch_sharding(mesh))

    # 1) spatially sharded neighbourhood op with halo exchange
    y = sharded_gaussian_blur(mesh, sigma=1.5)(x)
    assert y.shape == x.shape, (y.shape, x.shape)

    # 2) global reductions (histogram + statistics)
    hist = sharded_histogram(mesh, bins=64)(y)
    assert int(hist.sum()) == batch * h * w * c, "histogram lost pixels"
    mean, std, mn, mx = sharded_statistics(mesh)(y)
    assert mean.shape == std.shape == mn.shape == mx.shape == (c,)

    # 2b) resize, morphology, median and global-histogram Otsu, each on
    #     tile + halo and staying sharded
    r = sharded_resize(mesh, (h, w), (h // 2, w // 2), "lanczos")(x)
    assert r.shape == (batch, h // 2, w // 2, c), r.shape

    # geometry the mesh does not divide: operator-space padding + crop
    x_odd = torch.zeros((batch, 1083, 769, c), device=dev)
    ro = sharded_resize(mesh, (1083, 769), (541, 385), "lanczos")(x_odd)
    assert ro.shape == (batch, 541, 385, c), ro.shape

    m = sharded_morphology(mesh, "open", "square:1")(x)
    assert m.shape == x.shape
    md = sharded_median(mesh, radius=1)(x)
    assert md.shape == x.shape
    ot = sharded_otsu_threshold(mesh)(x)
    assert ot.shape == x.shape[:-1] + (1,)

    # 3) the flagship pipeline (resize + blur + colorspace) with the batch
    #    split over dp
    xb = torch.rand((dp * 2, sy * 32, sx * 48, 3), generator=gen, device=dev)
    dp_only = P("dp", None, None, None)
    out = halo_map(_pipeline, mesh, 0, 0, dp_only)(
        device_put(xb, NamedSharding(mesh, dp_only)))
    assert out.shape == (dp * 2, 32, 32, 1), out.shape
    print(f"dryrun_multichip OK: mesh dp={dp} sy={sy} sx={sx}, "
          f"halo-blur {tuple(y.shape)}, hist sum {int(hist.sum())}, "
          f"sharded resize {tuple(x.shape)}->{tuple(r.shape)}, "
          f"morphology/median/otsu, dp-split pipeline {tuple(xb.shape)} -> "
          f"{tuple(out.shape)}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_devices", nargs="?", type=int, default=8)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="run on this process's cards (default) or on "
                             "the CPU")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices,
                     [torch.device("cpu")] * args.n_devices
                     if args.device == "cpu" else None)


if __name__ == "__main__":
    main()
