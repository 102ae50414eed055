"""Gigapixel pipeline: spatially sharded processing of huge single images.

Port of ``imagemagick_tpu/models/gigapixel.py``.  The reference handles
images beyond RAM with a disk-backed pixel cache (cache.c
OpenPixelCacheOnDisk) or by farming pixel regions to TCP cache servers
(distribute-cache.c).  Here a huge image lives as blocks of a (dp, sy,
sx) mesh (``parallel/mesh.py``) and the pipeline runs block by block
where the data lives: each block takes its blur's halo from its
neighbours, the blur is kernel K3 on the card, and the global statistics
are reductions over the blocks.  A block's halo'd copy, its blur and the
temporaries are released before the next block starts, so the card holds
the input, the output and one block's transients.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import (Mesh, ShardedArray, _group, batch_sharding,
                             device_put, local_devices, make_mesh)
from ..parallel.spatial import _crop, _map_blocks, _window


def shard_image(mesh: Mesh, img) -> ShardedArray:
    """Place an (N, H, W, C) array sharded over (dp, sy, sx)."""
    return device_put(img, batch_sharding(mesh))


def sharded_pipeline(mesh: Mesh, sigma: float = 2.0,
                     unsharp_gain: float = 1.0,
                     to_gray: bool = False) -> Callable:
    """Blur -> unsharp -> (optional grayscale) on a spatially sharded
    image: per block, the blur of block + halo (sy, then sx) by
    ``ops.blur._separable_conv`` (K3 on the card) cropped to the block,
    then ``clip(x + g*(x - blur), 0, 1)``, then the optional Rec.709 row
    (0.212656, 0.715158, 0.072186)."""
    from ..ops.blur import _separable_conv, gaussian_kernel_1d

    taps = np.asarray(gaussian_kernel_1d(0.0, sigma), np.float32)
    r = (len(taps) - 1) // 2
    ex = [(1, 1, r, "sy"), (2, 2, r, "sx")]

    def run(x):
        x = shard_image(mesh, x)

        def block(idx):
            b = x.blocks[idx]
            blurred = _crop(_separable_conv(_window(x.blocks, idx, ex), taps,
                                            "edge"), r, r)
            sharp = torch.sub(b, blurred)
            del blurred
            sharp.mul_(unsharp_gain).add_(b).clamp_(0.0, 1.0)
            if to_gray:
                return (0.212656 * sharp[..., 0] + 0.715158 * sharp[..., 1] +
                        0.072186 * sharp[..., 2])[..., None]
            return sharp

        return _map_blocks(x, block)

    return run


def sharded_global_stats(mesh: Mesh) -> Callable:
    """Mean/std/min/max across every block (all mesh axes)."""
    from ..parallel.spatial import sharded_statistics

    return sharded_statistics(mesh)


def process_gigapixel(img: Union[np.ndarray, torch.Tensor],
                      mesh: Optional[Mesh] = None, sigma: float = 2.0,
                      to_gray: bool = False
                      ) -> Tuple[ShardedArray, Dict[str, np.ndarray]]:
    """End-to-end sharded run: place, process, reduce.

    ``img`` is (H, W, C) or (N, H, W, C), a numpy array (sent to each
    device block by block) or a tensor (a tensor already on a block's
    device is not copied).  With no mesh, one is chosen from the global
    card count as the JAX function chooses it.  Returns (the result,
    still sharded, the global statistics as numpy arrays)."""
    if mesh is None:
        n_dev = _group()[0] * len(local_devices("cuda"))
        sy = 2 if n_dev % 2 == 0 and n_dev >= 2 else 1
        sx = 2 if n_dev % 4 == 0 and n_dev >= 4 else 1
        # at least one row, so that a machine without a card gets
        # make_mesh's error rather than an empty mesh
        dp = max(1, n_dev // (sy * sx))
        mesh = make_mesh(dp=dp, sy=sy, sx=sx)
    x = img if isinstance(img, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(img))
    x = x if x.dim() == 4 else x[None]
    xs = shard_image(mesh, x.to(torch.float32))
    out = sharded_pipeline(mesh, sigma, to_gray=to_gray)(xs)
    mean, std, mn, mx = sharded_global_stats(mesh)(out)
    stats = {"mean": mean.cpu().numpy(), "std": std.cpu().numpy(),
             "min": mn.cpu().numpy(), "max": mx.cpu().numpy()}
    return out, stats
