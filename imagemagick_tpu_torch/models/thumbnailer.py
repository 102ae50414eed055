"""The flagship pipeline: corpus-scale thumbnailer (BASELINE config #5).

Port of ``imagemagick_tpu/models/thumbnailer.py``.  End to end: decode N
JPEGs -> Lanczos resize [-> watermark composite] [-> sRGB->Gray] ->
encode, as a producer/consumer pipeline:

  * host threads decode with the native codec (``native/miniio.cpp``,
    PIL's ``draft`` decode where it is not built) straight into the
    kernel's flat wire layout (rows x 128-aligned W*C lanes, u8);
  * images are grouped by exact decoded size; each size gets ONE step,
    whose kernel plan is made once (``make_flat_step``);
  * a batch's staged u8 bytes go to the card from pinned host memory
    without waiting, its thumbnails come back the same way behind a CUDA
    event, and ``inflight_depth`` batches stay in flight before the
    oldest is drained, so the transfers and the kernel overlap the
    decode of the next batches;
  * encode threads drain finished batches.

The step is one launch of kernel K1 (``csrc/fused_pipeline.cu``) on the
staged layout; a watermark is then composited onto the batch by
``ops/composite.composite_at`` (dissolve 35 %, southeast) as PyTorch ops
before the gray conversion.  Where the JAX step falls back to XLA ops,
this one raises: nothing here runs another route on a card.
"""

from __future__ import annotations

import concurrent.futures as futures
import io as _io
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

@dataclass
class ThumbnailerConfig:
    thumb_width: int = 256
    thumb_height: int = 256
    stage_width: int = 1024     # decimation bound for oversized inputs
    stage_height: int = 1024
    batch_size: int = 32
    quality: int = 87
    grayscale: bool = False
    decode_workers: int = 8
    encode_workers: int = 8
    # DCT-scaled decode (coders/jpeg.c jpeg:size culture): decode at the
    # largest 1/{2,4,8} scale still covering scale_hint_mul x the thumb
    # dims (1.0 = exactly `-define jpeg:size=WxH`), so the Lanczos pass
    # always downsamples and fewer bytes go to the card.
    dct_scale_hint: bool = True
    scale_hint_mul: float = 1.0
    # in-flight device batches before the oldest is drained; >=3 lets
    # batch k's readback overlap k+1's upload and k+2's staging
    inflight_depth: int = 3


def _align(x: int, m: int) -> int:
    return -(-x // m) * m


def _decode_flat(blob: bytes, max_w: int, max_h: int,
                 min_w: int = 0, min_h: int = 0
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode into the flat wire layout: (h8, wcp) u8 with the image's
    (h, w, 3) bytes row-major in the top-left and zero pad to the
    8-row / 128-lane alignment.  Returns (flat, (w, h)).  min_w/min_h > 0
    request a DCT-scaled decode covering at least that size."""
    from .. import native

    arr = None
    if native.available():
        arr = (native.decode_jpeg_scaled(blob, min_w, min_h)
               if min_w and min_h else native.decode_jpeg(blob))
    if arr is None:
        from PIL import Image as PImage

        pim = PImage.open(_io.BytesIO(blob))
        if min_w and min_h:
            pim.draft("RGB", (min_w, min_h))    # PIL's DCT-scale hint
        pim = pim.convert("RGB")
        arr = np.asarray(pim)
    h, w = arr.shape[:2]
    # host-side decimation if wildly larger than the bound (stride trick)
    while h > 2 * max_h and w > 2 * max_w:
        arr = arr[::2, ::2]
        h, w = arr.shape[:2]
    h8 = _align(h, 8)
    wcp = _align(w * 3, 128)
    flat = np.zeros((h8, wcp), np.uint8)
    flat[:h, :w * 3] = arr.reshape(h, w * 3)
    return flat, (w, h)


def make_flat_step(cfg: ThumbnailerConfig, h: int, w: int, watermark=None,
                   device="cuda"):
    """The batch step for ONE source size: (B, h8, wcp) u8 flat -> (B, th,
    tw, C) u8 on ``device``.

    K1's plan (``fused_pipeline.linear_plan``) is made here, once; its
    device operands once per batch size.  A step uploads the staged u8
    batch (pinned host memory copies without waiting), scales it to
    [0, 1], runs K1 once (its plain version for a CPU ``device``) and
    rounds to u8.  Without a watermark ``grayscale`` folds the Rec.709
    luma row into K1's channel mix.  ``watermark``, an (h, w, c)
    float image in [0, 1] (a tensor or an array), is moved to ``device``
    here, once; K1 then keeps the color channels, the watermark is
    dissolved in at 35 % in the southeast corner, and the gray
    conversion follows, as in the JAX step."""
    from ..ops import colorspace as cs
    from ..ops import composite as comp
    from ..ops import fused_pipeline as fp
    from ..ops.resize import resize_matrix

    device = torch.device(device)
    if watermark is not None:
        watermark = torch.as_tensor(watermark, dtype=torch.float32).to(
            device)
    th, tw = cfg.thumb_height, cfg.thumb_width
    mix = np.asarray([[0.212656, 0.715158, 0.072186]]) \
        if cfg.grayscale and watermark is None else np.eye(3)
    h8 = _align(h, 8)
    wcp = _align(w * 3, 128)
    Mv = resize_matrix(h, th, "lanczos").astype(np.float64).T
    Mv = np.pad(Mv, ((0, 0), (0, h8 - h)))      # pad rows contribute 0
    Mw = resize_matrix(w, tw, "lanczos").astype(np.float64).T
    plan = fp.linear_plan([(Mv, Mw)], 3, mix, 64, h8, wcp)
    operands: Dict[int, fp.K1Operands] = {}

    def step(staged_u8) -> torch.Tensor:
        x = torch.as_tensor(staged_u8)
        if x.dim() != 3 or tuple(x.shape[1:]) != (h8, wcp) or \
                x.dtype != torch.uint8:
            raise ValueError(
                f"thumbnailer step for {w}x{h}: staged batch must be u8 "
                f"(B, {h8}, {wcp}), got {x.dtype} {tuple(x.shape)}")
        b = x.shape[0]
        if b not in operands:
            operands[b] = fp.plan_to_tensors(
                plan.WV, plan.GB, fp.flat_r0(plan.r0s, b, h8), device)
        x = x.to(device, non_blocking=True)
        flat = x.reshape(b * h8, wcp).to(torch.float32) / 255.0
        y = fp.run_plan(flat, b, plan, operands[b])
        if watermark is not None:
            y = comp.composite_at(y, watermark, "dissolve", 0, 0,
                                  "southeast",
                                  src_alpha=watermark.shape[-1] == 4,
                                  args=(35.0,))[..., :3]
            if cfg.grayscale:
                y = cs.convert(y, "srgb", "gray")
        return (y.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)

    step.plan = plan
    return step


def read_watermark(path: str) -> np.ndarray:
    """A watermark file as an (h, w, c) float32 array in [0, 1] on the
    host: any file the port's ``io`` reads, read as the JAX function reads
    it (``io.read_images(path)[0]``), on the CPU; each step moves it to
    its device."""
    from .. import io as iio

    return iio.read_images(path, device="cpu")[0].to_numpy()


def run(paths: Sequence[str], out_dir: str,
        cfg: Optional[ThumbnailerConfig] = None,
        watermark_path: Optional[str] = None, device="cuda") -> dict:
    """Thumbnail a corpus on ``device``; returns timing/throughput stats.

    Pipeline: decode pool -> per-size batches -> device steps with
    ``inflight_depth`` batches in flight -> encode pool.
    ``watermark_path`` names an image file of any format the port reads
    (``read_watermark``) that every step dissolves into its thumbnails.
    ``device_drain_wait_s`` is the time the host waited on the card for a
    finished batch; ``overlap_efficiency`` the share of the wall time it
    did not."""
    cfg = cfg or ThumbnailerConfig()
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("thumbnailer: no CUDA card for device 'cuda'; "
                           "pass device='cpu' to run on the CPU")
    os.makedirs(out_dir, exist_ok=True)
    from .. import native

    wm = read_watermark(watermark_path) if watermark_path else None
    steps: Dict[Tuple[int, int], object] = {}

    def step_for(h, w):
        key = (h, w)
        if key not in steps:
            steps[key] = make_flat_step(cfg, h, w, wm, device=device)
        return steps[key]

    t0 = time.perf_counter()
    n_done = 0
    total_mp = 0.0
    drain_wait = 0.0
    staged_bytes = 0

    with futures.ThreadPoolExecutor(cfg.decode_workers) as dec_pool, \
            futures.ThreadPoolExecutor(cfg.encode_workers) as enc_pool:

        def decode_one(p):
            with open(p, "rb") as f:
                blob = f.read()
            mw = int(cfg.thumb_width * cfg.scale_hint_mul) \
                if cfg.dct_scale_hint else 0
            mh = int(cfg.thumb_height * cfg.scale_hint_mul) \
                if cfg.dct_scale_hint else 0
            return _decode_flat(blob, cfg.stage_width, cfg.stage_height,
                                mw, mh)

        enc_futures = []
        # per-size pending batches
        pend: Dict[Tuple[int, int], Tuple[List[str], List[np.ndarray]]] = {}
        # (host thumbnails, the event after their copy or None, paths)
        inflight: List[Tuple[torch.Tensor, object, List[str]]] = []

        def write_thumb(arr, dst):
            rgb = arr if arr.shape[-1] == 3 else np.repeat(arr, 3, -1)[..., :3]
            blob = native.encode_jpeg(rgb, cfg.quality)
            if blob is None:
                from PIL import Image as PImage

                buf = _io.BytesIO()
                PImage.fromarray(arr.squeeze()).save(buf, "JPEG",
                                                     quality=cfg.quality)
                blob = buf.getvalue()
            with open(dst, "wb") as f:
                f.write(blob)

        def drain_one():
            nonlocal n_done, drain_wait
            host, done, bpaths = inflight.pop(0)
            tw0 = time.perf_counter()
            if done is not None:
                done.synchronize()        # the batch's readback has landed
            drain_wait += time.perf_counter() - tw0
            out = host.numpy()
            for i, p in enumerate(bpaths):
                name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
                enc_futures.append(enc_pool.submit(
                    write_thumb, out[i], os.path.join(out_dir, name)))
                n_done += 1

        def submit(key):
            nonlocal staged_bytes
            bpaths, flats = pend.pop(key)
            staged = torch.empty((len(flats),) + flats[0].shape,
                                 dtype=torch.uint8, pin_memory=on_card)
            np.stack(flats, out=staged.numpy())
            staged_bytes += staged.numel()
            out_dev = step_for(*key)(staged)
            done = None
            if on_card:
                # start the readback now, so it streams behind the next
                # batches' decode and upload instead of inside drain_one
                host = torch.empty(out_dev.shape, dtype=torch.uint8,
                                   pin_memory=True)
                host.copy_(out_dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
            else:
                host = out_dev
            inflight.append((host, done, bpaths))
            while len(inflight) >= max(cfg.inflight_depth, 1) + 1:
                drain_one()

        for path, (flat, (w, h)) in zip(paths,
                                        dec_pool.map(decode_one, paths)):
            key = (h, w)
            bpaths, flats = pend.setdefault(key, ([], []))
            bpaths.append(path)
            flats.append(flat)
            total_mp += w * h / 1e6
            if len(flats) == cfg.batch_size:
                submit(key)
        for key in list(pend):
            submit(key)
        while inflight:
            drain_one()
        for f in enc_futures:
            f.result()

    dt = time.perf_counter() - t0
    return {
        "images": n_done,
        "seconds": round(dt, 3),
        "images_per_sec": round(n_done / dt, 2) if dt > 0 else 0.0,
        "megapixels_per_sec": round(total_mp / dt, 2) if dt > 0 else 0.0,
        "device_drain_wait_s": round(drain_wait, 3),
        # share of the wall time the host pipeline (decode/stage/encode)
        # ran without blocking on the card; 1.0 = device time fully hidden
        "overlap_efficiency": round(1.0 - drain_wait / dt, 3)
        if dt > 0 else 0.0,
        # host->device staging volume (the DCT-scaled decode stages the
        # reduced size, not the source size)
        "staged_MB": round(staged_bytes / 1e6, 2),
        "size_groups": len(steps),
    }
