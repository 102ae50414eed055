"""Port parity: the corpus thumbnailer (BASELINE config #5) against the JAX
package's ``models/thumbnailer.py``.

On the CPU the JAX step takes its XLA op path (``fused_linear_pipeline``
returns None off a TPU) and the port's step runs K1's plain version:
thumbnails agree within 1 u8 level, and within 2 after each side's JPEG
encode and decode."""

import importlib
import os

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import native as tnat
from imagemagick_tpu_torch.models import thumbnailer as tt
from imagemagick_tpu_torch.ops import fused_pipeline as tfp

jt = importlib.import_module("imagemagick_tpu.models.thumbnailer")
jnat = importlib.import_module("imagemagick_tpu.native")


def _natural(h, w, seed=0):
    """Smooth gradient + modest texture + a hard-edged block, u8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 7.0)[..., None] * np.cos(
        xx[..., None] / 9.0 + np.arange(3))
    img = np.clip(base + 0.08 * rng.standard_normal((h, w, 3)), 0.0, 1.0)
    img[h // 3:h // 2, w // 4:w // 2] = 0.95
    return (img * 255.0 + 0.5).astype(np.uint8)


def _jpeg(h, w, seed=0):
    return tnat.encode_jpeg(_natural(h, w, seed), 90)


@pytest.fixture(params=["native", "pil"])
def codec(request, monkeypatch):
    """Each side's native codec, or neither (both decode with PIL)."""
    if request.param == "pil":
        monkeypatch.setattr(tnat, "available", lambda: False)
        monkeypatch.setattr(tnat, "png_available", lambda: False)
        monkeypatch.setattr(jnat, "available", lambda: False)
    return request.param


@pytest.mark.parametrize("shape,bounds,hint", [
    ((64, 96), (1024, 1024), (0, 0)),
    ((64, 96), (1024, 1024), (24, 16)),     # DCT-scaled decode at 1/2
    ((37, 50), (1024, 1024), (8, 8)),       # 1/4, odd extents
    ((80, 120), (16, 16), (0, 0)),          # stride decimation, twice
])
def test_decode_flat_equals_jax(codec, shape, bounds, hint):
    blob = _jpeg(*shape)
    got, got_wh = tt._decode_flat(blob, *bounds, *hint)
    want, want_wh = jt._decode_flat(blob, *bounds, *hint)
    assert got_wh == want_wh
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[0] % 8 == 0 and got.shape[1] % 128 == 0
    assert np.array_equal(got, want)


def _staged(h, w, n, seed=0):
    flats = [tt._decode_flat(_jpeg(h, w, seed + i), 1024, 1024)[0]
             for i in range(n)]
    return np.stack(flats)


@pytest.mark.parametrize("h,w,thumb", [(64, 96, (24, 32)),
                                       (37, 50, (16, 20))])
@pytest.mark.parametrize("grayscale", [False, True])
def test_flat_step_matches_jax(h, w, thumb, grayscale):
    th, tw = thumb
    cfg = tt.ThumbnailerConfig(thumb_width=tw, thumb_height=th,
                               grayscale=grayscale)
    jcfg = jt.ThumbnailerConfig(thumb_width=tw, thumb_height=th,
                                grayscale=grayscale)
    staged = _staged(h, w, 3, seed=h)
    got = tt.make_flat_step(cfg, h, w, device="cpu")(staged)
    want = np.asarray(jt.make_flat_step(jcfg, h, w)(staged))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (3, th, tw,
                                              1 if grayscale else 3)
    assert np.abs(got.numpy().astype(int) - want).max() <= 1


def test_plan_made_once_per_size(monkeypatch):
    """linear_plan runs when the step is made, never per step; operands
    are made once per batch size."""
    calls = []
    orig = tfp.linear_plan
    monkeypatch.setattr(tfp, "linear_plan",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    staged = _staged(64, 96, 3)
    cfg = tt.ThumbnailerConfig(thumb_width=32, thumb_height=24)
    step = tt.make_flat_step(cfg, 64, 96, device="cpu")
    assert len(calls) == 1 and step.plan.Hout == 24 and step.plan.OUT == 96
    outs = [step(staged), step(staged), step(staged[:2])]
    assert len(calls) == 1
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[2], outs[0][:2])


def test_flat_step_rejects_other_layouts():
    cfg = tt.ThumbnailerConfig(thumb_width=32, thumb_height=24)
    step = tt.make_flat_step(cfg, 64, 96, device="cpu")
    with pytest.raises(ValueError, match="staged batch"):
        step(np.zeros((2, 64, 256), np.uint8))
    with pytest.raises(ValueError, match="staged batch"):
        step(np.zeros((2, 64, 384), np.float32))


def _corpus(tmp_path):
    """Six JPEGs of two sizes; with batches of 2, each size ends in a
    short batch."""
    paths = []
    for i, (h, w) in enumerate([(64, 96)] * 3 + [(48, 80)] * 3):
        p = tmp_path / "in" / f"img_{i}.jpg"
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(_jpeg(h, w, seed=i))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("grayscale", [False, True])
def test_run_matches_jax(tmp_path, monkeypatch, grayscale):
    calls = []
    orig = tfp.linear_plan
    monkeypatch.setattr(tfp, "linear_plan",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    paths = _corpus(tmp_path)
    kw = dict(thumb_width=32, thumb_height=24, batch_size=2,
              grayscale=grayscale, decode_workers=2, encode_workers=2)
    got = tt.run(paths, str(tmp_path / "port"), tt.ThumbnailerConfig(**kw),
                 device="cpu")
    want = jt.run(paths, str(tmp_path / "jax"), jt.ThumbnailerConfig(**kw))
    assert set(got) == set(want)
    assert got["size_groups"] == want["size_groups"] == 2
    assert got["images"] == want["images"] == 6
    assert got["staged_MB"] == want["staged_MB"]
    assert len(calls) == 2                  # one plan per source size
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
        a = tnat.decode_jpeg((tmp_path / "port" / name).read_bytes())
        b = tnat.decode_jpeg((tmp_path / "jax" / name).read_bytes())
        assert a.shape == b.shape == (24, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


def _watermark(channels, seed=3, h=9, w=12):
    """A small watermark of 8-bit levels in [0, 1], with a transparent
    corner when it has alpha."""
    rng = np.random.default_rng(seed)
    wm = rng.integers(0, 256, (h, w, channels)).astype(np.float32) / 255.0
    if channels == 4:
        wm[:3, :3, 3] = 0.0
    return wm.astype(np.float32)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("grayscale", [False, True])
def test_watermarked_flat_step_matches_jax(channels, grayscale):
    """K1 with the identity mix, the dissolve at 35 % in the southeast
    corner, then gray: within 1 u8 level of the JAX step, as without a
    watermark; the corner differs from the unwatermarked step."""
    import jax.numpy as jnp

    th, tw = 24, 32
    cfg = tt.ThumbnailerConfig(thumb_width=tw, thumb_height=th,
                               grayscale=grayscale)
    jcfg = jt.ThumbnailerConfig(thumb_width=tw, thumb_height=th,
                                grayscale=grayscale)
    wm = _watermark(channels)
    staged = _staged(64, 96, 3, seed=5)
    step = tt.make_flat_step(cfg, 64, 96, watermark=wm, device="cpu")
    assert step.plan.OUT == tw * 3      # K1's mix: identity, not gray
    got = step(staged)
    want = np.asarray(jt.make_flat_step(jcfg, 64, 96,
                                        jnp.asarray(wm))(staged))
    assert got.dtype == torch.uint8
    assert tuple(got.shape) == want.shape == (3, th, tw,
                                              1 if grayscale else 3)
    assert np.abs(got.numpy().astype(int) - want).max() <= 1
    plain = tt.make_flat_step(cfg, 64, 96, device="cpu")(staged).numpy()
    corner = np.abs(got.numpy().astype(int) - plain)[:, -9:, -12:]
    assert corner.max() > 2 and np.array_equal(got.numpy()[:, :-9],
                                               plain[:, :-9])


def _write_watermark(path, channels):
    from PIL import Image as PImage

    arr = (_watermark(channels) * 255.0 + 0.5).astype(np.uint8)
    PImage.fromarray(arr, "RGBA" if channels == 4 else "RGB").save(path)


@pytest.mark.parametrize("grayscale", [False, True])
def test_run_with_watermark_matches_jax(tmp_path, grayscale):
    """run(watermark_path=...) against the JAX run, which reads the PNG
    through its io/: within 2 levels after each side's JPEG round trip,
    one plan per source size."""
    wm_path = str(tmp_path / "wm.png")
    _write_watermark(wm_path, 4)
    paths = _corpus(tmp_path)
    kw = dict(thumb_width=32, thumb_height=24, batch_size=2,
              grayscale=grayscale, decode_workers=2, encode_workers=2)
    got = tt.run(paths, str(tmp_path / "port"), tt.ThumbnailerConfig(**kw),
                 watermark_path=wm_path, device="cpu")
    want = jt.run(paths, str(tmp_path / "jax"), jt.ThumbnailerConfig(**kw),
                  watermark_path=wm_path)
    assert got["images"] == want["images"] == 6
    assert got["size_groups"] == want["size_groups"] == 2
    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
        a = tnat.decode_jpeg((tmp_path / "port" / name).read_bytes())
        b = tnat.decode_jpeg((tmp_path / "jax" / name).read_bytes())
        assert a.shape == b.shape == (24, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_read_watermark(tmp_path, mode):
    """Every PIL mode reads through the port's io/ as the JAX reader reads
    it (levels over 255, the same channels); the JAX side's native PNG
    decoder is turned off, as on a host without libpng, so that both
    decode with PIL."""
    from PIL import Image as PImage

    from imagemagick_tpu import io as jio

    path = str(tmp_path / f"wm_{mode}.png")
    _write_watermark(path, 4)
    PImage.open(path).convert(mode).save(path)
    got = tt.read_watermark(path)
    want = np.asarray(jio.read_images(path)[0].data)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _write_deep_watermarks(tmp_path):
    """A PGM (8-bit gray) and a 16-bit gray PNG watermark of 9x12."""
    from PIL import Image as PImage

    gray = _watermark(4)[..., 0]
    pgm = str(tmp_path / "wm.pgm")
    PImage.fromarray((gray * 255.0 + 0.5).astype(np.uint8), "L").save(pgm)
    png16 = str(tmp_path / "wm16.png")
    PImage.fromarray((gray * 65535.0 + 0.5).astype(np.uint16)).save(png16)
    return {"pgm": pgm, "png16": png16}


@pytest.mark.parametrize("kind", ["pgm", "png16"])
def test_run_with_a_pgm_or_16bit_watermark_matches_jax(tmp_path, kind,
                                                       monkeypatch):
    """run() with a PGM and with a 16-bit PNG watermark (one gray channel,
    which the JAX function reads through its io/ and composites) against
    the JAX run: the watermarks read equal, and the thumbnails within 2
    levels after each side's JPEG round trip."""
    monkeypatch.setattr(jnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "available", lambda: False)
    monkeypatch.setattr(tnat, "png_available", lambda: False)
    from imagemagick_tpu import io as jio

    wm_path = _write_deep_watermarks(tmp_path)[kind]
    np.testing.assert_array_equal(
        tt.read_watermark(wm_path),
        np.asarray(jio.read_images(wm_path)[0].data))
    paths = _corpus(tmp_path)
    kw = dict(thumb_width=32, thumb_height=24, batch_size=2,
              decode_workers=2, encode_workers=2)
    got = tt.run(paths, str(tmp_path / "port"), tt.ThumbnailerConfig(**kw),
                 watermark_path=wm_path, device="cpu")
    want = jt.run(paths, str(tmp_path / "jax"), jt.ThumbnailerConfig(**kw),
                  watermark_path=wm_path)
    assert got["images"] == want["images"] == 6
    from PIL import Image as PImage

    for p in paths:
        name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
        a = np.asarray(PImage.open(tmp_path / "port" / name))
        b = np.asarray(PImage.open(tmp_path / "jax" / name))
        assert a.shape == b.shape == (24, 32, 3)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 2
