"""The port's slice end to end, against the JAX package's Image chain.

The op route (resize -> gaussian_blur -> gray, each op clipping) is the
same float32 math on both sides (atol 1e-5); the fused route clips once at
the end, so it is gated at >= 60 dB like the JAX package's dispatch."""

import math
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagemagick_tpu.core.image import Image as JImage
import imagemagick_tpu_torch as it
from imagemagick_tpu_torch.ops import fused_pipeline as tfp
from imagemagick_tpu_torch.ops import gpu_kernels as gk

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRAY = np.array([[0.212656, 0.715158, 0.072186]])


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return 200.0 if mse == 0 else 10 * math.log10(1.0 / mse)


@pytest.fixture
def batch():
    rng = np.random.default_rng(11)
    yy, xx = np.mgrid[0:64, 0:128].astype(np.float32)
    base = 0.5 + 0.35 * np.sin(yy / 9.0)[..., None] * np.cos(xx / 13.0)[..., None]
    tex = 0.06 * rng.standard_normal((2, 64, 128, 3))
    return np.clip(base + tex, 0.0, 1.0).astype(np.float32)


def test_slice_matches_jax_image_chain(batch):
    before = dict(gk.LAUNCHES)
    ref = JImage(jnp.asarray(batch)).resize(32, 32, "lanczos") \
        .gaussian_blur(0.0, 1.5).transform_colorspace("gray")
    got = it.Image(torch.from_numpy(batch)).resize(32, 32, "lanczos") \
        .gaussian_blur(0.0, 1.5).transform_colorspace("gray")
    assert got.spec == it.ImageSpec("gray") and ref.spec.colorspace == "gray"
    np.testing.assert_allclose(got.to_numpy(), np.asarray(ref.data),
                               atol=1e-5)
    fused = tfp.fused_resize_pipeline(torch.from_numpy(batch), 32, 32,
                                      "lanczos", 1.5, GRAY, TO=16)
    assert _psnr(fused.numpy(), np.asarray(ref.data)) >= 60.0
    # on CPU tensors every wrapper takes its plain version
    assert gk.LAUNCHES == before


def test_image_members(batch):
    img = it.Image(torch.from_numpy(batch[0]))
    assert (img.height, img.width, img.channels) == (64, 128, 3)
    assert img.color_data().shape == (64, 128, 3)
    assert img.resize_geometry("128x64") is img          # no-op geometry
    small = img.resize_geometry("50%")
    ref = JImage(jnp.asarray(batch[0])).resize_geometry("50%")
    np.testing.assert_allclose(small.to_numpy(), np.asarray(ref.data),
                               atol=1e-5)
    blurred = img.blur(0.0, 1.0).to_numpy()
    np.testing.assert_allclose(
        blurred, np.asarray(JImage(jnp.asarray(batch[0])).blur(0.0, 1.0).data),
        atol=1e-5)
    u8 = (batch[0] * 255).astype(np.uint8)
    np.testing.assert_array_equal(it.Image.from_uint8(u8, device="cpu").to_numpy(),
                                  np.asarray(JImage.from_uint8(u8).data))
    both = it.stack([img, img])
    assert both.data.shape == (2, 64, 128, 3)
    with pytest.raises(ValueError):
        it.stack([img, img.transform_colorspace("gray")])


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import imagemagick_tpu_torch\n"
            "from imagemagick_tpu_torch.ops import dispatch, fused_pipeline\n"
            "from imagemagick_tpu_torch import _build\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'imagemagick_tpu' or "
            "m.startswith('imagemagick_tpu.')]\n"
            "assert not bad, bad\n"
            "import torch\n"
            "assert not torch.backends.cuda.matmul.allow_tf32\n"
            "assert not torch.backends.cudnn.allow_tf32\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|imagemagick_tpu)\b",
                         re.MULTILINE)
    files = sorted((ROOT / "imagemagick_tpu_torch").rglob("*.py"))
    assert len(files) >= 10
    for path in files + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
