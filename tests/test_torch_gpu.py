"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test skips without a card.  On a machine with one, run
``python -m pytest tests/test_torch_gpu.py --noconftest -q`` (this file
imports neither JAX nor the JAX package, and the suite's conftest does).
Tolerances: K3 sums at most 33 float32 taps in another order (1e-5); K1
sums float32 products of depth up to SPAN in another order (2e-5); K2
sums up to 33 + 17 taps in another order (2e-5), and with Lab its powf and
cbrtf stand against torch.pow (5e-5); K2p computes K2's values in K2's
order, so it is held to its plain version at K2's Lab tolerance and to K2
for equality.  K4 counts and K5's 0/1 outputs are
exact: both are held to equality (K4 also to one CUDA kernel a call, by
``torch.profiler``).  K6a and K6b sum radix butterflies (or
a p-term sum for a prime factor above 7) in another order than their
plain versions, with FMAs: their spectra within 1e-5 of max|F|; K6c's
[0, 1] output within 1e-5, also against a float64 inverse of a spectrum
with no symmetry.  The CLI's tone and threshold chains (``cli_tone``)
run on the card against the same chains on the CPU: the thumbnail chain
in one K1 launch within 1e-4 (K1's 2e-5 through auto-level's stretch,
the card's expf and powf); the document chain in one K1 and one K4
launch, at most 0.1 % of its 0/1 pixels apart; gathers, selects and the
ordered dither equal; the mesh resize within 1e-6; colorspaces within
their round-trip tolerances of ``chip_smoke.py``; the distance transform
within 1e-6 (its sums and minima are the CPU's).  Blur's effects run
on the card against the CPU within 1e-5 (K3's and cuDNN's float32 sums
in another order); the adaptive level and Kuwahara's quadrant, selected
from nearly equal values, may differ on at most 0.1 % of the pixels;
each adaptive blur, adaptive sharpen and Kuwahara filter is exactly one
K3 launch.  Composite operators agree within 1e-4 (the card's cosf and
divisions) but where a comparison inside the operator falls otherwise,
on at most 0.1 % of the values.  The transforms are copies, slices and
flips: equal on the card.  Distortions, shears and the samplers agree
within 1e-5 but on at most 0.1 % of the pixels, where a selection (an
EWA bin, a scan bound, a bilinear floor) falls otherwise; the deskew
angle and the liquid-rescale seams are equal; the EWA mask is the CPU's
at Q just below 0 and at and above 1024.  The channel ops are equal on
the card; the compare metrics within 1e-5 relative of the CPU's (float32
sums in another order); fx, k-means, ``kmeans_reference``'s device path
and ``set_image_type`` at most 0.1 % of the pixels or labels apart; the
native posterize (host) and ``remap`` equal; the CLI's channel chains
one K1 launch each, at most 0.1 % apart from the CPU run.  Decorate,
paint, vision, segment, Hough, mean shift, the GLCM and draw's float64
coverage are equal on the card; Canny's blur is one K3 launch and the
rest of Canny, replayed on the CPU from the card's blur, is equal.  The
visual effects agree within 1e-5 but on at most 0.1 % of the pixels (a
normalize's histogram bin, cuDNN's sums), the random ones on variates
drawn on the card and handed to the CPU; solarize, stegano and stereo
are equal; charcoal, the shadow and the polaroid are one K3 launch each.
The layer operators and the montage are copies and Over blends: within
1e-5, with equal frame counts, pages and delays.  Files decode onto the
card equal to their decode on the CPU bit for bit (the host makes the
float32 pixels) and encode from it to the CPU's bytes; the CLI from files
(config #1's chain in one K1 launch, config #3's in one K4 launch) and
the server's /convert (one K1 launch a request) write samples within one
level of the CPU run's on 99.9 % of them; -region's mask, on the card,
reaches mask:, MIFF and -print as the CPU's bytes.  The palette walks (Floyd-
Steinberg and Riemersma) equal their plain versions bit for bit, one
launch a call, their rows in shared or in device memory.  The wand's
resize and Gaussian blur are one K1 launch each, within K1's 2e-5 of the
same wand chain on the CPU (K1's plain version); its blur of a non-opaque
alpha is one K3 launch (1e-5), its Otsu threshold one K4 launch (equal);
a clone's pixel write leaves the original on the card alone.  A
Magick++ program built for the card (the default device) resizes and
blurs in one K1 launch each, counted in its own embedded interpreter,
within 2e-5 of the same program built for the CPU; the PerlMagick
server on the card answers a Read, Resize, Blur session in two K1
launches, its pixel within 2e-5 and its written 16-bit samples within
one level of the same session on the CPU.  The sharded ops on a mesh
that names the card eight times launch K3 and K4 once a block and equal
the unsharded ops on the card (the blur, the resize and the gigapixel
pipeline within 1e-5, the rest exactly; the statistics within 1e-5 and
1e-4 of float64); K1 on each dp block equals one call within 1e-6; the
CLI under ``-define tpu:mesh=1x1`` writes the bytes of the run without
it.
"""

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch.ops import dispatch
from imagemagick_tpu_torch.ops import fused_pipeline as fp
from imagemagick_tpu_torch.ops import gpu_kernels as gk

GRAY = np.array([[0.212656, 0.715158, 0.072186]])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1 to K6c run only there")
    return torch.device("cuda", 0)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _taps(n, sigma):
    j = n // 2
    xs = np.arange(-j, j + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


@pytest.mark.parametrize("shape,ntaps", [
    ((1, 1, 1, 1), 3), ((2, 37, 45, 3), 15), ((1, 100, 33, 4), 33),
    ((2, 31, 70, 8), 9), ((1, 5, 300, 2), 31), ((3, 64, 64, 3), 1),
    # the generic kernel at C = 1, 2, 4 and 8, at 3 and 33 taps
    ((2, 40, 70, 1), 3), ((2, 40, 70, 1), 33), ((1, 45, 97, 2), 3),
    ((1, 45, 97, 2), 33), ((1, 33, 65, 4), 3), ((1, 33, 65, 4), 33),
    ((1, 37, 70, 8), 3), ((1, 37, 70, 8), 33),
    # images smaller than the halo, on each kernel
    ((2, 5, 7, 3), 33), ((1, 6, 10, 3), 15), ((1, 3, 4, 3), 9),
    ((1, 9, 5, 8), 33),
    # W not a multiple of the tile; rows of W * C % 4 == 0 take the
    # 16-byte window copy on interior tiles (256 * 3, 96 * 4)
    ((1, 70, 130, 3), 15), ((2, 40, 100, 3), 9), ((1, 100, 256, 3), 15),
    ((1, 100, 256, 3), 9), ((1, 70, 96, 4), 33), ((2, 70, 200, 1), 7),
])
def test_k3_matches_plain(dev, shape, ntaps):
    x = _rand(shape)
    k = _taps(ntaps, max(ntaps / 5.0, 0.5))
    before = gk.LAUNCHES["k3"]
    got = gk.separable_blur(torch.from_numpy(x).to(dev), k)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] == before + 1
    ref = gk.separable_blur(torch.from_numpy(x), k)          # plain, CPU
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("ntaps", [15, 9, 33])
def test_k3_unaligned_batch_matches_plain(dev, ntaps):
    """A contiguous batch that starts 4 bytes past a 16-byte boundary: the
    window is copied float by float on every tile."""
    shape = (2, 70, 256, 3)
    flat = torch.from_numpy(_rand((int(np.prod(shape)) + 1,), seed=8))
    x = flat.to(dev)[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    k = _taps(ntaps, ntaps / 5.0)
    got = gk.separable_blur(x, k)
    ref = gk.separable_blur(flat[1:].view(shape), k)          # plain, CPU
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


def test_k3_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 3), device=dev)
    for bad_x, k in ((x, _taps(35, 6.0)), (x, np.ones(4) / 4),
                     (x.double(), _taps(3, 1.0)),
                     (x.transpose(1, 2), _taps(3, 1.0))):
        with pytest.raises(ValueError):
            gk.separable_blur(bad_x, k)


@pytest.mark.parametrize("N,H,W,C,Hout,Wout,sigma,mix,TO", [
    (2, 64, 128, 3, 32, 32, 1.5, GRAY, 16),
    (3, 96, 256, 1, 40, 100, 1.0, None, 128),
    (1, 200, 384, 3, 57, 77, 2.5, None, 64),
    # a wide kernel on narrow outputs: lane windows that overlap most
    (2, 64, 512, 1, 24, 200, 2.5, None, 32),
])
def test_k1_matches_plain(dev, N, H, W, C, Hout, Wout, sigma, mix, TO):
    x = _rand((N, H, W, C), seed=1)
    before = gk.LAUNCHES["k1"]
    got = fp.fused_resize_pipeline(torch.from_numpy(x).to(dev), Hout, Wout,
                                   "lanczos", sigma, mix, TO=TO)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k1"] == before + 1
    ref = fp.fused_resize_pipeline(torch.from_numpy(x), Hout, Wout,
                                   "lanczos", sigma, mix, TO=TO)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_k1_two_terms_matches_plain(dev):
    """Rank-2 blur -> unsharp term list: two terms, deduplicated blocks."""
    Bv, Bw = fp.blur_band_matrix(64, 1.0), fp.blur_band_matrix(512, 1.0)
    Uv = fp.blur_band_matrix(64, 0.8, width_rule="1d")
    Uw = fp.blur_band_matrix(512, 0.8, width_rule="1d")
    terms = [(1.7 * Bv, Bw), (-0.7 * (Uv @ Bv), Uw @ Bw)]
    x = _rand((2, 64, 512, 1), seed=2)
    got = fp.fused_linear_pipeline(torch.from_numpy(x).to(dev), terms, 1,
                                   TO=32)
    ref = fp.fused_linear_pipeline(torch.from_numpy(x), terms, 1, TO=32)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


@pytest.mark.parametrize("N,h,w,wcp", [(2, 512, 768, 2304),
                                       (1, 500, 100, 512)])
def test_k1_thumbnail_matches_plain(dev, N, h, w, wcp):
    """Config #5's step (Lanczos to 256x256x3, identity mix) on the staged
    layout, whose rows may carry zero lanes past w * 3 (winc_pad)."""
    from imagemagick_tpu_torch.ops.resize import resize_matrix

    h8 = -(-h // 8) * 8
    Mv = np.pad(resize_matrix(h, 256, "lanczos").astype(np.float64).T,
                ((0, 0), (0, h8 - h)))
    Mw = resize_matrix(w, 256, "lanczos").astype(np.float64).T
    x = _rand((N * h8, wcp), seed=5)
    x[:, w * 3:] = 0.0
    before = gk.LAUNCHES["k1"]
    got = fp.fused_linear_pipeline(torch.from_numpy(x).to(dev), [(Mv, Mw)],
                                   3, in_shape=(N, h8, w, 3), winc_pad=wcp)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k1"] == before + 1
    ref = fp.fused_linear_pipeline(torch.from_numpy(x), [(Mv, Mw)], 3,
                                   in_shape=(N, h8, w, 3), winc_pad=wcp)
    assert got.shape == (N, 256, 256, 3)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_dispatch_unaligned_matches_plain(dev):
    x = _rand((70, 90, 3), seed=3)
    tags = [("resize", (40, 36, "lanczos")), ("gblur", (0.0, 1.5, "2d")),
            ("mix", ((0.212656, 0.715158, 0.072186),))]
    got, n = dispatch.try_fused_chain(torch.from_numpy(x).to(dev), tags)
    ref, _ = dispatch.try_fused_chain(torch.from_numpy(x), tags)
    assert n == 3 and got.shape == (40, 36, 1)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=2e-5)


def test_k1_refuses_bad_operands(dev):
    WV, r0s, BAND, ntiles, GB, c0s, SPAN, OUT, OUTP = fp._plan(
        64, 128, 3, 32, 32, "lanczos", 1.0, ((1.0, 0.0, 0.0),), 16)
    ops = fp.plan_to_tensors(WV, GB, fp.flat_r0(r0s, 1, 64), dev)
    x = torch.zeros((64, 384), device=dev)
    guids = tuple(range(len(c0s)))
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops._replace(WV=ops.WV.double()), c0s, guids,
                        ntiles)
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops._replace(kr=ops.kr[..., :1].contiguous()),
                        c0s, guids, ntiles)
    with pytest.raises(ValueError):
        fp.fused_kernel(x, ops, (10_000,) * len(c0s), guids, ntiles)


def test_blur_beyond_k3_channels_takes_plain_path(dev):
    """More than 8 channels exceed K3's shared memory: the op runs the two
    plain passes on the card, as the TPU path declines past its budget."""
    from imagemagick_tpu_torch.ops import blur

    x = _rand((1, 20, 24, 10), seed=4)
    before = gk.LAUNCHES["k3"]
    got = blur.gaussian_blur(torch.from_numpy(x).to(dev), 0.0, 2.0)
    assert gk.LAUNCHES["k3"] == before
    ref = blur.gaussian_blur(torch.from_numpy(x), 0.0, 2.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("shape,lab,nb,nu", [
    ((2, 64, 128, 3), True, 15, 9),
    ((2, 64, 128, 3), False, 15, 9),
    ((2, 37, 45, 3), True, 15, 9),     # rows, columns short of a 32-tile
    ((1, 100, 33, 1), False, 15, 9),   # C = 1
    ((3, 50, 70, 4), False, 7, 3),
    ((1, 40, 50, 8), False, 33, 17),   # the largest windows: 16-tiles
    ((1, 37, 45, 6), False, 33, 17),   # the fewest channels on 16-tiles
    ((1, 40, 50, 3), True, 33, 17),    # the generic kernel with Lab
    ((1, 5, 7, 3), True, 33, 17),      # image smaller than the taps
    ((2, 100, 150, 3), True, 15, 9),   # partial 64 x 32 tiles
    ((2, 37, 45, 3), True, 1, 1),
])
def test_k2_matches_plain(dev, shape, lab, nb, nu):
    x = _rand(shape, seed=5)
    bt, ut = _taps(nb, nb / 7.0), _taps(nu, nu / 9.0)
    before = gk.LAUNCHES["k2"]
    got = fp.blur_unsharp_kernel(torch.from_numpy(x).to(dev), bt, ut, 1.0,
                                 lab)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k2"] == before + 1
    ref = fp.blur_unsharp_kernel(torch.from_numpy(x), bt, ut, 1.0, lab)
    tol = 5e-5 if lab else 2e-5
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=tol)
    # the border rows and columns on their own
    got, ref = got.cpu().numpy(), ref.numpy()
    for sl in (np.s_[:, :4], np.s_[:, -4:], np.s_[:, :, :4],
               np.s_[:, :, -4:]):
        np.testing.assert_allclose(got[sl], ref[sl], atol=tol)


@pytest.mark.parametrize("lab", [False, True])
def test_k2_fused_entry_borders_vs_float64(dev, lab):
    """Config #2's operators on a card: the whole image and its first and
    last 4 rows and columns alone against the float64 reference."""
    x = _rand((2, 16, 128, 3), seed=6)
    before = gk.LAUNCHES["k2"]
    got = fp.fused_blur_unsharp_pipeline(torch.from_numpy(x).to(dev), 2.0,
                                         1.0, 1.0, 3, lab_roundtrip=lab)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k2"] == before + 1
    got = got.cpu().numpy()
    ref = fp.reference_blur_unsharp_f64(x, 2.0, 1.0, 1.0, lab)
    for sl in (np.s_[:], np.s_[:, :4], np.s_[:, -4:], np.s_[:, :, :4],
               np.s_[:, :, -4:]):
        assert float(np.abs(got[sl] - ref[sl]).max()) <= 3e-5


@pytest.mark.parametrize("shape,nb,nu", [
    ((2, 100, 150, 3), 15, 9),   # config #2's kernel, partial 64 x 32 tiles
    ((1, 40, 50, 3), 33, 17),    # the generic kernel, 32-tiles
    ((2, 37, 45, 3), 7, 3),
])
def test_k2_equals_k2p(dev, shape, nb, nu):
    """K2 with Lab leaves every value as K2p makes it, whichever of its
    kernels runs: each output keeps its chain of FMAs."""
    x = torch.from_numpy(_rand(shape, seed=7)).to(dev)
    bt, ut = _taps(nb, nb / 7.0), _taps(nu, nu / 9.0)
    got = fp.blur_unsharp_kernel(x, bt, ut, 1.0, True)
    want = fp.blur_unsharp_pipe_kernel(x, bt, ut, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 3), device=dev)
    t9, t15 = _taps(9, 1.0), _taps(15, 2.0)
    for bad_x, bt, ut, lab in ((x, _taps(35, 6.0), t9, False),
                               (x, t15, _taps(19, 3.0), False),
                               (x, np.ones(4) / 4, t9, False),
                               (x, t15, np.ones(2) / 2, False),
                               (x[..., :1].contiguous(), t15, t9, True),
                               (torch.zeros((1, 8, 8, 9), device=dev), t15,
                                t9, False),
                               (x.double(), t15, t9, False),
                               (x.transpose(1, 2), t15, t9, False)):
        with pytest.raises(ValueError):
            fp.blur_unsharp_kernel(bad_x, bt, ut, 1.0, lab)


@pytest.mark.parametrize("shape,nb,nu", [
    ((8, 1080, 1920, 3), 15, 9),    # config #2
    ((2, 37, 45, 3), 15, 9),        # partial tiles, fewer tiles than SMs
    ((1, 8, 128, 3), 15, 9),        # one tile row
    ((2, 300, 500, 3), 15, 9),      # 320 tiles: a tail on the grid
    ((1, 40, 50, 3), 33, 17),       # the largest windows: 16-tiles
    ((1, 5, 7, 3), 33, 17),         # image smaller than the taps
])
def test_k2p_matches_plain(dev, shape, nb, nu):
    x = _rand(shape, seed=15)
    bt, ut = _taps(nb, nb / 7.0), _taps(nu, nu / 9.0)
    before = dict(gk.LAUNCHES)
    got = fp.blur_unsharp_pipe_kernel(torch.from_numpy(x).to(dev), bt, ut,
                                      1.0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k2p"] == before["k2p"] + 1
    assert gk.LAUNCHES["k2"] == before["k2"]
    ref = fp.blur_unsharp_pipe_kernel(torch.from_numpy(x), bt, ut, 1.0)
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=5e-5)
    got, ref = got.cpu().numpy(), ref.numpy()
    for sl in (np.s_[:, :4], np.s_[:, -4:], np.s_[:, :, :4],
               np.s_[:, :, -4:]):
        np.testing.assert_allclose(got[sl], ref[sl], atol=5e-5)


def test_k2p_equals_k2(dev):
    """One 1080p image: K2p's schedule leaves every value as K2 makes it."""
    x = torch.from_numpy(_rand((1, 1080, 1920, 3), seed=16)).to(dev)
    blur, unsharp = fp.blur_unsharp_taps(1080, 1920, 2.0, 1.0)
    got = fp.blur_unsharp_pipe_kernel(x, blur, unsharp, 1.0)
    want = fp.blur_unsharp_kernel(x, blur, unsharp, 1.0, True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k2p_refuses_what_it_does_not_take(dev):
    x = torch.zeros((1, 8, 8, 3), device=dev)
    t9, t15 = _taps(9, 1.0), _taps(15, 2.0)
    for bad_x, bt, ut in ((x[..., :1].contiguous(), t15, t9),
                          (torch.zeros((1, 8, 8, 4), device=dev), t15, t9),
                          (x, _taps(35, 6.0), t9),
                          (x, t15, _taps(19, 3.0)),
                          (x, np.ones(4) / 4, t9),
                          (x, t15, np.ones(2) / 2),
                          (x.double(), t15, t9),
                          (x.transpose(1, 2), t15, t9)):
        with pytest.raises(ValueError):
            fp.blur_unsharp_pipe_kernel(bad_x, bt, ut, 1.0)


def test_pipelined_route_runs_k2p(dev):
    """``pipelined=True`` with Lab launches K2p and not K2, and equals the
    sequential route; without Lab it runs K2."""
    x = torch.from_numpy(_rand((2, 64, 128, 3), seed=17)).to(dev)
    before = dict(gk.LAUNCHES)
    got = fp.fused_blur_unsharp_pipeline(x, 2.0, 1.0, 1.0, 3,
                                         lab_roundtrip=True, pipelined=True)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k2p"] == before["k2p"] + 1
    assert gk.LAUNCHES["k2"] == before["k2"]
    want = fp.fused_blur_unsharp_pipeline(x, 2.0, 1.0, 1.0, 3,
                                          lab_roundtrip=True)
    assert torch.equal(got, want)
    before = dict(gk.LAUNCHES)
    fp.fused_blur_unsharp_pipeline(x, 2.0, 1.0, 1.0, 3, pipelined=True)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k2"] == before["k2"] + 1
    assert gk.LAUNCHES["k2p"] == before["k2p"]


def _hdri(n, seed):
    v = _rand((n,), seed=seed)
    v[::97] = -0.25
    v[1::101] = 1.75
    v[2::103] = 1e9
    v[3::107] = -1e9
    v[4::109] = np.nan
    v[5::113] = (np.arange(len(v[5::113])) % 256 + 0.5) / 255  # bin edges
    return v


@pytest.mark.parametrize("rows,rowlen,skew", [
    (1, 5 * 256 * 512 + 333, False), (16, 20_000, False), (3, 1, False),
    (5, 70_001, True), (300, 257, True),
    # rows whose starts fall 4, 8 and 12 bytes past a 16-byte boundary;
    # rows shorter than a block; near-white pages (about 16 bins)
    (16, 20_001, False), (16, 20_002, False), (16, 20_003, True),
    (1024, 37, False), (2, 3, False), (1, 2 ** 24 + 5, False),
    (7, 30_001, "near"), (16, 4096, "near"),
])
def test_k4_matches_plain(dev, rows, rowlen, skew):
    x = _hdri(rows * rowlen, seed=rows).reshape(rows, rowlen)
    if skew == "near":
        x = 0.94 + 0.06 * _rand(x.shape, seed=8)
    elif skew:                                 # a mostly white page
        x[_rand(x.shape, seed=7) < 0.9] = 1.0
    before = gk.LAUNCHES["k4"]
    got = gk.histogram256(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k4"] == before + 1
    ref = gk.histogram256(torch.from_numpy(x))          # plain, CPU
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())
    assert got.double().sum().item() == rows * rowlen


def test_k4_is_one_kernel_per_call(dev):
    """The kernel writes the float32 counts itself: one call runs one CUDA
    kernel (no memset, no conversion), on a row shared by many blocks and
    on rows of one block each."""
    from torch.profiler import ProfilerActivity, profile

    for shape in ((16, 861696), (1000, 37)):
        x = torch.from_numpy(_rand(shape, seed=9)).to(dev)
        gk.histogram256(x)                       # the scratch, made once
        torch.cuda.synchronize()
        # the profiler drops an event now and then (never adds one): take
        # a capture that holds all five launches
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    gk.histogram256(x)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if sum("histogram256" in n for n in names) == 5:
                break
        assert len(names) == 5, names


def test_k4_refuses_what_it_does_not_take(dev):
    x = torch.zeros((4, 64), device=dev)
    for bad in (x.double(), x.t(), x[None], x[:, :0]):
        with pytest.raises(ValueError):
            gk.histogram256(bad)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_channel_histogram_on_card(dev, channels):
    """Each channel of an image is a strided view: the histogram reads it
    through K4, one launch a channel, and equals the CPU's counts."""
    from imagemagick_tpu_torch.ops import histogram

    x = torch.from_numpy(_hdri(2 * 40 * 33 * channels, seed=channels)
                         .reshape(2, 40, 33, channels))
    before = gk.LAUNCHES["k4"]
    got = histogram.channel_histogram(x.to(dev))
    bars = histogram.histogram_image(x.to(dev), height=50)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k4"] == before + 2 * channels
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  histogram.channel_histogram(x).numpy())
    np.testing.assert_array_equal(
        bars.cpu().numpy(), histogram.histogram_image(x, height=50).numpy())


@pytest.mark.parametrize("shape", [
    (2, 77, 61), (1, 1, 50), (1, 5, 1), (3, 40, 700), (1, 33, 96),
    (2, 64, 128), (1, 1, 1), (4, 130, 65),
    # a word of 32 pixels and one pixel either side of it; a row of two
    # groups of words; images shorter than a strip's 5-row halo
    (2, 9, 31), (2, 9, 32), (2, 9, 33), (1, 23, 1025), (2, 1, 37),
    (2, 2, 37), (2, 3, 37), (2, 4, 37), (2, 5, 37), (2, 6, 37),
    (2, 11, 37),
])
def test_k5_matches_plain(dev, shape):
    x = _rand(shape, seed=shape[1])
    t = np.linspace(0.35, 0.65, shape[0]).astype(np.float32)
    before = gk.LAUNCHES["k5"]
    got = gk.fused_bilevel_morph_edge(torch.from_numpy(x).to(dev),
                                      torch.from_numpy(t).to(dev))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k5"] == before + 1
    ref = gk.fused_bilevel_morph_edge(torch.from_numpy(x),
                                      torch.from_numpy(t))
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


def test_k5_on_8bit_pages_and_scalar_threshold(dev):
    u8 = np.random.default_rng(1).integers(0, 256, (2, 96, 80, 1))
    x = torch.from_numpy((u8 / 255.0).astype(np.float32))
    t = 128 / 255.0                           # pixels sit on the threshold
    got = gk.fused_bilevel_morph_edge(x.to(dev), t)
    ref = gk.fused_bilevel_morph_edge(x, t)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())


def test_config3_routes_agree_on_card(dev):
    from imagemagick_tpu_torch.models import pipelines
    from imagemagick_tpu_torch.ops import threshold

    batch = torch.from_numpy(_rand((3, 90, 70, 1), seed=9)).to(dev)
    before = dict(gk.LAUNCHES)
    ops = pipelines.document_binarize()(batch)
    fused = gk.fused_bilevel_morph_edge(
        batch, threshold.auto_threshold_values(batch, "otsu"))
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k4"] == before["k4"] + 2
    assert gk.LAUNCHES["k5"] == before["k5"] + 1
    np.testing.assert_array_equal(fused.cpu().numpy(), ops.cpu().numpy())
    cpu = pipelines.document_binarize()(batch.cpu())
    np.testing.assert_array_equal(ops.cpu().numpy(), cpu.numpy())


def test_image_defaults_to_the_card(dev):
    import imagemagick_tpu_torch as it

    arr = _rand((5, 6, 3), seed=10)
    assert it.Image(arr).data.device.type == "cuda"
    u8 = (arr * 255).astype(np.uint8)
    assert it.Image.from_uint8(u8).data.device.type == "cuda"
    assert it.Image(arr, device="cpu").data.device.type == "cpu"


def _spec_rel(got, ref):
    return float((got.cpu() - ref.cpu()).abs().max() / ref.abs().max())


@pytest.mark.parametrize("shape", [
    (1, 2160, 4096), (2, 72, 384), (3, 45, 102), (1, 7, 8192),
    (1, 5, 8186), (1, 48, 256), (1, 5, 135),
])
def test_k6_match_plain(dev, shape):
    """Each K6 kernel against its plain version on the same card inputs
    (K6b where H is composite), and K6c on a non-Hermitian spectrum
    against a float64 inverse."""
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    x = torch.from_numpy(_rand(shape, seed=shape[1])).to(dev)
    pmean = torch.sum(x * x, dim=(-2, -1))
    before = dict(gk.LAUNCHES)
    spec = fk.w_forward(x)
    spec_ref = fk._w_forward_plain(x)
    g_ref = fk._h_mask_plain(spec_ref, pmean, 0.01)
    out = fk.w_inverse(g_ref)
    out_ref = fk._w_inverse_plain(g_ref)
    with_k6b = fk.supported(*shape[1:])
    if with_k6b:
        g = fk.h_mask(spec_ref, pmean, 0.01)
    torch.cuda.synchronize()
    for key in ("k6a", "k6b", "k6c"):
        assert gk.LAUNCHES[key] == before[key] + (key != "k6b" or with_k6b)
    assert spec.dtype == torch.complex64
    assert _spec_rel(spec, spec_ref) <= 1e-5
    if with_k6b:
        assert _spec_rel(g, g_ref) <= 1e-5
    assert float((out - out_ref).abs().max()) <= 1e-5
    rng = np.random.default_rng(shape[2])
    u = rng.uniform(-0.2, 1.2, shape) + 1j * rng.uniform(-1, 1, shape)
    g_any = np.fft.fft(u, axis=-1).astype(np.complex64)
    ref = np.clip(np.fft.ifft(g_any.astype(np.complex128), axis=-1).real,
                  0, 1)
    got = fk.w_inverse(torch.from_numpy(g_any).to(dev)).cpu().numpy()
    assert float(np.abs(got - ref).max()) <= 1e-5


@pytest.mark.parametrize("shape", [
    (1, 2160, 6), (2, 135, 9), (1, 8186, 4), (1, 8192, 6), (3, 4, 6),
    (1, 4096, 10), (1, 3418, 8), (1, 3420, 4), (1, 6838, 4),
])
def test_k6b_matches_plain(dev, shape):
    """K6b at the heights of its plans (8.2.3.3.3.5, 3.3.3.5, a generic
    pass of 4093, 8.8.8.8.2, one pass) and strip widths (4 columns up to
    H = 3418, 2 up to 6837, 1 above), W not a multiple of the strip."""
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    rng = np.random.default_rng(shape[1])
    spec = torch.from_numpy(np.fft.fft(rng.random(shape), axis=-1)
                            .astype(np.complex64)).to(dev)
    pmean = torch.from_numpy(rng.uniform(50, 200, shape[0])
                             .astype(np.float32)).to(dev)
    before = gk.LAUNCHES["k6b"]
    got = fk.h_mask(spec, pmean, 0.01)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k6b"] == before + 1
    assert _spec_rel(got, fk._h_mask_plain(spec, pmean, 0.01)) <= 1e-5


def test_k6_fused_route_vs_float64(dev):
    """Config #4's entry on a card batch of two images runs K6a-K6c once
    each and is >= 100 dB from a float64 numpy Wiener."""
    from imagemagick_tpu_torch.models import pipelines

    x = _rand((2, 72, 384, 1), seed=12)
    before = dict(gk.LAUNCHES)
    got = pipelines.fft_wiener()(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize()
    for key in ("k6a", "k6b", "k6c"):
        assert gk.LAUNCHES[key] == before[key] + 1
    planes = x[..., 0].astype(np.float64)
    f = np.fft.fft2(planes)
    p = np.abs(f) ** 2
    pmean = (planes ** 2).sum(axis=(-2, -1), keepdims=True)
    ref = np.clip(np.fft.ifft2(f * p / (p + 0.01 * pmean)).real, 0, 1)
    mse = float(np.mean((got.cpu().numpy()[..., 0] - ref) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-30)) >= 100.0


def test_k6_refuses_what_it_does_not_take(dev):
    from imagemagick_tpu_torch.ops import fourier_kernels as fk

    x = torch.zeros((1, 48, 256), device=dev)
    spec = torch.zeros((1, 48, 256), dtype=torch.complex64, device=dev)
    pm = torch.ones(1, device=dev)
    # K6a and K6c transform rows: a prime W is refused, a prime H is not
    for bad in (x.double(), x.transpose(1, 2), x[0],
                torch.zeros((1, 13, 251), device=dev),
                torch.zeros((1, 13, 8200), device=dev)):
        with pytest.raises(ValueError):
            fk.w_forward(bad)
    for bad, p in ((spec, torch.ones(2, device=dev)), (spec, pm.double()),
                   (x, pm), (spec.transpose(1, 2), pm)):
        with pytest.raises(ValueError):
            fk.h_mask(bad, p, 0.01)
    for bad in (x, spec[:, :, :251].contiguous()):          # 251 is prime
        with pytest.raises(ValueError):
            fk.w_inverse(bad)


def test_k6_declined_shape_takes_the_fourstep(dev):
    """A prime extent has no four-step factorization for K6: the card
    runs the torch four-step (dense along the prime axis), no K6 launch."""
    from imagemagick_tpu_torch.ops import fourier

    x = torch.from_numpy(_rand((2, 13, 40, 1), seed=13))
    before = dict(gk.LAUNCHES)
    got = fourier.wiener_deconvolve(x.to(dev), noise=0.01)
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before
    fourier.set_fft_mode("fourstep")
    try:
        ref = fourier.wiener_deconvolve(x, noise=0.01)
    finally:
        fourier.set_fft_mode("auto")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), atol=1e-5)


# -- empty inputs: the empty or zero result, no launch -----------------------

def _empty_cases(device):
    from imagemagick_tpu_torch.models import pipelines
    from imagemagick_tpu_torch.ops import blur, histogram, threshold

    def z(*shape):
        return torch.zeros(shape, device=device)

    return [
        (lambda: blur.gaussian_blur(z(0, 16, 16, 3), 0, 2.0),
         (0, 16, 16, 3)),
        (lambda: histogram.channel_histogram(z(0, 5, 3)), (256, 3)),
        (lambda: gk.fused_bilevel_morph_edge(z(0, 16, 16, 1), 0.5),
         (0, 16, 16, 1)),
        (lambda: gk.fused_bilevel_morph_edge(z(2, 0, 16), 0.5), (2, 0, 16)),
        (lambda: threshold.auto_threshold_values(z(0, 16, 16, 3)), (0,)),
        (lambda: pipelines.document_binarize()(z(0, 16, 16, 1)),
         (0, 16, 16, 1)),
    ]


def _check_empty(cases):
    before = dict(gk.LAUNCHES)
    for run, shape in cases:
        out = run()
        assert tuple(out.shape) == shape
        assert not out.any()
    assert gk.LAUNCHES == before


def test_empty_inputs_on_card(dev):
    _check_empty(_empty_cases(dev))


def test_empty_inputs_reach_no_kernel(monkeypatch):
    """The same calls with every wrapper taking its card path: none may
    reach the kernel library."""
    from imagemagick_tpu_torch import _build

    def no_library():
        raise AssertionError("an empty input reached a kernel")

    monkeypatch.setattr(gk, "on_card", lambda x: True)
    monkeypatch.setattr(_build, "load", no_library)
    _check_empty(_empty_cases("cpu"))


# -- the product surfaces: thumbnailer step, CLI batch, serve sessions ------

@pytest.mark.parametrize("grayscale", [False, True])
def test_thumbnail_step_on_card(dev, grayscale):
    """Config #5's step at its real staged layout (256 rows of 1152 lanes,
    a 1/2 DCT-scaled 768x512 JPEG), short last batch included: one K1
    launch a step, within 1 u8 level of the plain step."""
    from imagemagick_tpu_torch.models import thumbnailer as tn

    cfg = tn.ThumbnailerConfig(grayscale=grayscale)
    staged = torch.from_numpy(
        (_rand((5, 256, 1152), 7) * 255).astype(np.uint8))
    step = tn.make_flat_step(cfg, 256, 384, device=dev)
    plain = tn.make_flat_step(cfg, 256, 384, device="cpu")
    for batch in (staged[:4], staged[4:]):
        before = gk.LAUNCHES["k1"]
        got = step(batch.pin_memory())
        torch.cuda.synchronize()
        assert gk.LAUNCHES["k1"] == before + 1
        assert got.device.type == "cuda" and got.dtype == torch.uint8
        want = plain(batch)
        assert (got.cpu().int() - want.int()).abs().max() <= 1


def test_cli_batch_is_one_launch_on_card(dev):
    from imagemagick_tpu_torch.cli import main as cli
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec

    argv = ["-resize", "64x64!", "-gaussian-blur", "0x2", "-colorspace",
            "gray"]
    x = torch.from_numpy(_rand((3, 96, 128, 3), 8))
    outs = {}
    for where in ("cpu", dev):
        st = cli.CLIState()
        for im in x.to(where):
            st.images.append(cli.LazyImage(Image(im,
                                                 ImageSpec(colorspace="srgb"))))
        cli.process(argv, st)
        before = dict(gk.LAUNCHES)
        outs[str(where)] = torch.stack([o.data for o in
                                        cli.materialize_all(st.images)])
        torch.cuda.synchronize()
        launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
    assert launched["k1"] == 1 and launched["k3"] == 0
    got, want = outs[str(dev)], outs["cpu"]
    assert got.shape == (3, 64, 64, 1)
    assert (got.cpu() - want).abs().max() <= 2e-5


def test_serve_session_on_card(dev):
    from imagemagick_tpu_torch import serve

    pixels = (_rand((4, 64, 96, 3), 9) * 255).astype(np.uint8)
    chain = "-resize 32x32! -gaussian-blur 0x2 -colorspace gray".split()
    fetched = {}
    for where in ("cpu", dev):
        info = serve._session_store("gpu_test", pixels.tobytes(),
                                    pixels.shape, "u8", where)
        assert info["platform"] == torch.device(where).type
        before = gk.LAUNCHES["k1"]
        info = serve._session_apply("gpu_test", chain)
        assert info["path"] == "fused-batch"
        if where == dev:
            assert gk.LAUNCHES["k1"] == before + 1
        fetched[str(where)] = np.frombuffer(
            serve._session_fetch("gpu_test"), np.uint8)
    serve._SESSIONS.pop("gpu_test")
    diff = fetched[str(dev)].astype(int) - fetched["cpu"]
    assert fetched["cpu"].size == 4 * 32 * 32 and np.abs(diff).max() <= 1


# -- cli_tone: the tone and threshold chains of the CLI ----------------------

def _cli_chain(argv, x, where, specs=None):
    from imagemagick_tpu_torch.cli import main as cli
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec

    st = cli.CLIState()
    for im in x.to(where):
        st.images.append(cli.LazyImage(Image(
            im, specs or ImageSpec(colorspace="srgb"))))
    before = dict(gk.LAUNCHES)
    cli.process(argv, st)
    out = torch.stack([o.data for o in cli.materialize_all(st.images)])
    if torch.device(where).type == "cuda":
        torch.cuda.synchronize()
    return out, {k: gk.LAUNCHES[k] - before[k] for k in before}


def test_cli_thumbnail_chain_is_one_launch_on_card(dev):
    """The thumbnail's tag over the group in one K1 launch, the tone
    options after it image by image: within 1e-4 of the CPU run (K1's
    2e-5 through auto-level's stretch, the card's expf and powf)."""
    argv = ("-thumbnail 48x48 -auto-level -modulate 100,120 "
            "-sigmoidal-contrast 3x50% -gamma 1.1").split()
    x = torch.from_numpy(_rand((3, 96, 128, 3), 10))
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k1"] == 1 and sum(launched.values()) == 1
    assert got.shape == (3, 36, 48, 3)
    assert (got.cpu() - want).abs().max() <= 1e-4


def test_cli_document_chain_is_one_k1_and_one_k4_launch(dev):
    argv = "-scale 50% -colorspace gray -normalize -auto-threshold otsu"
    x = torch.from_numpy(_rand((4, 96, 128, 3), 11))
    x = torch.where(x > 0.6, 0.9, 0.2) + 0.05 * x
    got, launched = _cli_chain(argv.split(), x, dev)
    want, _ = _cli_chain(argv.split(), x, "cpu")
    assert launched["k1"] == 1 and launched["k4"] == 1
    assert sum(launched.values()) == 2
    assert got.shape == (4, 48, 64, 1)
    assert float((got.cpu() != want).float().mean()) <= 1e-3


@pytest.mark.parametrize("argv,tol", [
    ("-sample 50%", 0.0), ("-magnify", 0.0), ("-ordered-dither o8x8", 0.0),
    ("-adaptive-resize 75%", 1e-6), ("-colorspace jzazbz", 2e-4),
    ("-colorspace lab", 5e-5), ("-colorspace ycc", 1e-3),
    # an intensity an ulp from a bin edge moves one pixel's count in the
    # cumulative map: 1 / (64 * 48)
    ("-equalize", 1.0 / 3072), ("-white-balance", 5e-5),
    # L on the host from the same pixels, Lab's a and b on the card
    ("-clahe 16x16+64+2", 1e-4)])
def test_cli_tone_options_on_card(dev, argv, tol):
    x = torch.from_numpy(_rand((2, 64, 48, 3), 12))
    got, _ = _cli_chain(argv.split(), x, dev)
    want, _ = _cli_chain(argv.split(), x, "cpu")
    assert got.is_cuda and got.shape == want.shape
    assert (got.cpu() - want).abs().max() <= tol


def test_distance_transform_on_card(dev):
    from imagemagick_tpu_torch.ops import morphology as mo

    x = torch.from_numpy((_rand((2, 64, 48, 1), 13) > 0.4).astype(
        np.float32))
    for metric in ("chebyshev", "manhattan", "euclidean"):
        got = mo.distance_transform(x.to(dev), metric)
        want = mo.distance_transform(x, metric)
        assert (got.cpu() - want).abs().max() <= 1e-6


def _selected_apart(got, want, tol=1e-5):
    """The share of pixels further apart than ``tol``."""
    return float(((got.cpu() - want).abs() > tol).any(-1).float().mean())


@pytest.mark.parametrize("name,args", [
    ("adaptive_blur", (0.0, 2.0)), ("adaptive_sharpen", (0.0, 1.0)),
    ("kuwahara", (3.0,))])
def test_k3_on_the_adaptive_and_kuwahara_paths(dev, name, args):
    """The adaptive pair's edge-map blur and Kuwahara's pre-blur are ONE
    K3 launch a call, and nothing else launches a kernel."""
    from imagemagick_tpu_torch.ops import blur as bl

    x = torch.from_numpy(_rand((2, 96, 128, 3), 14))
    before = dict(gk.LAUNCHES)
    got = getattr(bl, name)(x.to(dev), *args)
    torch.cuda.synchronize()
    launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
    assert launched["k3"] == 1 and sum(launched.values()) == 1
    want = getattr(bl, name)(x, *args)
    assert got.is_cuda and got.shape == want.shape
    assert _selected_apart(got, want) <= 1e-3


@pytest.mark.parametrize("name,args", [
    ("sharpen", (0.0, 1.0)), ("emboss", (1.0, 1.0)),
    ("motion_blur", (0.0, 3.0, 45.0)), ("rotational_blur", (10.0,)),
    ("selective_blur", (0.0, 1.0, 0.1)), ("despeckle", ()),
    ("shade", (30.0, 30.0)), ("bilateral_blur", (5, 5)),
    ("local_contrast", ())])
def test_effects_on_card(dev, name, args):
    from imagemagick_tpu_torch.ops import blur as bl

    x = _rand((2, 96, 128, 3), 15)
    if name == "despeckle":
        x = np.round(x * 255.0).astype(np.float32) / np.float32(255.0)
    x = torch.from_numpy(x)
    got = getattr(bl, name)(x.to(dev), *args)
    want = getattr(bl, name)(x, *args)
    assert got.is_cuda and got.shape == want.shape
    if name == "despeckle":
        assert torch.equal(got.cpu(), want)
    else:
        assert _selected_apart(got, want) <= 1e-3


def test_composite_on_card(dev):
    from imagemagick_tpu_torch.ops import composite as comp

    d = torch.from_numpy(_rand((2, 64, 96, 4), 16))
    s = torch.from_numpy(_rand((2, 64, 96, 4), 17))
    for op in comp.OPERATORS:
        got = comp.composite(d.to(dev), s.to(dev), op, True, True, (35.0,))
        want = comp.composite(d, s, op, True, True, (35.0,))
        assert got.is_cuda and got.shape == want.shape, op
        assert float(((got.cpu() - want).abs() > 1e-4).float().mean()) \
            <= 1e-3, op


def test_watermarked_thumbnail_step_on_card(dev):
    """One K1 launch a batch, then the watermark: within 2 u8 levels of
    the CPU step on the same staged bytes."""
    from imagemagick_tpu_torch.models import thumbnailer as tn

    cfg = tn.ThumbnailerConfig(thumb_width=64, thumb_height=48)
    staged = (np.random.default_rng(18).uniform(0, 255, (3, 96, 384))
              ).astype(np.uint8)
    wm = _rand((16, 20, 4), 19)
    before = dict(gk.LAUNCHES)
    got = tn.make_flat_step(cfg, 96, 128, wm, device=dev)(staged)
    torch.cuda.synchronize()
    launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
    want = tn.make_flat_step(cfg, 96, 128, wm, device="cpu")(staged)
    assert launched["k1"] == 1 and sum(launched.values()) == 1
    assert got.shape == want.shape == (3, 48, 64, 3)
    assert int((got.cpu().int() - want.int()).abs().max()) <= 2


def test_cli_effects_chain_on_card(dev):
    """``-resize -sharpen -adaptive-blur -median``: one K1 launch for the
    group, one K3 launch an image; then ``-composite``."""
    argv = "-resize 64x64 -sharpen 0x1 -adaptive-blur 0x2 -median 1".split()
    x = torch.from_numpy(_rand((3, 96, 128, 3), 20))
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k1"] == 1 and launched["k3"] == 3
    assert sum(launched.values()) == 4
    assert got.shape == (3, 48, 64, 3)
    assert _selected_apart(got, want) <= 1e-3
    argv = ("-gravity southeast -compose dissolve -define compose:args=35 "
            "-composite").split()
    got, _ = _cli_chain(argv, got[:2], dev)
    want, _ = _cli_chain(argv, want[:2], "cpu")
    assert got.shape == (1, 48, 64, 4)       # the dissolve adds alpha
    assert _selected_apart(got, want) <= 1e-3


def test_cli_distort_chain_is_one_launch_on_card(dev):
    """``-resize -flop -rotate -extent -distort Barrel -border``: the
    group's resize in one K1 launch, the rest with no kernel."""
    argv = ["-resize", "96x64!", "-flop", "-background", "white", "-rotate",
            "12", "-gravity", "center", "-extent", "96x64", "-distort",
            "Barrel", "0.05 0.0 0.0", "-bordercolor", "navy", "-border", "4"]
    x = torch.from_numpy(_rand((3, 128, 192, 3), 21))
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k1"] == 1 and sum(launched.values()) == 1
    assert got.shape == (3, 72, 104, 3)
    assert _selected_apart(got, want) <= 1e-3


def test_ewa_weight_mask_on_card(dev):
    """Q just below 0 reads bin 0, Q at and above 1024 no bin: the card
    masks as the CPU does (a cast of an out-of-range float is undefined,
    so the mask comes from Q)."""
    from imagemagick_tpu_torch.ops import distort as dt

    q = torch.tensor([-1.5, -1.0, -0.99999994, -0.5, -1e-30, -0.0, 0.0,
                      1e-7, 1023.0, 1023.99994, 1024.0, 1024.0001, 1e10,
                      -1e10, float("inf"), float("-inf"), float("nan")])
    want = dt._ewa_weight(q, dt._robidoux_lut())
    got = dt._ewa_weight(q.to(dev), dt._robidoux_lut(dev))
    assert torch.equal(got.cpu(), want)
    assert float(want[2]) == float(dt._robidoux_lut()[0]) != 0.0
    assert float(want[10]) == float(want[11]) == 0.0


@pytest.mark.parametrize("name,args", [
    ("crop", (-5, 7, 40, 30)), ("chop", (5, 7, 10, 8)),
    ("extent", (-5, -3, 140, 100)), ("flip", ()), ("flop", ()),
    ("roll", (5, -3)), ("shave", (3, 2)), ("splice", (5, 4, 3, 2)),
    ("transpose", ()), ("transverse", ()), ("rotate90", ()),
    ("rotate180", ()), ("rotate270", ())])
def test_transforms_equal_on_card(dev, name, args):
    from imagemagick_tpu_torch.ops import transform as tf

    x = torch.from_numpy(_rand((2, 96, 128, 3), 22))
    got = getattr(tf, name)(x.to(dev), *args)
    assert got.is_cuda
    assert torch.equal(got.cpu(), getattr(tf, name)(x, *args))


def test_trim_bounds_equal_on_card(dev):
    from imagemagick_tpu_torch.ops import transform as tf

    x = np.ones((2, 80, 100, 4), np.float32)
    x[:, 10:50, 20:70] = _rand((2, 40, 50, 4), 23)
    t = torch.from_numpy(x)
    for fuzz in (0.0, 0.1):
        assert tf.trim_bounds(t.to(dev), fuzz) == tf.trim_bounds(t, fuzz)


@pytest.mark.parametrize("method,args,bestfit", [
    ("srt", [30], False), ("srt", [0.7, 20], True),
    ("perspective", [0, 0, 5, 3, 127, 0, 120, 8, 0, 95, 4, 90,
                     127, 95, 118, 84], True),
    ("polar", [40], False), ("arc", [60], False),
    ("barrel", [0.05, 0.0, 0.0], False), ("depolar", [-1], True),
    ("shepards", [20, 20, 24, 26, 80, 60, 76, 55], False),
    ("polynomial", [1.5, 0, 0, 5, 3, 127, 0, 120, 8, 0, 95, 4, 90,
                    127, 95, 118, 84], False)])
@pytest.mark.parametrize("block", [None, 1 << 20, 1 << 14],
                         ids=["module-block", "block-2-20", "block-2-14"])
def test_distort_on_card(dev, monkeypatch, method, args, bestfit, block):
    """Each method on the card against the CPU; the per-pixel EWA at the
    module's block and at blocks small enough that its buckets run in
    scanline blocks and pixel chunks on the card (the CPU at the
    module's)."""
    from imagemagick_tpu_torch.ops import distort as dt

    x = torch.from_numpy(_rand((2, 96, 128, 4), 24))
    want = dt.distort(x, method, args, bestfit=bestfit)
    if block is not None:
        monkeypatch.setattr(dt, "_EWA_BLOCK", block)
    got = dt.distort(x.to(dev), method, args, bestfit=bestfit)
    assert got.is_cuda and got.shape == want.shape
    assert _selected_apart(got, want) <= 1e-3


def test_effects_shear_and_sparse_color_on_card(dev):
    from imagemagick_tpu_torch.ops import distort as dt
    from imagemagick_tpu_torch.ops import shear as sh

    x = torch.from_numpy(_rand((2, 96, 128, 3), 25))
    pts = [(5, 5, (1.0, 0.0, 0.0)), (100, 20, (0.0, 1.0, 0.0)),
           (40, 80, (0.0, 0.0, 1.0)), (120, 90, (1.0, 1.0, 0.0))]
    for fn, args in ((dt.swirl, (60.0,)), (dt.implode, (0.5,)),
                     (dt.wave, (5.0, 20.0)), (dt.rotate, (30.0,)),
                     (sh.shear, (20.0, 10.0)), (sh.x_shear, (15.0,)),
                     (dt.sparse_color, ("shepards", pts)),
                     (dt.sparse_color, ("voronoi", pts)),
                     (dt.sparse_color, ("barycentric", pts))):
        got = fn(x.to(dev), *args)
        want = fn(x, *args)
        assert got.is_cuda and got.shape == want.shape, fn
        assert _selected_apart(got, want) <= 1e-3, fn


def test_deskew_and_liquid_rescale_equal_on_card(dev):
    """The skew angle and the carved seams equal the CPU's."""
    from imagemagick_tpu_torch.ops import distort as dt
    from imagemagick_tpu_torch.ops import shear as sh

    page = np.ones((120, 200, 1), np.float32)
    page[10:110:9, 20:180] = 0.1
    p = dt.rotate(torch.from_numpy(page), 2.5, (1.0,))
    assert sh.deskew_angle_reference(p.to(dev)) == \
        sh.deskew_angle_reference(p) != 0.0
    assert sh.deskew_angle(p.to(dev)) == sh.deskew_angle(p)
    got = sh.deskew(p.to(dev))
    want = sh.deskew(p)
    assert got.shape == want.shape and _selected_apart(got, want) <= 1e-3
    x = torch.from_numpy(_rand((2, 40, 48, 3), 26))
    assert torch.equal(dt.liquid_rescale(x.to(dev), 40, 40).cpu(),
                       dt.liquid_rescale(x, 40, 40))


# -- channel, compare, fx, quantize and attribute on the card -------------

def test_channel_ops_equal_on_card(dev):
    """Slices, indexes and concatenations: equal on the card."""
    from imagemagick_tpu_torch.ops import channel as ch

    x = torch.from_numpy(_rand((2, 96, 128, 4), 30))
    xd = x.to(dev)
    for expr in ("red<=>blue", "rgba=>bgra", "g=>r,b=>g"):
        assert torch.equal(ch.channel_fx(xd, expr).cpu(),
                           ch.channel_fx(x, expr))
    for op in ("set", "off", "remove", "extract", "copy", "transparent"):
        for alpha in (False, True):
            assert torch.equal(ch.set_alpha(xd, op, alpha).cpu(),
                               ch.set_alpha(x, op, alpha)), (op, alpha)
    assert torch.equal(ch.combine(ch.separate_all(xd)).cpu(), x)
    assert torch.equal(ch.channel_mean(xd).cpu(), ch.channel_mean(x))


def test_compare_metrics_on_card(dev):
    """Each metric within 1e-5 relative of the CPU's (float32 sums in
    another order; dssim through 1 - 2 dssim); ae equal."""
    from imagemagick_tpu_torch.ops import compare as cm

    a = torch.from_numpy(_rand((2, 96, 128, 3), 31))
    b = torch.clamp(a + 0.05 * torch.from_numpy(_rand((2, 96, 128, 3), 32))
                    - 0.025, 0, 1)
    for m in sorted(cm._METRICS):
        aa, bb = (a[0], b[0]) if m == "phash" else (a, b)
        got = float(cm.get_distortion(aa.to(dev), bb.to(dev), m))
        want = float(cm.get_distortion(aa, bb, m))
        if m == "ae":
            assert got == want
        elif m == "dssim":
            assert abs((1 - 2 * got) - (1 - 2 * want)) <= 1e-5
        else:
            assert abs(got - want) <= 1e-5 * max(abs(want), 1e-2), m
    x = a[0]
    (y, xx), _ = cm.similarity_image(x.to(dev), x[20:52, 30:70].to(dev))
    assert (y, xx) == (20, 30)


def test_fx_on_card(dev):
    """fx on the card: at most 0.1 % of the values further than 1e-5 from
    the CPU's; rand by moments and equal channels."""
    from imagemagick_tpu_torch.ops import fx

    u = torch.from_numpy(_rand((2, 96, 128, 3), 33))
    v = torch.from_numpy(_rand((2, 96, 128, 3), 34))
    for expr in ("u*2-v/3", "u.g", "u>0.5?v:1-u", "i/w*j/h", "(u+v)/2",
                 "p[1,-1]", "p{5,7}", "sin(u*pi)*pow(v,2.2)",
                 "t=u*u; t+v", "hue", "luminance", "u[1]*0.5",
                 "gcd(u*20, 12)", "round(u*7)/7"):
        got = fx.fx([u.to(dev), v.to(dev)], expr)
        want = fx.fx([u, v], expr)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert _selected_apart(got, want) <= 1e-3, expr
    r = fx.fx(u.to(dev), "rand()")
    assert torch.equal(r[..., 0], r[..., 2])
    assert abs(float(r.mean()) - 0.5) < 0.01
    assert abs(float(r.var()) - 1 / 12) < 0.005


def test_quantize_on_card(dev):
    """posterize by rounding equal; the native walks (host) equal; k-means
    labels at most 0.1 % apart; unique colours exact; kmeans_reference's
    device path at most 0.1 % of the pixels apart."""
    from imagemagick_tpu_torch.ops import quantize as qz

    x = torch.from_numpy(_rand((2, 96, 128, 3), 35))
    xd = x.to(dev)
    for d in (False, True, "fs"):
        got = qz.posterize(xd, 4, d)
        assert got.is_cuda and torch.equal(got.cpu(), qz.posterize(x, 4, d))
    pal, lab = qz.kmeans(xd, 16)
    cpal, clab = qz.kmeans(x, 16)
    assert float((lab.cpu() != clab).float().mean()) <= 1e-3
    assert float((pal.cpu() - cpal).abs().max()) <= 1e-5
    assert int(qz.unique_colors_count(xd)) == int(qz.unique_colors_count(x))
    big = torch.from_numpy(_rand((1088, 1024, 3), 36))
    stats, cstats = {}, {}
    got = qz.kmeans_reference(big.to(dev), 4, 8, stats=stats)
    want = qz.kmeans_reference(big, 4, 8, stats=cstats)
    assert stats["route"] == "device"
    assert _selected_apart(got, want) <= 1e-3
    assert torch.equal(qz.remap(xd, pal).cpu(), qz.remap(x, pal.cpu()))


def test_attribute_on_card(dev):
    from imagemagick_tpu_torch.ops import attribute as at

    x = torch.from_numpy(np.round(_rand((96, 128, 3), 37) * 3) / 3)
    xd = x.to(dev)
    assert at.image_type(xd) == at.image_type(x) == "palette"
    assert at.image_depth(xd) == at.image_depth(x)
    for t in ("bilevel", "grayscale", "palette", "truecolor"):
        got = at.set_image_type(xd, t)
        assert got.is_cuda
        assert _selected_apart(got, at.set_image_type(x, t)) <= 1e-3, t
    assert at.bounding_box(xd) == at.bounding_box(x)


def test_cli_channel_chains_on_card(dev):
    """Chain A (one K1 launch for the group's resize) and chain B's list
    ops, each against the CPU run."""
    argv = ("-resize 64x64 -channel R -negate -channel All -channel-fx "
            "red<=>blue -alpha set -posterize 8 -type grayscale").split()
    x = torch.from_numpy(_rand((3, 96, 128, 3), 38))
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k1"] == 1 and sum(launched.values()) == 1
    assert got.shape == (3, 48, 64, 1)
    assert _selected_apart(got, want) <= 1e-3
    for argv, n in (("-resize 64x64 -separate -combine -colors 64", 1),
                    ("-resize 64x64 -fx (u+v)/2", 2),
                    ("-resize 64x64 -metric rmse -compare", 2)):
        got, launched = _cli_chain(argv.split(), x[:n], dev)
        want, _ = _cli_chain(argv.split(), x[:n], "cpu")
        assert launched["k1"] == 1 and sum(launched.values()) == 1, argv
        assert got.shape == want.shape == (1, 48, 64, 3), argv
        assert _selected_apart(got, want) <= 1e-3, argv


# -- segment, feature, vision, paint, draw and decorate on the card ----------

def test_decorate_and_paint_equal_on_card(dev):
    """Pads, masks, the flood fill's fixpoint and oil paint's integer
    counts: equal on the card; the gradient canvas too (host cosines,
    divisions by device tensors)."""
    from imagemagick_tpu_torch.ops import decorate as dc
    from imagemagick_tpu_torch.ops import paint as pt

    x = torch.from_numpy(np.round(_rand((2, 96, 128, 3), 40) * 3) / 3)
    xd = x.to(dev)
    calls = [(dc.border, (5, 3)), (dc.frame, (9, 7, 2, 3)),
             (dc.raise_image, (6, 4, False)),
             (pt.opaque_paint, ([0.5] * 3, [1, 0, 0], 0.3)),
             (pt.floodfill, (3, 4, [0, 0, 1], 0.4)),
             (pt.floodfill, (90, 60, [0, 1, 0], 0.3, None, [1, 1, 1])),
             (pt.oil_paint, (3.0,))]
    for fn, args in calls:
        got = fn(xd, *args)
        assert got.is_cuda and torch.equal(got.cpu(), fn(x, *args)), fn
    xa = torch.cat([x, torch.ones_like(x[..., :1])], -1)
    assert torch.equal(pt.transparent_paint(xa.to(dev), [1, 1, 1], 0.0, 0.2)
                       .cpu(), pt.transparent_paint(xa, [1, 1, 1], 0.0, 0.2))
    for kind in ("linear", "radial"):
        args = (60, 80, [1, 0, 0, 1], [0, 0, 1, 1], kind, 30.0)
        assert torch.equal(pt.gradient_image(*args, device=dev).cpu(),
                           pt.gradient_image(*args, device="cpu"))


def test_vision_equal_on_card(dev):
    """Labels (4 and 8 neighbours), the relabeling, the merge and the area
    threshold: equal on the card."""
    from imagemagick_tpu_torch.ops import vision as vi

    x = torch.from_numpy((_rand((3, 96, 128, 1), 41) > 0.55)
                         .astype(np.float32))
    for conn in (4, 8):
        lab = vi.connected_components(x.to(dev), conn)
        want = vi.connected_components(x, conn)
        assert lab.is_cuda and torch.equal(lab.cpu(), want)
        seq = vi.relabel_sequential(lab)
        assert torch.equal(seq.cpu(), vi.relabel_sequential(want))
        assert torch.equal(vi.merge_small_components(seq[0], 5, conn).cpu(),
                           vi.merge_small_components(seq[0].cpu(), 5, conn))
        assert torch.equal(vi.area_threshold(x.to(dev), lab, 4).cpu(),
                           vi.area_threshold(x, want, 4))


def test_feature_on_card(dev):
    """Canny's blur is one K3 launch, and the rest of Canny replayed on the
    CPU from the card's blur is equal; Hough segments and accumulator,
    mean shift and the GLCM equal."""
    from imagemagick_tpu_torch.ops import blur as bl
    from imagemagick_tpu_torch.ops import enhance as en
    from imagemagick_tpu_torch.ops import feature as ft

    x = torch.from_numpy(_rand((2, 96, 128, 3), 42))
    xd = x.to(dev)
    before = dict(gk.LAUNCHES)
    edges = ft.canny_edge(xd, 0.0, 1.0, 0.1, 0.3)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] - before["k3"] == 1
    smooth = bl.blur(en.grayscale(xd), 0.0, 1.0)[..., 0].cpu()
    replay = ft.canny_from_smooth(smooth, 0.1, 0.3)
    assert torch.equal(edges.cpu()[..., 0] > 0, replay)
    e1 = edges[0]
    assert ft.hough_line_segments(e1, 9, 9, 20) == \
        ft.hough_line_segments(e1.cpu(), 9, 9, 20)
    assert torch.equal(ft.hough_accumulator(edges).cpu(),
                       ft.hough_accumulator(edges.cpu()))
    assert torch.equal(ft.mean_shift(xd, 5, 5, 0.1).cpu(),
                       ft.mean_shift(x, 5, 5, 0.1))
    assert torch.equal(ft.glcm_counts(xd).cpu(), ft.glcm_counts(x))
    got, want = ft.glcm_features(xd), ft.glcm_features(x)
    assert all(float(got[k]) == float(want[k]) for k in want)


def test_segment_equal_on_card(dev):
    from imagemagick_tpu_torch.ops import segment as sg

    x = torch.from_numpy(np.round(_rand((2, 96, 128, 3), 43) * 4) / 4 +
                         0.01 * _rand((2, 96, 128, 3), 44)).clamp(0, 1)
    for ct, sm in ((1.0, 1.5), (0.5, 1.0)):
        got = sg.segment(x.to(dev), cluster_threshold=ct, smooth_threshold=sm)
        assert got.is_cuda and torch.equal(
            got.cpu(), sg.segment(x, cluster_threshold=ct,
                                  smooth_threshold=sm))


def test_draw_equal_on_card(dev):
    """float64 coverage, each step its own op: equal on the card."""
    from imagemagick_tpu_torch.ops import draw as dw

    x = torch.from_numpy(_rand((96, 128, 4), 45))
    for mvg in (
            "fill red stroke navy stroke-width 3 circle 60,50 60,80",
            "fill-rule evenodd fill black polygon 16,2 90,90 2,40 120,40 "
            "40,90",
            "stroke black stroke-width 6 fill none stroke-linejoin miter "
            "stroke-dasharray 12 5 polyline 8,80 60,10 120,80",
            "push defs push gradient g linear 0,0 127,0 stop-color red 0 "
            "stop-color blue 1 pop gradient pop defs fill 'url(#g)' "
            "roundrectangle 5,5 120,90 20,15",
            "push defs push clip-path c circle 64,48 64,90 pop clip-path "
            "pop defs clip-path url(#c) fill black font-size 30 "
            "text 10,60 'Card'",
            "fill red color 3,3 floodfill"):
        got = dw.draw(x.to(dev), mvg)
        assert got.is_cuda and torch.equal(got.cpu(), dw.draw(x, mvg)), mvg


def test_cli_vision_and_draw_chains_on_card(dev):
    """-resize 50% -canny ... -hough-lines: one K1 launch for the group's
    resize and one K3 launch an image; -auto-threshold then
    -connected-components: one K4 launch; -draw, -annotate and -frame
    after a resize: one K1 launch.  Each against the CPU run, the canny
    chain by replaying its rest on the CPU from the card's resize (its
    blur there is the CPU's, an ulp from K3's: at most 0.1 % apart)."""
    x = torch.from_numpy(_rand((3, 96, 128, 3), 46))
    argv = "-resize 50% -canny 0x1+10%+30% -hough-lines 9x9+20".split()
    got, launched = _cli_chain(argv, x, dev)
    assert launched["k1"] == 1 and launched["k3"] == 3
    head, _ = _cli_chain(argv[:2], x, dev)
    replay, _ = _cli_chain(argv[2:], head.cpu(), "cpu")
    assert _selected_apart(got, replay) <= 1e-3
    argv = ["-auto-threshold", "otsu", "-define",
            "connected-components:area-threshold=6",
            "-connected-components", "8"]
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k4"] == 1
    assert torch.equal(got.cpu(), want)
    argv = ["-resize", "50%", "-fill", "red", "-stroke", "navy",
            "-strokewidth", "3", "-draw", "circle 30,20 30,40",
            "-pointsize", "20", "-annotate", "+5+25", "Card", "-frame",
            "6x6+2+2"]
    got, launched = _cli_chain(argv, x, dev)
    want, _ = _cli_chain(argv, x, "cpu")
    assert launched["k1"] == 1 and sum(launched.values()) == 1
    assert _selected_apart(got, want) <= 1e-3


# -- layer, montage and visual_effects --------------------------------------

def test_visual_effects_on_card(dev):
    """Each effect on the card against the CPU, the random ones on the
    card's variates; one K3 launch for charcoal, shadow and polaroid."""
    from imagemagick_tpu_torch.ops import visual_effects as vfx

    x = torch.from_numpy(np.round(_rand((2, 96, 128, 3), 47) * 8) / 8)
    xa = torch.cat([x, x[..., 1:2]], -1)
    xd, xad = x.to(dev), xa.to(dev)
    val = vfx.sketch_variates(xd, torch.Generator(dev).manual_seed(1))
    calls = [
        ("blue_shift", lambda v: vfx.blue_shift(v, 1.5), x),
        ("charcoal", lambda v: vfx.charcoal(v), x),
        ("colorize", lambda v: vfx.colorize(v, (1, 0.5, 0), 0.3), x),
        ("color_matrix", lambda v: vfx.color_matrix(
            v, np.eye(3) * 0.9 + 0.05), x),
        ("sepia_tone", lambda v: vfx.sepia_tone(v), x),
        ("solarize", lambda v: vfx.solarize(v, 0.4), x),
        ("stegano", lambda v: vfx.stegano(v, v.flip(0)), x),
        ("stereo", lambda v: vfx.stereo(v, v.flip(0), 5, -3), x),
        ("tint", lambda v: vfx.tint(v, (0.2, 0.9, 0.4), (80.0,)), x),
        ("vignette", lambda v: vfx.vignette(v, 0.0, 10.0), x),
        ("wavelet_denoise", lambda v: vfx.wavelet_denoise(v, 0.1), x),
        ("sketch", lambda v: vfx.sketch_from(v, val.to(v.device), 0.0, 1.0,
                                             20.0), x),
        ("shadow", lambda v: vfx.shadow(v, 80.0, 3.0), xa),
        ("polaroid", lambda v: vfx.polaroid(v, 8.0), xa)]
    for name, fn, v in calls:
        before = dict(gk.LAUNCHES)
        got = fn(v.to(dev))
        torch.cuda.synchronize()
        launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
        k3 = 1 if name in ("charcoal", "shadow", "polaroid") else 0
        assert launched["k3"] == k3 and sum(launched.values()) == k3, name
        want = fn(v)
        assert got.is_cuda and got.shape == want.shape, name
        if name in ("solarize", "stegano", "stereo"):
            assert torch.equal(got.cpu(), want), name
        else:
            assert _selected_apart(got, want) <= 1e-3, name
    gen = torch.Generator(dev).manual_seed(2)
    for kind in ("uniform", "gaussian", "impulse", "laplacian",
                 "multiplicative", "poisson", "random"):
        vs = vfx.noise_variates(xd, kind, 1.0, gen)
        got = vfx.add_noise_from(xd, kind, 1.0, vs)
        want = vfx.add_noise_from(x, kind, 1.0, [v.cpu() for v in vs])
        assert _selected_apart(got, want) <= 1e-3, kind


def test_layers_and_montage_on_card(dev):
    """Coalesce, optimize, the transparency pass, duplicates, deconstruct,
    flatten, mosaic, append and smush of frames with page offsets, alpha
    and delays, and a montage: the CPU's frames, pages and delays, pixels
    within 1e-5; no kernel launch."""
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.ops import layer as ly
    from imagemagick_tpu_torch.ops import montage as mo

    spec = ImageSpec(colorspace="srgb", alpha=True)
    base = _rand((48, 64, 4), 48)
    base[..., 3] = 1.0
    datas = [base] + [_rand((9, 13, 4), 49 + k) for k in range(5)]
    datas[3] = datas[2]
    pages = [None] + [(3 * k, 2 * k, 64, 48) for k in range(1, 6)]
    cpu = [Image(torch.from_numpy(d), spec, page=p, delay=k % 3)
           for k, (d, p) in enumerate(zip(datas, pages))]
    card = [Image(i.data.to(dev), spec, page=i.page, delay=i.delay)
            for i in cpu]
    bg = (0.2, 0.4, 0.6, 1.0)
    calls = [lambda f: ly.coalesce(f), lambda f: ly.optimize_layers(f),
             lambda f: ly.optimize_transparency(f),
             lambda f: ly.remove_duplicate_layers(ly.coalesce(f)),
             lambda f: ly.deconstruct(ly.coalesce(f)),
             lambda f: [ly.flatten(f, bg)], lambda f: [ly.mosaic(f, bg)],
             lambda f: [ly.append(f, True, bg, "center")],
             lambda f: [ly.smush(f, False, 2, bg, "south")],
             lambda f: [mo.montage(f, "3x2", "30x30+2+1")]]
    before = dict(gk.LAUNCHES)
    for fn in calls:
        got, want = fn(card), fn(cpu)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.data.is_cuda
            assert (g.page, g.delay) == (w.page, w.delay)
            assert g.data.shape == w.data.shape
            assert float((g.data.cpu() - w.data).abs().max()) <= 1e-5
    torch.cuda.synchronize()
    assert gk.LAUNCHES == before


def test_cli_layers_chains_on_card(dev):
    """-resize 50% then -charcoal and -montage, -polaroid and -flatten,
    and the options that need no file: one K1 launch for the group's
    resize, the K3 launches an image that the chain names, and the rest
    replayed on the CPU from the card's resize within 1e-5 but on at most
    0.1 % of the pixels."""
    x = torch.from_numpy(_rand((3, 96, 128, 3), 55))
    for argv, k3 in (
            ("-resize 50% -charcoal 1 -tile 2x2 -montage".split(), 3),
            ("-resize 50% -polaroid 5 -background white -flatten".split(),
             3),
            ("-resize 50% -morphology close disk:2 -level-colors navy,gold "
             "-cdl 1.1,0.05,0.9:0.8 -sepia-tone 80% -noise 1".split(), 0)):
        got, launched = _cli_chain(argv, x, dev)
        assert launched["k1"] == 1 and launched["k3"] == k3
        assert sum(launched.values()) == 1 + k3
        head, _ = _cli_chain(argv[:2], x, dev)
        replay, _ = _cli_chain(argv[2:], head.cpu(), "cpu")
        assert got.shape == replay.shape
        assert _selected_apart(got, replay) <= 1e-3


def _u8(shape, seed):
    return (_rand(shape, seed) * 255 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["png", "jpeg", "ppm", "rgb"])
def test_io_decodes_onto_the_card_as_on_the_cpu(dev, tmp_path, fmt):
    """A file decoded onto the card equals its decode on the CPU bit for
    bit (the host makes the float32 pixels, the card receives them once),
    and its encode from the card gives the CPU's bytes."""
    import io

    from PIL import Image as PImage

    from imagemagick_tpu_torch import io as tio

    arr = _u8((60, 80, 3), 60)
    if fmt == "rgb":
        path = str(tmp_path / "x.rgb")
        arr.tofile(path)

        def read(d):
            return tio.read_images(path, size="80x60", device=d)[0]
    else:
        buf = io.BytesIO()
        PImage.fromarray(arr).save(buf, {"jpeg": "JPEG", "png": "PNG",
                                         "ppm": "PPM"}[fmt])

        def read(d):
            return tio.image_from_blob(buf.getvalue(), fmt, device=d)[0]

    got, want = read(dev), read("cpu")
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
    assert tio.image_to_blob(got, fmt) == tio.image_to_blob(want, fmt)


def test_cli_files_on_card(dev, tmp_path):
    """main(..., device="cuda") from files: config #1's chain on 4 PNGs
    in one K1 launch, its samples within one level of the CPU run's on
    99.9 % of them; config #3's chain on 3 PGM pages in one K4 launch,
    0.1 % of the pixels at most apart."""
    from PIL import Image as PImage

    from imagemagick_tpu_torch.cli.main import main

    pngs, pgms = [], []
    for k in range(4):
        pngs.append(str(tmp_path / f"in{k}.png"))
        PImage.fromarray(_u8((96, 128, 3), 61 + k)).save(pngs[-1])
    for k in range(3):
        pgms.append(str(tmp_path / f"p{k}.pgm"))
        PImage.fromarray(_u8((66, 51), 70 + k), "L").save(pgms[-1])
    chain1 = "-resize 32x32! -gaussian-blur 0x2 -colorspace gray".split()
    chain3 = ("-auto-threshold otsu -morphology open square:1 -morphology "
              "close square:1 -edge 1").split()
    for files, chain, out, kernel in ((pngs, chain1, "o-%d.png", "k1"),
                                      (pgms, chain3, "q-%d.pbm", "k4")):
        before = dict(gk.LAUNCHES)
        assert main(files + chain + [str(tmp_path / ("card" + out))],
                    device=dev) == 0
        torch.cuda.synchronize()
        launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
        assert launched[kernel] == 1 and sum(launched.values()) == 1
        assert main(files + chain + [str(tmp_path / ("cpu" + out))],
                    device="cpu") == 0
        for k in range(len(files)):
            a = np.asarray(PImage.open(tmp_path / ("card" + out % k)))
            b = np.asarray(PImage.open(tmp_path / ("cpu" + out % k)))
            assert a.shape == b.shape
            assert np.mean(np.abs(a.astype(int) - b) > 1) <= 1e-3


@pytest.mark.parametrize("out", ["mask:m.png", "r.miff", "r.mpc"])
def test_region_mask_reaches_the_coders_on_card(dev, tmp_path, capsys, out):
    """-region's mask lies on the card; mask:, MIFF's header and -print
    render it as on the CPU (a host array), byte for byte."""
    from PIL import Image as PImage

    from imagemagick_tpu_torch.cli.main import main

    src = str(tmp_path / "a.png")
    PImage.fromarray(_u8((24, 32, 3), 90)).save(src)
    blobs, texts = [], []
    for name, side in (("card", dev), ("cpu", "cpu")):
        (tmp_path / name).mkdir()
        path = out.replace(":", f":{tmp_path / name}/") if ":" in out \
            else str(tmp_path / name / out)
        assert main([src, "-gravity", "center", "-region", "10x6+3+2",
                     "-negate", "-print", "%[wand:mask]", path],
                    device=side) == 0
        texts.append(capsys.readouterr().out)
        blobs.append(open(path.split(":", 1)[-1], "rb").read())
    assert blobs[0] == blobs[1] and texts[0] == texts[1]
    assert "[[0. 0." in texts[0] and "tensor" not in texts[0]


def test_serve_convert_on_card(dev):
    """POST /convert on a card server: one K1 launch a request, the
    result within one level of the same request on the CPU; /identify and
    /formats answer."""
    import io
    import json
    import threading
    from http.client import HTTPConnection
    from urllib.parse import quote

    from PIL import Image as PImage

    from imagemagick_tpu_torch import serve

    buf = io.BytesIO()
    PImage.fromarray(_u8((120, 160, 3), 80)).save(buf, "PNG")
    body = buf.getvalue()
    chain = "-resize 40x30! -gaussian-blur 0x2 -colorspace gray"
    srv = serve.make_server(port=0, device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def call(method, path, data=None):
        conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        try:
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    try:
        before = dict(gk.LAUNCHES)
        status, out = call("POST", f"/convert?args={quote(chain)}&of=png",
                           body)
        launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
        assert status == 200
        assert launched["k1"] == 1 and sum(launched.values()) == 1
        assert call("POST", "/identify", body)[0] == 200
        status, formats = call("GET", "/formats")
        assert status == 200 and "png" in json.loads(formats)["write"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    want = serve._run_cli(["-", *chain.split(), "png:-"], body, "cpu")
    a = np.asarray(PImage.open(io.BytesIO(out))).astype(int)
    b = np.asarray(PImage.open(io.BytesIO(want))).astype(int)
    assert a.shape == b.shape == (30, 40)
    assert np.mean(np.abs(a - b) > 1) <= 1e-3


DNG_DEMOSAIC_CARD_TOL = 1e-6   # cuDNN's and the CPU's sums of <= 9 taps
DNG_CARD_TOL = 2e-5            # that, times the sRGB transfer's slope
                               # (at most 12.92), and pow an ulp apart


@pytest.mark.parametrize("fmt", ["miff", "miff16", "mpc", "exr", "exr32",
                                 "ff", "dng"])
def test_new_coders_decode_onto_the_card_as_on_the_cpu(dev, tmp_path, fmt):
    """MIFF (8 and 16 bits, zip), MPC, EXR (half and float, zip),
    farbfeld and a 16-bit Bayer DNG: bytes made on the CPU decode onto the
    card equal to their decode on the CPU (the DNG's demosaic runs on the
    card: within DNG_CARD_TOL), and encode from the card to the CPU's
    bytes."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.io import exr as texr
    from imagemagick_tpu_torch.io import miff as tmiff

    src = TImage(_rand((48, 64, 3), 90), device="cpu")
    blobs = {"miff": lambda im: tmiff.encode([im], 8, "zip"),
             "miff16": lambda im: tmiff.encode([im], 16, "zip"),
             "exr": lambda im: texr.encode(im, True, "zip"),
             "exr32": lambda im: texr.encode(im, False, "zip"),
             "ff": lambda im: tio.image_to_blob(im, "ff"),
             "dng": lambda im: tio.image_to_blob(im, "dng")}
    if fmt == "mpc":
        path = str(tmp_path / "x.mpc")
        tio.write_image(src, path)

        def read(d):
            return tio.read_images(path, device=d)[0]
    else:
        blob = blobs[fmt](src)

        def read(d):
            return tio.image_from_blob(blob, device=d)[0]

    got, want = read(dev), read("cpu")
    assert got.data.is_cuda
    if fmt == "dng":
        err = float((got.data.cpu() - want.data).abs().max())
        assert err <= DNG_CARD_TOL, err
    else:
        assert torch.equal(got.data.cpu(), want.data)
    if fmt == "mpc":
        tio.write_image(got, str(tmp_path / "card.mpc"))
        assert (tmp_path / "card.mpc").read_bytes() == \
            open(path, "rb").read()
    elif fmt != "dng":
        assert blobs[fmt](got) == blobs[fmt](want)
    else:
        assert blobs[fmt](want) == blobs[fmt](TImage(want.data.to(dev)))


@pytest.mark.parametrize("fmt", ["dpx", "dcm", "g4"])
def test_formats_decode_onto_the_card_as_on_the_cpu(dev, fmt):
    """DPX (10 bits), a 16-bit DICOM and a G4 page: bytes made on the CPU
    decode onto the card equal to their decode on the CPU, and the card's
    image encodes to the CPU's bytes (a DICOM is read only: written as
    DPX)."""
    from chip_smoke import _dicom16
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage

    if fmt == "dcm":
        rng = np.random.default_rng(97)
        blob = _dicom16(rng.integers(0, 4096, (40, 56)))
    else:
        src = TImage(_rand((40, 56, 3 if fmt == "dpx" else 1), 98),
                     device="cpu")
        blob = tio.image_to_blob(src, fmt, depth=16)
    got = tio.image_from_blob(blob, fmt, device=dev)[0]
    want = tio.image_from_blob(blob, fmt, device="cpu")[0]
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
    out = "dpx" if fmt == "dcm" else fmt
    assert tio.image_to_blob(got, out, depth=16) == \
        tio.image_to_blob(want, out, depth=16)


@pytest.mark.parametrize("fmt", ["tiff", "vips", "cals"])
def test_formats4_decode_onto_the_card_as_on_the_cpu(dev, fmt):
    """A 48-bit TIFF (the native deep reader and writer), a 16-bit VIPS
    and a CALS page: bytes made on the CPU decode onto the card equal to
    their decode on the CPU, and the card's image encodes to the CPU's
    bytes."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec

    c = 1 if fmt == "cals" else 3
    src = TImage(_rand((40, 56, c), 99), TSpec(
        colorspace="gray" if c == 1 else "srgb", depth=16), device="cpu")
    blob = tio.image_to_blob(src, fmt, depth=16)
    got = tio.image_from_blob(blob, fmt, device=dev)[0]
    want = tio.image_from_blob(blob, fmt, device="cpu")[0]
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
    assert tio.image_to_blob(got, fmt, depth=16) == \
        tio.image_to_blob(want, fmt, depth=16)


@pytest.mark.parametrize("fmt", ["map", "wpg"])
def test_palette_writers_run_kmeans_on_the_card(dev, monkeypatch, fmt):
    """MAP's and WPG's 256-colour k-means takes the card's pixels on the
    card, and its labels and palette are the CPU's (its sums in float64),
    so the bytes are equal."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.ops import quantize

    seen = []
    real = quantize.kmeans

    def spy(x, *a, **kw):
        seen.append(x.device.type)
        return real(x, *a, **kw)

    monkeypatch.setattr(quantize, "kmeans", spy)
    arr = _rand((30, 41, 3), 100)
    got = tio.image_to_blob(TImage(arr, device=dev), fmt)
    want = tio.image_to_blob(TImage(arr, device="cpu"), fmt)
    assert seen == ["cuda", "cpu"] and got == want


def test_dng_demosaic_on_the_card(dev):
    from imagemagick_tpu_torch.io import dng as tdng

    cfa = _rand((135, 242), 91)
    pat = np.asarray([[0, 1], [1, 2]], np.int64)
    wb = np.asarray([1.9, 1.0, 1.4], np.float32)
    got = tdng._demosaic_bilinear(cfa, pat, wb, dev)
    want = tdng._demosaic_bilinear(cfa, pat, wb, "cpu")
    assert got.is_cuda
    err = float((got.cpu() - want).abs().max())
    assert err <= DNG_DEMOSAIC_CARD_TOL, err


@pytest.mark.parametrize("dither", ["Riemersma", "FloydSteinberg", "none"])
def test_remap_under_each_dither_on_card(dev, tmp_path, dither):
    """-remap FILE on the card: the native octree library remaps the
    card's pixels on the host and puts them back on the card; the written
    file equals the CPU run's."""
    from PIL import Image as PImage

    from imagemagick_tpu_torch.cli.main import main

    src, pal = str(tmp_path / "in.png"), str(tmp_path / "pal.png")
    PImage.fromarray(_u8((60, 80, 3), 92)).save(src)
    PImage.fromarray(np.array([[[0, 0, 0], [255, 255, 255], [200, 40, 40],
                                [30, 90, 200]]], np.uint8)).save(pal)
    setting = ["+dither"] if dither == "none" else ["-dither", dither]
    outs = []
    for d in (dev, "cpu"):
        out = str(tmp_path / f"out-{torch.device(d).type}.png")
        assert main([src, *setting, "-remap", pal, out], device=d) == 0
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1]


def test_cli_from_miff_on_card(dev, tmp_path):
    """main(..., device="cuda") from MIFF files: a resize chain to EXR in
    one K1 launch (within one level of the CPU run at 16 bits on 99.9 % of
    the samples, read back as float), and -auto-threshold otsu on 16-bit
    MIFF pages in one K4 launch (0.1 % of the pixels at most apart)."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.cli.main import main
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec

    frames, pages = [], []
    for k in range(3):
        frames.append(str(tmp_path / f"f{k}.miff"))
        with open(frames[-1], "wb") as f:
            f.write(tio.image_to_blob(TImage(_rand((96, 128, 3), 93 + k),
                                             device="cpu"), "miff"))
        pages.append(str(tmp_path / f"p{k}.miff"))
        page = TImage(_rand((66, 51, 1), 96 + k),
                      TSpec(colorspace="gray", depth=16), device="cpu")
        with open(pages[-1], "wb") as f:
            f.write(tio.image_to_blob(page, "miff"))
    chain1 = "-resize 50% -gaussian-blur 0x2 -colorspace gray".split()
    chain3 = "-auto-threshold otsu".split()
    for files, chain, out, kernel in ((frames, chain1, "o-%d.exr", "k1"),
                                      (pages, chain3, "q-%d.pbm", "k4")):
        before = dict(gk.LAUNCHES)
        assert main(files + chain + [str(tmp_path / ("card" + out))],
                    device=dev) == 0
        torch.cuda.synchronize()
        launched = {k: gk.LAUNCHES[k] - before[k] for k in before}
        assert launched[kernel] == 1 and sum(launched.values()) == 1
        assert main(files + chain + [str(tmp_path / ("cpu" + out))],
                    device="cpu") == 0
        for k in range(len(files)):
            a, b = (tio.read_images(str(tmp_path / (side + out % k)),
                                    device="cpu")[0].data.numpy()
                    for side in ("card", "cpu"))
            assert a.shape == b.shape
            assert np.mean(np.abs(a - b) > 1 / 255) <= 1e-3


def test_outofcore_chain_and_metafile_and_hdr_decodes_on_card(dev):
    """run_chain with a blur, a Lanczos resize and an unsharp on the card:
    within 2e-5 of the same run on the CPU (K3's sums and the products'
    float32 dot products in another order), one K3 launch a band for each
    blur; an EMF and an HDR decode onto the card equal to their decode on
    the CPU (the EMF's coverage is float64, its canvas made and drawn on
    the card)."""
    import struct

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.models import outofcore as toc

    img = _rand((300, 96, 3), 101)
    ops = [("blur", {"sigma": 2.0}), ("level", {"black": 0.05,
                                               "white": 0.95})]
    kw = dict(resize=(150, 48, "lanczos"), post_ops=[("unsharp",
                                                       {"sigma": 1.0})],
              band_rows=64)
    before = gk.LAUNCHES["k3"]
    got = toc.run_chain(img, img.shape, ops, device=dev, **kw)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] - before == 2 * 3      # 3 output bands
    want = toc.run_chain(img, img.shape, ops, device="cpu", **kw)
    assert got.shape == want.shape == (150, 48, 3)
    assert float(np.abs(got - want).max()) <= 2e-5

    def emr(rtype, payload=b""):
        return struct.pack("<II", rtype, 8 + len(payload)) + payload
    body = (emr(39, struct.pack("<IIII", 1, 0, 0x0000FF, 0)) +
            emr(37, struct.pack("<I", 1)) +
            emr(43, struct.pack("<4i", 10, 10, 50, 30)) +
            emr(42, struct.pack("<4i", 20, 5, 60, 35)) +
            emr(14, struct.pack("<3I", 0, 16, 20)))
    head = struct.pack("<4i4iIIIHHIII2i2i", 0, 0, 63, 39, 0, 0, 1693, 1058,
                       0x464D4520, 0x10000, 88 + len(body), 7, 16, 0, 0, 0,
                       1024, 768, 270, 203)
    emf = struct.pack("<II", 1, 8 + len(head)) + head + body
    hdr = tio.image_to_blob(TImage(_rand((20, 33, 3), 102) * 8.0,
                                   device="cpu"), "hdr")
    for blob in (emf, hdr):
        card = tio.image_from_blob(blob, device=dev)[0]
        host = tio.image_from_blob(blob, device="cpu")[0]
        assert card.data.is_cuda and torch.equal(card.data.cpu(), host.data)
        assert tio.image_to_blob(card, "hdr") == tio.image_to_blob(host,
                                                                   "hdr")


# -- the palette walks (csrc/palette_walk.cu) ---------------------------------

@pytest.mark.parametrize("k", [2, 16, 256])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_palette_walks_match_plain(dev, c, k):
    """Both walks equal their plain versions bit for bit (the plain
    version runs on the CPU copy: the same float32 operations), on an odd
    width and inputs outside [0, 1]; one launch each."""
    from imagemagick_tpu_torch.ops import quantize as tq

    rng = np.random.default_rng(c * 1000 + k)
    x = torch.from_numpy((rng.random((2, 24, 31, c)) * 1.6 - 0.3)
                         .astype(np.float32))
    pal = torch.from_numpy(rng.random((k, c)).astype(np.float32))
    for fn, key in ((tq.floyd_steinberg, "walk_fs"),
                    (tq.riemersma, "walk_riemersma")):
        before = gk.LAUNCHES[key]
        got = fn(x.to(dev), pal.to(dev))
        torch.cuda.synchronize()
        assert gk.LAUNCHES[key] == before + 1
        assert torch.equal(got.cpu(), fn(x, pal))


def test_floyd_steinberg_rows_in_device_memory_match_plain(dev):
    """Rows too long for shared memory beside the palette: the kernel
    keeps its error rows in device memory, with the same bits."""
    from imagemagick_tpu_torch.ops import quantize as tq

    assert not tq.walk_fs_rows_in_shared(7500, 4, 256)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((1, 3, 7500, 4)) * 1.2 - 0.1)
                         .astype(np.float32))
    pal = torch.from_numpy(rng.random((256, 4)).astype(np.float32))
    got = tq.floyd_steinberg(x.to(dev), pal.to(dev))
    assert torch.equal(got.cpu(), tq.floyd_steinberg(x, pal))


def test_remap_with_dither_on_card(dev):
    """remap(..., dither=True) is one Floyd-Steinberg launch over a batch;
    the walk is causal in rows, so its first rows equal the plain walk of
    the input's first rows, and every pixel is a palette entry."""
    from imagemagick_tpu_torch.ops import quantize as tq

    x = torch.rand(3, 40, 257, 3, generator=torch.Generator().manual_seed(1))
    pal = torch.rand(16, 3, generator=torch.Generator().manual_seed(2))
    before = gk.LAUNCHES["walk_fs"]
    got = tq.remap(x.to(dev), pal.to(dev), dither=True)
    assert gk.LAUNCHES["walk_fs"] == before + 1
    assert torch.equal(got[:, :4].cpu(), tq.floyd_steinberg(x[:, :4], pal))
    hit = (got.reshape(-1, 1, 3) == pal.to(dev)[None]).all(-1).any(-1)
    assert bool(hit.all())


def test_palette_walks_refuse_what_they_do_not_take(dev):
    from imagemagick_tpu_torch.ops import quantize as tq

    with pytest.raises(ValueError):
        tq.floyd_steinberg(torch.zeros(1, 4, 4, 9, device=dev),
                           torch.zeros(2, 9, device=dev))
    with pytest.raises(ValueError):
        tq.riemersma(torch.zeros(1, 4, 4, 3, device=dev),
                     torch.zeros(20000, 3, device=dev))


def _wand_frame(h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 23.0)[..., None] * np.cos(
        xx[..., None] / 31.0 + np.arange(c))
    return np.clip(base + 0.03 * rng.standard_normal((h, w, c)), 0, 1
                   ).astype(np.float32)


def test_wand_chain_launches_k1_twice_and_matches_the_cpu_wand(dev):
    from imagemagick_tpu_torch.core.image import Image
    from imagemagick_tpu_torch.core.spec import ImageSpec
    from imagemagick_tpu_torch.wand import api as wa

    x = _wand_frame(216, 384, 3, 1)
    card, cpu = wa.new_magick_wand(device=dev), wa.new_magick_wand("cpu")
    card.add_image(Image(x, device=dev))
    cpu.add_image(Image(x, device="cpu"))
    before = dict(gk.LAUNCHES)
    card.resize_image(192, 108)
    card.gaussian_blur_image(0.0, 2.0)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k1"] - before["k1"] == 2
    assert card.current.data.is_cuda
    cpu.resize_image(192, 108)
    cpu.gaussian_blur_image(0.0, 2.0)
    np.testing.assert_allclose(card.current.data.cpu().numpy(),
                               cpu.current.data.numpy(), atol=2e-5)
    # a non-opaque alpha declines the fused offer: K3 blurs it
    xa = _wand_frame(120, 160, 4, 2)
    xa[..., 3] = 0.25 + 0.5 * xa[..., 3]
    card, cpu = wa.MagickWand(dev), wa.MagickWand("cpu")
    card.add_image(Image(xa, ImageSpec(alpha=True), device=dev))
    cpu.add_image(Image(xa, ImageSpec(alpha=True), device="cpu"))
    before = dict(gk.LAUNCHES)
    card.blur_image(0.0, 1.5)
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] > before["k3"] and \
        gk.LAUNCHES["k1"] == before["k1"]
    cpu.blur_image(0.0, 1.5)
    np.testing.assert_allclose(card.current.data.cpu().numpy(),
                               cpu.current.data.numpy(), atol=1e-5)
    # Otsu through K4
    page = _wand_frame(264, 204, 1, 3)
    card, cpu = wa.MagickWand(dev), wa.MagickWand("cpu")
    card.add_image(Image(page, device=dev))
    cpu.add_image(Image(page, device="cpu"))
    before = gk.LAUNCHES["k4"]
    card.auto_threshold_image("otsu")
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k4"] == before + 1
    cpu.auto_threshold_image("otsu")
    assert torch.equal(card.current.data.cpu(), cpu.current.data)


def test_wand_clone_write_and_views_on_card(dev, tmp_path):
    import imagemagick_tpu_torch as imt
    from imagemagick_tpu_torch.wand import api as wa

    w = wa.new_magick_wand(device=dev)
    w.read_image("rose:")
    assert w.current.data.is_cuda
    keep = w.current.data.clone()
    c = w.clone()
    c.set_image_pixel_color(3, 4, "red")
    wa.WandView(c, 0, 0, 8, 8).update(lambda r: r * 0.5)
    it = wa.PixelIterator(c, 0, 10, 5, 2)
    for row in it:
        for p in row:
            p.blue = 1.0
        it.sync_iterator()
    assert torch.equal(w.current.data, keep)
    assert c.current.data.is_cuda
    assert c.get_image_pixel_color(3, 4).get_color()[:3] == (0.5, 0.0, 0.0)
    imt.write(c.current, str(tmp_path / "c.ppm"))
    back = imt.read(str(tmp_path / "c.ppm"), device=dev)
    assert back.data.is_cuda
    ref = imt.read(str(tmp_path / "c.ppm"), device="cpu")
    assert torch.equal(back.data.cpu(), ref.data)


# A Magick++ program: a PPM resized and blurred (K1 twice), its launches
# counted in its own embedded interpreter, its pixels dumped as float32
MAGICKPP_PROGRAM = r"""
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <Magick++.h>

#include <cstdio>
#include <string>

using namespace Magick;

static std::string py(const char* code) {
  PyGILState_STATE g = PyGILState_Ensure();
  PyObject* d = PyModule_GetDict(PyImport_AddModule("__main__"));
  PyObject* r = PyRun_String(code, Py_eval_input, d, d);
  std::string out = "error";
  if (r) {
    PyObject* s = PyObject_Str(r);
    out = PyUnicode_AsUTF8(s);
    Py_DECREF(s);
    Py_DECREF(r);
  } else {
    PyErr_Print();
  }
  PyGILState_Release(g);
  return out;
}

int main(int argc, char** argv) {
  try {
    InitializeMagick(argv[0]);
    py("__import__('imagemagick_tpu_torch.ops.gpu_kernels').ops"
       ".gpu_kernels.LAUNCHES.update(k1=0)");
    Image img(argv[1]);
    img.resize(Geometry(240, 135));
    img.gaussianBlur(0.0, 2.0);
    printf("k1=%s\n", py("(__import__('torch').cuda.synchronize() if "
                         "__import__('torch').cuda.is_available() else 0,"
                         " __import__('imagemagick_tpu_torch.ops.gpu_kernels')"
                         ".ops.gpu_kernels.LAUNCHES['k1'])[1]").c_str());
    const float* p = img.getConstPixels(0, 0, img.columns(), img.rows());
    FILE* f = fopen(argv[2], "wb");
    fwrite(p, sizeof(float), img.columns() * img.rows() * 4, f);
    fclose(f);
    return 0;
  } catch (const Exception& e) {
    fprintf(stderr, "MagickException: %s\n", e.what());
    return 1;
  }
}
"""


def _ppm(path, h, w, seed):
    frame = (_wand_frame(h, w, 3, seed) * 255 + 0.5).astype(np.uint8)
    path.write_bytes(f"P6\n{w} {h}\n255\n".encode() + frame.tobytes())


def test_magickpp_chain_on_card_matches_the_cpu_build(dev, tmp_path):
    """The same Magick++ program built for the card and for the CPU
    (``-DMAGICKPP_DEVICE="cpu"``): on the card its resize and Gaussian
    blur are one K1 launch each, counted in its embedded interpreter, and
    its pixels lie within K1's 2e-5 of the CPU build's."""
    import os
    import subprocess
    from pathlib import Path

    from imagemagick_tpu_torch.native.magickpp import build

    root = Path(__file__).resolve().parent.parent
    src = tmp_path / "chain.cpp"
    src.write_text(MAGICKPP_PROGRAM)
    _ppm(tmp_path / "in.ppm", 270, 480, 5)
    env = dict(os.environ, PYTHONPATH=str(root))
    out = {}
    for key, device in (("card", None), ("cpu", "cpu")):
        exe = build.compile_program(str(src), str(tmp_path / key), device)
        r = subprocess.run([exe, str(tmp_path / "in.ppm"),
                            str(tmp_path / f"{key}.f32")], capture_output=True,
                           text=True, timeout=300, env=env, cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr
        out[key] = (r.stdout, np.fromfile(tmp_path / f"{key}.f32",
                                          np.float32).reshape(135, 240, 4))
    assert "k1=2" in out["card"][0] and "k1=0" in out["cpu"][0]
    np.testing.assert_allclose(out["card"][1], out["cpu"][1], atol=2e-5)


def test_rpc_server_session_on_card(dev, tmp_path):
    """The PerlMagick server on the card: Read, Resize and Blur (one K1
    launch each), a pixel within K1's 2e-5 of the same session on the
    CPU, the written 16-bit samples within one level."""
    import io
    import json

    import imagemagick_tpu_torch as imt
    from imagemagick_tpu_torch.wand import rpc_server

    _ppm(tmp_path / "in.ppm", 270, 480, 6)
    replies = {}
    for where in (dev, "cpu"):
        key = torch.device(where).type
        reqs = [{"id": 1, "op": "new"},
                {"id": 2, "op": "pm", "wand": 1, "method": "Read",
                 "kwargs": {"filename": str(tmp_path / "in.ppm")}},
                {"id": 3, "op": "pm", "wand": 1, "method": "Resize",
                 "kwargs": {"geometry": "240x135"}},
                {"id": 4, "op": "pm", "wand": 1, "method": "Blur",
                 "kwargs": {"radius": 0, "sigma": 2}},
                {"id": 5, "op": "get", "wand": 1,
                 "attrs": ["width", "height", "pixel[100,60]"]},
                {"id": 6, "op": "pm", "wand": 1, "method": "Write",
                 "kwargs": {"filename": str(tmp_path / f"{key}.ppm")}},
                {"id": 7, "op": "quit"}]
        out = io.StringIO()
        before = gk.LAUNCHES["k1"]
        rpc_server.serve(io.StringIO("".join(json.dumps(q) + "\n"
                                             for q in reqs)), out,
                         device=where)
        torch.cuda.synchronize()
        replies[key] = [json.loads(ln) for ln in out.getvalue().splitlines()]
        assert all("error" not in r for r in replies[key])
        assert gk.LAUNCHES["k1"] - before == (2 if key == "cuda" else 0)
    (wc, hc, pc), (wh, hh, ph) = (replies[k][4]["result"]
                                  for k in ("cuda", "cpu"))
    assert (wc, hc) == (wh, hh) == (240, 135)
    np.testing.assert_allclose(pc, ph, atol=2e-5)
    a, b = (np.asarray(imt.read(str(tmp_path / f"{k}.ppm"),
                                device="cpu").to_uint16()).astype(np.int64)
            for k in ("cuda", "cpu"))
    assert int(np.abs(a - b).max()) <= 1


def test_sharded_ops_on_card_match_the_unsharded_ops(dev):
    from imagemagick_tpu_torch.models import gigapixel as gp
    from imagemagick_tpu_torch.ops import blur as bl
    from imagemagick_tpu_torch.ops import resize as rz
    from imagemagick_tpu_torch.ops import threshold as th
    from imagemagick_tpu_torch.ops.enhance import grayscale
    from imagemagick_tpu_torch.parallel import mesh as pm
    from imagemagick_tpu_torch.parallel import spatial as sp

    mesh = pm.make_mesh(2, 2, 2, devices=[dev] * 8)
    x = torch.from_numpy(_rand((4, 96, 128, 3), 28)).to(dev)
    xs = pm.device_put(x, pm.batch_sharding(mesh))
    before = dict(gk.LAUNCHES)
    blur = sp.sharded_gaussian_blur(mesh, 2.0)(xs).gather()
    hist = sp.sharded_histogram(mesh, 256)(xs)
    otsu = sp.sharded_otsu_threshold(mesh)(grayscale(x)).gather()
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k3"] - before["k3"] == 8
    assert gk.LAUNCHES["k4"] - before["k4"] == 16
    taps = bl.gaussian_kernel_1d(0.0, 2.0)
    assert float((blur - gk._separable_blur_plain(x, taps)).abs().max()) \
        <= 1e-5
    assert torch.equal(hist.to(torch.int64), gk.histogram256_plain(
        x.reshape(-1, 128 * 3)).to(torch.int64).sum(0))
    assert torch.equal(otsu, th.auto_threshold(grayscale(x), "otsu"))
    mean, std, mn, mx = sp.sharded_statistics(mesh)(xs)
    x64 = x.double()
    assert float((mean.double() - x64.mean((0, 1, 2))).abs().max()) <= 1e-5
    assert float((std.double() - x64.std((0, 1, 2), unbiased=False))
                 .abs().max()) <= 1e-4
    assert torch.equal(mn, x.amin((0, 1, 2)))
    assert torch.equal(mx, x.amax((0, 1, 2)))
    rsz = sp.sharded_resize(mesh, (96, 128), (48, 64), "lanczos")(xs)
    assert float((rsz.gather() - rz.resize(x, 48, 64, "lanczos"))
                 .abs().max()) <= 1e-5
    img = torch.from_numpy(_rand((256, 384, 3), 29)).to(dev)
    out, stats = gp.process_gigapixel(
        img, mesh=pm.make_mesh(1, 2, 2, devices=[dev] * 4), sigma=2.0)
    b = gk._separable_blur_plain(img[None], taps)
    want = (img[None] + (img[None] - b)).clamp(0.0, 1.0)
    assert float((out.gather() - want).abs().max()) <= 1e-5
    assert abs(float(stats["mean"][0]) - float(want[..., 0].double()
                                                .mean())) <= 1e-5


@pytest.mark.parametrize("method,spec,iterations", [
    ("dilate", "Corners", 1), ("dilate", "Ring:2,3", 1),
    ("edge", "square:1", 2), ("convolve", "Gaussian:1x1", 1)])
def test_sharded_morphology_on_card_equals_morphology(dev, method, spec,
                                                      iterations):
    from imagemagick_tpu_torch.ops import morphology as mo
    from imagemagick_tpu_torch.parallel import mesh as pm
    from imagemagick_tpu_torch.parallel import spatial as sp

    mesh = pm.make_mesh(2, 2, 2, devices=[dev] * 8)
    x = torch.from_numpy(_rand((4, 32, 48, 3), 31)).to(dev)
    got = sp.sharded_morphology(mesh, method, spec, iterations)(x).gather()
    assert torch.equal(got, mo.morphology(x, method, spec,
                                          iterations=iterations))


def test_fused_kernel_on_each_dp_block(dev):
    from imagemagick_tpu_torch.parallel import mesh as pm
    from imagemagick_tpu_torch.parallel import spatial as sp

    mesh = pm.make_mesh(4, 1, 1, devices=[dev] * 4)
    x = torch.from_numpy(_rand((8, 64, 128, 3), 17)).to(dev)

    def local(block):
        return fp.fused_resize_pipeline(block, 32, 32, "lanczos", 1.0)

    before = gk.LAUNCHES["k1"]
    out = sp.halo_map(local, mesh, 0, 0)(x).gather()
    torch.cuda.synchronize()
    assert gk.LAUNCHES["k1"] - before == 4
    assert float((out - local(x)).abs().max()) <= 1e-6


def test_cli_tpu_mesh_on_card_writes_the_unsharded_bytes(dev, tmp_path):
    from PIL import Image as PImage

    from imagemagick_tpu_torch.cli.main import main as cli_main

    src = tmp_path / "in.png"
    PImage.fromarray((_rand((96, 128, 3), 30) * 255).astype(np.uint8)
                     ).save(src)
    chain = ["-gaussian-blur", "0x2", "-auto-threshold", "otsu"]
    assert cli_main([str(src)] + chain + [str(tmp_path / "a.png")],
                    device=dev) == 0
    before = dispatch.COUNTS["sharded"]
    assert cli_main([str(src), "-define", "tpu:mesh=1x1", "-define",
                     "tpu:shard-threshold=1024"] + chain +
                    [str(tmp_path / "b.png")], device=dev) == 0
    assert dispatch.COUNTS["sharded"] == before + 1
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()
