"""Port parity: ``parallel/`` (mesh, halo exchange, sharded ops),
``models/gigapixel.py``, the dry run and the CLI's ``-define tpu:mesh``.

The JAX functions run on their 8-virtual-device CPU mesh (conftest); the
port's on ``make_mesh(2, 2, 2, devices=[cpu] * 8)``, one device named
eight times, so that every exchange and reduction runs.  Inputs are made
from a seed with numpy at the JAX tests' sizes.  Tolerances: the blur,
the gigapixel pipeline and the resize within 1e-5 of JAX (float sums in
another order); morphology, median, min/max statistics and histogram
counts exact; the windowed mean within 1e-6; the global statistics
within JAX's own bounds (mean 1e-5, std 1e-4, min/max exact).  Otsu
equals the port's ``auto_threshold`` and is held to JAX's at its own
bound of 1e-3 of the pixels (JAX's float32 cumsums against the port's
exact counts, ROADMAP.md Queue 3).  Each sharded op is also held to the
port's unsharded op, exactly where the local steps are the same
arithmetic.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from imagemagick_tpu_torch.models import gigapixel as tgp
from imagemagick_tpu_torch.ops import blur as tbl
from imagemagick_tpu_torch.ops import dispatch as tdsp
from imagemagick_tpu_torch.ops import morphology as tmo
from imagemagick_tpu_torch.ops import resize as trz
from imagemagick_tpu_torch.ops import statistic as tstx
from imagemagick_tpu_torch.ops import threshold as tth
from imagemagick_tpu_torch.parallel import mesh as tpm
from imagemagick_tpu_torch.parallel import spatial as tsp

jpm = importlib.import_module("imagemagick_tpu.parallel.mesh")
jsp = importlib.import_module("imagemagick_tpu.parallel.spatial")
jgp = importlib.import_module("imagemagick_tpu.models.gigapixel")

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def meshes():
    return jpm.make_mesh(dp=2, sy=2, sx=2), tpm.make_mesh(2, 2, 2,
                                                          devices=CPU8)


@pytest.fixture
def batch():
    return np.random.default_rng(42).uniform(
        0, 1, (4, 32, 48, 3)).astype(np.float32)


def _jax_run(fn, mesh, x):
    xs = jax.device_put(jnp.asarray(x),
                        JNamedSharding(mesh, JP("dp", "sy", "sx", None)))
    return jax.jit(fn)(xs)


def _port(out):
    return (out.gather() if isinstance(out, tpm.ShardedArray)
            else out).numpy()


def _max(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) -
                               np.asarray(b, np.float64))))


def test_sharded_blur_matches_jax(meshes, batch):
    jm_, tm_ = meshes
    want = np.asarray(_jax_run(jsp.sharded_gaussian_blur(jm_, 1.5), jm_,
                               batch))
    got = tsp.sharded_gaussian_blur(tm_, 1.5)(torch.from_numpy(batch))
    assert isinstance(got, tpm.ShardedArray) and got.shape == batch.shape
    assert _max(_port(got), want) <= 1e-5
    k = tbl.gaussian_kernel_1d(0.0, 1.5)
    assert np.array_equal(_port(got), tbl._separable_conv(
        torch.from_numpy(batch), k, "edge").numpy())


@pytest.mark.parametrize("sigma,to_gray", [(1.5, False), (1.0, True)])
def test_gigapixel_matches_jax(meshes, sigma, to_gray):
    jm_, tm_ = meshes
    img = np.random.default_rng(42).uniform(
        0, 1, (2, 32, 64, 3)).astype(np.float32)
    jout, jstats = jgp.process_gigapixel(img, mesh=jm_, sigma=sigma,
                                         to_gray=to_gray)
    tout, tstats = tgp.process_gigapixel(img, mesh=tm_, sigma=sigma,
                                         to_gray=to_gray)
    assert tout.shape == jout.shape == (2, 32, 64, 1 if to_gray else 3)
    assert _max(_port(tout), np.asarray(jout)) <= 1e-5
    assert _max(tstats["mean"], jstats["mean"]) <= 1e-5
    assert _max(tstats["std"], jstats["std"]) <= 1e-4
    assert _max(tstats["min"], jstats["min"]) <= 1e-5
    assert _max(tstats["max"], jstats["max"]) <= 1e-5
    if not to_gray:
        x = torch.from_numpy(img)
        b = tbl._separable_conv(x, tbl.gaussian_kernel_1d(0.0, sigma),
                                "edge")
        assert np.array_equal(_port(tout), (x + (x - b)).clamp(0, 1).numpy())


def _resize_case(name):
    rng = np.random.default_rng({"arbitrary": 11, "odd-up": 12}.get(name, 42))
    if name == "halve":
        return rng.uniform(0, 1, (4, 32, 48, 3)), (16, 24), "lanczos", False
    if name == "double":
        return rng.uniform(0, 1, (4, 32, 48, 3)), (64, 96), "mitchell", False
    if name == "arbitrary":
        return rng.uniform(0, 1, (2, 45, 67, 3)), (31, 23), "lanczos", False
    if name == "odd-up":
        return rng.uniform(0, 1, (2, 33, 49, 3)), (77, 101), "mitchell", False
    return rng.uniform(0, 1, (4, 32, 48, 4)), (16, 24), "lanczos", True


@pytest.mark.parametrize("name", ["halve", "double", "arbitrary", "odd-up",
                                  "alpha"])
def test_sharded_resize_matches_jax(meshes, name):
    jm_, tm_ = meshes
    x, out_hw, filt, alpha = _resize_case(name)
    x = x.astype(np.float32)
    in_hw = x.shape[1:3]
    jfn = jax.jit(jsp.sharded_resize(jm_, in_hw, out_hw, filt, alpha))
    want = np.asarray(jfn(x))
    got = _port(tsp.sharded_resize(tm_, in_hw, out_hw, filt, alpha)(
        torch.from_numpy(x)))
    assert got.shape == want.shape == (x.shape[0],) + out_hw + x.shape[3:]
    assert _max(got, want) <= 1e-5
    ref = trz.resize(torch.from_numpy(x), *out_hw, filt, has_alpha=alpha)
    assert _max(got, ref.numpy()) <= 1e-5


@pytest.mark.parametrize("spec", ["square:1", "diamond:1"])
@pytest.mark.parametrize("method", ["erode", "dilate", "open", "close",
                                    "edge", "tophat"])
def test_sharded_morphology_matches_jax(meshes, batch, method, spec):
    jm_, tm_ = meshes
    want = np.asarray(_jax_run(jsp.sharded_morphology(jm_, method, spec),
                               jm_, batch))
    got = _port(tsp.sharded_morphology(tm_, method, spec)(
        torch.from_numpy(batch)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tmo.morphology(torch.from_numpy(batch),
                                              method, spec).numpy())


def test_sharded_median_matches_jax(meshes, batch):
    jm_, tm_ = meshes
    want = np.asarray(_jax_run(jsp.sharded_median(jm_, radius=1), jm_, batch))
    got = _port(tsp.sharded_median(tm_, radius=1)(torch.from_numpy(batch)))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tstx.median_filter(torch.from_numpy(batch),
                                                  1).numpy())


@pytest.mark.parametrize("wh", [(3, 3), (5, 3)], ids=["3x3", "5x3"])
@pytest.mark.parametrize("stat", ["min", "max", "mean"])
def test_sharded_statistic_matches_jax(meshes, batch, stat, wh):
    jm_, tm_ = meshes
    w, h = wh
    want = np.asarray(_jax_run(jsp.sharded_statistic(jm_, stat, w, h), jm_,
                               batch))
    got = _port(tsp.sharded_statistic(tm_, stat, w, h)(
        torch.from_numpy(batch)))
    tol = 1e-6 if stat == "mean" else 0.0
    assert _max(got, want) <= tol
    assert np.array_equal(got, tstx.statistic(torch.from_numpy(batch), stat,
                                              w, h).numpy())


@pytest.mark.parametrize("bins", [64, 256])
def test_sharded_histogram_matches_jax(meshes, batch, bins):
    jm_, tm_ = meshes
    want = np.asarray(_jax_run(jsp.sharded_histogram(jm_, bins), jm_, batch))
    got = tsp.sharded_histogram(tm_, bins)(torch.from_numpy(batch))
    assert got.dtype == torch.float32 and got.shape == (bins,)
    assert np.array_equal(got.numpy(), want)
    idx = np.clip((batch * np.float32(bins - 1) + np.float32(0.5))
                  .astype(np.int32), 0, bins - 1)
    assert np.array_equal(got.numpy().astype(np.int64),
                          np.bincount(idx.ravel(), minlength=bins))


def test_sharded_statistics_matches_jax(meshes, batch):
    jm_, tm_ = meshes
    jmean, jstd, jmn, jmx = _jax_run(jsp.sharded_statistics(jm_), jm_, batch)
    mean, std, mn, mx = tsp.sharded_statistics(tm_)(torch.from_numpy(batch))
    assert all(t.dtype == torch.float32 and t.shape == (3,)
               for t in (mean, std, mn, mx))
    assert _max(mean.numpy(), jmean) <= 1e-5
    assert _max(std.numpy(), jstd) <= 1e-4
    assert np.array_equal(mn.numpy(), np.asarray(jmn))
    assert np.array_equal(mx.numpy(), np.asarray(jmx))
    a = batch.astype(np.float64)
    assert _max(mean.numpy(), np.float32(a.mean(axis=(0, 1, 2)))) == 0.0
    assert _max(std.numpy(), np.float32(a.std(axis=(0, 1, 2)))) <= 1e-7


def test_sharded_otsu_matches_auto_threshold(meshes, batch):
    jm_, tm_ = meshes
    want = np.asarray(_jax_run(jsp.sharded_otsu_threshold(jm_), jm_, batch))
    got = _port(tsp.sharded_otsu_threshold(tm_)(torch.from_numpy(batch)))
    ref = tth.auto_threshold(torch.from_numpy(batch), "otsu").numpy()
    assert got.shape == want.shape == ref.shape == (4, 32, 48, 1)
    assert np.array_equal(got, ref)
    assert np.mean(got != want) < 1e-3


def test_halo_wider_than_a_shard_raises_the_jax_error():
    x = np.random.default_rng(3).uniform(0, 1, (1, 16, 8, 3)).astype(
        np.float32)
    jm_ = jpm.make_mesh(1, 8, 1)
    with pytest.raises(ValueError) as jerr:
        jax.jit(jsp.sharded_gaussian_blur(jm_, 1.5))(
            jax.device_put(jnp.asarray(x), JNamedSharding(
                jm_, JP("dp", "sy", "sx", None))))
    tm_ = tpm.make_mesh(1, 8, 1, devices=CPU8)
    with pytest.raises(ValueError) as terr:
        tsp.sharded_gaussian_blur(tm_, 1.5)(torch.from_numpy(x))
    assert str(terr.value) == str(jerr.value)
    assert "exceeds the per-device shard extent 2 along 'sy'" in \
        str(terr.value)


def test_axis_of_size_one_edge_pads(batch):
    """sy = 1: each block is edge-padded along H, as the JAX n == 1
    branch pads it; sx = 4 exchanges along W."""
    jm_ = jpm.make_mesh(2, 1, 4)
    tm_ = tpm.make_mesh(2, 1, 4, devices=CPU8)
    want = np.asarray(_jax_run(jsp.sharded_gaussian_blur(jm_, 1.5), jm_,
                               batch))
    got = _port(tsp.sharded_gaussian_blur(tm_, 1.5)(torch.from_numpy(batch)))
    assert _max(got, want) <= 1e-5
    blocks = tpm.device_put(torch.from_numpy(batch),
                            tpm.batch_sharding(tm_)).blocks
    halo = tsp._exchange_halo_1d(blocks, "sy", 1, 3)
    b = blocks[0, 0, 1]
    assert torch.equal(halo[0, 0, 1], torch.cat(
        [b[:, :1].expand(-1, 3, -1, -1), b, b[:, -1:].expand(-1, 3, -1, -1)],
        1))
    halo = tsp._exchange_halo_1d(blocks, "sx", 2, 2)
    assert torch.equal(halo[1, 0, 1][:, :, :2], blocks[1, 0, 0][:, :, -2:])
    assert torch.equal(halo[1, 0, 1][:, :, -2:], blocks[1, 0, 2][:, :, :2])


@pytest.mark.parametrize("args", [("open", "square:1", -1),
                                  ("thinning", "square:1", 1)],
                         ids=["iterations-1", "unknown-method"])
def test_morphology_errors_match_jax(meshes, args):
    jm_, tm_ = meshes
    with pytest.raises(ValueError) as jerr:
        jsp.sharded_morphology(jm_, *args)
    with pytest.raises(ValueError) as terr:
        tsp.sharded_morphology(tm_, *args)
    assert str(terr.value) == str(jerr.value)


def test_mesh_of_more_devices_than_given_raises():
    with pytest.raises(ValueError) as jerr:
        jpm.make_mesh(2, 2, 4)
    with pytest.raises(ValueError) as terr:
        tpm.make_mesh(2, 2, 4, devices=[torch.device("cpu")] * 8)
    assert str(terr.value) == str(jerr.value) == \
        "mesh 2x2x4 needs 16 devices, have 8"
    with pytest.raises(ValueError, match="mesh 2x2x2 needs 8 devices, "
                                         "have 4"):
        tpm.make_mesh(2, 2, 2, devices=[torch.device("cpu")] * 4)


def test_no_card_raises_rather_than_running_on_the_cpu():
    """Without a card the entry points raise the JAX error text: the
    default devices are the cards, and a mesh never falls back."""
    assert not torch.cuda.is_available()
    assert tpm.local_devices("cuda") == []
    assert tpm.local_devices("cpu") == [torch.device("cpu")]
    msg = "mesh 1x1x1 needs 1 devices, have 0"
    for call in (tpm.make_mesh, tpm.auto_mesh, lambda: tgp.process_gigapixel(
            np.zeros((8, 8, 3), np.float32))):
        with pytest.raises(ValueError, match=msg):
            call()


def test_device_put_gather_and_sum(meshes, batch):
    _, tm_ = meshes
    x = torch.from_numpy(batch)
    xs = tpm.device_put(x, tpm.batch_sharding(tm_))
    assert xs.blocks.shape == (2, 2, 2)
    assert xs.blocks[1, 0, 1].shape == (2, 16, 24, 3)
    assert torch.equal(xs.blocks[1, 0, 1], x[2:, :16, 24:])
    assert torch.equal(xs.gather(), x)
    assert float(xs.sum()) == pytest.approx(float(batch.astype(
        np.float64).sum()), rel=1e-7)
    img = torch.from_numpy(batch[0])
    sp_ = tpm.device_put(img, tpm.spatial_sharding(tm_))
    assert torch.equal(sp_.gather(), img)
    assert torch.equal(sp_.blocks[0, 1, 0], sp_.blocks[1, 1, 0])
    with pytest.raises(ValueError, match="not divisible"):
        tpm.device_put(torch.zeros(3, 5, 4, 1), tpm.batch_sharding(tm_))
    assert tpm.replicated(tm_).spec == ()
    assert tm_.shape == {"dp": 2, "sy": 2, "sx": 2}
    assert tm_.axis_names == ("dp", "sy", "sx")


def test_init_distributed_without_an_address_starts_nothing(monkeypatch):
    import torch.distributed as dist

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    assert tpm.init_distributed(device="cpu") == 1
    assert tpm.init_distributed(device="cuda") == 0
    assert not dist.is_initialized()


def test_fused_kernel_over_dp():
    """K1 on each dp block (the port of test_shard_pallas.py's
    test_fused_kernel_inside_shard_map): K1's plain version here."""
    from imagemagick_tpu_torch.ops.fused_pipeline import fused_resize_pipeline

    jfp = importlib.import_module("imagemagick_tpu.ops.fused_pipeline")
    mesh = tpm.make_mesh(4, 1, 1, devices=[torch.device("cpu")] * 4)
    x = np.random.default_rng(17).random((8, 64, 128, 3)).astype(np.float32)

    def local(block):
        return fused_resize_pipeline(block, 32, 32, "lanczos", 1.0, TO=16)

    out = tsp.halo_map(local, mesh, 0, 0)(torch.from_numpy(x))
    assert out.shape == (8, 32, 32, 3)
    got = out.gather().numpy()
    ref = jfp.reference_pipeline_f64(x, 32, 32, "lanczos", 1.0)
    rms = float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)))
    assert 20 * np.log10(1.0 / max(rms, 1e-12)) >= 100.0
    whole = fused_resize_pipeline(torch.from_numpy(x), 32, 32, "lanczos",
                                  1.0, TO=16)
    assert np.array_equal(got, whole.numpy())


def _png(path, seed=7, size=64):
    from PIL import Image as PImage

    rng = np.random.default_rng(seed)
    PImage.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)
                     ).save(path)


def _read(path):
    from PIL import Image as PImage

    return np.asarray(PImage.open(path))


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(tpm, "local_devices",
                        lambda device="cuda": [torch.device("cpu")] * 4)


MESH_DEFINES = ["-define", "tpu:mesh=2x2", "-define",
                "tpu:shard-threshold=1024"]


def test_cli_define_tpu_mesh_shards(tmp_path, four_cpus):
    """The port of test_cli_define_tpu_mesh_autoshards: the chain runs
    with its image split over a 2x2 mesh (one ``sharded`` count) and
    writes the bytes of the unsharded run; the JAX CLI's GSPMD run is
    held at its own bound."""
    from imagemagick_tpu_torch.cli.main import main as tmain

    jmain = importlib.import_module("imagemagick_tpu.cli.main").main
    src = tmp_path / "big.png"
    _png(src)
    chain = ["-gaussian-blur", "0x2", "-auto-threshold", "otsu"]
    assert tmain([str(src)] + chain + [str(tmp_path / "plain.png")],
                 device="cpu") == 0
    before = dict(tdsp.COUNTS)
    assert tmain([str(src)] + MESH_DEFINES + chain +
                 [str(tmp_path / "sharded.png")], device="cpu") == 0
    assert tdsp.COUNTS["sharded"] == before["sharded"] + 1
    assert (tmp_path / "plain.png").read_bytes() == \
        (tmp_path / "sharded.png").read_bytes()
    assert jmain([str(src)] + MESH_DEFINES + chain +
                 [str(tmp_path / "jax.png")]) == 0
    a, b = _read(tmp_path / "sharded.png"), _read(tmp_path / "jax.png")
    assert a.shape == b.shape and np.mean(a != b) < 1e-3


@pytest.mark.parametrize("chain", [
    ["-resize", "48x48", "-morphology", "open", "square:1", "-median", "1",
     "-statistic", "mean", "3x3", "-negate", "-blur", "0x1"],
    ["-morphology", "edge", "diamond:1", "-statistic", "max", "5x3",
     "-flop", "-gaussian-blur", "0x1.5"],
    ["-morphology", "dilate", "Ring:2,3", "-morphology", "dilate",
     "Corners", "-morphology", "edge:2", "square:1"],
], ids=["shard-gather-shard", "edge-flop", "ring-corners-edge-twice"])
def test_cli_sharded_chain_equals_unsharded(tmp_path, four_cpus, chain):
    """Every op with a sharded form on the blocks, -negate and -flop on
    the gathered image, and the bytes of the unsharded run."""
    from imagemagick_tpu_torch.cli.main import main as tmain

    src = tmp_path / "in.png"
    _png(src, seed=9)
    assert tmain([str(src)] + chain + [str(tmp_path / "plain.png")],
                 device="cpu") == 0
    before = dict(tdsp.COUNTS)
    assert tmain([str(src)] + MESH_DEFINES + chain +
                 [str(tmp_path / "sharded.png")], device="cpu") == 0
    assert tdsp.COUNTS["sharded"] == before["sharded"] + 1
    assert np.array_equal(_read(tmp_path / "plain.png"),
                          _read(tmp_path / "sharded.png"))


def test_cli_otsu_shards_only_the_images_the_mesh_takes(tmp_path, four_cpus,
                                                       monkeypatch):
    """-auto-threshold otsu decides image by image: the 64x64 image runs
    split over the mesh (one ``sharded`` run), the two 30x30 ones, under
    the threshold, stay in the grouped path (one batched threshold), and
    every output is the unsharded run's."""
    from imagemagick_tpu_torch.cli.main import main as tmain

    srcs = []
    for i, size in enumerate((64, 30, 30)):
        srcs.append(str(tmp_path / f"in{i}.png"))
        _png(srcs[-1], seed=11 + i, size=size)
    chain = ["-blur", "0x1", "-auto-threshold", "otsu"]
    assert tmain(srcs + chain + [str(tmp_path / "plain-%d.png")],
                 device="cpu") == 0
    batches = []
    real = tth.auto_threshold
    monkeypatch.setattr(tth, "auto_threshold", lambda x, *a, **k: (
        batches.append(int(x.shape[0])), real(x, *a, **k))[1])
    before = tdsp.COUNTS["sharded"]
    assert tmain(srcs + MESH_DEFINES + chain +
                 [str(tmp_path / "mesh-%d.png")], device="cpu") == 0
    assert tdsp.COUNTS["sharded"] == before + 1
    assert batches == [2], batches
    for i in range(3):
        assert (tmp_path / f"plain-{i}.png").read_bytes() == \
            (tmp_path / f"mesh-{i}.png").read_bytes()


def test_cli_mesh_rules(tmp_path, four_cpus, monkeypatch):
    """An image under the threshold, one the mesh does not divide and a
    chain with no sharded form run unsharded; +define clears the mesh;
    a mask keeps -blur on the gathered image; morphology that converges
    (0 iterations), and convolve under another virtual pixel, are not
    sharded."""
    from imagemagick_tpu_torch.cli import main as tcm
    from imagemagick_tpu_torch.cli.main import main as tmain

    src = tmp_path / "in.png"
    _png(src, seed=5)
    odd = tmp_path / "odd.png"
    _png(odd, seed=5, size=63)
    for argv in ([str(src), "-define", "tpu:mesh=2x2", "-blur", "0x1"],
                 [str(odd)] + MESH_DEFINES + ["-blur", "0x1"],
                 [str(src)] + MESH_DEFINES + ["-negate"],
                 [str(src)] + MESH_DEFINES + ["+define", "tpu:mesh",
                                              "-blur", "0x1"],
                 [str(src)] + MESH_DEFINES + ["-channel", "R", "-blur",
                                              "0x1"],
                 [str(src)] + MESH_DEFINES + ["-virtual-pixel", "black",
                                              "-morphology", "convolve",
                                              "Gaussian:1x1"],
                 [str(src)] + MESH_DEFINES + ["-morphology", "erode:0",
                                              "square:1"]):
        before = tdsp.COUNTS["sharded"]
        assert tmain(argv + [str(tmp_path / "o.png")], device="cpu") == 0
        assert tdsp.COUNTS["sharded"] == before, argv
    st = tcm.process([str(src)] + MESH_DEFINES, tcm.CLIState("cpu"))
    mesh, minpx = st.shard
    assert minpx == 1024 and mesh.shape == {"dp": 1, "sy": 2, "sx": 2}


def test_dryrun_multichip_on_cpu_handles(capsys):
    from imagemagick_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, devices=CPU8)
    assert "dryrun_multichip OK: mesh dp=2 sy=2 sx=2" in \
        capsys.readouterr().out


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    """Without devices the dry run names the cards, so with none it
    raises make_mesh's error; ``--device cpu`` runs it on CPU handles."""
    from imagemagick_tpu_torch.parallel import dryrun

    with pytest.raises(ValueError, match="mesh 2x2x1 needs 4 devices, "
                                         "have 0"):
        dryrun.dryrun_multichip(4)
    with pytest.raises(ValueError, match="needs 8 devices, have 0"):
        dryrun.main([])
    dryrun.main(["4", "--device", "cpu"])
    assert "dryrun_multichip OK: mesh dp=2 sy=2 sx=1" in \
        capsys.readouterr().out


def _own_names(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("__") and not inspect.ismodule(v) and
            (getattr(v, "__module__", None) == mod.__name__ or
             n.startswith("_") and not callable(v))}


@pytest.mark.parametrize("name", ["parallel.mesh", "parallel.spatial",
                                  "models.gigapixel"])
def test_every_jax_name_has_a_counterpart(name):
    """Each function, class and constant the JAX module defines (its
    private helpers too), and the sharding names it takes from
    jax.sharding, exists in the port's module; nothing there imports JAX
    or the JAX package."""
    jmod = importlib.import_module(f"imagemagick_tpu.{name}")
    tmod = importlib.import_module(f"imagemagick_tpu_torch.{name}")
    names = _own_names(jmod) - {"annotations"}
    if name == "parallel.mesh":
        names |= {"Mesh", "NamedSharding", "P"}
    assert names and not names - set(vars(tmod)), names - set(vars(tmod))
    src = inspect.getsource(tmod)
    assert "import jax" not in src and "from jax" not in src
    assert "imagemagick_tpu." not in src and "imagemagick_tpu " not in src


@pytest.mark.parametrize("method,spec,iterations", [
    ("dilate", "Corners", 1), ("erode", "Edges", 1), ("dilate", "Ring:2,3", 1),
    ("edge", "square:1", 2), ("erode", "square:1", 0)],
    ids=["first-of-4-kernels", "first-of-4-edges", "ring-border",
         "edge-twice", "erode-converge"])
def test_jax_sharded_morphology_departs_from_morphology(meshes, batch, method,
                                                        spec, iterations):
    """A fault of the JAX module, recorded and not copied:
    ``sharded_morphology`` takes only a spec's first kernel
    (``spatial.py:153``), repeats the image's edge where ``morphology``
    ignores outside pixels (a ring reads values its window lacks), runs
    dilate^n - erode^n for an edge method of n iterations and one pass
    for n = 0, where ``morphology`` runs the method n times or until it
    converges.  The port's sharded form equals the port's ``morphology``
    (every kernel, the neutral border, n rounds) and raises for n = 0."""
    jmo = importlib.import_module("imagemagick_tpu.ops.morphology")
    jm_, tm_ = meshes
    sharded = np.asarray(_jax_run(jsp.sharded_morphology(
        jm_, method, spec, iterations), jm_, batch))
    whole = np.asarray(jmo.morphology(jnp.asarray(batch), method, spec,
                                      iterations=iterations))
    assert _max(sharded, whole) > 0.5
    x = torch.from_numpy(batch)
    if iterations < 1:
        with pytest.raises(ValueError, match="is not shardable"):
            tsp.sharded_morphology(tm_, method, spec, iterations)
        return
    got = _port(tsp.sharded_morphology(tm_, method, spec, iterations)(x))
    assert np.array_equal(got, tmo.morphology(
        x, method, spec, iterations=iterations).numpy())
    assert np.array_equal(whole, tmo.morphology(
        x, method, spec, iterations=iterations).numpy())


@pytest.mark.parametrize("method,spec,iterations", [
    ("smooth", "Ring:2,3", 2), ("bottomhat", "disk:2", 1),
    ("tophat", "diamond:1", 3), ("edgein", "rectangle:4x3", 1),
    ("edgeout", "plus:2", 2), ("close", "rectangle:2x2", 1),
    ("convolve", "Gaussian:1x1", 1), ("correlate", "Sobel", 2)])
def test_sharded_morphology_equals_morphology(meshes, batch, method, spec,
                                              iterations):
    """Every bounded method, multi-kernel and even-sized specs, and more
    than one round, exactly as the unsharded op."""
    _, tm_ = meshes
    x = torch.from_numpy(batch)
    got = _port(tsp.sharded_morphology(tm_, method, spec, iterations)(x))
    assert np.array_equal(got, tmo.morphology(
        x, method, spec, iterations=iterations).numpy())


def test_jax_sharded_statistics_float32_mean_at_scale(meshes):
    """A fault of the JAX module: its float32 psums put the mean of a
    flat 0.7 image of 2 x 2048 x 2048 pixels 1.1e-5 away from 0.7,
    beyond its own test's 1e-5 bound, and the error grows with the
    pixel count (a gigapixel is 128 times this).  The port's float64 sums
    give 0.7 exactly and a zero deviation."""
    jm_, tm_ = meshes
    v = np.float32(0.7)
    flat = np.full((2, 2048, 2048, 1), v, np.float32)
    jmean, jstd, _, _ = _jax_run(jsp.sharded_statistics(jm_), jm_, flat)
    assert abs(float(np.asarray(jmean)[0]) - float(v)) > 1e-5
    mean, std, mn, mx = tsp.sharded_statistics(tm_)(torch.from_numpy(flat))
    assert float(mean[0]) == float(v) == float(mn[0]) == float(mx[0])
    assert float(std[0]) == 0.0
