"""Port parity: core/'s services (policy, resource, log, metadata, profile,
properties) and utils/ (aes, signature and the cipher, quantum) against
the JAX package's modules.

Inputs are made from a seed with numpy.  The pure-Python services
(policy, resource, log, metadata, aes, quantum) must give equal results;
a signature, a cipher's output and a quantum stream equal bytes; an ICC
transform equal pixels (both run LittleCMS over the same 8-bit planes);
a property escape equal text, but for the float32 statistics (%[mean],
%[standard-deviation], %[entropy], ...), which are compared as numbers
within 1e-5 relative or 1e-5 absolute (two float32 reductions in another
order; skewness's third moment cancels to near 0)."""

import importlib
import json
import struct

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch.core import log as tlog
from imagemagick_tpu_torch.core import metadata as tmd
from imagemagick_tpu_torch.core import policy as tpol
from imagemagick_tpu_torch.core import profile as tprof
from imagemagick_tpu_torch.core import properties as tprops
from imagemagick_tpu_torch.core import resource as tres
from imagemagick_tpu_torch.core.image import Image as TImage
from imagemagick_tpu_torch.utils import aes as taes
from imagemagick_tpu_torch.utils import quantum as tq
from imagemagick_tpu_torch.utils import signature as tsig

jlog = importlib.import_module("imagemagick_tpu.core.log")
jmd = importlib.import_module("imagemagick_tpu.core.metadata")
jpol = importlib.import_module("imagemagick_tpu.core.policy")
jprof = importlib.import_module("imagemagick_tpu.core.profile")
jprops = importlib.import_module("imagemagick_tpu.core.properties")
jres = importlib.import_module("imagemagick_tpu.core.resource")
jaes = importlib.import_module("imagemagick_tpu.utils.aes")
jq = importlib.import_module("imagemagick_tpu.utils.quantum")
jsig = importlib.import_module("imagemagick_tpu.utils.signature")
JImage = importlib.import_module("imagemagick_tpu.core.image").Image

STAT_REL = 1e-5
STAT_ABS = 1e-5   # skewness and kurtosis: means of cubes and fourth powers
                  # that cancel to near 0


def _pixels(seed=0, h=24, w=32, c=3):
    """Smooth texture with flat blocks, float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 5.0)[..., None] * np.cos(
        xx[..., None] / 7.0 + np.arange(c))
    img = base + 0.05 * rng.standard_normal((h, w, c))
    img[h // 3:h // 2, w // 4:w // 2] = 0.75
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _pair(arr, **spec):
    from imagemagick_tpu.core.spec import ImageSpec as JSpec
    from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec

    return (TImage(torch.from_numpy(arr.copy()), TSpec(**spec)),
            JImage(arr.copy(), JSpec(**spec)))


# -- resource ---------------------------------------------------------------

@pytest.mark.parametrize("limits", [
    {"width": 100}, {"area": "1kp"}, {"height": "64"}, {"area": "2KiB"},
    {"memory": "1mb"}])
def test_resource_limits_match_jax(limits):
    managers = (tres.ResourceManager(), jres.ResourceManager())
    for rm in managers:
        for k, v in limits.items():
            rm.set_limit(k, v)
    for w, h in ((50, 50), (200, 50), (90, 90), (31, 70)):
        outcomes = []
        for rm, err in zip(managers, (tres.ResourceLimitError,
                                      jres.ResourceLimitError)):
            try:
                rm.check_image_size(w, h)
                outcomes.append("ok")
            except err as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1], (w, h)
    for rm in managers:
        rm.acquire("memory", 400_000)
    assert managers[0].report() == managers[1].report()


def test_resource_env_override(monkeypatch):
    monkeypatch.setenv("MAGICK_AREA_LIMIT", "10kp")
    monkeypatch.setenv("MAGICK_LIST_LENGTH_LIMIT", "32")
    assert tres.ResourceManager().limits == jres.ResourceManager().limits
    assert tres.ResourceManager().get_limit("area") == 10_000


# -- policy -----------------------------------------------------------------

POLICY_XML = '''<policymap>
  <policy domain="delegate" rights="none" pattern="*"/>
  <policy domain="coder" rights="read|write" pattern="PNG"/>
  <policy domain="coder" rights="none" pattern="EPS"/>
  <policy domain="path" rights="none" pattern="@*"/>
</policymap>'''


@pytest.mark.parametrize("query", [
    ("delegate", "ghostscript", "execute"), ("coder", "PNG", "write"),
    ("coder", "png", "read"), ("coder", "EPS", "read"),
    ("coder", "GIF", "read"), ("path", "@list.txt", "read")])
def test_policy_matches_jax(query):
    pms = (tpol.PolicyManager(), jpol.PolicyManager())
    for pm in pms:
        pm.load_xml(POLICY_XML)
    assert pms[0].is_authorized(*query) == pms[1].is_authorized(*query)
    assert pms[0].rules == pms[1].rules


@pytest.mark.parametrize("profile", ["open", "secure", "websafe"])
def test_policy_profiles_match_jax(profile, monkeypatch):
    monkeypatch.setattr(tpol.policy, "rules", [])
    monkeypatch.setattr(jpol.policy, "rules", [])
    tpol.load_profile(profile)
    jpol.load_profile(profile)
    assert tpol.policy.rules == jpol.policy.rules
    for fmt in ("PNG", "TIFF", "MIFF"):
        assert tpol.policy.is_authorized("coder", fmt, "read") == \
            jpol.policy.is_authorized("coder", fmt, "read")


def test_policy_file_from_environment(tmp_path, monkeypatch):
    path = tmp_path / "policy.xml"
    path.write_text(POLICY_XML)
    monkeypatch.setenv("MAGICK_POLICY_PATH", str(path))
    assert tpol.PolicyManager().rules == jpol.PolicyManager().rules
    with pytest.raises(tpol.PolicyError, match="security policy"):
        tpol.PolicyManager().enforce("coder", "EPS", "read")


@pytest.mark.parametrize("name", ["{f}", "mpr:keep", "mask:{f}",
                                  "tile:{f}"])
def test_no_host_files_refuses_named_paths(tmp_path, name):
    """Inside ``no_host_files`` a read or a write of a named path or an
    ``mpr:`` entry raises PolicyError on this thread only; ``-`` and the
    pseudo formats stay open, and the block restores what was before."""
    import threading

    from imagemagick_tpu_torch import io as tio

    f = tmp_path / "in.png"
    img = TImage(torch.from_numpy(np.random.default_rng(3).random(
        (6, 5, 3), dtype=np.float32)))
    tio.write_image(img, str(f))
    tio.write_image(img, "mpr:keep")
    name = name.format(f=f)
    assert tio.read_images(name, size="4x4", device="cpu")
    with tpol.no_host_files():
        with pytest.raises(tpol.PolicyError, match="no file of the host"):
            tio.read_images(name, size="4x4", device="cpu")
        with pytest.raises(tpol.PolicyError):
            tio.write_image(img, name if name.startswith("mpr:")
                            else str(f))
        assert tio.read_images("xc:red", size="2x2", device="cpu")
        other = []
        t = threading.Thread(target=lambda: other.append(
            tio.read_images(str(f), device="cpu")))
        t.start()
        t.join()
        assert len(other) == 1
        with tpol.no_host_files():
            pass
        with pytest.raises(tpol.PolicyError):
            tpol.enforce_path(str(f))
    tpol.enforce_path(str(f))
    assert tio.read_images(name, size="4x4", device="cpu")


# -- log --------------------------------------------------------------------

@pytest.mark.parametrize("mask", ["all", "none", "coder,policy",
                                  "Coder+Resource", "bogus,blob"])
def test_log_event_masks_match_jax(mask, monkeypatch):
    monkeypatch.setenv("MAGICK_DEBUG", mask)
    t, j = tlog.LogManager(), jlog.LogManager()
    assert t.enabled == j.enabled
    for d in ("coder", "policy", "blob", "resource"):
        assert t.is_enabled(d) == j.is_enabled(d)


def test_log_event_line_and_monitor(capsys):
    lm = tlog.LogManager()
    lm.set_log_event_mask("coder")
    lm.sink = __import__("sys").stdout
    lm.event("coder", "decoded %s", "x.png")
    lm.event("blob", "not shown")
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].endswith("CODE decoded x.png")
    assert tlog.ProgressMonitor()("t", 1, 2)
    assert not tlog.ProgressMonitor(lambda *a: False)("t", 1, 2)
    tlog.cli_monitor("Resize", 2, 4)
    jlog.cli_monitor("Resize", 2, 4)
    err = capsys.readouterr().err.split("\r")
    assert err[0] == err[1] == "Resize: 2 of 4, 50% complete"


# -- metadata ---------------------------------------------------------------

def _tiff_exif(entries, bo="<"):
    """A minimal TIFF/EXIF blob: IFD0 with the (tag, type, count, value)
    entries, built by hand."""
    head = (b"II" if bo == "<" else b"MM") + struct.pack(bo + "HI", 42, 8)
    n = len(entries)
    ifd = struct.pack(bo + "H", n)
    data_off = 8 + 2 + 12 * n + 4
    tail = b""
    for tag, vtype, count, val in entries:
        size = jmd._TYPE_SIZE[vtype] * count
        raw = struct.pack(bo + {3: "H", 4: "I"}[vtype], val) \
            if isinstance(val, int) else val
        if size <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack(bo + "I", data_off + len(tail))
            tail += raw
        ifd += struct.pack(bo + "HHI", tag, vtype, count) + field
    ifd += struct.pack(bo + "I", 0)
    return head + ifd + tail


EXIF_ENTRIES = [(0x010F, 2, 6, b"Canon\0"), (0x0110, 2, 4, b"EOS\0"),
                (0x0112, 3, 1, 6), (0x011A, 5, 1, struct.pack("<II", 72, 1)),
                (0x0132, 2, 20, b"2024:01:02 03:04:05\0")]


@pytest.mark.parametrize("bo", ["<", ">"])
def test_exif_matches_jax(bo):
    entries = [(t, ty, c, v if not (ty == 5) else
                struct.pack(bo + "II", 72, 1)) for t, ty, c, v in
               EXIF_ENTRIES]
    blob = _tiff_exif(entries, bo)
    assert tmd.parse_exif(blob) == jmd.parse_exif(blob)
    assert tmd.parse_exif(blob)["exif:Orientation"] == "6"


def _jpeg_with_app1(exif: bytes) -> bytes:
    from PIL import Image as PImage
    import io

    buf = io.BytesIO()
    PImage.fromarray((_pixels(1) * 255).astype(np.uint8)).save(buf, "JPEG")
    raw = buf.getvalue()
    app1 = b"Exif\0\0" + exif
    seg = b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1
    return raw[:2] + seg + raw[2:]


def test_jpeg_png_tiff_metadata_match_jax():
    exif = _tiff_exif(EXIF_ENTRIES)
    jpg = _jpeg_with_app1(exif)
    assert tmd.extract_metadata(jpg, "jpeg") == \
        jmd.extract_metadata(jpg, "jpeg")
    assert tmd.extract_metadata(jpg, None)["exif:Make"] == "Canon"
    assert tmd.extract_metadata(exif, "tiff") == \
        jmd.extract_metadata(exif, "tiff")
    assert tmd.extract_metadata(b"GIF89a...", "gif") == {}


def test_iptc_xmp_and_clip_path_match_jax():
    iptc = (b"\x1c\x02\x78" + struct.pack(">H", 11) + b"Hello World" +
            b"\x1c\x02\x19" + struct.pack(">H", 3) + b"gpu" +
            b"\x1c\x02\x19" + struct.pack(">H", 5) + b"cuda!")
    blob = (b"Photoshop 3.0\x00" + b"8BIM" + struct.pack(">H", 0x0404) +
            b"\x00\x00" + struct.pack(">I", len(iptc)) + iptc)
    assert tmd.parse_8bim(blob) == jmd.parse_8bim(blob)
    assert tmd.parse_8bim(blob)["iptc:Keyword"] == "gpu;cuda!"
    xmp = b"""<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF
      xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
      <rdf:Description xmlns:xmp="http://ns.adobe.com/xap/1.0/"
        xmp:CreatorTool="tmagick 1.0" xmp:Rating="5">
        <dc:title>Sunset</dc:title></rdf:Description></rdf:RDF>
      </x:xmpmeta>"""
    assert tmd.parse_xmp(xmp) == jmd.parse_xmp(xmp)
    path = _clip_8bim(40, 30)
    assert tmd.clip_path_from_8bim(path, 40, 30) == \
        jmd.clip_path_from_8bim(path, 40, 30)
    assert tmd.clip_path_from_8bim(path, 40, 30).startswith("M8,3 C")


def _clip_8bim(w, h) -> bytes:
    """An 8BIM resource 2000 (a path) of a closed triangle, each knot's
    three points equal (straight edges), in 8.24 fixed point."""
    def fixed(v):
        return struct.pack(">i", int(round(v * (1 << 24))))

    recs = [struct.pack(">H", 6) + b"\0" * 24,          # fill rule
            struct.pack(">HH", 0, 3) + b"\0" * 22]     # closed subpath
    for y, x in ((0.1, 0.2), (0.9, 0.5), (0.2, 0.8)):
        pt = fixed(y) + fixed(x)
        recs.append(struct.pack(">H", 1) + pt * 3)
    data = b"".join(recs)
    name = b"\x04clip\x00"        # pascal string, padded to even
    return (b"8BIM" + struct.pack(">H", 2000) + name +
            struct.pack(">I", len(data)) + data)


# -- profile ----------------------------------------------------------------

def _icc(name: str) -> bytes:
    from PIL import ImageCms

    return ImageCms.ImageCmsProfile(ImageCms.createProfile(name)).tobytes()


@pytest.mark.parametrize("channels,target,intent", [
    (3, "sRGB", "perceptual"), (3, "sRGB", "relative"),
    (4, "sRGB", "saturation"), (3, "sRGB", "absolute"),
    (3, "LAB", "relative"), (1, "sRGB", "perceptual")])
def test_profile_image_matches_jax(channels, target, intent):
    """sRGB targets at each intent give the JAX pixels bit for bit; the
    transforms LittleCMS cannot build here (to a Lab profile, from gray)
    raise the same error in both."""
    if not tprof.HAVE_LCMS:
        pytest.skip("Pillow has no LittleCMS here")
    spec = dict(colorspace="gray" if channels == 1 else "srgb",
                alpha=channels == 4)
    t, j = _pair(_pixels(2, c=channels), **spec)
    blob = _icc(target)
    try:
        want = jprof.profile_image(j, blob, intent)
    except Exception as e:   # noqa: BLE001 — the port must raise the same
        with pytest.raises(type(e)):
            tprof.profile_image(t, blob, intent)
        return
    got = tprof.profile_image(t, blob, intent)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.data))
    assert (got.spec.colorspace, got.spec.alpha) == \
        (want.spec.colorspace, want.spec.alpha)
    assert got.profiles["icc"] == blob and got.data.device == t.data.device


def test_transform_to_srgb_matches_jax():
    t, j = _pair(_pixels(3))
    assert tprof.transform_to_srgb(t) is t
    t.profiles["icc"] = j.profiles["icc"] = tprof.srgb_profile_bytes()
    got, want = tprof.transform_to_srgb(t), jprof.transform_to_srgb(j)
    np.testing.assert_array_equal(got.to_numpy(), np.asarray(want.data))
    assert tprof.srgb_profile_bytes() == jprof.srgb_profile_bytes()


# -- properties -------------------------------------------------------------

EXACT = ["%wx%h", "%[width]x%[height]", "%[comment]", "%[colorspace]",
         "%[channels]", "%[depth]", "%[size]", "\\n%t\\t%e", "%f %d", "%k",
         "%[colors]", "%#", "%[pixel:p{3,4}]", "%[hex:5,6]", "%[fx:w/2]",
         "%[fx:u.r*0+h]", "%A %C %r %z %q", "%n %p %s %x", "%[EXIF:Make]",
         "%[iptc:Keyword]", "%%w", "%Q", "%m"]
NUMERIC = ["%[mean]", "%[standard-deviation]", "%[min]", "%[max]",
           "%[entropy]", "%[skewness]", "%[kurtosis]"]


def _props_pair(c=3):
    t, j = _pair(_pixels(4, c=c), colorspace="gray" if c == 1 else "srgb")
    for im in (t, j):
        im.properties.update({"comment": "hello", "exif:Make": "Canon",
                              "iptc:Keyword": "gpu;cuda", "format": "PNG"})
    return t, j


@pytest.mark.parametrize("fmt", EXACT)
def test_interpret_text_matches_jax(fmt):
    t, j = _props_pair()
    name = "/tmp/dir/photo.png"
    assert tprops.interpret(fmt, t, name, 1, 3) == \
        jprops.interpret(fmt, j, name, 1, 3)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("fmt", NUMERIC)
def test_interpret_statistics_match_jax(fmt, c):
    t, j = _props_pair(c)
    got = float(tprops.interpret(fmt, t))
    want = float(jprops.interpret(fmt, j))
    assert got == pytest.approx(want, rel=STAT_REL, abs=STAT_ABS)


# -- signature and the cipher -----------------------------------------------

@pytest.mark.parametrize("shape", [(24, 32, 3), (7, 5, 1), (2, 9, 11, 4)])
def test_signature_matches_jax(shape):
    arr = np.random.default_rng(5).uniform(-0.1, 1.1, shape).astype(
        np.float32)
    assert tsig.signature_image(torch.from_numpy(arr)) == \
        jsig.signature_image(arr)


def test_aes_fips197_vectors():
    """FIPS-197 appendix C vectors, and the JAX module's cipher on a
    batch of random blocks under each key length."""
    pt = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"),
                       np.uint8).reshape(1, 16)
    for klen, expect in [(16, "69c4e0d86a7b0430d8cdb78070b4c55a"),
                         (24, "dda97ca4864cdfe06eaf70a0ec0d7191"),
                         (32, "8ea2b7ca516745bfeafc49904b496089")]:
        key = bytes(range(klen))
        assert taes.aes_encrypt_blocks(pt, key).tobytes().hex() == expect
        blocks = np.random.default_rng(klen).integers(0, 256, (64, 16),
                                                      dtype=np.uint8)
        np.testing.assert_array_equal(taes.aes_encrypt_blocks(blocks, key),
                                      jaes.aes_encrypt_blocks(blocks, key))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("passphrase", ["correct horse battery",
                                        "x" * 40, "k"])
def test_encipher_matches_jax_and_deciphers(depth, passphrase):
    arr = _pixels(6)
    enc = tsig.encipher_image(torch.from_numpy(arr), passphrase, depth)
    want = np.asarray(jsig.encipher_image(arr, passphrase, depth))
    assert isinstance(enc, torch.Tensor)
    np.testing.assert_array_equal(enc.numpy(), want)
    dec = tsig.decipher_image(enc, passphrase, depth).numpy()
    scale = 255.0 if depth == 8 else 65535.0
    q = (np.clip(arr, 0, 1) * scale + 0.5).astype(np.uint32)
    np.testing.assert_array_equal(
        dec, q.astype(np.float32) / np.float32(scale))


# -- quantum ----------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("order", ["msb", "lsb"])
def test_quantum_matches_jax(depth, order):
    x = np.random.default_rng(depth).uniform(0, 1, (5, 7, 3)).astype(
        np.float32)
    blob = tq.export_quantum(x, depth, endian=order, bit_order=order)
    assert blob == jq.export_quantum(x, depth, endian=order,
                                     bit_order=order)
    assert len(blob) == tq.quantum_extent(7, 5, 3, depth)
    np.testing.assert_array_equal(
        tq.import_quantum(blob, 7, 5, 3, depth, endian=order,
                          bit_order=order),
        jq.import_quantum(blob, 7, 5, 3, depth, endian=order,
                          bit_order=order))


def test_identify_json_payload_keys_match_jax():
    """The json: payload's structure; its numbers are held in
    test_torch_io.py."""
    from imagemagick_tpu.io import identify as jident
    from imagemagick_tpu_torch.io import identify as tident

    t, j = _props_pair()
    a = json.loads(tident.to_json(t, "x.png"))["image"]
    b = json.loads(jident.to_json(j, "x.png"))["image"]
    assert sorted(a) == sorted(b)
    assert a["signature"] == b["signature"] and a["colors"] == b["colors"]
