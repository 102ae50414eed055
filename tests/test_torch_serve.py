"""Port parity: the serve daemon's device-resident sessions against the
JAX package's ``serve.py``.

A loopback server on port 0 with its sessions on the CPU; the JAX
``_session_store`` / ``_session_apply`` / ``_session_fetch`` run
in-process on the same pixels.  On the CPU the JAX apply takes its
general per-image path (XLA ops, a clip after every op) and the port's
its fused-batch path (K1's plain version, one clip): fetched u8 pixels
agree within 1 level on these images.  ``/convert``, ``/identify`` and
``/formats`` are held to the JAX server's ``_run_cli``, ``describe`` and
validator on the same requests (the tolerances in each test)."""

import importlib
import json
import threading
from http.client import HTTPConnection
from urllib.parse import quote

import numpy as np
import pytest

from imagemagick_tpu_torch import serve as ts
from imagemagick_tpu_torch.cli import main as tm

js = importlib.import_module("imagemagick_tpu.serve")

N, H, W, C = 3, 64, 96, 3
CHAIN = "-resize 32x32! -gaussian-blur 0x2 -colorspace gray"


def _pixels(seed=0, n=N, h=H, w=W):
    """Smooth u8 content: a gradient with modest texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(yy / 11.0)[..., None] * np.cos(
        xx[..., None] / 13.0 + np.arange(C))
    img = base + 0.05 * rng.standard_normal((n, h, w, C))
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


@pytest.fixture(scope="module")
def server():
    srv = ts.make_server(port=0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _png(arr) -> bytes:
    import io

    from PIL import Image as PImage

    buf = io.BytesIO()
    PImage.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def _call(port, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _store(port, name, raw, shape=(N, H, W, C), dtype="u8"):
    return _call(port, "POST", f"/session/{name}", raw,
                 {"X-Shape": ",".join(map(str, shape)), "X-Dtype": dtype})


def _apply(port, name, chain=CHAIN, keep=0):
    return _call(port, "POST",
                 f"/session/{name}/apply?keep={keep}&args={quote(chain)}")


def test_healthz(server):
    status, body = _call(server, "GET", "/healthz")
    assert status == 200
    assert json.loads(body) == {"ok": True, "platform": "cpu", "devices": 1}


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_sessions_match_jax(server, dtype):
    pixels = _pixels(1)
    raw = pixels.tobytes() if dtype == "u8" else \
        (pixels.astype("<f4") / 255.0).tobytes()
    name = f"match_{dtype}"
    status, body = _store(server, name, raw, dtype=dtype)
    assert status == 200
    assert json.loads(body) == js._session_store(name, raw, (N, H, W, C),
                                                 dtype)
    for keep in (1, 0):
        status, body = _apply(server, name, keep=keep)
        assert status == 200
        got = json.loads(body)
        want = js._session_apply(name, CHAIN.split(), keep=bool(keep))
        assert got["path"] == "fused-batch"
        assert got["shape"] == want["shape"] == [N, 32, 32, 1]
        status, raw_out = _call(server, "GET", f"/session/{name}")
        assert status == 200
        fetched = np.frombuffer(raw_out, np.uint8)
        jfetched = np.frombuffer(js._session_fetch(name), np.uint8)
        assert fetched.size == jfetched.size
        assert np.abs(fetched.astype(int) - jfetched).max() <= 1
        if keep:        # the session still holds the stored pixels
            assert fetched.size == N * H * W * C
    js._SESSIONS.pop(name, None)


def test_general_path_for_a_declined_chain(server):
    """A chain dispatch declines (an upscale) runs per image through the
    CLI's materialize_all, as the JAX server's does."""
    pixels = _pixels(2)
    _store(server, "general", pixels.tobytes())
    js._session_store("general", pixels.tobytes(), (N, H, W, C), "u8")
    chain = "-resize 80x120! -colorspace gray"
    status, body = _apply(server, "general", chain)
    assert status == 200 and json.loads(body)["path"] == "general"
    js._session_apply("general", chain.split())
    got = np.frombuffer(_call(server, "GET", "/session/general")[1], np.uint8)
    want = np.frombuffer(js._session_fetch("general"), np.uint8)
    assert got.size == want.size == N * 80 * 120
    assert np.abs(got.astype(int) - want).max() <= 1
    js._SESSIONS.pop("general", None)


def test_tag_cache_hit_on_second_apply(server, monkeypatch):
    calls = []
    orig = tm.process
    monkeypatch.setattr(tm, "process",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    _store(server, "cache", _pixels(3, h=48, w=80).tobytes(), (N, 48, 80, C))
    chain = "-resize 24x40! -colorspace gray"
    assert _apply(server, "cache", chain, keep=1)[0] == 200
    assert len(calls) == 1
    assert ts._TAG_CACHE[((tuple(chain.split())), (N, 48, 80, C))] == [
        ("resize", (40, 24, "lanczos")),
        ("mix", ((0.212656, 0.715158, 0.072186),))]
    status, body = _apply(server, "cache", chain, keep=1)
    assert status == 200 and json.loads(body)["path"] == "fused-batch"
    assert len(calls) == 1


def test_error_codes_match_jax(server):
    """An unknown session and a bad X-Shape give the JAX server's codes."""
    assert _apply(server, "nosuch")[0] == 400
    assert _call(server, "GET", "/session/nosuch")[0] == 404
    raw = _pixels(4).tobytes()
    for shape in ("1,2,3", "a,b,c,d", ""):
        status, _ = _call(server, "POST", "/session/bad", raw,
                          {"X-Shape": shape})
        assert status == 400
    assert _store(server, "bad", raw, (N, H, W, 4))[0] == 400   # size
    assert _store(server, "bad", raw, dtype="u16")[0] == 400
    assert _call(server, "POST", "/session/bad", b"",
                 {"X-Shape": "1,1,1,1"})[0] == 400
    assert _call(server, "GET", "/nowhere")[0] == 404
    with pytest.raises(KeyError):
        js._session_apply("nosuch", CHAIN.split())
    with pytest.raises(KeyError):
        ts._session_apply("nosuch", CHAIN.split())


@pytest.mark.parametrize("path", ["/convert?args=-region%2010x10",
                                  "/convert?args=-bench%202"])
def test_convert_and_identify_answer_501(server, path):
    """The options that once answered 501 answer as the JAX server does:
    ``-region`` runs (a region negated: the JAX server's PPM bytes) and
    ``-bench`` is an unknown option (400), as the JAX validator has it."""
    body = _png(_pixels(9, n=1)[0])
    args = path.split("args=")[1].replace("%20", " ").split()
    if args[0] == "-region":
        args = ["-region", "10x10+3+4", "-negate"]
        status, out = _call(server, "POST",
                            f"/convert?args={quote(' '.join(args))}&of=ppm",
                            body)
        assert status == 200
        assert out == js._run_cli(["-", *args, "ppm:-"], body)
        js.validate_convert_args(args)
        return
    status, body = _call(server, "POST", path, body)
    assert status == 400
    assert "unknown option '-bench'" in json.loads(body)["error"]
    with pytest.raises(ValueError, match="unknown option '-bench'"):
        js.validate_convert_args(args)


def test_apply_args_are_checked(server):
    """/apply walks its options as /convert does, as the JAX server's
    /apply does: ``-region`` and a setting run (a setting leaves the
    session as it was), ``-bench`` and a path are refused (400)."""
    _store(server, "args", _pixels(5).tobytes())
    status, body = _apply(server, "args", "-region 10x10")
    assert status == 200 and json.loads(body)["shape"] == [N, H, W, C]
    before = _call(server, "GET", "/session/args")[1]
    assert _apply(server, "args", "-gravity center")[0] == 200
    assert _call(server, "GET", "/session/args")[1] == before
    status, body = _apply(server, "args", "-bench 2 -negate")
    assert status == 400 and "unknown option" in json.loads(body)["error"]
    status, body = _apply(server, "args", "-profile sRGB.icc")
    assert status == 400 and "filesystem" in json.loads(body)["error"]
    # an option of one optional argument, with and without it
    assert _apply(server, "args", "-shadow -blue-shift 1.2")[0] == 200
    assert _apply(server, "args", "-shadow 60x2+3+3")[0] == 200
    status, body = _apply(server, "args", "-resize 10x10 in.png")
    assert status == 400 and "filename" in json.loads(body)["error"]
    assert _apply(server, "args", "-resize")[0] == 400


def test_apply_runs_a_setting_as_jax():
    """A setting sent to /apply answers 200 in the JAX server too: its
    validator takes it and ``_session_apply`` runs it, leaving the
    session's pixels as they were."""
    raw = _pixels(6)
    js._session_store("jset", raw.tobytes(), (N, H, W, C), "u8")
    ts._session_store("tset", raw.tobytes(), (N, H, W, C), "u8", "cpu")
    for args in (["-gravity", "center"], ["-region", "5x5+1+1"]):
        js.validate_convert_args(args)
        ts.validate_args(args)
        js._session_apply("jset", args)
        ts._session_apply("tset", args)
    assert js._session_fetch("jset") == ts._session_fetch("tset") == \
        raw.tobytes()


def test_burst_of_clients_loses_no_connection(server):
    """16 clients at once: a listen backlog of 5 (socketserver's default)
    drops some of their connection requests, which the clients send again
    a second later."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def health(_):
        t0 = time.perf_counter()
        assert _call(server, "GET", "/healthz")[0] == 200
        return time.perf_counter() - t0

    assert ts._Server.request_queue_size >= 16
    with ThreadPoolExecutor(16) as ex:
        for _ in range(3):
            assert max(ex.map(health, range(16))) < 0.9


def test_card_device_without_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ts.make_server(port=0)


# -- /convert, /identify and /formats ---------------------------------------

def _decode(blob) -> np.ndarray:
    import io

    from PIL import Image as PImage

    return np.asarray(PImage.open(io.BytesIO(blob))).astype(int)


@pytest.mark.parametrize("of", ["png", "jpeg", "ppm"])
def test_convert_matches_jax(server, of):
    """config #1's chain on a PNG request: the port runs it as one call of
    K1's plain version, the JAX server as XLA ops that clip after every
    op: the written samples within 1 level (2 for JPEG, whose encoder
    turns a 1-level input difference into at most 2)."""
    body = _png(_pixels(20, n=1)[0])
    status, out = _call(server, "POST",
                        f"/convert?args={quote(CHAIN)}&of={of}", body)
    assert status == 200
    want = js._run_cli(["-", *CHAIN.split(), f"{of}:-"], body)
    a, b = _decode(out), _decode(want)
    assert a.shape == b.shape and a.shape[:2] == (32, 32)
    assert np.abs(a - b).max() <= (2 if of == "jpeg" else 1)


def test_convert_exact_chain_gives_jax_bytes(server):
    """A chain of copies and exact per-pixel ops gives the JAX server's
    bytes (PPM: no codec choice on either side)."""
    body = _png(_pixels(21, n=1)[0])
    args = "-flip -negate -crop 40x30+3+5"
    status, out = _call(server, "POST",
                        f"/convert?args={quote(args)}&of=ppm", body)
    assert status == 200
    assert out == js._run_cli(["-", *args.split(), "ppm:-"], body)


def test_identify_matches_jax(server):
    import re

    from imagemagick_tpu import io as jio
    from imagemagick_tpu.io import identify as jident

    body = _png(_pixels(22, n=1)[0])
    status, text = _call(server, "POST", "/identify", body)
    assert status == 200
    want = jident.describe(jio.image_from_blob(body)[0], "request",
                           verbose=True)
    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
    got_lines, want_lines = text.decode().splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for g, w in zip(got_lines, want_lines):
        if g.startswith("  Version:"):
            continue
        assert num.sub("#", g) == num.sub("#", w)
        for x, y in zip(num.findall(g), num.findall(w)):
            assert float(x) == pytest.approx(float(y), rel=1e-5, abs=5e-5)


def test_formats_lists_what_the_port_reads_and_writes(server):
    """The port's lists, which equal the lists the JAX server answers
    (``imagemagick_tpu/serve.py:304-309``, its io's) but for the names the
    JAX lists get wrong (``torch_format_faults``)."""
    from imagemagick_tpu_torch import io as tio
    from torch_format_faults import RECORDED_FORMATS

    jio = importlib.import_module("imagemagick_tpu.io")
    status, body = _call(server, "GET", "/formats")
    assert status == 200
    got = json.loads(body)
    assert got == {"read": tio.supported_read_formats(),
                   "write": tio.supported_write_formats()}
    recorded = {n.lower() for n in RECORDED_FORMATS}
    for key, jax_list in (("read", jio.supported_read_formats()),
                          ("write", jio.supported_write_formats())):
        assert [f for f in got[key] if f not in recorded] == \
            [f for f in jax_list if f not in recorded]
    assert "png" in got["read"] and "jpeg" in got["write"]
    assert "miff" in got["read"] and "miff" in got["write"]
    assert "dpx" in got["read"] and "dpx" in got["write"]
    assert "aai" in got["read"] and "aai" in got["write"]
    assert "hdr" in got["read"] and "hdr" in got["write"]
    assert "dmr" in got["read"] and "wmf" in got["read"]


@pytest.mark.parametrize("args", [
    "-resize 10x10 other.png", "-write /tmp/x.png", "-texture rose.png",
    "-profile x.icc", "-script s.mgk", "-nosuch-option", "-resize",
    "+dither -remap x.png", "-read x.png", "-limit memory 0"])
def test_convert_refuses_files_and_denied_options(server, args):
    """A file name, an option that reads or writes a path or sets the
    process's limits, an unknown option or a missing argument: 400, as
    from the JAX validator (which refuses ``+dither -remap x.png`` only
    because it takes ``-remap`` for +dither's argument)."""
    status, body = _call(server, "POST", f"/convert?args={quote(args)}",
                         _png(_pixels(23, n=1)[0]))
    assert status == 400
    with pytest.raises(ValueError):
        js.validate_convert_args(args.split())
    with pytest.raises(ValueError):
        ts.validate_convert_args(args.split())


@pytest.mark.parametrize("args", ["-remap {}", "-affinity {}", "-font {}"])
def test_jax_validator_passes_options_that_read_files(server, tmp_path,
                                                      args):
    """The JAX validator lets ``-remap``, its alias ``-affinity`` and
    ``-font`` name a file of the host; the port refuses them (400)."""
    path = tmp_path / "palette.png"
    path.write_bytes(_png(_pixels(26, n=1)[0]))
    argv = args.format(path).split()
    js.validate_convert_args(argv)
    with pytest.raises(ValueError):
        ts.validate_convert_args(argv)
    status, body = _call(server, "POST",
                         f"/convert?args={quote(' '.join(argv))}",
                         _png(_pixels(23, n=1)[0]))
    assert status == 400 and "filesystem" in json.loads(body)["error"]


@pytest.mark.parametrize("endpoint", ["convert", "apply"])
def test_paths_inside_arguments_are_refused(server, tmp_path, endpoint):
    """A path that an allowed option's argument names (a ``-draw`` font)
    passes the validators but not ``no_host_files``: 400, nothing
    opened."""
    font = tmp_path / "x.ttf"
    font.write_bytes(b"not a font")
    args = f"-draw \"font '{font}' text 2,10 'a'\""
    if endpoint == "convert":
        status, body = _call(server, "POST", f"/convert?args={quote(args)}",
                             _png(_pixels(27, n=1)[0]))
    else:
        _store(server, "paths", _pixels(27).tobytes())
        status, body = _apply(server, "paths", args)
    assert status == 400
    assert "no file of the host" in json.loads(body)["error"]


def test_convert_runs_the_list_options(server):
    """The options that ``process`` runs itself pass the validator with
    the arguments ``process`` takes (``option_arity``): the JAX validator
    refuses them as unknown."""
    args = ("-label x -repage 0x0+0+0 -clone 0 -delete 0 -swap 0,0 -strip "
            "+repage -comment y -flip")
    body = _png(_pixels(28, n=1)[0])
    status, out = _call(server, "POST",
                        f"/convert?args={quote(args)}&of=ppm", body)
    assert status == 200
    assert out == js._run_cli(["-", "-flip", "ppm:-"], body)
    with pytest.raises(ValueError):
        js.validate_convert_args(args.split())


@pytest.mark.parametrize("of", ["../x", "mpr", "1x"])
def test_convert_of_must_be_a_word(server, of):
    """``of`` is a word that starts with a letter and is not ``mpr`` (an
    entry there would outlive the request)."""
    status, _ = _call(server, "POST", f"/convert?args=-flip&of={quote(of)}",
                      _png(_pixels(24, n=1)[0]))
    assert status == 400


def test_replies_go_out_without_waiting_on_delayed_acks(server):
    """The port's handler sets TCP_NODELAY: a reply's body goes out with
    its headers instead of waiting on the client's delayed ACK.  The JAX
    handler leaves Nagle's algorithm on."""
    assert ts.Handler.disable_nagle_algorithm
    assert not js.Handler.disable_nagle_algorithm
    body = _png(_pixels(25, n=1)[0])
    status, _ = _call(server, "POST", "/convert?args=-flip&of=png", body)
    assert status == 200


def _miff(seed) -> bytes:
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage

    img = TImage(_pixels(seed, n=1)[0].astype(np.float32) / 255.0,
                 device="cpu")
    return tio.image_to_blob(img, "miff")


@pytest.mark.parametrize("args,of", [
    ("-resize 32x32! -gaussian-blur 0x2 -colorspace gray", "exr"),
    ("-flip -negate", "exr"), ("-flop", "miff"), ("-rotate 90", "ff")])
def test_convert_of_a_miff_body_answers_the_cli_bytes(server, args, of):
    """A MIFF request body converted to EXR, MIFF or farbfeld: the
    server's bytes are the port's CLI run on the CPU, and, for the chains
    without a fused resize, the JAX server's."""
    body = _miff(40)
    status, got = _call(server, "POST",
                        f"/convert?args={quote(args)}&of={of}", body)
    assert status == 200, got
    assert got == ts._run_cli(["-", *args.split(), f"{of}:-"], body, "cpu")
    if "resize" not in args:
        assert got == js._run_cli(["-", *args.split(), f"{of}:-"], body)


@pytest.mark.parametrize("args,of", [
    ("-flip -negate", "dpx"), ("-resize 32x32! -colorspace gray", "dpx"),
    ("-flop", "g4"), ("-rotate 90", "pict")])
def test_convert_of_a_dpx_body_answers_the_cli_bytes(server, args, of):
    """A 10-bit DPX request body converted to DPX, G4 or PICT: the
    server's bytes are the port's CLI run on the CPU, and, for the chains
    without a fused resize, the JAX server's."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage

    body = tio.image_to_blob(TImage(_pixels(42, n=1)[0].astype(np.float32)
                                    / 255.0, device="cpu"), "dpx", depth=16)
    status, got = _call(server, "POST",
                        f"/convert?args={quote(args)}&of={of}", body)
    assert status == 200, got
    assert got == ts._run_cli(["-", *args.split(), f"{of}:-"], body, "cpu")
    if "resize" not in args:
        assert got == js._run_cli(["-", *args.split(), f"{of}:-"], body)


@pytest.mark.parametrize("of", ["mpc", "mp4", "webm", "mpr", "dmr"])
def test_convert_refuses_outputs_that_reach_the_host(server, of):
    """mpc: and dmr: write files of the host and the video formats run
    ffmpeg: 400 before the request runs, and no_host_files refuses them
    again where they are reached."""
    status, body = _call(server, "POST", f"/convert?args=-flip&of={of}",
                         _miff(41))
    assert status == 400 and "bad output format" in json.loads(body)["error"]


def _metafile_or_hdr(kind: str) -> bytes:
    """A request body: an EMF or WMF of a few shapes, an HDR of the seed's
    pixels, or an RGBA MIFF that carries an IPTC profile."""
    import struct

    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec as TSpec

    px = _pixels(45, n=1)[0].astype(np.float32) / 255.0
    if kind == "hdr":
        return tio.image_to_blob(TImage(px * 4.0, device="cpu"), "hdr")
    if kind == "miff-rgba":
        rgba = np.concatenate([px, px[..., :1]], -1)
        blob = tio.image_to_blob(TImage(rgba, TSpec(alpha=True),
                                        device="cpu"), "miff")
        iptc = b"\x1c\x02\x05" + struct.pack(">H", 4) + b"Rose"
        head, sep, rest = blob.partition(b"\x0c\n:\x1a")
        return (head + b"profile=iptc\n" + sep +
                struct.pack(">I", len(iptc)) + iptc + rest)
    if kind == "wmf":
        def rec(func, *p):
            return struct.pack("<IH%dh" % len(p), 3 + len(p), func, *p)
        recs = (rec(0x020C, 40, 60) + rec(0x02FC, 0, 0x00FF, 0) +
                rec(0x012D, 0) + rec(0x041B, 30, 50, 5, 5) +
                rec(0x0418, 38, 58, 20, 20) + rec(0))
        return (struct.pack("<IH4hH", 0x9AC6CDD7, 0, 0, 0, 60, 40, 72) +
                struct.pack("<IH", 0, 0) +
                struct.pack("<HHHIHIH", 1, 9, 0x300, (18 + len(recs)) // 2,
                            1, 0, 0) + recs)

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
    return struct.pack("<II", 1, 8 + len(head)) + head + body


@pytest.mark.parametrize("kind,args,of", [
    ("emf", "-flip", "png"), ("wmf", "-negate", "ppm"),
    ("hdr", "-flop", "hdr"), ("emf", "-flip", "hdr"),
    ("wmf", "-flop", "debug"), ("miff-rgba", "-flip", "matte"),
    ("emf", "-flip", "strimg"), ("miff-rgba", "-flop", "iptctext")])
def test_convert_of_metafile_and_hdr_bodies_answers_the_cli_bytes(
        server, kind, args, of):
    """A WMF, EMF, HDR or MIFF request body converted to PNG, PPM, HDR,
    DEBUG, MATTE, STRIMG or IPTCTEXT: the server's bytes are the port's
    CLI run on the CPU and the JAX server's."""
    body = _metafile_or_hdr(kind)
    status, got = _call(server, "POST",
                        f"/convert?args={quote(args)}&of={of}", body)
    assert status == 200, got
    argv = ["-", *args.split(), f"{of}:-"]
    assert got == ts._run_cli(argv, body, "cpu") == js._run_cli(argv, body)


@pytest.mark.parametrize("body", [b"%PDF-1.4\n", b"%!PS-Adobe-3.0\n"])
@pytest.mark.parametrize("path", ["/convert?args=-flip", "/identify"])
def test_delegate_bodies_are_refused(server, body, path, monkeypatch):
    """A body that only a delegate reads (ghostscript here) is refused
    before the program is looked for, even where it is installed."""
    from imagemagick_tpu_torch.io import delegates as tdel

    monkeypatch.setattr(tdel, "_which", lambda *n: "/bin/true")
    status, out = _call(server, "POST", path, body)
    assert status == 400
    assert "no program of the host" in json.loads(out)["error"]


def _tiff48(seed: int) -> bytes:
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.image import Image as TImage
    from imagemagick_tpu_torch.core.spec import ImageSpec

    px = _pixels(seed, n=1)[0].astype(np.float32) / 255.0
    return tio.image_to_blob(TImage(px, ImageSpec(depth=16), device="cpu"),
                             "tiff", depth=16)


@pytest.mark.parametrize("args,of", [
    ("-depth 16 -flip", "tiff"), ("-flop", "vips"), ("-negate", "cals"),
    ("-flip", "xwd"), ("-flip", "braille"), ("-rotate 90", "aai"),
    ("-flip", "wpg")])
def test_convert_of_a_deep_tiff_body_answers_the_cli_bytes(server, args, of):
    """A 48-bit TIFF request body (the native deep reader's) converted to
    a 16-bit TIFF (the native deep writer's) and to formats4's writers:
    the server's bytes are the port's CLI run on the CPU and, but for
    WPG's k-means (ROADMAP.md Queue 3), the JAX server's."""
    body = _tiff48(43)
    status, got = _call(server, "POST",
                        f"/convert?args={quote(args)}&of={of}", body)
    assert status == 200, got
    assert got == ts._run_cli(["-", *args.split(), f"{of}:-"], body, "cpu")
    if of != "wpg":
        assert got == js._run_cli(["-", *args.split(), f"{of}:-"], body)


@pytest.mark.parametrize("line", [
    "image over 0,0 10,10 '{f}'", "font '{f}'\ntext 2,10 'a'"])
def test_mvg_body_naming_a_host_file_is_refused(server, tmp_path, line):
    """An MVG body has no magic, so /convert cannot take it for one (400);
    read as MVG inside no_host_files, as the daemon runs each request, an
    image primitive or a font that names a host file is refused."""
    from imagemagick_tpu_torch import io as tio
    from imagemagick_tpu_torch.core.policy import PolicyError, no_host_files

    host = tmp_path / "x.png"
    host.write_bytes(_png(_pixels(44, n=1)[0]))
    body = ("viewbox 0 0 20 20\nfill 'red'\nrectangle 2,2 9,9\n"
            + line.format(f=host) + "\n").encode()
    status, out = _call(server, "POST", "/convert?args=-flip", body)
    assert status == 400
    with no_host_files():
        with pytest.raises(PolicyError, match="no file of the host"):
            tio.image_from_blob(body, "mvg", device="cpu")
