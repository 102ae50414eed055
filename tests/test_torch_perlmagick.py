"""Port parity: PerlMagick through the port's Perl module
(``imagemagick_tpu_torch/bindings/perl/Image/Magick.pm``) and its server
(``wand/rpc_server.py``) against the JAX package's.

The Perl scripts of ``tests/test_perlmagick.py`` (read from its source)
run against both modules: the JAX one as its test runs them, the port's
with ``$Image::Magick::Device = 'cpu'`` set after ``use Image::Magick``.
Their standard outputs must be equal.  The port's runs import Python
with ``PYTHONPROFILEIMPORTTIME``, whose log shows that no module of the
JAX package is imported.  The same JSON request lines go to both
servers' ``serve`` in this process; their replies must be equal, the
tracebacks of error replies left out.  Without a card, the port's
module with its default device ('cuda') and the server started without
``--device`` exit nonzero with the CUDA error, running nothing on the CPU.
"""

import ast
import io
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from imagemagick_tpu.wand import rpc_server as jrpc
from imagemagick_tpu_torch.wand import rpc_server as trpc

REPO = Path(__file__).resolve().parent.parent
JAX_PERL = REPO / "bindings" / "perl"
PORT_PERL = REPO / "imagemagick_tpu_torch" / "bindings" / "perl"

pytestmark = pytest.mark.skipif(shutil.which("perl") is None,
                                reason="perl unavailable")


def _jax_scripts():
    """The scripts that tests/test_perlmagick.py hands to run_perl."""
    tree = ast.parse((REPO / "tests" / "test_perlmagick.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "id", "") == "run_perl":
                out[fn.name] = node.args[0].value
    return out


SCRIPTS = _jax_scripts()


def _perl(script: str, libdir: Path, cwd: Path, env_extra=None):
    env = dict(os.environ, IMTPU_PYTHON=sys.executable,
               PYTHONPATH=str(REPO) + os.pathsep +
               os.environ.get("PYTHONPATH", ""), **(env_extra or {}))
    path = cwd / "script.pl"
    path.write_text(script)
    return subprocess.run(["perl", f"-I{libdir}", str(path)],
                          capture_output=True, text=True, timeout=600,
                          env=env, cwd=str(cwd))


def _on(script: str, device: str) -> str:
    return script.replace("use Image::Magick;\n",
                          "use Image::Magick;\n"
                          f"$Image::Magick::Device = '{device}';\n", 1)


def _jax_imports(stderr: str) -> list:
    """Modules of the JAX package in an import-time log."""
    return [ln for ln in stderr.splitlines() if ln.startswith("import time")
            and re.search(r"\|\s*imagemagick_tpu(\.|$)", ln)]


def test_scripts_are_found():
    assert set(SCRIPTS) == {"test_pipeline_and_attributes",
                            "test_error_convention",
                            "test_composite_clone_compare",
                            "test_draw_annotate_effects"}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_prints_as_jax(name, tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    rj = _perl(SCRIPTS[name], JAX_PERL, tmp_path / "j",
               {"JAX_PLATFORMS": "cpu"})
    assert rj.returncode == 0, rj.stderr
    rt = _perl(_on(SCRIPTS[name], "cpu"), PORT_PERL, tmp_path / "t",
               {"PYTHONPROFILEIMPORTTIME": "1"})
    assert rt.returncode == 0, rt.stderr
    assert rt.stdout == rj.stdout
    assert re.search(r"\|\s*imagemagick_tpu_torch\.wand\.perl_compat$",
                     rt.stderr, re.M)
    assert _jax_imports(rt.stderr) == []
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())


def test_written_file_equals_jax(tmp_path):
    """The pipeline script's out.png decodes to the same samples."""
    import numpy as np
    from PIL import Image as P

    script = SCRIPTS["test_pipeline_and_attributes"].replace(
        "out.png", "out.ppm")
    for side, lib, dev in (("j", JAX_PERL, None), ("t", PORT_PERL, "cpu")):
        (tmp_path / side).mkdir()
        r = _perl(_on(script, dev) if dev else script, lib, tmp_path / side,
                  {"JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
    a = np.asarray(P.open(tmp_path / "j" / "out.ppm"))
    b = np.asarray(P.open(tmp_path / "t" / "out.ppm"))
    assert a.shape == b.shape == (16, 32, 3)
    # Resize and Blur: the port's fused route against the JAX op route,
    # >= 60 dB apart as floats: 8-bit samples at most one level apart
    assert int(np.abs(a.astype(int) - b).max()) <= 1


def test_default_device_is_the_card(tmp_path):
    """Without ``$Image::Magick::Device`` the server starts on 'cuda':
    without a card it exits at start and the script dies nonzero; with
    one the script runs there."""
    script = "use Image::Magick;\nmy $i = Image::Magick->new;\n" \
        "print 'made=', ref($i), \"\\n\";\n"
    r = _perl(script, PORT_PERL, tmp_path)
    if torch.cuda.is_available():
        assert r.returncode == 0 and "made=Image::Magick" in r.stdout
    else:
        assert r.returncode != 0 and "made=" not in r.stdout
        assert "CUDA" in r.stderr and "rpc server closed the pipe" in \
            r.stderr


def test_server_without_a_device_needs_a_card(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "imagemagick_tpu_torch.wand.rpc_server"],
        input='{"id": 1, "op": "ping"}\n', capture_output=True, text=True,
        timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    if torch.cuda.is_available():
        assert json.loads(r.stdout) == {"id": 1, "result": "pong"}
    else:
        assert r.returncode != 0 and r.stdout == ""
        assert "no CUDA card" in r.stderr


def test_server_on_the_cpu_answers_from_the_command_line(tmp_path):
    reqs = [{"id": 1, "op": "new"},
            {"id": 2, "op": "call", "wand": 1, "method": "read_image",
             "args": ["gradient:black-white"]},
            {"id": 3, "op": "get", "wand": 1, "attrs": ["width"]},
            {"id": 4, "op": "quit"}]
    r = subprocess.run(
        [sys.executable, "-m", "imagemagick_tpu_torch.wand.rpc_server",
         "--device", "cpu"],
        input="".join(json.dumps(q) + "\n" for q in reqs),
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr
    assert [json.loads(ln) for ln in r.stdout.splitlines()] == \
        [{"id": 1, "result": {"wand": 1}}, {"id": 2, "result": None},
         {"id": 3, "result": [256]}, {"id": 4, "result": None}]


def _session(tmp):
    """Request lines that reach every op of the protocol, each kind of
    return value, the PerlMagick dispatch and its errors.  The pixels
    come from ops that both packages compute bit for bit (Sample, not
    Resize, whose port runs K1 where the JAX wand runs the op)."""
    src = str(tmp / "in.ppm")
    return [
        {"id": 1, "op": "new"},
        {"id": 2, "op": "call", "wand": 1, "method": "read_image",
         "args": ["gradient:black-white"]},
        {"id": 3, "op": "pm", "wand": 1, "method": "Sample",
         "kwargs": {"geometry": "8x4!"}},
        {"id": 4, "op": "get", "wand": 1, "attrs": ["width", "height"]},
        {"id": 5, "op": "pm", "wand": 1, "method": "Bogus", "kwargs": {}},
        {"id": 6, "op": "call", "wand": 1, "method": "get_image_range"},
        {"id": 7, "op": "call", "wand": 1, "method": "get_image_signature"},
        {"id": 8, "op": "call", "wand": 1, "method": "export_image_pixels",
         "args": [0, 0, 3, 2, "RGB", "char"]},
        {"id": 9, "op": "call", "wand": 1, "method": "export_image_pixels",
         "args": [0, 0, 1, 1, "R", "double"]},
        {"id": 10, "op": "call", "wand": 1, "method": "get_image_histogram"},
        {"id": 11, "op": "clone", "wand": 1},
        {"id": 12, "op": "pm", "wand": 2, "method": "Negate", "kwargs": {}},
        {"id": 13, "op": "pm", "wand": 1, "method": "Compare",
         "kwargs": {"image": 2, "metric": "rmse"}},
        {"id": 14, "op": "set", "wand": 1, "attrs": {"quality": 70}},
        {"id": 15, "op": "get", "wand": 1,
         "attrs": ["quality", "pixel[2,1]", "colorspace", "signature"]},
        {"id": 16, "op": "pm", "wand": 1, "method": "Append",
         "kwargs": {"stack": 0}},
        {"id": 17, "op": "call", "wand": 1, "method": "write_image",
         "args": [src]},
        {"id": 18, "op": "call", "wand": 1, "method": "get_image_blob",
         "args": ["ppm"]},
        {"id": 19, "op": "call", "wand": 1, "method": "clone"},
        {"id": 20, "op": "call", "wand": 1, "method": "resize_image",
         "args": [4, 2]},
        {"id": 21, "op": "call", "wand": 99, "method": "resize_image"},
        {"id": 22, "op": "ping"},
        {"id": 23, "op": "nope"},
        {"id": 24, "op": "pm", "wand": 1, "method": "Read",
         "kwargs": {"filename": "/nonexistent/nope.png"}},
        {"id": 25, "op": "destroy", "wand": 2},
        {"id": 26, "op": "pm", "wand": 2, "method": "Negate", "kwargs": {}},
        {"id": 27, "op": "quit"},
        {"id": 28, "op": "ping"},
    ]


def _replies(serve, lines, **kw):
    out = io.StringIO()
    serve(io.StringIO(lines), out, **kw)
    resps = [json.loads(ln) for ln in out.getvalue().splitlines()]
    for r in resps:
        r.pop("trace", None)
    return resps


def test_same_requests_get_the_jax_replies(tmp_path):
    lines = "".join(json.dumps(q) + "\n" for q in _session(tmp_path))
    lines = lines.replace('{"id": 5,', 'not json\n\n{"id": 5,')
    want = _replies(jrpc.serve, lines)
    got = _replies(trpc.serve, lines, device="cpu")
    assert len(want) == 27          # up to quit; the bad line is skipped
    assert got == want
    assert "not supported" in got[4]["error"]


def test_serve_puts_new_wands_on_its_device():
    from imagemagick_tpu_torch.wand import api as ta

    made = []
    real = ta.MagickWand

    class Spy(real):
        def __init__(self, device="cuda"):
            super().__init__(device)
            made.append(self.device)

    lines = json.dumps({"id": 1, "op": "new"}) + "\n"
    try:
        ta.MagickWand = Spy
        _replies(trpc.serve, lines, device="cpu")
    finally:
        ta.MagickWand = real
    assert [d.type for d in made] == ["cpu"]


def test_jsonable_reads_tensors_as_jax_reads_arrays():
    import numpy as np
    import jax.numpy as jnp

    for v in (np.float32(0.25), np.arange(6, dtype=np.float32) / 7,
              np.array([[1, 2], [3, 4]], np.uint8),
              np.array([0.5], np.float32), np.array(True), np.int32(3)):
        t = torch.from_numpy(np.asarray(v))
        assert trpc._jsonable(t) == jrpc._jsonable(jnp.asarray(v))
        assert trpc._jsonable([t, {"k": t}]) == \
            jrpc._jsonable([jnp.asarray(v), {"k": jnp.asarray(v)}])
