"""Port parity: the Magick++ layer (``native/magickpp``) against the JAX
package's.

``tests/magickpp_demo.cpp``, unchanged, is built twice: against the JAX
library, compiled here from its sources into this test's own directory
with the JAX ``build.py``'s flags (the JAX ``build()`` writes in place,
where ``tests/test_magickpp.py`` may build on another worker), and
against the port's library for the CPU (``compile_program(...,
device="cpu")``, i.e. ``-DMAGICKPP_DEVICE="cpu"``).  Both print 80
``key=value`` lines (integers, short strings, one-decimal numbers): they
must be equal, every one.  The port's run has a ``PYTHONPATH`` whose
``imagemagick_tpu`` package raises on import first, so it shows that the
library imports nothing of the JAX package.  The default build (the
card) fails here with torch's CUDA error and a nonzero exit, running
nothing on the CPU; on a machine with a card it prints the CPU build's
keys.
"""

import os
import shutil
import subprocess
import sys
import sysconfig
from pathlib import Path

import pytest
import torch

from imagemagick_tpu.native.magickpp import build as jbuild
from imagemagick_tpu_torch.native.magickpp import build

REPO = Path(__file__).resolve().parent.parent
DEMO = REPO / "tests" / "magickpp_demo.cpp"
JAX_DIR = REPO / "imagemagick_tpu" / "native" / "magickpp"

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ unavailable")


def _keys(stdout: str) -> dict:
    return dict(line.split("=", 1) for line in stdout.splitlines()
                if "=" in line)


def _run(exe, outdir, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run([str(exe), str(outdir)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=str(outdir))


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The demo against the JAX library, built with the JAX build.py's
    commands (``build.py:53-55``, ``:67-69``) into this test's directory."""
    tmp = tmp_path_factory.mktemp("jax_magickpp")
    inc = sysconfig.get_path("include")
    lib = tmp / "libmagickpp_tpu.so"
    for cmd in (["g++", "-O1", "-fPIC", "-shared", "-std=c++11",
                 str(JAX_DIR / "magickpp.cpp"), f"-I{inc}", f"-I{JAX_DIR}"]
                + jbuild._py_link_flags() + ["-o", str(lib)],
                ["g++", "-O0", "-std=c++11", str(DEMO), f"-I{JAX_DIR}",
                 f"-I{inc}", f"-L{tmp}", "-lmagickpp_tpu",
                 f"-Wl,-rpath,{tmp}"] + jbuild._py_link_flags()
                + ["-o", str(tmp / "demo")]):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
    out = tmp / "out"
    out.mkdir()
    r = _run(tmp / "demo", out, {"JAX_PLATFORMS": "cpu",
                                  "PYTHONPATH": str(REPO)})
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return _keys(r.stdout)


@pytest.fixture(scope="module")
def poisoned(tmp_path_factory):
    """A directory whose ``imagemagick_tpu`` package raises on import."""
    root = tmp_path_factory.mktemp("poisoned")
    pkg = root / "imagemagick_tpu"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "raise ImportError('the JAX package was imported')\n")
    return root


@pytest.fixture(scope="module")
def port_run(tmp_path_factory, poisoned):
    tmp = tmp_path_factory.mktemp("port_magickpp")
    exe = build.compile_program(str(DEMO), str(tmp / "demo"), device="cpu")
    out = tmp / "out"
    out.mkdir()
    r = _run(exe, out, {"PYTHONPATH": f"{poisoned}{os.pathsep}{REPO}"})
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    return _keys(r.stdout), out


def test_demo_prints_the_jax_keys(jax_keys, port_run):
    keys, _ = port_run
    assert len(jax_keys) == 80
    assert keys == jax_keys


def test_demo_writes_its_files_on_the_cpu_build(port_run):
    _, out = port_run
    assert (out / "magickpp_demo.png").exists()
    assert (out / "seq.miff").exists()


def test_poisoned_path_raises_for_the_jax_package(poisoned):
    """The poisoned ``PYTHONPATH`` of the port's run does hide the JAX
    package: importing it there fails."""
    env = dict(os.environ, PYTHONPATH=f"{poisoned}{os.pathsep}{REPO}")
    r = subprocess.run([sys.executable, "-c", "import imagemagick_tpu"],
                       capture_output=True, text=True, env=env, timeout=120,
                       cwd=str(poisoned))
    assert r.returncode != 0 and "the JAX package was imported" in r.stderr


def test_default_build_runs_on_the_card_or_fails(tmp_path, port_run):
    """Built without a device, the demo asks InitializeMagick for "cuda":
    without a card it throws Magick::Error with torch's CUDA error, prints
    no key and exits nonzero; with one it prints the CPU build's keys."""
    exe = build.compile_program(str(DEMO), str(tmp_path / "demo"))
    r = _run(exe, tmp_path, {"PYTHONPATH": str(REPO)})
    if torch.cuda.is_available():
        assert r.returncode == 0, r.stderr
        assert _keys(r.stdout) == port_run[0]
    else:
        assert r.returncode != 0
        assert r.stdout == ""
        assert "MagickException: Magick++/torch:" in r.stderr
        assert "CUDA" in r.stderr


def test_library_is_built_once_under_its_hash():
    """``build()`` names the library by a hash of its sources and command
    under ``_build/`` and leaves no temporary file behind."""
    path = Path(build.build())
    assert path == build.library_path()
    assert path.parent == REPO / "imagemagick_tpu_torch" / "_build"
    assert path.name.startswith("libmagickpp_") and path.exists()
    assert build.build() == str(path)
    assert not list(path.parent.glob(f"{path.stem}.*.tmp"))


def test_failed_builds_raise_with_the_compiler_text(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("#include <Magick++.h>\nint main() { return nope; }\n")
    with pytest.raises(RuntimeError, match="program build failed") as e:
        build.compile_program(str(bad), str(tmp_path / "bad"))
    assert "nope" in str(e.value)
    monkeypatch.setattr(build, "_OUT", tmp_path / "_build")
    monkeypatch.setattr(build, "_command",
                        lambda: ["g++", "-fPIC", "-shared",
                                 str(tmp_path / "missing.cpp")])
    with pytest.raises(RuntimeError, match="magickpp build failed") as e:
        build.build()
    assert "missing.cpp" in str(e.value)
    assert not list((tmp_path / "_build").glob("*"))
