"""Serving daemon: file conversions and device-resident batch sessions
over HTTP.

Port of ``imagemagick_tpu/serve.py``.  ``/convert`` runs the CLI in
process on the request's bytes, with stdin and stdout swapped for byte
buffers: the body is decoded on the host, goes to the server's device
once, runs the option chain there (a chain that K1 covers as one K1
launch, ``LazyImage.materialize`` -> ``dispatch.try_fused_chain``), and
comes back to the host to be encoded.  ``/convert`` and ``/identify``
run under one lock, as in the JAX server, since the readers' settings
and the ``mpr:`` registry are module globals.  A session holds an
(N, H, W, C) float32 tensor on the server's device; ``/apply`` runs a CLI
option chain on the whole batch and keeps the result on the device, so
repeated applies pay no host<->device transfer.  A chain that K1 covers
runs as ONE K1 launch over the batch (``dispatch.try_fused_batch_array``,
``path == "fused-batch"``); its kernel tags are found once per (args,
shape) by interpreting the options over one image, then cached.  Any
other chain runs per image through the CLI's ``materialize_all``.

Endpoints (stdlib http.server; no external dependencies):

  GET  /healthz                  -> {"ok": true, "platform": "...",
                                     "devices": N}
  GET  /formats                  -> {"read": [...], "write": [...]}: what
                                    the port reads and writes
  POST /convert?args=...&of=png  -> body: image bytes; ``args`` a
                                    shell-style option string; ``of`` the
                                    output format
  POST /identify                 -> body: image bytes -> verbose identify
                                    text
  POST /session/<name>           -> body: raw pixels, headers
                                    X-Shape: N,H,W,C and X-Dtype: u8|f32
  POST /session/<name>/apply?args=...&keep=0|1
                                 -> runs the options on the session
  GET  /session/<name>           -> the session's pixels as u8 bytes

No request reaches the host's files or runs a program of the host:
``/convert`` refuses bare tokens (file names), the options that read or
write paths and the output formats ``mpr``, ``mpc``, ``dmr`` and video
(400), as does ``/apply``, and ``/convert``, ``/apply`` and ``/identify``
run under ``core.policy.no_host_files``, so that a path that an option's
argument names anyway (a ``-draw`` font, say) is refused (400) before it
is opened, and a body that only a delegate reads (PDF, PostScript, a raw
that dcraw would take) is refused before the delegate runs.  ``-bench``,
which would run a request's work N times, is an unknown option there,
as in the JAX server.  A bad request answers 400; an error of the server
or the card (a kernel's), 500.

Run:  python -m imagemagick_tpu_torch.serve [--port 8089] [--device cuda]
"""

from __future__ import annotations

import io
import json
import shlex
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .core.policy import PolicyError, no_host_files
from .io import _VIDEO_FMTS

_LOCK = threading.Lock()


class _Stdin:
    """sys.stdin stand-in exposing only .buffer (what the CLI uses)."""

    def __init__(self, data: bytes):
        self.buffer = io.BytesIO(data)


class _Stdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):        # text writes (identify and friends)
        self.buffer.write(s.encode() if isinstance(s, str) else s)

    def flush(self):
        pass


def _run_cli(argv, body: bytes, device="cuda") -> bytes:
    """Run the in-process CLI on ``device`` with stdio redirected to byte
    buffers."""
    from .cli.main import main as cli_main

    old_in, old_out = sys.stdin, sys.stdout
    sin, sout = _Stdin(body), _Stdout()
    try:
        sys.stdin, sys.stdout = sin, sout
        rc = cli_main(argv, device=device)
    finally:
        sys.stdin, sys.stdout = old_in, old_out
    if rc != 0:
        raise ValueError("command failed with exit code %d" % rc)
    return sout.buffer.getvalue()


_MIME = {"png": "image/png", "jpeg": "image/jpeg", "jpg": "image/jpeg",
         "gif": "image/gif", "webp": "image/webp", "tiff": "image/tiff",
         "bmp": "image/bmp", "miff": "application/octet-stream"}

# Options that touch the host's files (read or write paths, or take their
# argument for one) or the process's global state (-limit, -debug): a
# client that can reach the port must get neither (policy.xml's "path"
# domain).  The JAX server's list, with -read, -remap and its alias
# -affinity, -font, -limit and -debug added.
_DENY_OPTS = {
    "write", "script", "texture", "profile", "map", "clip-mask", "mask",
    "read-mask", "write-mask", "encipher", "decipher", "passphrase",
    "authenticate", "process", "display", "log",
    "read", "remap", "affinity", "font", "limit", "debug",
}


# output formats that a request may not name: mpr: outlives the request,
# mpc: and dmr: write files of the host, a video format runs ffmpeg
# (no_host_files refuses the last three again where they are reached)
_HOST_OF = {"mpr", "mpc", "dmr"} | _VIDEO_FMTS


# options the CLI runs that a request may not name, refused as unknown
# (the JAX validator does not know them)
_UNKNOWN_OPTS = {"bench"}


def _check_args(args, where: str) -> None:
    """Walk an option list as the CLI's ``process`` does
    (``option_arity``): bare tokens (file names), denied options, unknown
    options and missing arguments raise ValueError."""
    from .cli import main as climain

    i = 0
    while i < len(args):
        tok = args[i]
        i += 1
        if tok in ("(", ")"):
            continue
        if not tok.startswith(("-", "+")) or tok == "-":
            raise ValueError(
                "filename arguments are not allowed via %s: %r" % (where, tok))
        if tok[1:] in _DENY_OPTS:
            raise ValueError("option %r is not allowed via %s "
                             "(filesystem access)" % (tok, where))
        n = None if tok[1:] in _UNKNOWN_OPTS else \
            climain.option_arity(tok, args, i)
        if n is None:
            raise ValueError("unknown option %r" % tok)
        if i + n > len(args):
            raise ValueError("missing argument for %r" % tok)
        i += n


def validate_convert_args(args):
    """Reject /convert option lists that name files, options that read or
    write paths, or unknown options (ValueError).  Allowed: parentheses
    and the CLI's other options and settings with their arguments."""
    _check_args(args, "/convert")


def validate_args(args):
    """As ``validate_convert_args``, for /apply (the JAX server checks
    /apply with its /convert validator): a setting runs, and leaves the
    session as it was."""
    _check_args(args, "/apply")


# name -> (N, H, W, C) float32 tensor on the server's device
_SESSIONS: dict = {}
# (args, shape) -> kernel tags (None = chain not kernel-expressible)
_TAG_CACHE: dict = {}


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _session_store(name: str, body: bytes, shape, dtype: str,
                   device="cuda"):
    """Store raw pixels as session ``name`` on ``device``.  u8 pixels go
    up as bytes, from pinned host memory on a card, and are scaled to
    [0, 1] there."""
    device = torch.device(device)
    n, h, w, c = shape
    if dtype == "u8":
        src, tdtype = np.frombuffer(body, np.uint8), torch.uint8
    elif dtype == "f32":
        src, tdtype = np.frombuffer(body, "<f4"), torch.float32
    else:
        raise ValueError("X-Dtype must be u8 or f32")
    if src.size != n * h * w * c:
        raise ValueError("payload size does not match X-Shape")
    host = torch.empty(src.size, dtype=tdtype,
                       pin_memory=device.type == "cuda")
    host.numpy()[:] = src
    dev = host.to(device).reshape(n, h, w, c)
    if tdtype == torch.uint8:
        dev = dev.to(torch.float32) / 255.0
    _SESSIONS[name] = dev
    return {"session": name, "shape": [n, h, w, c], "platform": device.type}


def _session_apply(name: str, args, keep: bool = False):
    from .cli import main as climain
    from .core.image import Image
    from .core.spec import ImageSpec
    from .ops import dispatch as _dsp

    dev = _SESSIONS.get(name)
    if dev is None:
        raise KeyError("no such session %r" % name)
    t0 = time.perf_counter()
    # Probe: interpret the options over ONE image to collect the lazy
    # chain's kernel tags, cached per (args, shape).  A fully tagged
    # chain runs over the resident batch as one K1 launch.
    new = None
    path = "general"
    ck = (tuple(args), tuple(map(int, dev.shape)))
    tags = _TAG_CACHE.get(ck, False)
    if tags is False:
        probe = dev[0]
        st = climain.CLIState()
        st.images.append(climain.LazyImage(
            Image(probe, ImageSpec(colorspace="srgb"))))
        climain.process(list(args), st)
        tags = None
        if len(st.images) == 1 and st.images[0].image.data is probe:
            li = st.images[0]
            ptags = [t for _, _, t in li.pending]
            if li.pending and all(t is not None for t in ptags):
                tags = ptags
        _TAG_CACHE[ck] = tags
    if tags is not None:
        out = _dsp.try_fused_batch_array(dev, tags)
        if out is not None:
            new = out
            path = "fused-batch"
    if new is None:
        st = climain.CLIState()
        for i in range(dev.shape[0]):
            st.images.append(climain.LazyImage(
                Image(dev[i], ImageSpec(colorspace="srgb"))))
        climain.process(list(args), st)
        new = torch.stack([o.data for o in climain.materialize_all(
            st.images)])
    _sync(new)
    if not keep:
        _SESSIONS[name] = new
    dt = time.perf_counter() - t0
    mp = dev.shape[0] * dev.shape[1] * dev.shape[2] / 1e6
    return {"session": name, "shape": list(map(int, new.shape)),
            "seconds": round(dt, 5), "path": path,
            "megapixels_per_sec": round(mp / dt, 1) if dt > 0 else 0.0}


def _session_fetch(name: str) -> bytes:
    dev = _SESSIONS.get(name)
    if dev is None:
        raise KeyError("no such session %r" % name)
    return clip_u8(dev).cpu().numpy().tobytes()


def clip_u8(dev: torch.Tensor) -> torch.Tensor:
    return (dev.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class Handler(BaseHTTPRequestHandler):
    server_version = "imagemagick-tpu-torch/0.1"
    # TCP_NODELAY: without it a reply's body, written after its headers,
    # waits on the client's delayed ACK of them
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):   # quiet by default
        if self.server.verbose:          # type: ignore[attr-defined]
            sys.stderr.write(fmt % args + "\n")

    def _reply(self, code, body: bytes, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _err(self, code, msg):
        self._reply(code, json.dumps({"error": msg}).encode())

    def do_GET(self):
        url = urlparse(self.path)
        device = self.server.device      # type: ignore[attr-defined]
        if url.path.startswith("/session/"):
            try:
                raw = _session_fetch(url.path[len("/session/"):])
            except KeyError as exc:
                return self._err(404, str(exc))
            return self._reply(200, raw, "application/octet-stream")
        if url.path == "/healthz":
            count = torch.cuda.device_count() if device.type == "cuda" \
                else 1
            self._reply(200, json.dumps({"ok": True, "platform": device.type,
                                         "devices": count}).encode())
        elif url.path == "/formats":
            from . import io as iio

            self._reply(200, json.dumps(
                {"read": iio.supported_read_formats(),
                 "write": iio.supported_write_formats()}).encode())
        else:
            self._err(404, "unknown path %s" % url.path)

    def do_POST(self):
        from .cli import main as climain

        url = urlparse(self.path)
        q = parse_qs(url.query)
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length)
        device = self.server.device      # type: ignore[attr-defined]
        if not body and not url.path.endswith("/apply"):
            return self._err(400, "empty body")
        try:
            if url.path == "/convert":
                args = shlex.split(q.get("args", [""])[0])
                of = q.get("of", ["png"])[0].lower()
                validate_convert_args(args)
                # a word that starts with a letter, so that no option
                # takes "<of>:-" for its argument, and none of _HOST_OF
                if not (of.isalnum() and of[0].isalpha()) or \
                        of in _HOST_OF:
                    return self._err(400, "bad output format %r" % of)
                with _LOCK, no_host_files():
                    out = _run_cli(["-", *args, f"{of}:-"], body, device)
                self._reply(200, out, _MIME.get(of,
                                                "application/octet-stream"))
            elif url.path == "/identify":
                from . import io as iio
                from .io import identify as ident

                with _LOCK, no_host_files():
                    img = iio.image_from_blob(body, device=device)[0]
                    text = ident.describe(img, "request", verbose=True)
                self._reply(200, text.encode(), "text/plain")
            elif url.path.startswith("/session/") and \
                    url.path.endswith("/apply"):
                name = url.path[len("/session/"):-len("/apply")]
                args = shlex.split(q.get("args", [""])[0])
                keep = q.get("keep", ["0"])[0] not in ("", "0")
                validate_args(args)
                # no global lock: applies from client threads overlap;
                # concurrent non-keep applies to one session are
                # last-writer-wins
                with no_host_files():
                    info = _session_apply(name, args, keep=keep)
                self._reply(200, json.dumps(info).encode())
            elif url.path.startswith("/session/"):
                name = url.path[len("/session/"):]
                shape = tuple(int(v) for v in
                              self.headers.get("X-Shape", "").split(","))
                if len(shape) != 4:
                    return self._err(400, "X-Shape must be N,H,W,C")
                dtype = self.headers.get("X-Dtype", "u8")
                with _LOCK:
                    info = _session_store(name, body, shape, dtype,
                                          device)
                self._reply(200, json.dumps(info).encode())
            else:
                self._err(404, "unknown path %s" % url.path)
        except (ValueError, KeyError, climain.CLIError,
                PolicyError) as exc:
            self._err(400, "%s: %s" % (type(exc).__name__, exc))
        except Exception as exc:                    # noqa: BLE001
            # the server's or the card's fault (a kernel's error): report
            # it to the client and keep serving
            self._err(500, "%s: %s" % (type(exc).__name__, exc))


class _Server(ThreadingHTTPServer):
    # socketserver listens with a backlog of 5: a burst of more clients
    # than that loses connection requests, which the clients send again
    # a second later
    request_queue_size = 128


def make_server(host="127.0.0.1", port=8089, verbose=False, device="cuda"):
    """An HTTP server whose sessions live on ``device`` (the card unless
    the caller passes a CPU device); call ``serve_forever`` to run it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA card for device 'cuda'; pass "
                           "device='cpu' to serve from the CPU")
    srv = _Server((host, port), Handler)
    srv.verbose = verbose                           # type: ignore[attr-defined]
    srv.device = device                             # type: ignore[attr-defined]
    return srv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8089)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--verbose", action="store_true")
    ns = ap.parse_args(argv)
    srv = make_server(ns.host, ns.port, ns.verbose, ns.device)
    print(json.dumps({"serving": f"http://{ns.host}:{ns.port}",
                      "endpoints": ["/healthz", "/formats", "/convert",
                                    "/identify", "/session/<name>",
                                    "/session/<name>/apply"]}))
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
