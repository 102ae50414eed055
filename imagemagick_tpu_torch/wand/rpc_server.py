"""Line-delimited JSON-RPC server over stdin/stdout for language bindings.

Port of ``imagemagick_tpu/wand/rpc_server.py``.  The PerlMagick
compatibility module (``imagemagick_tpu_torch/bindings/perl/Image/Magick.pm``)
— and any other out-of-process binding — spawns::

    python -m imagemagick_tpu_torch.wand.rpc_server [--device cuda|cpu]

once and drives MagickWand objects through it.  This replaces the
reference's in-process XS binding (PerlMagick's Magick.xs) with a process
boundary: the Perl side stays dependency-free (core JSON::PP + IPC::Open2)
while all pixel work runs in this process, on the card unless the server
was started with ``--device cpu``.  Without a card the default start
fails and the server exits nonzero.

Protocol (one JSON object per line):
  -> {"id": 1, "op": "new"}                          => {"id": 1, "result": {"wand": 7}}
  -> {"id": 2, "op": "call", "wand": 7,
      "method": "read_image", "args": ["rose:"]}     => {"id": 2, "result": null}
  -> {"id": 3, "op": "pm", "wand": 7,
      "method": "Resize", "kwargs": {...}}           => PerlMagick-name dispatch
  -> {"id": 4, "op": "get", "wand": 7,
      "attrs": ["width", "height"]}                  => {"id": 4, "result": [..]}
  -> {"id": 5, "op": "destroy", "wand": 7}
Errors come back as {"id": n, "error": "message"}.
"""

from __future__ import annotations

import json
import sys
import traceback


def _jsonable(v):
    """Convert a wand return value into something JSON-serializable.  A
    tensor reads as the JAX server reads a JAX array: a number where it
    has no axes, else the text of its values."""
    import torch

    if isinstance(v, torch.Tensor):
        a = v.detach().cpu().numpy()
        return float(a) if a.ndim == 0 else str(a)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, bytes):
        import base64

        return {"__bytes__": base64.b64encode(v).decode()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    try:
        return float(v)  # numpy scalars
    except (TypeError, ValueError):
        return str(v)


def serve(stdin=None, stdout=None, device="cuda"):
    """Answer requests from ``stdin`` on ``stdout`` until ``quit`` or the
    end of the input; every wand it makes lands on ``device``."""
    from . import perl_compat
    from .api import MagickWand

    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    wands = {}
    next_handle = [1]

    def adopt(wand):
        h = next_handle[0]
        next_handle[0] += 1
        wands[h] = wand
        return h

    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except ValueError:
            continue
        rid = req.get("id")
        try:
            op = req["op"]
            if op == "new":
                resp = {"id": rid,
                        "result": {"wand": adopt(MagickWand(device))}}
            elif op == "destroy":
                wands.pop(req["wand"], None)
                resp = {"id": rid, "result": None}
            elif op == "clone":
                resp = {"id": rid, "result": {
                    "wand": adopt(wands[req["wand"]].clone())}}
            elif op == "call":
                w = wands[req["wand"]]
                r = getattr(w, req["method"])(*req.get("args", []))
                if isinstance(r, MagickWand) and r is not w:
                    r = {"wand": adopt(r)}
                elif isinstance(r, MagickWand):
                    r = None
                resp = {"id": rid, "result": _jsonable(r)}
            elif op == "pm":
                w = wands[req["wand"]]
                other = req.get("kwargs", {}).get("image")
                if isinstance(other, (int, float)):
                    req["kwargs"]["image"] = wands[int(other)]
                r = perl_compat.apply(w, req["method"],
                                      **req.get("kwargs", {}))
                if isinstance(r, MagickWand):
                    r = {"wand": adopt(r)}
                resp = {"id": rid, "result": _jsonable(r)}
            elif op == "get":
                w = wands[req["wand"]]
                vals = [perl_compat.get_attribute(w, a)
                        for a in req.get("attrs", [])]
                resp = {"id": rid, "result": _jsonable(vals)}
            elif op == "set":
                w = wands[req["wand"]]
                for k, v in req.get("attrs", {}).items():
                    perl_compat.set_attribute(w, k, v)
                resp = {"id": rid, "result": None}
            elif op == "ping":
                resp = {"id": rid, "result": "pong"}
            elif op == "quit":
                stdout.write(json.dumps({"id": rid, "result": None}) + "\n")
                stdout.flush()
                return
            else:
                resp = {"id": rid, "error": f"unknown op {op!r}"}
        except Exception as e:  # noqa: BLE001 - report everything to client
            resp = {"id": rid,
                    "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc(limit=3)}
        stdout.write(json.dumps(resp) + "\n")
        stdout.flush()


def _main(argv=None) -> None:
    """The server's command line: check the device (a CUDA device without
    a card raises, and the process exits nonzero), then serve stdin."""
    import argparse

    from ..core.image import checked_device

    parser = argparse.ArgumentParser(
        prog="python -m imagemagick_tpu_torch.wand.rpc_server",
        description="JSON-RPC wand server for language bindings")
    parser.add_argument("--device", default="cuda",
                        help="where the wands' pixels live (default cuda)")
    args = parser.parse_args(argv)
    serve(device=checked_device(args.device, "rpc_server"))


if __name__ == "__main__":
    _main()
