"""The multicall tools: mogrify, composite, montage, conjure, -bench and
display/animate.

Port of ``imagemagick_tpu/cli/tools.py``: each tool is a front end over
the option interpreter of ``main.py`` (MagickWand's mogrify.c,
composite.c, montage.c, conjure.c), on the device its caller names (the
card unless it passes ``device="cpu"``).  ``conjure`` runs MSL scripts
(coders/msl.c): an XML pipeline of reads, writes and operations.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Sequence

from .main import (CLIError, CLIState, LazyImage, OPS, _SETTINGS,
                   _replaced, _write_output, materialize_all, process)

# the tool's user interface, as in the JAX package: sixel output where
# IMTPU_SIXEL is "1" (or stdout is a terminal), at most
# IMTPU_DISPLAY_WIDTH columns wide; else these files
DISPLAY_FILE = "/tmp/tmagick-display.png"
ANIMATE_FILE = "/tmp/tmagick-animate.gif"


def mogrify_main(argv: Sequence[str], device="cuda") -> int:
    """mogrify: the options applied to each file, written over it or, with
    ``-format EXT``, beside it under that extension, in ``-path DIR``
    where given (MogrifyImageCommand).  An option's arguments are counted
    as the JAX tool counts them: an operator's from the ``OPS`` table, one
    for a setting and for -size, -depth, -define, -label and -comment, two
    for -limit, none for anything else; every other token is a file."""
    opts: List[str] = []
    paths: List[str] = []
    out_format = None
    out_path = None
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a == "-format":
            out_format = argv[i + 1]
            i += 2
        elif a == "-path":
            out_path = argv[i + 1]
            i += 2
        elif a.startswith(("-", "+")):
            opts.append(a)
            name = a[1:]
            n = 0
            if name in OPS:
                n = OPS[name][0]
            elif name in _SETTINGS or name in ("size", "depth", "define",
                                               "limit", "label", "comment"):
                n = 2 if name == "limit" else 1
            for _ in range(n):
                i += 1
                opts.append(argv[i])
            i += 1
        else:
            paths.append(a)
            i += 1
    rc = 0
    for p in paths:
        try:
            dst = os.path.splitext(p)[0] + "." + out_format.lower() \
                if out_format else p
            if out_path:
                dst = os.path.join(out_path, os.path.basename(dst))
            process([p] + opts + [dst], CLIState(device))
        except (CLIError, FileNotFoundError, ValueError) as e:
            print(f"mogrify: {e}", file=sys.stderr)
            rc = 1
    return rc


def composite_main(argv: Sequence[str], device="cuda") -> int:
    """composite [options] SOURCE [MASK] DEST OUTPUT: SOURCE over DEST
    (CompositeImageCommand) with ``-compose``, ``-gravity``,
    ``-geometry``, ``-dissolve PERCENT`` (the dissolve operator) and
    ``-stereo OFFSET`` (an anaglyph of DEST and SOURCE instead of a
    composite); other options run before the composite."""
    opts: List[str] = []
    paths: List[str] = []
    compose = "over"
    gravity = None
    geometry = None
    argv = list(argv)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-compose":
            compose = argv[i + 1]
            i += 2
        elif a == "-gravity":
            gravity = argv[i + 1]
            i += 2
        elif a == "-geometry":
            geometry = argv[i + 1]
            i += 2
        elif a == "-dissolve":
            compose = "dissolve"
            opts += ["-define", f"dissolve={argv[i + 1]}"]
            i += 2
        elif a == "-stereo":
            # composite.c:183: StereoAnaglyphImage(base, overlay, x, y)
            compose = None
            opts += ["-stereo", argv[i + 1]]
            i += 2
        elif a.startswith("-"):
            opts.append(a)
            i += 1
        else:
            paths.append(a)
            i += 1
    if len(paths) < 3:
        print("composite: usage: composite src dst out", file=sys.stderr)
        return 2
    src, dst, out = paths[0], paths[-2], paths[-1]
    args = [dst, src, *opts]
    if compose is not None:
        args += ["-compose", compose]
    if gravity:
        args += ["-gravity", gravity]
    if geometry:
        args += ["-geometry", geometry]
    if compose is not None:
        args += ["-composite"]
    args += [out]
    try:
        process(args, CLIState(device))
        return 0
    except (CLIError, FileNotFoundError, ValueError) as e:
        print(f"composite: {e}", file=sys.stderr)
        return 1


def montage_main(argv: Sequence[str], device="cuda") -> int:
    """montage INPUTS... OUTPUT (MontageImageCommand): the inputs as tiles
    of ``-tile COLSxROWS`` cells of ``-geometry`` (120x120+4+3 by
    default), through the CLI's ``-montage``."""
    args = []
    tile = None
    geometry = "120x120+4+3"
    argv = list(argv)
    i = 0
    inputs = []
    while i < len(argv):
        a = argv[i]
        if a == "-tile":
            tile = argv[i + 1]
            i += 2
        elif a == "-geometry":
            geometry = argv[i + 1]
            i += 2
        elif a.startswith(("-", "+")):
            args.append(a)
            i += 1
        else:
            inputs.append(a)
            i += 1
    if len(inputs) < 2:
        print("montage: need inputs and an output", file=sys.stderr)
        return 2
    try:
        st = CLIState(device)
        if tile:
            st.settings["tile"] = tile
        st.settings["compose-geometry"] = geometry
        process(inputs[:-1] + ["-montage", inputs[-1]], st)
        return 0
    except (CLIError, FileNotFoundError, ValueError) as e:
        print(f"montage: {e}", file=sys.stderr)
        return 1


def conjure_main(argv: Sequence[str], device="cuda") -> int:
    """conjure SCRIPT...: run each MSL file; an error prints
    ``conjure: ...`` and the exit code is 1."""
    rc = 0
    for path in argv:
        if path.startswith("-"):
            continue
        try:
            with open(path) as f:
                run_msl(f.read(), device)
        except Exception as e:   # noqa: BLE001 — the JAX tool's rule
            print(f"conjure: {e}", file=sys.stderr)
            rc = 1
    return rc


def run_msl(xml_text: str, device="cuda") -> None:
    """Interpret an MSL document: ``<image>`` groups of ``<read>``,
    ``<write>``, ``<resize>``, ``<blur>``, ``<gaussian-blur>``,
    ``<crop>``, the flag operations, ``<colorspace>``, ``<rotate>``,
    ``<set>`` and ``<get>``; any other element runs as the option of its
    name with its geometry (or first attribute), and is skipped where the
    CLI does not know it."""
    import xml.etree.ElementTree as ET

    from .. import io as iio

    root = ET.fromstring(xml_text)

    def new_state(el):
        st = CLIState(device)
        if "size" in el.attrib:
            st.size = el.attrib["size"]
        return st

    def handle_group(el):
        st = CLIState(device)
        for child in el:
            if child.tag.lower() == "image":
                if "size" in child.attrib:
                    st.size = child.attrib["size"]
                handle_children(child, st)
            else:
                handle_element(child, st)
        return st

    def handle_children(el, st):
        for child in el:
            handle_element(child, st)

    def handle_element(el, st):
        tag = el.tag.lower()
        a = el.attrib
        if tag == "read":
            for im in iio.read_images(a["filename"], size=st.size,
                                      device=st.device):
                st.images.append(LazyImage(im))
        elif tag == "write":
            _write_output(st, a["filename"])
        elif tag == "resize":
            process(["-resize", a.get("geometry", "100%")], st)
        elif tag in ("blur", "gaussian-blur", "gaussianblur"):
            g = a.get("geometry") or \
                f"{a.get('radius', 0)}x{a.get('sigma', 1)}"
            process(["-blur" if tag == "blur" else "-gaussian-blur", g], st)
        elif tag == "crop":
            process(["-crop", a.get("geometry", "100%")], st)
        elif tag in ("negate", "flip", "flop", "equalize", "normalize",
                     "despeckle", "trim", "magnify"):
            process([f"-{tag}"], st)
        elif tag == "colorspace":
            process(["-colorspace", a.get("colorspace", "sRGB")], st)
        elif tag == "rotate":
            process(["-rotate", a.get("degrees", "0")], st)
        elif tag == "set":
            for li in st.images:
                _replaced(li, properties=dict(li.image.properties, **a))
        elif tag == "get":
            pass
        else:
            # generic: the tag as an option, with its geometry or first
            # attribute; one the CLI does not know is skipped
            arg = a.get("geometry") or next(iter(a.values()), None)
            try:
                process([f"-{tag}"] + ([arg] if arg else []), st)
            except CLIError:
                pass

    if root.tag.lower() == "image":
        handle_children(root, new_state(root))
    elif root.tag.lower() in ("msl", "group"):
        for child in root:
            if child.tag.lower() == "image":
                handle_children(child, new_state(child))
            else:
                handle_group(root)
                break


def bench_run(argv: Sequence[str], iterations: int, concurrent: bool = False,
              device="cuda") -> int:
    """-bench N: the whole command N times, then ``Performance[1]: Ni
    IPSips 1.000e SECONDSu M:SS.mmm`` on stderr (MagickCommandGenesis,
    magick-cli.c:116-300); returns the last run's exit code.  Each run
    ends in its write, which brings the pixels to the host, so the wall
    clock holds the card's work; the first run holds the kernels' first
    build, as the JAX tool's holds XLA's compilation."""
    t0 = time.perf_counter()
    rc = 0
    for _ in range(iterations):
        rc = _run_once(argv, device)
    dt = time.perf_counter() - t0
    ips = iterations / dt if dt > 0 else 0.0
    mins, secs = divmod(dt, 60.0)
    print(f"Performance[1]: {iterations}i {ips:.3f}ips 1.000e {dt:.3f}u "
          f"{int(mins)}:{secs:06.3f}", file=sys.stderr)
    return rc


def _run_once(argv, device="cuda") -> int:
    try:
        process(list(argv), CLIState(device))
        return 0
    except (CLIError, FileNotFoundError, ValueError) as e:
        print(f"tmagick: {e}", file=sys.stderr)
        return 1


def display_main(argv: Sequence[str], animate: bool = False,
                 device="cuda") -> int:
    """display/animate without X11: the images as sixel escape sequences
    on stdout (xterm -ti vt340, mlterm, foot, wezterm, iTerm2) where
    stdout is a terminal or IMTPU_SIXEL is "1", each scaled down to
    IMTPU_DISPLAY_WIDTH columns (800 by default); animate shows every
    frame, ``delay`` apart.  Elsewhere the images go to a file,
    ``DISPLAY_FILE`` (several images under animate: ``ANIMATE_FILE``),
    and stderr names it."""
    st = process(list(argv), CLIState(device))
    what = "animate" if animate else "display"
    if not st.images:
        print(f"{what}: no images", file=sys.stderr)
        return 1
    images = materialize_all(st.images)
    if not (os.environ.get("IMTPU_SIXEL") == "1" or sys.stdout.isatty()):
        from .. import io as iio

        out = ANIMATE_FILE if animate and len(images) > 1 else DISPLAY_FILE
        iio.write_image(images if len(images) > 1 else images[0], out)
        print(f"{what}: no sixel terminal; wrote {out}", file=sys.stderr)
        return 0

    from ..io.extra_coders import encode_sixel
    from ..ops import resize as rz

    max_w = int(os.environ.get("IMTPU_DISPLAY_WIDTH", "800"))
    frames = images if animate else images[:1]
    for img in frames:
        if img.width > max_w:
            h = max(1, round(img.height * max_w / img.width))
            img = img.replace(data=rz.resize(img.data, h, max_w, "triangle"))
        sys.stdout.buffer.write(encode_sixel(img))
        sys.stdout.buffer.write(b"\n")
        sys.stdout.buffer.flush()
        if animate and len(frames) > 1:
            time.sleep(max(img.delay, 2) / 100.0)
    return 0
