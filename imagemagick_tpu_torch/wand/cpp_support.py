"""Glue helpers for the Magick++ compatibility layer.

Port of ``imagemagick_tpu/wand/cpp_support.py``.  Only ``display``, which
``MagickWand.animate_images`` and ``display_image`` call, is here so far;
the rest of the module comes with the Magick++ layer.
"""

from __future__ import annotations


def display(wand):
    """In-terminal sixel preview when attached to a TTY (or with
    ``IMTPU_SIXEL`` set, as for the CLI's ``display``); silent no-op
    otherwise (the reference blocks on an X server here)."""
    import os
    import sys

    if not (sys.stdout.isatty() or os.environ.get("IMTPU_SIXEL")):
        return
    from ..io.extra_coders import encode_sixel

    sys.stdout.buffer.write(encode_sixel(wand.current))
    sys.stdout.buffer.flush()
