"""Byte codecs from compress.c: Ascii85 and PackBits RLE.

A copy of ``imagemagick_tpu/utils/compress.py``, plain Python on the host:
the embeddable codecs of ImageMagick's MagickCore/compress.c, Ascii85
(PS/PDF text embedding) and PackBits run-length encoding (TIFF, PICT,
PS).  The CCITT fax codecs are in ``utils/fax.py``.
"""

from __future__ import annotations


def ascii85_encode(data: bytes) -> bytes:
    """Ascii85Encode (compress.c): 4 bytes -> 5 chars, 'z' for zero group."""
    out = bytearray()
    n = len(data)
    for i in range(0, n, 4):
        chunk = data[i:i + 4]
        pad = 4 - len(chunk)
        word = int.from_bytes(chunk + b"\x00" * pad, "big")
        if word == 0 and pad == 0:
            out += b"z"
            continue
        chars = bytearray(5)
        for j in range(4, -1, -1):
            chars[j] = 33 + word % 85
            word //= 85
        out += chars[: 5 - pad]
    return bytes(out) + b"~>"


def ascii85_decode(data: bytes) -> bytes:
    """Ascii85Decode (compress.c)."""
    data = data.replace(b"\n", b"").replace(b"\r", b"").replace(b" ", b"")
    if data.endswith(b"~>"):
        data = data[:-2]
    out = bytearray()
    group = []
    for ch in data:
        if ch == ord("z") and not group:
            out += b"\x00\x00\x00\x00"
            continue
        group.append(ch - 33)
        if len(group) == 5:
            word = 0
            for g in group:
                word = word * 85 + g
            out += word.to_bytes(4, "big")
            group = []
    if group:
        pad = 5 - len(group)
        for g in [84] * pad:
            group.append(g)
        word = 0
        for g in group:
            word = word * 85 + g
        out += word.to_bytes(4, "big")[: 4 - pad]
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits RLE (compress.c PackbitsEncodeImage semantics)."""
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        # find run
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # literal stretch
        start = i
        i += 1
        while i < n and (i - start) < 128:
            if i + 1 < n and data[i] == data[i + 1]:
                break
            i += 1
        out.append(i - start - 1)
        out += data[start:i]
    return bytes(out)


def packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        i += 1
        if b == 128:
            continue
        if b > 128:
            out += bytes([data[i]]) * (257 - b)
            i += 1
        else:
            out += data[i:i + b + 1]
            i += b + 1
    return bytes(out)
