"""CCITT Group 3 (T.4 modified-Huffman) and Group 4 (T.6 MMR) fax codecs.

A copy of ``imagemagick_tpu/utils/fax.py``, numpy and plain Python on the
host, for ImageMagick's MagickCore/compress.c (HuffmanDecodeImage,
HuffmanEncodeImage): 1-D MH coding of bilevel rows -- alternating
white/black run lengths as terminating (0..63) plus makeup (64..2560)
codes, EOL-synchronized -- and 2-D MMR coding relative to the previous
row.  The code tables are the ITU-T T.4 standard constants.

The JAX module finds a row's runs with a loop over its pixels; here they
come from the positions where the row changes colour (``np.diff``), which
gives the same runs.  Its bit writer keeps every bit it was given in one
integer, so each shift costs as much as the stream so far and an encode
grows with the square of its length; here it keeps only the bits not yet
written.  The decoders read the stream's bits from a byte string, and the
reference row's changes from a list (``bisect``), where the JAX module
indexes numpy arrays (``np.searchsorted``).  Each gives the JAX module's
bytes and rows.  A row-by-row bit coder stays on the host: the port's
images come here once, as one bilevel array.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

import numpy as np

# (code, bit_length, run) — ITU-T T.4 tables
_TERM_WHITE = [
    (0x35, 8, 0), (0x07, 6, 1), (0x07, 4, 2), (0x08, 4, 3), (0x0b, 4, 4),
    (0x0c, 4, 5), (0x0e, 4, 6), (0x0f, 4, 7), (0x13, 5, 8), (0x14, 5, 9),
    (0x07, 5, 10), (0x08, 5, 11), (0x08, 6, 12), (0x03, 6, 13),
    (0x34, 6, 14), (0x35, 6, 15), (0x2a, 6, 16), (0x2b, 6, 17),
    (0x27, 7, 18), (0x0c, 7, 19), (0x08, 7, 20), (0x17, 7, 21),
    (0x03, 7, 22), (0x04, 7, 23), (0x28, 7, 24), (0x2b, 7, 25),
    (0x13, 7, 26), (0x24, 7, 27), (0x18, 7, 28), (0x02, 8, 29),
    (0x03, 8, 30), (0x1a, 8, 31), (0x1b, 8, 32), (0x12, 8, 33),
    (0x13, 8, 34), (0x14, 8, 35), (0x15, 8, 36), (0x16, 8, 37),
    (0x17, 8, 38), (0x28, 8, 39), (0x29, 8, 40), (0x2a, 8, 41),
    (0x2b, 8, 42), (0x2c, 8, 43), (0x2d, 8, 44), (0x04, 8, 45),
    (0x05, 8, 46), (0x0a, 8, 47), (0x0b, 8, 48), (0x52, 8, 49),
    (0x53, 8, 50), (0x54, 8, 51), (0x55, 8, 52), (0x24, 8, 53),
    (0x25, 8, 54), (0x58, 8, 55), (0x59, 8, 56), (0x5a, 8, 57),
    (0x5b, 8, 58), (0x4a, 8, 59), (0x4b, 8, 60), (0x32, 8, 61),
    (0x33, 8, 62), (0x34, 8, 63),
]
_MAKEUP_WHITE = [
    (0x1b, 5, 64), (0x12, 5, 128), (0x17, 6, 192), (0x37, 7, 256),
    (0x36, 8, 320), (0x37, 8, 384), (0x64, 8, 448), (0x65, 8, 512),
    (0x68, 8, 576), (0x67, 8, 640), (0xcc, 9, 704), (0xcd, 9, 768),
    (0xd2, 9, 832), (0xd3, 9, 896), (0xd4, 9, 960), (0xd5, 9, 1024),
    (0xd6, 9, 1088), (0xd7, 9, 1152), (0xd8, 9, 1216), (0xd9, 9, 1280),
    (0xda, 9, 1344), (0xdb, 9, 1408), (0x98, 9, 1472), (0x99, 9, 1536),
    (0x9a, 9, 1600), (0x18, 6, 1664), (0x9b, 9, 1728),
]
_TERM_BLACK = [
    (0x37, 10, 0), (0x02, 3, 1), (0x03, 2, 2), (0x02, 2, 3), (0x03, 3, 4),
    (0x03, 4, 5), (0x02, 4, 6), (0x03, 5, 7), (0x05, 6, 8), (0x04, 6, 9),
    (0x04, 7, 10), (0x05, 7, 11), (0x07, 7, 12), (0x04, 8, 13),
    (0x07, 8, 14), (0x18, 9, 15), (0x17, 10, 16), (0x18, 10, 17),
    (0x08, 10, 18), (0x67, 11, 19), (0x68, 11, 20), (0x6c, 11, 21),
    (0x37, 11, 22), (0x28, 11, 23), (0x17, 11, 24), (0x18, 11, 25),
    (0xca, 12, 26), (0xcb, 12, 27), (0xcc, 12, 28), (0xcd, 12, 29),
    (0x68, 12, 30), (0x69, 12, 31), (0x6a, 12, 32), (0x6b, 12, 33),
    (0xd2, 12, 34), (0xd3, 12, 35), (0xd4, 12, 36), (0xd5, 12, 37),
    (0xd6, 12, 38), (0xd7, 12, 39), (0x6c, 12, 40), (0x6d, 12, 41),
    (0xda, 12, 42), (0xdb, 12, 43), (0x54, 12, 44), (0x55, 12, 45),
    (0x56, 12, 46), (0x57, 12, 47), (0x64, 12, 48), (0x65, 12, 49),
    (0x52, 12, 50), (0x53, 12, 51), (0x24, 12, 52), (0x37, 12, 53),
    (0x38, 12, 54), (0x27, 12, 55), (0x28, 12, 56), (0x58, 12, 57),
    (0x59, 12, 58), (0x2b, 12, 59), (0x2c, 12, 60), (0x5a, 12, 61),
    (0x66, 12, 62), (0x67, 12, 63),
]
_MAKEUP_BLACK = [
    (0x0f, 10, 64), (0xc8, 12, 128), (0xc9, 12, 192), (0x5b, 12, 256),
    (0x33, 12, 320), (0x34, 12, 384), (0x35, 12, 448), (0x6c, 13, 512),
    (0x6d, 13, 576), (0x4a, 13, 640), (0x4b, 13, 704), (0x4c, 13, 768),
    (0x4d, 13, 832), (0x72, 13, 896), (0x73, 13, 960), (0x74, 13, 1024),
    (0x75, 13, 1088), (0x76, 13, 1152), (0x77, 13, 1216), (0x52, 13, 1280),
    (0x53, 13, 1344), (0x54, 13, 1408), (0x55, 13, 1472), (0x5a, 13, 1536),
    (0x5b, 13, 1600), (0x64, 13, 1664), (0x65, 13, 1728),
]
# extended makeup (shared, T.4 2.5)
_MAKEUP_EXT = [
    (0x08, 11, 1792), (0x0c, 11, 1856), (0x0d, 11, 1920), (0x12, 12, 1984),
    (0x13, 12, 2048), (0x14, 12, 2112), (0x15, 12, 2176), (0x16, 12, 2240),
    (0x17, 12, 2304), (0x1c, 12, 2368), (0x1d, 12, 2432), (0x1e, 12, 2496),
    (0x1f, 12, 2560),
]

_EOL = (0x001, 12)  # 000000000001


def _enc_tables():
    white = {run: (code, ln) for code, ln, run in _TERM_WHITE}
    black = {run: (code, ln) for code, ln, run in _TERM_BLACK}
    mw = {run: (code, ln) for code, ln, run in _MAKEUP_WHITE + _MAKEUP_EXT}
    mb = {run: (code, ln) for code, ln, run in _MAKEUP_BLACK + _MAKEUP_EXT}
    return white, black, mw, mb


def _dec_tables():
    white = {(ln, code): run for code, ln, run in
             _TERM_WHITE + _MAKEUP_WHITE + _MAKEUP_EXT}
    black = {(ln, code): run for code, ln, run in
             _TERM_BLACK + _MAKEUP_BLACK + _MAKEUP_EXT}
    return white, black


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        # keep only the bits not yet written: the JAX writer keeps them all,
        # and its shifts grow with the stream
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.buf.append((self.acc << (8 - self.n)) & 0xFF)
            self.n = 0
        return bytes(self.buf)


def _runs_of_row(row: np.ndarray) -> List[int]:
    """Alternating run lengths starting with white (0 = black pixel)."""
    # row: uint8, 1 = black.  T.4 rows start with a (possibly 0) white run,
    # and each later run ends where the colour changes.
    n = len(row)
    if n == 0:
        return []
    bounds = np.concatenate([[0], _changes(row), [n]])
    return np.diff(bounds).tolist()


def encode_g3(bits: np.ndarray) -> bytes:
    """Encode an (h, w) 0/1 array (1 = black) as a G3 MH stream.

    EOL before every line; six EOLs (RTC) at the end (T.4 4.1.2).
    """
    tw, tb, mw, mb = _enc_tables()
    out = _BitWriter()
    for row in np.asarray(bits, np.uint8):
        out.put(*_EOL)
        color = 0  # white first
        for run in _runs_of_row(row):
            term, makeup = (tw, mw) if color == 0 else (tb, mb)
            while run >= 64:
                chunk = min((run // 64) * 64, 2560)
                out.put(*makeup[chunk])
                run -= chunk
            out.put(*term[run])
            color ^= 1
    for _ in range(6):
        out.put(*_EOL)
    return out.flush()


def decode_g3(data: bytes, width: int, max_rows: int = 1 << 20) -> np.ndarray:
    """Decode a G3 MH stream into an (h, width) 0/1 array (1 = black)."""
    dw, db = _dec_tables()
    bits = _bit_string(data)
    pos = 0
    n = len(bits)
    rows: List[np.ndarray] = []

    def sync_eol(p):
        # find the next 000000000001 pattern
        zeros = 0
        while p < n:
            if bits[p] == 0:
                zeros += 1
            else:
                if zeros >= 11:
                    return p + 1
                zeros = 0
            p += 1
        return -1

    pos = sync_eol(0)
    if pos < 0:
        raise ValueError("G3: no EOL found")
    while pos >= 0 and len(rows) < max_rows:
        row = np.zeros(width, np.uint8)
        col = 0
        color = 0
        bad = False
        while col < width:
            # greedy prefix decode, 2..13 bits
            run = None
            code = 0
            ln = 0
            p = pos
            table = dw if color == 0 else db
            while ln < 14 and p < n:
                code = (code << 1) | bits[p]
                p += 1
                ln += 1
                if ln >= 2 and (ln, code) in table:
                    run = table[(ln, code)]
                    break
                if ln >= 11 and code == 0:  # trailing fill / EOL
                    run = -1
                    break
            if run is None or p >= n:
                bad = True
                break
            if run == -1:   # hit EOL zeros: row ends (or RTC)
                bad = col == 0
                break
            pos = p
            if color == 1:
                row[col:col + run] = 1
            col += run
            if run < 64:    # terminating code flips the color
                color ^= 1
        if bad and col == 0:
            break
        rows.append(row)
        nxt = sync_eol(pos)
        if nxt < 0:
            break
        # RTC detection: consecutive EOLs with nothing between
        pos = nxt
        # peek: if the next 11+ bits are zeros again -> RTC, stop
        z = 0
        q = pos
        while q < n and bits[q] == 0:
            z += 1
            q += 1
        if z >= 11:
            break
    if not rows:
        raise ValueError("G3: no rows decoded")
    return np.stack(rows)


# ---------------------------------------------------------------------------
# CCITT Group 4 (T.6 MMR) — 2-D coding relative to the previous row.
# Completes the compress.c family: vertical/pass modes code most rows in
# a handful of bits; horizontal mode falls back to the T.4 MH run tables
# above.  (ITU-T T.6 §2; no EOLs, stream ends with EOFB.)
# ---------------------------------------------------------------------------

_V_CODES = {0: (0b1, 1), 1: (0b011, 3), -1: (0b010, 3),
            2: (0b000011, 6), -2: (0b000010, 6),
            3: (0b0000011, 7), -3: (0b0000010, 7)}
_H_CODE = (0b001, 3)
_P_CODE = (0b0001, 4)


def _changes(row: np.ndarray) -> np.ndarray:
    """Positions where a new-color run begins (rows conceptually start
    white; a change at even index switches to black)."""
    return np.nonzero(np.diff(np.concatenate([[0], row])))[0]


def _bit_string(data: bytes) -> bytes:
    """The bits of ``data``, MSB first, one byte (0 or 1) each: indexing
    it gives a Python int, which the per-bit decoders read far faster than
    a numpy element."""
    return np.unpackbits(np.frombuffer(data, np.uint8)).tobytes()


def _b1_b2(rc: List[int], a0: int, color: int, width: int):
    """First reference change > a0 switching to !color, and its successor
    (``rc`` a list: ``bisect`` is ``np.searchsorted(side="right")``)."""
    want_parity = 0 if color == 0 else 1  # to-black changes sit at even idx
    j = bisect.bisect_right(rc, a0)
    if (j & 1) != want_parity:
        j += 1
    b1 = int(rc[j]) if j < len(rc) else width
    b2 = int(rc[j + 1]) if j + 1 < len(rc) else width
    return b1, b2


def _mh_put(out: "_BitWriter", run: int, color: int, tables):
    tw, tb, mw, mb = tables
    term, makeup = (tw, mw) if color == 0 else (tb, mb)
    while run >= 64:
        chunk = min((run // 64) * 64, 2560)
        out.put(*makeup[chunk])
        run -= chunk
    out.put(*term[run])


def encode_g4(bits: np.ndarray) -> bytes:
    """Encode an (h, w) 0/1 array (1 = black) as a T.6 MMR stream."""
    bits = np.asarray(bits, np.uint8)
    h, w = bits.shape
    tables = _enc_tables()
    out = _BitWriter()
    rc: List[int] = []  # imaginary all-white reference line
    for y in range(h):
        cc = _changes(bits[y]).tolist()
        a0, color = -1, 0
        ci = 0  # index of the next coding change > a0
        while a0 < w:
            while ci < len(cc) and cc[ci] <= a0:
                ci += 1
            a1 = int(cc[ci]) if ci < len(cc) else w
            b1, b2 = _b1_b2(rc, a0, color, w)
            if b2 < a1:
                out.put(*_P_CODE)                    # pass mode
                a0 = b2
            elif abs(a1 - b1) <= 3:
                out.put(*_V_CODES[a1 - b1])          # vertical mode
                a0 = a1
                color ^= 1
            else:                                    # horizontal mode
                a2 = int(cc[ci + 1]) if ci + 1 < len(cc) else w
                out.put(*_H_CODE)
                r1 = a1 - a0 if a0 >= 0 else a1
                _mh_put(out, r1, color, tables)
                _mh_put(out, a2 - a1, color ^ 1, tables)
                a0 = a2
        rc = cc
    out.put(0b000000000001, 12)                      # EOFB = two EOLs
    out.put(0b000000000001, 12)
    return out.flush()


def _mh_read(bits: bytes, pos: int, color: int, dec) -> Tuple[int, int]:
    dw, db = dec
    table = dw if color == 0 else db
    total = 0
    n = len(bits)
    while True:
        code, ln = 0, 0
        while ln < 14 and pos < n:
            code = (code << 1) | bits[pos]
            pos += 1
            ln += 1
            if ln >= 2 and (ln, code) in table:
                break
        else:
            raise ValueError("G4: bad horizontal run code")
        run = table[(ln, code)]
        total += run
        if run < 64:       # terminating code ends the run
            return total, pos


def decode_g4(data: bytes, width: int = 1728,
              max_rows: int = 1 << 20) -> np.ndarray:
    """Decode a T.6 MMR stream into an (h, width) 0/1 array (1 = black)."""
    dec = _dec_tables()
    bits = _bit_string(data)
    n = len(bits)
    pos = 0
    rows: List[np.ndarray] = []
    rc: List[int] = []
    while pos < n and len(rows) < max_rows:
        row = np.zeros(width, np.uint8)
        a0, color = -1, 0
        ok = True
        while a0 < width:
            # mode decode (prefix tree)
            if pos >= n:
                ok = False
                break
            if bits[pos] == 1:                       # V0
                pos += 1
                d = 0
            elif pos + 2 < n and bits[pos + 1] == 1:  # 01x
                d = 1 if bits[pos + 2] == 1 else -1
                pos += 3
            elif pos + 2 < n and bits[pos + 2] == 1:  # 001 horizontal
                pos += 3
                start = a0 if a0 >= 0 else 0
                r1, pos = _mh_read(bits, pos, color, dec)
                r2, pos = _mh_read(bits, pos, color ^ 1, dec)
                if color == 1:
                    row[start:start + r1] = 1
                else:
                    row[start + r1:start + r1 + r2] = 1
                a0 = start + r1 + r2
                continue
            elif pos + 3 < n and bits[pos + 3] == 1:  # 0001 pass
                pos += 4
                b1, b2 = _b1_b2(rc, a0, color, width)
                if color == 1:
                    row[max(a0, 0):b2] = 1
                a0 = b2
                continue
            elif pos + 5 < n and bits[pos + 4] == 1:  # 00001x VR2/VL2
                d = 2 if bits[pos + 5] == 1 else -2
                pos += 6
            elif pos + 6 < n and bits[pos + 5] == 1:  # 000001x VR3/VL3
                d = 3 if bits[pos + 6] == 1 else -3
                pos += 7
            else:                                     # EOFB / fill
                ok = False
                break
            b1, _ = _b1_b2(rc, a0, color, width)
            a1 = min(max(b1 + d, 0), width)
            if color == 1:
                row[max(a0, 0):a1] = 1
            a0 = a1
            color ^= 1
        if not ok and a0 < 0:
            break
        if not ok:
            break
        rows.append(row)
        rc = _changes(row).tolist()
    if not rows:
        raise ValueError("G4: no rows decoded")
    return np.stack(rows)
