"""Quantum wire-format import/export: any depth, endianness, bit order.

A copy of ``imagemagick_tpu/utils/quantum.py``, numpy on the host.

The breadth of MagickCore/quantum-import.c:4846 /
quantum-export.c:4049 as pure-numpy codecs: sample depths 1/2/4/8/16/32/64
bits, MSB/LSB *bit* packing for the sub-byte depths, big/little *byte*
endianness for the multi-byte depths, and unsigned-integer or
floating-point sample formats.  This is what faithful MONO/WBMP/old-PNM
wire handling and `-depth`-controlled raw IO need.

Rows are bit-padded to byte boundaries for sub-byte depths (the scanline
convention of the raw coders, e.g. coders/mono.c).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_INT_DTYPES = {8: "u1", 16: "u2", 32: "u4", 64: "u8"}
_FLOAT_DTYPES = {16: "f2", 32: "f4", 64: "f8"}


def _scale(depth: int) -> float:
    return float((1 << depth) - 1)


def import_quantum(data: bytes, width: int, height: int, channels: int = 1,
                   depth: int = 8, endian: str = "msb",
                   sample_format: str = "unsigned",
                   bit_order: str = "msb") -> np.ndarray:
    """Decode wire samples into (height, width, channels) float32 in [0,1].

    endian: byte order of multi-byte samples ('msb'/'lsb').
    bit_order: packing order within a byte for depths 1/2/4.
    sample_format: 'unsigned' or 'floating-point'.
    """
    spp = width * channels  # samples per row
    if depth in (1, 2, 4):
        if sample_format != "unsigned":
            raise ValueError("sub-byte floats do not exist")
        per_byte = 8 // depth
        stride = -(-spp // per_byte)  # bytes per row
        raw = np.frombuffer(data, np.uint8, stride * height).reshape(
            height, stride)
        bits = np.unpackbits(raw, axis=1,
                             bitorder="big" if bit_order == "msb" else
                             "little")
        bits = bits.reshape(height, stride * per_byte, depth)
        if bit_order == "msb":
            weights = 1 << np.arange(depth - 1, -1, -1)
        else:
            weights = 1 << np.arange(depth)
        vals = (bits * weights).sum(-1)[:, :spp]
        out = vals.astype(np.float32) / _scale(depth)
        return out.reshape(height, width, channels)
    bo = ">" if endian == "msb" else "<"
    if sample_format == "floating-point":
        dt = bo + _FLOAT_DTYPES[depth]
        arr = np.frombuffer(data, dt, spp * height).astype(np.float32)
        return arr.reshape(height, width, channels)
    dt = bo + _INT_DTYPES[depth]
    arr = np.frombuffer(data, dt, spp * height).astype(np.float64)
    return (arr / _scale(depth)).astype(np.float32).reshape(
        height, width, channels)


def export_quantum(arr: np.ndarray, depth: int = 8, endian: str = "msb",
                   sample_format: str = "unsigned",
                   bit_order: str = "msb") -> bytes:
    """Encode a (height, width, channels) float array to wire samples."""
    arr = np.clip(np.asarray(arr, np.float64), 0.0, 1.0)
    h, w, c = arr.shape
    spp = w * c
    if depth in (1, 2, 4):
        per_byte = 8 // depth
        q = (arr.reshape(h, spp) * _scale(depth) + 0.5).astype(np.uint8)
        stride = -(-spp // per_byte)
        padded = np.zeros((h, stride * per_byte), np.uint8)
        padded[:, :spp] = q
        if bit_order == "msb":
            weights = np.arange(depth - 1, -1, -1)
        else:
            weights = np.arange(depth)
        bits = ((padded[..., None] >> weights) & 1).astype(np.uint8)
        bits = bits.reshape(h, stride * 8)
        return np.packbits(bits, axis=1,
                           bitorder="big" if bit_order == "msb" else
                           "little").tobytes()
    bo = ">" if endian == "msb" else "<"
    if sample_format == "floating-point":
        return arr.astype(bo + _FLOAT_DTYPES[depth]).tobytes()
    q = (arr * _scale(depth) + 0.5).astype(bo + _INT_DTYPES[depth])
    return q.tobytes()


def quantum_extent(width: int, height: int, channels: int, depth: int) -> int:
    """Bytes needed for the wire representation (GetQuantumExtent)."""
    spp = width * channels
    if depth in (1, 2, 4):
        per_byte = 8 // depth
        return (-(-spp // per_byte)) * height
    return spp * height * (depth // 8)
