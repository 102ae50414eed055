"""Pixel signatures and AES-CTR pixel enciphering (signature.c / cipher.c).

Port of ``imagemagick_tpu/utils/signature.py``.  The hash, the keystream
and the quantization run on the host in numpy, as in the JAX package;
only the pixels cross to and from the device.

SignatureImage (MagickCore/signature.c:461) computes a
SHA-256 over the pixel content serialized as big-endian Q16 quantum rows —
the ``%#`` property.

EncipherImage/DecipherImage reproduce the reference construction
bit-for-bit (MagickCore/cipher.c:561-935):

  * passphrase split in half: first half = nonce, second half = AES key
    (zero-padded; 10/12/14 rounds by key-half length — SetAESKey
    cipher.c:999)
  * initial counter block = SHA256(nonce || u64le(columns*rows))[:16]
    (cipher.c:637-648)
  * keystream: AES-encrypt the counter, increment it BIG-endian
    per block (IncrementCipherNonce cipher.c:527 carries from byte 15
    down; verified by two-way interop with the real binary), consume
    ceil(row_bytes/16) blocks per row, XOR into the row's big-endian
    unsigned quantum samples

Pixels are quantized to the quantum depth (Q16 default) before XOR — the
same clamp the reference's quantum export applies — so HDRI values outside
[0,1] and sub-Q16 precision do not survive the round trip (they don't in
the reference either).  Output of encipher_image can be deciphered by
``magick -decipher`` and vice versa at matching depth.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np
import torch

from .aes import aes_encrypt_blocks


def _host(data) -> np.ndarray:
    """Pixels as a host array: a tensor leaves its device once."""
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def signature_image(data) -> str:
    """SHA-256 of pixels as big-endian Q16 (signature.c SignatureImage)."""
    arr = _host(data)
    q16 = (np.clip(arr, 0.0, 1.0) * 65535.0 + 0.5).astype(">u2")
    return hashlib.sha256(q16.tobytes()).hexdigest()


def _cipher_key_nonce(passphrase: str, width: int, height: int):
    """Derive (aes_key, counter0) exactly as cipher.c:620-648 does."""
    pp = passphrase.encode("utf-8")
    nonce, keyhalf = pp[:len(pp) // 2], pp[len(pp) // 2:]
    if len(keyhalf) * 8 >= 256:
        key = keyhalf[:32].ljust(32, b"\0")
    elif len(keyhalf) * 8 >= 192:
        key = keyhalf[:24].ljust(24, b"\0")
    else:
        key = keyhalf[:16].ljust(16, b"\0")
    digest = hashlib.sha256(
        nonce + struct.pack("<Q", width * height)).digest()
    return key, digest[:16]


def _keystream(key: bytes, counter0: bytes, rows: int, row_bytes: int
               ) -> np.ndarray:
    """CTR keystream: rows x ceil(row_bytes/16) blocks, row-truncated."""
    nb = -(-row_bytes // 16)
    total = rows * nb
    # IncrementCipherNonce (cipher.c:527) carries from byte 15 DOWN —
    # the counter is a 128-bit BIG-endian integer
    c0 = int.from_bytes(counter0, "big")
    lo0 = np.uint64(c0 & 0xFFFFFFFFFFFFFFFF)
    hi0 = np.uint64(c0 >> 64)
    k = np.arange(total, dtype=np.uint64)
    with np.errstate(over="ignore"):
        lo = lo0 + k
        hi = hi0 + (lo < lo0).astype(np.uint64)
    counters = np.empty((total, 16), np.uint8)
    counters[:, :8] = hi[:, None].astype(">u8").view(np.uint8).reshape(
        total, 8)
    counters[:, 8:] = lo[:, None].astype(">u8").view(np.uint8).reshape(
        total, 8)
    stream = aes_encrypt_blocks(counters, key)
    return stream.reshape(rows, nb * 16)[:, :row_bytes]


def _cipher_apply(data, passphrase: str, depth: int):
    arr = _host(data)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape[-3], arr.shape[-2], arr.shape[-1]
    if depth == 8:
        scale, dt = 255.0, ">u1"
    else:
        scale, dt = 65535.0, ">u2"
    q = (np.clip(arr, 0.0, 1.0) * scale + 0.5).astype(dt)
    key, counter0 = _cipher_key_nonce(passphrase, w, h)
    row_bytes = w * c * q.dtype.itemsize
    ks = _keystream(key, counter0, h, row_bytes)
    nframes = q.size // (h * w * c)
    raw = np.frombuffer(q.tobytes(), np.uint8).reshape(nframes, h, row_bytes)
    out = raw ^ ks[None]  # counter restarts per frame, like per-image calls
    dec = np.frombuffer(out.tobytes(), dt).reshape(arr.shape)
    out = dec.astype(np.float32) / scale
    return torch.from_numpy(out).to(data.device) \
        if isinstance(data, torch.Tensor) else out


def encipher_image(data, passphrase: str, depth: int = 16):
    """EncipherImage: AES-CTR over quantum rows, cipher.c-compatible."""
    return _cipher_apply(data, passphrase, depth)


def decipher_image(data, passphrase: str, depth: int = 16):
    """DecipherImage: inverse of encipher_image (CTR xor is self-inverse)."""
    return _cipher_apply(data, passphrase, depth)
