"""Vectorized AES block cipher (FIPS-197), numpy over batches of blocks.

A copy of ``imagemagick_tpu/utils/aes.py``, on the host.

Host-side primitive for EncipherImage/DecipherImage parity with the
reference (MagickCore/cipher.c:73 AESInfo): the reference
runs AES in CTR mode over quantum pixel rows, so only block *encryption*
is needed (CTR decrypt == encrypt).  Implemented from the public FIPS-197
specification; verified against the standard test vectors in
tests/test_services.py and
tests/test_torch_services.py.

Layout: a block is 16 bytes b0..b15; state column c holds bytes 4c..4c+3
(byte b[4c+r] is row r, column c).
"""

from __future__ import annotations

import numpy as np

# --- tables -----------------------------------------------------------------


def _build_sbox() -> np.ndarray:
    # GF(2^8) inverse via exp/log tables over generator 3, then the affine map.
    exp = np.zeros(256, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= (x << 1) ^ (0x1B if x & 0x80 else 0)
        x &= 0xFF
    sbox = np.zeros(256, np.uint8)
    for v in range(256):
        a = 0 if v == 0 else exp[(255 - log[v]) % 255]
        # affine map: s = a ^ rotl(a,1) ^ rotl(a,2) ^ rotl(a,3) ^ rotl(a,4) ^ 0x63
        sbox[v] = (a ^ ((a << 1 | a >> 7) & 0xFF) ^ ((a << 2 | a >> 6) & 0xFF)
                   ^ ((a << 3 | a >> 5) & 0xFF) ^ ((a << 4 | a >> 4) & 0xFF)
                   ^ 0x63)
    return sbox


_SBOX = _build_sbox()
_XT = np.array([(x << 1) ^ (0x1B if x & 0x80 else 0) for x in range(256)],
               np.int32).astype(np.uint8)  # xtime (multiply by 2 in GF(2^8))
_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36,
         0x6C, 0xD8, 0xAB, 0x4D]

# ShiftRows flat permutation: new[4c+r] = old[4*((c+r)%4)+r]
_SHIFT = np.array([4 * ((i // 4 + i % 4) % 4) + (i % 4) for i in range(16)],
                  np.int64)


def key_expansion(key: bytes) -> np.ndarray:
    """Expand a 16/24/32-byte key into (rounds+1, 16) round-key bytes."""
    nk = len(key) // 4
    if nk not in (4, 6, 8):
        raise ValueError("AES key must be 16, 24 or 32 bytes")
    rounds = {4: 10, 6: 12, 8: 14}[nk]
    words = [list(key[4 * i:4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        t = list(words[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]                       # RotWord
            t = [int(_SBOX[b]) for b in t]          # SubWord
            t[0] ^= _RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            t = [int(_SBOX[b]) for b in t]
        words.append([a ^ b for a, b in zip(words[i - nk], t)])
    flat = np.array(words, np.uint8).reshape(rounds + 1, 16)
    return flat


def _mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns on (N, 16) u8 state (columns are byte groups of 4)."""
    s = state.reshape(-1, 4, 4)  # (N, column, row)
    a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    x0, x1, x2, x3 = _XT[a0], _XT[a1], _XT[a2], _XT[a3]
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return np.stack([b0, b1, b2, b3], axis=-1).reshape(-1, 16)


def aes_encrypt_blocks(blocks: np.ndarray, key: bytes) -> np.ndarray:
    """Encrypt an (N, 16) u8 array of blocks under `key` (ECB, vectorized)."""
    rk = key_expansion(key)
    rounds = rk.shape[0] - 1
    state = blocks.astype(np.uint8) ^ rk[0]
    for rnd in range(1, rounds):
        state = _SBOX[state][:, _SHIFT]
        state = _mix_columns(state) ^ rk[rnd]
    state = _SBOX[state][:, _SHIFT] ^ rk[rounds]
    return state
