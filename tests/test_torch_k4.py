"""Kernel K4's partition, skew counters and host side, on the CPU.

``csrc/histogram256.cu`` cuts each row into a scalar head up to the
row's first 16-byte boundary, a float4 body shared by the row's blocks in
equal runs, and a scalar tail; each thread issues UNROLL float4 loads a
step and counts into the lane's own copy of the histogram
(``hist[bin * 32 + lane]``); a row shared by several blocks is summed
through an int32 accumulator and a ticket counter in a scratch buffer
that the last block reads, zeroes and resets.  ``replay`` below walks the
same loops (the constants are read from the source) and must count every
value of every row exactly once, and the per-lane copies must sum to K4's
plain version exactly.  The kernel itself is held to its plain version on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).  K4's wrapper
is checked against its C entry's signature with ``_build.load`` stubbed.
"""

import contextlib
import ctypes
import re

import numpy as np
import pytest
import torch

from imagemagick_tpu_torch import _build
from imagemagick_tpu_torch.ops import gpu_kernels as gk
from imagemagick_tpu_torch.ops.histogram import _bin_index

_TEXT = (_build._SRC / "histogram256.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _TEXT).group(1))


THREADS, BINS, LANES = _const("THREADS"), _const("BINS"), _const("LANES")
UNROLL, BLOCKS_PER_SM = _const("UNROLL"), _const("BLOCKS_PER_SM")
MIN_VECS = THREADS * UNROLL
H100_SMS = 132


def per_row(nrows, rowlen, sms=H100_SMS):
    """Blocks a row, as the C entry chooses them."""
    p = sms * BLOCKS_PER_SM // nrows
    return max(min(p, (rowlen // 4 + MIN_VECS - 1) // MIN_VECS), 1)


def replay(nrows, rowlen, addr, blocks=None):
    """The (row, element) -> (block, thread) walk of the kernel for x at
    byte address ``addr`` with ``blocks`` a row (the C entry's choice for
    an H100 by default): returns, for every element, how many threads
    counted it and the lane of the last one, and the blocks a row."""
    p = per_row(nrows, rowlen) if blocks is None else blocks
    seen = torch.zeros(nrows, rowlen, dtype=torch.int64)
    lane = torch.full((nrows, rowlen), -1, dtype=torch.int64)
    tid = torch.arange(THREADS)
    for row in range(nrows):
        a = addr + 4 * row * rowlen
        head = min((16 - (a & 15)) & 15, 4 * rowlen) // 4
        nvec = (rowlen - head) // 4
        tail = rowlen - head - 4 * nvec
        run = -(-nvec // p)
        for part in range(p):
            lo = min(part * run, nvec)
            hi = min(lo + run, nvec)
            idx, who = [], []
            if part == 0:
                idx.append(tid[tid < head])
                who.append(tid[tid < head])
            if part == p - 1:
                idx.append(head + 4 * nvec + tid[tid < tail])
                who.append(tid[tid < tail])
            for base in range(lo, hi, THREADS * UNROLL):
                for u in range(UNROLL):
                    v = base + tid + u * THREADS
                    ok = v < hi
                    for k in range(4):
                        idx.append(head + 4 * v[ok] + k)
                        who.append(tid[ok])
            idx, who = torch.cat(idx), torch.cat(who)
            seen[row].index_add_(0, idx, torch.ones_like(idx))
            lane[row, idx] = who % LANES
    return seen, lane, p


@pytest.mark.parametrize("nrows,rowlen", [
    (1, 4 * MIN_VECS * 3 + 1), (1, 70_001), (1, 5 * 256 * 512 + 333),
    (16, 20_000), (16, 20_001), (16, 20_002), (16, 20_003),
    (1000, 37), (1000, 257), (3, 1), (2, 2), (2, 3), (4, 4 * THREADS - 1),
])
@pytest.mark.parametrize("offset", [0, 4, 8, 12])
def test_partition_counts_every_value_once(nrows, rowlen, offset):
    seen, lane, p = replay(nrows, rowlen, 256 + offset)
    assert bool((seen == 1).all())
    assert int(lane.min()) >= 0 and int(lane.max()) < LANES
    assert p * nrows <= H100_SMS * BLOCKS_PER_SM or p == 1


@pytest.mark.parametrize("rowlen", [861696, 861697, 861698, 861699])
def test_partition_at_config3_rows(rowlen):
    """Config #3's 16 rows (861696 = 1056 * 816, aligned) and the three
    other residues of rowlen % 4: one resident wave of blocks, each row's
    head and tail at most 3 values and counted once."""
    p = per_row(16, rowlen)
    assert p == H100_SMS * BLOCKS_PER_SM // 16
    seen, _, _ = replay(2, rowlen, 256, blocks=p)
    assert bool((seen == 1).all())


def _pages(kind, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, shape).astype(np.float32)
    if kind == "white":                    # 90 % of the page at 1.0
        x[rng.uniform(0, 1, shape) < 0.9] = 1.0
    elif kind == "near_white":             # about 16 bins near the top
        x = rng.uniform(0.94, 1.0, shape).astype(np.float32)
    elif kind == "hdri":
        x[:, ::97] = -0.25
        x[:, 1::101] = 1.75
        x[:, 2::103] = 1e9
        x[:, 3::107] = -1e9
        x[:, 4::109] = np.nan
        x[:, 5::113] = (np.arange(x[:, 5::113].shape[1]) % 256 + 0.5) / 255
    return torch.from_numpy(x)


@pytest.mark.parametrize("kind", ["uniform", "white", "near_white", "hdri"])
@pytest.mark.parametrize("nrows,rowlen,offset", [
    (3, 20_001, 4), (16, 4099, 0), (1, 70_002, 8), (40, 255, 12)])
def test_lane_copies_sum_to_the_plain_histogram(kind, nrows, rowlen, offset):
    """The per-lane copies, filled as the replay deals the values to
    threads, sum to ``histogram256_plain`` exactly; a white page puts all
    of a warp's adds of one step on 32 different addresses."""
    x = _pages(kind, (nrows, rowlen), seed=nrows + rowlen)
    _, lane, _ = replay(nrows, rowlen, 256 + offset)
    v = x * 255.0
    v = v + 0.5                     # two roundings, as __fmul_rn/__fadd_rn
    v = torch.where(torch.isnan(v), 0.0, v).clamp(-1.0, 256.0)
    bins = v.to(torch.int32).clamp(0, BINS - 1).long()
    key = (torch.arange(nrows)[:, None] * BINS + bins) * LANES + lane
    copies = torch.bincount(key.reshape(-1), minlength=nrows * BINS * LANES)
    copies = copies.reshape(nrows, BINS, LANES)
    got = copies.sum(-1).to(torch.float32)
    assert torch.equal(got, gk.histogram256_plain(x))
    if kind == "white":
        assert int(copies[:, BINS - 1].min()) > 0     # every lane's copy


def test_ticket_reduction_in_any_order():
    """A row shared by several blocks: each adds its totals to the row's
    accumulator and takes a ticket; whichever block draws the last one
    writes the counts, and the scratch is zero again after the launch."""
    nrows, rowlen = 3, 20_001
    x = _pages("white", (nrows, rowlen), seed=5)
    _, _, p = replay(nrows, rowlen, 256)
    assert p > 1
    acc = torch.zeros(nrows, BINS, dtype=torch.int64)
    tickets = torch.zeros(nrows, dtype=torch.int64)
    out = torch.full((nrows, BINS), -1.0)
    plain = gk.histogram256_plain(x)
    rng = np.random.default_rng(0)
    for row in range(nrows):
        bins = _bin_index(x[row], BINS)
        # each block's share of the row (head with part 0, tail with the
        # last part), as contiguous runs of the element order
        parts = np.array_split(np.arange(rowlen), p)
        for part in rng.permutation(p):
            acc[row] += torch.bincount(bins[parts[part]], minlength=BINS)
            tickets[row] += 1
            if tickets[row] == p:
                out[row] = acc[row].to(torch.float32)
                acc[row] = 0
                tickets[row] = 0
    assert torch.equal(out, plain)
    assert not acc.any() and not tickets.any()


# -- K4's wrapper against the C entry's signature ----------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def k4_histogram256(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(gk, "on_card", lambda x: True)
    monkeypatch.setattr(gk, "stream_of", lambda x: 4321)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "check", lambda err, name: None)
    gk._k4_scratch.cache_clear()
    yield lib
    gk._k4_scratch.cache_clear()


@pytest.mark.parametrize("shape", [(16, 861696 // 64), (1, 5), (1000, 37)])
def test_k4_wrapper_passes_output_and_scratch(fake_card, shape):
    x = torch.zeros(shape)
    before = gk.LAUNCHES["k4"]
    counts = gk.histogram256(x)
    again = gk.histogram256(x)
    assert gk.LAUNCHES["k4"] == before + 2
    assert counts.shape == (shape[0], BINS) and counts.dtype == torch.float32
    (a1, a2) = fake_card.calls
    sig = _build._SIGNATURES["k4_histogram256"]
    assert len(a1) == len(sig) == 7
    for arg, kind in zip(a1, sig):
        assert isinstance(arg, int) and kind in (ctypes.c_void_p,
                                                 ctypes.c_int)
    xp, outp, scratch, srows, rows, rowlen, stream = a1
    assert (xp, outp) == (x.data_ptr(), counts.data_ptr())
    assert (rows, rowlen, stream) == (*shape, 4321)
    assert srows == gk.K4_SCRATCH_ROWS >= H100_SMS * BLOCKS_PER_SM // 2
    # one zeroed scratch per (device, stream), accumulators then tickets,
    # reused by the next call
    buf = gk._k4_scratch(x.device, 4321)
    assert scratch == buf.data_ptr() == a2[2] and a2[1] == again.data_ptr()
    assert buf.dtype == torch.int32 and buf.numel() == srows * (BINS + 1)
    assert not buf.any()


def test_k4_wrapper_refuses_before_the_library(fake_card):
    for bad in (torch.zeros(4, 64).double(), torch.zeros(64, 4).t(),
                torch.zeros(1, 4, 64), torch.zeros(4, 0)):
        with pytest.raises(ValueError):
            gk.histogram256(bad)
    assert fake_card.calls == []
