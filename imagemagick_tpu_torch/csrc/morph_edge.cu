// K5: threshold -> open square:1 -> close square:1 -> edge 1 of a float32
// batch of single-channel images, one threshold per image.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_morph_edge_kernel (built
// by _build_morph_edge_v2, entered through fused_bilevel_morph_edge): the
// tail of config #3, -auto-threshold otsu -> -morphology open square:1 ->
// -morphology close square:1 -> -edge 1.  The stages:
//   t = x > thr[n]                      (bilevel, as the op route compares;
//                                        NaN compares false)
//   erode, dilate (open), dilate, erode (close): 3x3 min / max
//   edge = clip(9 v - sum over the 3x3 window, 0, 1)
// The reference pads each stage's own input by replicating its border.
//
// What bounds it on an H100: device memory, 4 bytes read and 4 written a
// pixel (110.3 MB, 0.0329 ms at config #3's 16 x 1056 x 816).  Every value
// after the threshold is 0 or 1, so the stages are bit algebra on words of
// 32 pixels of a row: erode is the AND of a pixel's 3x3 neighbours and
// dilate the OR, both separable (along the row, then across three rows);
// and since a replicated neighbour is a pixel already in the window,
// clip(9 v - sum, 0, 1) = v AND NOT erode(v).  A stage costs a few shifts,
// two shuffles and a few ANDs a word, against 9 shared-memory reads and
// clamped index arithmetic a pixel before.
//
// The design:
// * A warp owns the words of a strip of rows of one image: lane l holds
//   word base + l of each row.  A row is read as coalesced float4 loads
//   of 128 pixels (32 loads of 32 pixels where W % 4 != 0), compared with
//   thr[n] and packed by __ballot_sync: four ballots of a 128-pixel load
//   hold its four words with their bits interleaved, and each lane
//   spreads the bytes of its word back into place.  The next row's loads
//   are issued before the current row runs through the stages.  A row of
//   up to 1024 pixels is one warp; a wider row is cut into groups of 30
//   words with one halo word on each side (five stages reach five pixels,
//   inside the halo word).
// * Bits cross from word to word by shuffles.  At the image's left border
//   the missing neighbour of pixel 0 is pixel 0; at its right border each
//   stage's input first copies pixel W-1 over the bits beyond it, so the
//   missing neighbour is pixel W-1 and no bit beyond W leaks in.
// * Rows stream down the strip.  Stage k keeps the row-reduced words of
//   its last two input rows (and, for the edge, the raw middle row) in
//   registers and emits a row one input row behind stage k-1.  A stage's
//   first input row stands in for the row above it and its last for the
//   row below, which at the image's top and bottom is exactly the edge
//   replication of that stage's own input.  A strip of S output rows reads
//   S + 10 rows (5 above, 5 below, cut at the image), so the rows where a
//   strip's start or end stands in wrongly are halo rows, never written.
// * Each lane fetches by shuffle the output word that holds its four
//   pixels of a 128-pixel span and stores them as 0.0 / 1.0 in one
//   float4, one coalesced store of 128 pixels a warp instruction.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;      // four warps, each its own strip
constexpr int HALO = 5;           // four 3x3 stages and the edge stage
constexpr int GROUP = 30;         // output words of a warp when W > 1024
constexpr unsigned FULL = 0xffffffffu;

// The lane's place in the row: whether its word is the image's first or
// last, and the mask of the bits of its word that lie inside the image
// (all ones for any word but the last).
struct Lane {
  bool first, last;
  uint32_t keep;
  int p;                          // the last pixel's bit in the last word
};

// Copy bit p over the bits beyond it (a no-op but in the last word).
__device__ __forceinline__ uint32_t fix(uint32_t a, const Lane& ln) {
  return ((a >> ln.p) & 1u) ? (a | ~ln.keep) : (a & ln.keep);
}

// a OP its left neighbour OP its right neighbour, along the row; OP 0 is
// AND (erode), 1 is OR (dilate).  Every lane of the warp takes part.
template <int OP>
__device__ __forceinline__ uint32_t hred(uint32_t a, const Lane& ln) {
  a = fix(a, ln);
  uint32_t wl = __shfl_up_sync(FULL, a, 1);
  uint32_t wr = __shfl_down_sync(FULL, a, 1);
  if (ln.first) wl = a << 31;     // pixel 0 is its own left neighbour
  if (ln.last) wr = a >> 31;      // pixel W-1 (copied to bit 31) its right
  const uint32_t l = (a << 1) | (wl >> 31);
  const uint32_t r = (a >> 1) | (wr << 31);
  return OP == 0 ? (a & l & r) : (a | l | r);
}

// One streamed 3x3 stage: hp, hc the row-reduced words of the rows above
// and at the row it emits next, c that row itself (kept by the edge only).
struct Stage {
  uint32_t hp, hc, c;
};

// Stage k at iteration i, over L input rows: its first input arrives at
// i = k - 1, it emits on each later arrival and once more, at i = k + L -
// 1, with its last row standing in for the row below.  Returns whether it
// emitted; the emitted word is in ``out``.  OP 0 erode, 1 dilate, 2 edge.
template <int OP>
__device__ __forceinline__ bool step(Stage& s, int k, int i, int L,
                                     uint32_t v, uint32_t& out,
                                     const Lane& ln) {
  constexpr int R = OP == 1 ? 1 : 0;
  if (i == k - 1) {               // first row: it is also the row above
    s.hp = s.hc = hred<R>(v, ln);
    s.c = v;
    return false;
  }
  if (i < k || i > k + L - 1) return false;
  const uint32_t hn = i == k + L - 1 ? s.hc : hred<R>(v, ln);
  const uint32_t m = R == 0 ? (s.hp & s.hc & hn) : (s.hp | s.hc | hn);
  out = OP == 2 ? (s.c & ~m) : m;
  s.hp = s.hc;
  s.hc = hn;
  s.c = v;
  return true;
}

// Bit j of a byte at bit 4 j.
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// VEC: W % 4 == 0 and 16-byte aligned planes, so a row is read and written
// as float4, 128 pixels (four words) a warp instruction.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
morph_edge_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                  float* __restrict__ y, int N, int H, int W, int S,
                  int nstrips, int ngroups) {
  const int lane = threadIdx.x % 32;
  const long long wid = (long long)blockIdx.x * (THREADS / 32) +
                        threadIdx.x / 32;
  if (wid >= (long long)N * nstrips * ngroups) return;   // warp-uniform
  const int g = (int)(wid % ngroups);
  const int strip = (int)(wid / ngroups % nstrips);
  const int n = (int)(wid / ((long long)ngroups * nstrips));
  const int nw = (W + 31) / 32;
  // words base .. base + 31; a group keeps lanes 1 .. 30 (all of them for
  // a row of one group)
  const int base = ngroups == 1 ? 0 : GROUP * g - 1;
  const int wi = base + lane;
  Lane ln;
  ln.first = wi == 0;
  ln.last = wi == nw - 1;
  ln.p = ln.last ? (W - 1) % 32 : 31;
  ln.keep = ln.p == 31 ? FULL : ((1u << (ln.p + 1)) - 1u);

  const int r0 = strip * S;                        // output rows r0 .. r1-1
  const int r1 = min(r0 + S, H);
  const int R0 = max(r0 - HALO, 0);                // input rows R0 .. R0+L-1
  const int L = min(r1 + HALO, H) - R0;
  const size_t plane = (size_t)H * W;
  const float* src = x + n * plane;
  float* dst = y + n * plane;
  const float t = thr[n];
  const int px0 = base * 32;                       // the warp's first pixel

  // VEC: segment s of 128 pixels, lane l pixels px0 + 128 s + 4 l .. + 3;
  // else word j, lane l pixel px0 + 32 j + l
  constexpr int NB = VEC ? 8 : 32;
  float4 vb[VEC ? NB : 1];
  float sb[VEC ? 1 : NB];
  auto load = [&](int row) {
    const float* p = src + (size_t)row * W;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      if (VEC) {
        const int col = px0 + 128 * j + 4 * lane;
        vb[j] = col >= 0 && col < W
            ? *reinterpret_cast<const float4*>(p + col)
            : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const int col = px0 + 32 * j + lane;
        sb[j] = col >= 0 && col < W ? p[col] : 0.0f;
      }
    }
  };
  load(R0);

  Stage st[5];
  for (int i = 0; i < L + HALO; ++i) {
    uint32_t v = 0;
    if (i < L) {                   // stage 0: threshold and pack row R0+i
      if (VEC) {
        // ballot c of segment s: bit l is pixel 128 s + 4 l + c; the
        // lane's word 4 s + k takes byte k of each, its bits 4 apart
        uint32_t mc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (px0 + 128 * j >= W) break;           // warp-uniform
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float val = c == 0 ? vb[j].x : c == 1 ? vb[j].y
                            : c == 2 ? vb[j].z : vb[j].w;
            const uint32_t b = __ballot_sync(FULL, val > t);
            if (lane / 4 == j) mc[c] = b;
          }
        }
        const int k = 8 * (lane % 4);
#pragma unroll
        for (int c = 0; c < 4; ++c) v |= spread4((mc[c] >> k) & 0xffu) << c;
      } else {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t b = __ballot_sync(FULL, sb[j] > t);
          if (lane == j) v = b;
        }
      }
      if (i + 1 < L) load(R0 + i + 1);
    }
    uint32_t o = 0;
    // each stage passes on what it emitted; one that did not emit passes
    // nothing, and the next stage then emits only for its final flush
    uint32_t a = v;
    if (step<0>(st[0], 1, i, L, a, o, ln)) a = o;
    if (step<1>(st[1], 2, i, L, a, o, ln)) a = o;
    if (step<1>(st[2], 3, i, L, a, o, ln)) a = o;
    if (step<0>(st[3], 4, i, L, a, o, ln)) a = o;
    const bool e = step<2>(st[4], 5, i, L, a, o, ln);
    const int row = R0 + i - HALO;                 // stage 5's row
    if (e && row >= r0 && row < r1) {
      float* q = dst + (size_t)row * W;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        if (VEC && px0 + 128 * j >= W) break;      // warp-uniform
        // the word this lane stores from, and its first pixel's bit
        const int src_lane = VEC ? 4 * j + lane / 8 : j;
        const uint32_t w = __shfl_sync(FULL, o, src_lane);
        const int wb = base + src_lane;
        const int col = VEC ? px0 + 128 * j + 4 * lane : px0 + 32 * j + lane;
        const bool mine = (ngroups == 1 ||
                           (src_lane >= 1 && src_lane <= GROUP)) &&
                          wb >= 0 && wb < nw && col < W;
        if (!mine) continue;
        if (VEC) {
          const uint32_t nib = w >> (4 * (lane % 8));
          *reinterpret_cast<float4*>(q + col) = make_float4(
              (float)(nib & 1u), (float)((nib >> 1) & 1u),
              (float)((nib >> 2) & 1u), (float)((nib >> 3) & 1u));
        } else {
          q[col] = (float)((w >> lane) & 1u);
        }
      }
    }
  }
}

}  // namespace

// x, y: (N, H, W) float32, contiguous; thr: N float32; all on the current
// device.  A warp streams the most of 64, 32, 16 or 8 output rows that
// still gives 8 warps an SM (16 rows at config #3; 8 and 32 were 8 % and
// 10 % slower there, PERF.md).
extern "C" int k5_morph_edge(const float* x, const float* thr, float* y,
                             int N, int H, int W, void* stream) {
  if (N < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  const int nw = (W + 31) / 32;
  const int ngroups = nw <= 32 ? 1 : (nw + GROUP - 1) / GROUP;
  int S = 64;
  while (S > 8 && (long long)N * ((H + S - 1) / S) * ngroups < 132 * 8)
    S /= 2;
  const int nstrips = (H + S - 1) / S;
  const long long warps = (long long)N * nstrips * ngroups;
  const long long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && (((uintptr_t)x | (uintptr_t)y) & 15) == 0;
  auto* kernel = vec ? morph_edge_kernel<true> : morph_edge_kernel<false>;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, thr, y, N, H, W, S, nstrips, ngroups);
  return cudaGetLastError();
}
