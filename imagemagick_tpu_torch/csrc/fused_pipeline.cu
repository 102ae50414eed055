// K1: the fused resize x blur x channel-mix pipeline as two banded products,
//     out[tile] = clip( sum_t WV_t[tile] @ (band @ G_t) ).
//
// Replaces imagemagick_tpu/ops/fused_pipeline.py:_kernel, plain variant
// (_mxu_stage and the clip of _vpu_stage), built by _build_call and entered
// through fused_resize_pipeline and fused_linear_pipeline.
//
// Operands: the host planner's, unchanged, and one table derived from gb:
//   r0    (nprog,) int32           absolute first input row of each program's band;
//                                  program p is image p / ntiles, row tile p % ntiles
//   x     (N*Hin, WINC) f32        input rows, channels interleaved in the lanes
//   wv    (T*ntiles, TO, BAND) f32 vertical operator of each term and row tile
//   gb    (n_unique, SPAN, 128) f32 deduplicated horizontal operator blocks
//   kr    (n_unique, 128/LC, 2) int32 [lo, hi) of the non-zero rows of each
//                                  LC-lane chunk of each block, 32-aligned
//   c0s   (nb,) int32              first input lane of each 128-lane output block
//   guids (T*nb,) int32            unique block of each (term, output block)
//   out   (nprog*TO, nb*128) f32
//
// What bounds it on an H100: FP32 arithmetic.  Config #1 (512x768x3 ->
// 256x256 gray, TO=64: BAND=176, SPAN=1280, nb=2, ntiles=4) does about
// 0.48 GFLOP per image, 2*ntiles*nb*BAND*SPAN*128 for the horizontal
// product plus 2*ntiles*TO*BAND*OUTP for the vertical one, against 4.7 MB of
// input: about 100 FLOP per byte, five times the card's FP32 FLOP/byte
// balance.  Precision is full FP32 (no TF32): the fused route is held at
// >= 100 dB against float64.
//
// What the design does about it: one block of 128 threads per (program,
// 32-lane chunk of a 128-lane output block), so config #1 launches 1024
// blocks.  The band is walked in chunks of RB=64 rows.  For each chunk the
// block computes mid = band[chunk, c0+lo:c0+hi] @ G[lo:hi, lanes], both
// operands staged through shared memory in KC-deep slices with float4
// loads, then folds WV_t[:, chunk] @ mid into the output accumulators.  In
// both products each thread owns a 4-row x 4-lane register tile and reads
// its operands as float4 (one shared-memory load per eight FMAs), so the
// inner loops are bound by the FMA pipes rather than by shared memory.
// [lo, hi) is the chunk's non-zero depth from the host table kr: a G block
// is SPAN deep to serve all 128 of its lanes, and a 32-lane chunk of config
// #1 reads only 36 % of that depth.  Neither mid nor any other
// intermediate reaches device memory; the input is read once per lane
// chunk, mostly from L2.  The TPU kernel's DMA ring, 128-lane blocking and
// bf16 three-pass split are scheduling and precision devices of that chip
// and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int LC = 32;       // output lanes per block
constexpr int RB = 64;       // band rows per chunk
constexpr int KC = 32;       // input lanes per staged slice
constexpr int MAX_TO = 128;  // output rows per tile at most
constexpr int THREADS = 128;
constexpr int TN = 4;                 // lanes per thread
constexpr int TM = 4;                 // band rows per thread (horizontal)
constexpr int LQ = LC / TN;           // 8 lane quads
constexpr int RG = THREADS / LQ;      // 16 row groups
static_assert(RG * TM == RB, "the horizontal product covers the chunk");
constexpr int STAGE = RB * KC + KC * LC > MAX_TO * RB ? RB * KC + KC * LC
                                                      : MAX_TO * RB;

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__global__ void __launch_bounds__(THREADS)
fused_pipeline_kernel(const int* __restrict__ r0, const float* __restrict__ x,
                      const float* __restrict__ wv,
                      const float* __restrict__ gb,
                      const int* __restrict__ kr,
                      const int* __restrict__ c0s,
                      const int* __restrict__ guids, float* __restrict__ out,
                      int ntiles, int nterms, int nb, int TO, int BAND,
                      int SPAN, int WINC, int OUTP, int clip) {
  // the band and G slices (horizontal product) and the WV slice (vertical
  // product) are never live together, so they share one buffer
  __shared__ __align__(16) float stage[STAGE];
  __shared__ __align__(16) float mid_s[RB * LC];
  float* band_s = stage;             // [RB][KC]
  float* g_s = stage + RB * KC;      // [KC][LC]
  float* wv_s = stage;               // [TO][RB]

  const int lq = threadIdx.x % LQ;   // lanes 4*lq .. 4*lq+3 of the chunk
  const int rg = threadIdx.x / LQ;   // row group
  const int chunks = 128 / LC;
  const int b = blockIdx.x / chunks;           // 128-lane output block
  const int q = blockIdx.x % chunks;
  const int lane0 = q * LC;
  const int p = blockIdx.y;
  const int tt = p % ntiles;
  const size_t row0 = (size_t)r0[p];
  const int c0 = c0s[b];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 acc[MAX_TO / RG];           // rows rg + RG*m, 4 lanes each
#pragma unroll
  for (int m = 0; m < MAX_TO / RG; ++m) acc[m] = zero;

  for (int t = 0; t < nterms; ++t) {
    const int gid = guids[t * nb + b];
    const float* g = gb + (size_t)gid * SPAN * 128 + lane0;
    const int k_lo = kr[(gid * chunks + q) * 2];
    const int k_hi = kr[(gid * chunks + q) * 2 + 1];
    const float* w = wv + (size_t)(t * ntiles + tt) * TO * BAND;
    for (int rc = 0; rc < BAND; rc += RB) {
      // mid[RB, LC] = band[rc:rc+RB, c0+k_lo:c0+k_hi] @ G[k_lo:k_hi, lanes]
      float4 part[TM];               // rows rg*TM + r
#pragma unroll
      for (int r = 0; r < TM; ++r) part[r] = zero;
      for (int kc = k_lo; kc < k_hi; kc += KC) {
        for (int e = threadIdx.x; e < RB * KC / 4; e += THREADS) {
          const int i = e / (KC / 4);
          const int s = (e % (KC / 4)) * 4;
          reinterpret_cast<float4*>(band_s)[e] = rc + i < BAND
              ? *reinterpret_cast<const float4*>(
                    x + (row0 + rc + i) * WINC + c0 + kc + s)
              : zero;
        }
        for (int e = threadIdx.x; e < KC * LC / 4; e += THREADS) {
          const int s = e / (LC / 4);
          const int j = (e % (LC / 4)) * 4;
          reinterpret_cast<float4*>(g_s)[e] =
              *reinterpret_cast<const float4*>(g + (size_t)(kc + s) * 128 + j);
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < KC; s += 4) {
          float4 gv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            gv[u] = *reinterpret_cast<const float4*>(&g_s[(s + u) * LC + lq * TN]);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const float4 a = *reinterpret_cast<const float4*>(
                &band_s[(rg * TM + r) * KC + s]);
            fma4(part[r], a.x, gv[0]);
            fma4(part[r], a.y, gv[1]);
            fma4(part[r], a.z, gv[2]);
            fma4(part[r], a.w, gv[3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
        *reinterpret_cast<float4*>(&mid_s[(rg * TM + r) * LC + lq * TN]) =
            part[r];
      // WV_t[:, rc:rc+RB]; BAND % 4 == 0, so a float4 is all in or all out
      for (int e = threadIdx.x; e < TO * RB / 4; e += THREADS) {
        const int i = e / (RB / 4);
        const int k = rc + (e % (RB / 4)) * 4;
        reinterpret_cast<float4*>(wv_s)[e] = k < BAND
            ? *reinterpret_cast<const float4*>(w + (size_t)i * BAND + k)
            : zero;
      }
      __syncthreads();
      // out[TO, LC] += WV_t[:, rc:rc+RB] @ mid
#pragma unroll 4
      for (int k = 0; k < RB; k += 4) {
        float4 mv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mv[u] = *reinterpret_cast<const float4*>(&mid_s[(k + u) * LC + lq * TN]);
#pragma unroll
        for (int m = 0; m < MAX_TO / RG; ++m) {
          const int i = rg + RG * m;
          if (i < TO) {
            const float4 a = *reinterpret_cast<const float4*>(&wv_s[i * RB + k]);
            fma4(acc[m], a.x, mv[0]);
            fma4(acc[m], a.y, mv[1]);
            fma4(acc[m], a.z, mv[2]);
            fma4(acc[m], a.w, mv[3]);
          }
        }
      }
      __syncthreads();
    }
  }

  float* dst = out + (size_t)p * TO * OUTP + b * 128 + lane0 + lq * TN;
#pragma unroll
  for (int m = 0; m < MAX_TO / RG; ++m) {
    const int i = rg + RG * m;
    if (i < TO) {
      float4 v = acc[m];
      if (clip) {
        v.x = fminf(fmaxf(v.x, 0.f), 1.f);
        v.y = fminf(fmaxf(v.y, 0.f), 1.f);
        v.z = fminf(fmaxf(v.z, 0.f), 1.f);
        v.w = fminf(fmaxf(v.w, 0.f), 1.f);
      }
      *reinterpret_cast<float4*>(dst + (size_t)i * OUTP) = v;
    }
  }
}

}  // namespace

// Shapes as in the header; every pointer on the current device and 16-byte
// aligned.  The planner guarantees r0[p] + BAND <= N*Hin, c0s[b] + SPAN <=
// WINC, c0s[b] % 4 == 0 and 0 <= lo <= hi <= SPAN, both multiples of KC,
// in kr.
extern "C" int k1_fused_pipeline(const int* r0, const float* x, const float* wv,
                                 const float* gb, const int* kr,
                                 const int* c0s,
                                 const int* guids, float* out, int nprog,
                                 int ntiles, int nterms, int nb, int TO,
                                 int BAND, int SPAN, int WINC, int OUTP,
                                 int clip, void* stream) {
  if (nprog < 1 || nprog > 65535 || ntiles < 1 || nterms < 1 || nb < 1 ||
      TO < 1 || TO > MAX_TO || BAND < 1 || BAND % 4 != 0 || SPAN < KC ||
      SPAN % KC != 0 || OUTP != nb * 128 || WINC < SPAN || WINC % 4 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(nb * (128 / LC), nprog);
  fused_pipeline_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      r0, x, wv, gb, kr, c0s, guids, out, ntiles, nterms, nb, TO, BAND, SPAN,
      WINC, OUTP, clip);
  return cudaGetLastError();
}
