// K1: the fused resize x blur x channel-mix pipeline as two banded products,
//     out[tile] = clip( sum_t WV_t[tile] @ (band @ G_t) ).
//
// Replaces imagemagick_tpu/ops/fused_pipeline.py:_kernel, plain variant
// (_mxu_stage and the clip of _vpu_stage), built by _build_call and entered
// through fused_resize_pipeline and fused_linear_pipeline.
//
// Operands: the host planner's, unchanged, and three tables derived from
// gb and wv (ops/fused_pipeline.py:plan_to_tensors):
//   r0    (nprog,) int32           absolute first input row of each program's band;
//                                  program p is image p / ntiles, row tile p % ntiles
//   x     (N*Hin, WINC) f32        input rows, channels interleaved in the lanes
//   wv    (T*ntiles, TO, BAND) f32 vertical operator of each term and row tile
//   gb    (n_unique, SPAN, 128) f32 deduplicated horizontal operator blocks
//   kr    (n_unique, 128/LB, 2) int32  [lo, hi) of the non-zero rows of
//                                  each LB-lane chunk of each block,
//                                  KC-aligned
//   hwin  (n_unique, 16, 2) int32  [lo, hi) of the non-zero rows of each
//                                  8-lane group, 4-aligned, inside kr
//   vwin  (T*ntiles, ceil(TO/16), 2) int32  [lo, hi) of the non-zero
//                                  columns of each 16-row group, 4-aligned
//   c0s   (nb,) int32              first input lane of each 128-lane output block
//   guids (T*nb,) int32            unique block of each (term, output block)
//   out   (nprog*TO, nb*128) f32
//
// What bounds it on an H100: device memory.  Config #1 (32 x 512x768x3 ->
// 256x256 gray, TO=64: BAND=176, SPAN=1280, nb=2, ntiles=4) moves 161 MB
// (the input once, the output once, the operators), 0.0480 ms at 3.35
// TB/s; the function's own arithmetic, each axis at its taps, takes less.
// K1 before this design did 6.55 GFLOP a step: each 32-lane chunk over
// the chunk's whole depth (456 input lanes, where eight adjacent output
// lanes read 238), each output row over all 192 padded band rows (16
// adjacent rows read 70).  Inside those windows the products are 3.29
// GFLOP (0.049 ms at 67 TFLOP/s).  Precision is full FP32 (no TF32): the
// fused route is held at >= 100 dB against float64.
//
// The design: one block of 128 threads per (program, 32-lane chunk of a
// 128-lane output block), so config #1 launches 1024 blocks.
// * Horizontal product, mid[RB, 32] = band[rows, c0 + k] @ G[k, lanes]:
//   each warp takes 8 of the chunk's lanes and all RB = 32 TM band rows
//   (lane l of the warp rows l + 32 m), and multiplies over its 8 lanes'
//   window from hwin only, a loop bound the whole warp shares.  TM is
//   chosen from BAND at launch (176 rows: TM = 6).  Each thread holds TM
//   rows x 8 lanes: per four input lanes it reads TM float4 of the band
//   and eight broadcast float4 of G for 32 TM FMAs.
// * The band and G are staged through shared memory in KC-deep slices of
//   the chunk's range kr, two buffers deep: cp.async copies slice s + 1
//   while slice s is multiplied.  The band's row stride is KC + 4 floats,
//   so eight threads reading eight rows hit eight bank groups.
// * Vertical product, out[TO, 32] += WV_t[:, rows] @ mid: a thread holds
//   two adjacent output rows x four lanes, whose window of band rows comes
//   from vwin (the 16-row group of the warp's rows), a loop bound the
//   whole warp shares.  WV is read from device memory through the
//   read-only cache; mid reuses the staging buffers.  With more than one
//   term or band chunk the output tile waits in shared memory between
//   them.
// * Each output's chain of FMAs keeps the order of the design before:
//   horizontal, ascending input lane within a band row, starting from 0;
//   vertical, term outer, then ascending band row.  Only terms whose
//   operator entry is 0 are left out, and fmaf(a, 0, acc) == acc for a
//   finite, so the result is bit for bit the one of K1 before.  A
//   non-finite input is outside K1's contract: the design before multiplied
//   it by the zeros this one skips.
// What still holds it near four times its bound (k1_split.py): every warp
// waits for every slice, and a chunk's four windows are offset, so about
// half the warps of a block have work in a slice; and staging each chunk's
// range from L2 moves 418 MB a step at config #1, which alone, with the
// products left out, takes about 0.15 ms.  Two lane groups a block (LB =
// 16, the rows split over two warps) stage more and were slower; one
// block a 128-lane block sweeping its whole range once was slower still
// (PERF.md).
// The TPU kernel's DMA ring, 128-lane blocking and bf16 three-pass split
// are scheduling and precision devices of that chip and are not carried
// over.

#include <cuda_runtime.h>

namespace {

constexpr int LB = 32;       // output lanes per block
constexpr int WL = 8;        // lanes of a warp in the horizontal product
constexpr int VR = 16;       // output rows of a warp in the vertical product
constexpr int KC = 16;       // input lanes per staged slice
constexpr int BS = KC + 4;   // the band slice's row stride, floats
constexpr int MS = LB + 4;   // mid's row stride, floats
constexpr int MAX_TO = 128;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// warps that share a lane group, each taking a share of the band rows: 1
// here; k1_split.py builds LB = 16, where it is 2
constexpr int HALVES = WARPS * WL / LB;
constexpr int MAX_TM = 6 / HALVES;        // at most 192 band rows a chunk
constexpr int MIN_BLOCKS = HALVES == 2 ? 6 : 4;  // blocks an SM, for ptxas
static_assert(HALVES * LB == WARPS * WL, "the warps cover the block's lanes");
static_assert(KC % 4 == 0, "slices hold whole float4");

// Shared-memory layout of a block, in floats: two staging buffers (band
// slice, then G slice), which mid reuses, then the output tile when it
// must wait between terms or band chunks.
template <int TM>
struct Layout {
  static constexpr int RB = 32 * HALVES * TM;        // band rows per chunk
  static constexpr int BAND_F = RB * BS;
  static constexpr int STAGE_F = BAND_F + KC * LB;
  static constexpr int MID_F = RB * MS;
  static constexpr int RING_F = 2 * STAGE_F > MID_F ? 2 * STAGE_F : MID_F;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src is then not read)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int TM>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_pipeline_kernel(const int* __restrict__ r0, const float* __restrict__ x,
                      const float* __restrict__ wv,
                      const float* __restrict__ gb,
                      const int* __restrict__ kr,
                      const int* __restrict__ hwin,
                      const int* __restrict__ vwin,
                      const int* __restrict__ c0s,
                      const int* __restrict__ guids, float* __restrict__ out,
                      int ntiles, int nterms, int nb, int TO, int BAND,
                      int SPAN, int WINC, int OUTP, int clip) {
  using Lay = Layout<TM>;
  constexpr int RB = Lay::RB;
  extern __shared__ __align__(16) float smem[];
  float* const ring = smem;                  // staging, then mid
  float* const tile_s = smem + Lay::RING_F;  // [TO][LB], when it must wait

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = warp / HALVES;             // lanes 8 grp .. 8 grp + 7
  const int half = warp % HALVES;            // rows lane + 32 (TM half + m)
  const int chunks = 128 / LB;
  const int b = blockIdx.x / chunks;         // 128-lane output block
  const int q = blockIdx.x % chunks;
  const int lane0 = q * LB;
  const int p = blockIdx.y;
  const int tt = p % ntiles;
  const size_t row0 = (size_t)r0[p];
  const int c0 = c0s[b];
  const int ngv = (TO + VR - 1) / VR;
  const int nchunk = (BAND + RB - 1) / RB;
  const int nit = ((TO + 1) / 2) * (LB / 4);  // (row pair, lane quad)
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < nterms; ++t) {
    const int gid = guids[t * nb + b];
    const float* g = gb + (size_t)gid * SPAN * 128 + lane0;
    const int u_lo = kr[(gid * chunks + q) * 2];
    const int u_hi = kr[(gid * chunks + q) * 2 + 1];
    const int* hw =
        hwin + ((size_t)gid * (128 / WL) + q * (LB / WL) + grp) * 2;
    const int h_lo = hw[0], h_hi = hw[1];
    const float* w = wv + (size_t)(t * ntiles + tt) * TO * BAND;
    const int* vw = vwin + (size_t)(t * ntiles + tt) * ngv * 2;
    const int nsl = (u_hi - u_lo) / KC;
    for (int ci = 0; ci < nchunk; ++ci) {
      const int rc = ci * RB;
      // -- mid[RB, LB] = band[rc:rc+RB, c0+k] @ G[k, lanes] -------------
      auto stage = [&](int s) {
        float* band_s = ring + (s & 1) * Lay::STAGE_F;
        float* g_s = band_s + Lay::BAND_F;
        const int k0 = u_lo + s * KC;
        for (int e = threadIdx.x; e < RB * KC / 4; e += THREADS) {
          const int i = e / (KC / 4);
          const int c = (e % (KC / 4)) * 4;
          const bool in = rc + i < BAND;
          cp_async16(band_s + i * BS + c,
                     in ? x + (row0 + rc + i) * WINC + c0 + k0 + c : x, in);
        }
        for (int e = threadIdx.x; e < KC * LB / 4; e += THREADS) {
          const int s2 = e / (LB / 4);
          const int j = (e % (LB / 4)) * 4;
          cp_async16(g_s + s2 * LB + j, g + (size_t)(k0 + s2) * 128 + j,
                     true);
        }
        cp_async_commit();
      };
      float4 acc[TM][2];             // rows lane + 32 (TM half + m)
#pragma unroll
      for (int m = 0; m < TM; ++m) acc[m][0] = acc[m][1] = zero;
      if (nsl > 0) stage(0);
      for (int s = 0; s < nsl; ++s) {
        if (s + 1 < nsl) {
          stage(s + 1);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* band_s = ring + (s & 1) * Lay::STAGE_F;
        const float* g_s = band_s + Lay::BAND_F;
        const int k0 = u_lo + s * KC;
        const int kb = max(h_lo, k0), ke = min(h_hi, k0 + KC);
        for (int k = kb; k < ke; k += 4) {   // the warp's window only
          const int kk = k - k0;
          float4 a[TM];
#pragma unroll
          for (int m = 0; m < TM; ++m)
            a[m] = *reinterpret_cast<const float4*>(
                &band_s[(lane + 32 * (TM * half + m)) * BS + kk]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 g0 = *reinterpret_cast<const float4*>(
                &g_s[(kk + u) * LB + grp * WL]);
            const float4 g1 = *reinterpret_cast<const float4*>(
                &g_s[(kk + u) * LB + grp * WL + 4]);
#pragma unroll
            for (int m = 0; m < TM; ++m) {
              const float av = comp(a[m], u);
              fma4(acc[m][0], av, g0);
              fma4(acc[m][1], av, g1);
            }
          }
        }
        __syncthreads();
      }
      float* mid_s = ring;
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        float* row = &mid_s[(lane + 32 * (TM * half + m)) * MS + grp * WL];
        *reinterpret_cast<float4*>(row) = acc[m][0];
        *reinterpret_cast<float4*>(row + 4) = acc[m][1];
      }
      __syncthreads();
      // -- out[TO, LB] += WV_t[:, rc:rc+RB] @ mid ------------------------
      const bool first = t == 0 && ci == 0;
      const bool last = t == nterms - 1 && ci == nchunk - 1;
      for (int e = threadIdx.x; e < nit; e += THREADS) {
        const int i0 = (e / (LB / 4)) * 2;   // rows i0, i0 + 1
        const int jq = (e % (LB / 4)) * 4;   // lanes jq .. jq+3
        const int vg = i0 / VR;              // the same for the whole warp
        const int k_lo = max(vw[vg * 2], rc);
        const int k_hi = min(vw[vg * 2 + 1], rc + RB);
        float4 o[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          o[r] = first || i0 + r >= TO
              ? zero
              : *reinterpret_cast<const float4*>(
                    &tile_s[(i0 + r) * LB + jq]);
        for (int k = k_lo; k < k_hi; k += 4) {
          float4 mv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            mv[u] = *reinterpret_cast<const float4*>(
                &mid_s[(k - rc + u) * MS + jq]);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if (i0 + r < TO) {
              const float4 a = __ldg(reinterpret_cast<const float4*>(
                  w + (size_t)(i0 + r) * BAND + k));
              fma4(o[r], a.x, mv[0]);
              fma4(o[r], a.y, mv[1]);
              fma4(o[r], a.z, mv[2]);
              fma4(o[r], a.w, mv[3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + r;
          if (i >= TO) continue;
          float4 v = o[r];
          if (!last) {
            *reinterpret_cast<float4*>(&tile_s[i * LB + jq]) = v;
            continue;
          }
          if (clip) {
            v.x = fminf(fmaxf(v.x, 0.f), 1.f);
            v.y = fminf(fmaxf(v.y, 0.f), 1.f);
            v.z = fminf(fmaxf(v.z, 0.f), 1.f);
            v.w = fminf(fmaxf(v.w, 0.f), 1.f);
          }
          *reinterpret_cast<float4*>(
              out + ((size_t)p * TO + i) * OUTP + b * 128 + lane0 + jq) = v;
        }
      }
      __syncthreads();   // mid and the tile are read before the next stage
    }
  }
}

template <int TM>
int launch(const int* r0, const float* x, const float* wv, const float* gb,
           const int* kr, const int* hwin, const int* vwin, const int* c0s,
           const int* guids, float* out, int nprog, int ntiles, int nterms,
           int nb, int TO, int BAND, int SPAN, int WINC, int OUTP, int clip,
           cudaStream_t stream) {
  const int nchunk = (BAND + Layout<TM>::RB - 1) / Layout<TM>::RB;
  const bool waits = nterms * nchunk > 1;
  const size_t smem =
      sizeof(float) * (Layout<TM>::RING_F + (waits ? TO * LB : 0));
  const cudaError_t err = cudaFuncSetAttribute(
      fused_pipeline_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nb * (128 / LB), nprog);
  fused_pipeline_kernel<TM><<<grid, THREADS, smem, stream>>>(
      r0, x, wv, gb, kr, hwin, vwin, c0s, guids, out, ntiles, nterms, nb, TO,
      BAND, SPAN, WINC, OUTP, clip);
  return cudaGetLastError();
}

// launch<tm>, for 1 <= tm <= MAX_TM
template <int TM, class... Args>
int launch_tm(int tm, Args... args) {
  if (tm == TM) return launch<TM>(args...);
  if constexpr (TM < MAX_TM) return launch_tm<TM + 1>(tm, args...);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shapes as in the header; every pointer on the current device and 16-byte
// aligned.  The planner guarantees r0[p] + BAND <= N*Hin, c0s[b] + SPAN <=
// WINC, c0s[b] % 4 == 0, and the tables that every [lo, hi) of kr is
// KC-aligned inside [0, SPAN], every one of hwin 4-aligned inside its
// chunk's, and every one of vwin 4-aligned inside [0, BAND].
extern "C" int k1_fused_pipeline(const int* r0, const float* x, const float* wv,
                                 const float* gb, const int* kr,
                                 const int* hwin, const int* vwin,
                                 const int* c0s, const int* guids, float* out,
                                 int nprog, int ntiles, int nterms, int nb,
                                 int TO, int BAND, int SPAN, int WINC,
                                 int OUTP, int clip, void* stream) {
  if (nprog < 1 || nprog > 65535 || ntiles < 1 || nterms < 1 || nb < 1 ||
      TO < 1 || TO > MAX_TO || BAND < 1 || BAND % 4 != 0 || SPAN < 32 ||
      SPAN % 32 != 0 || OUTP != nb * 128 || WINC < SPAN || WINC % 4 != 0)
    return cudaErrorInvalidValue;
  constexpr int ROWS = 32 * HALVES;          // band rows a TM step adds
  const int tm = BAND >= ROWS * MAX_TM ? MAX_TM : (BAND + ROWS - 1) / ROWS;
  return launch_tm<1>(tm, r0, x, wv, gb, kr, hwin, vwin, c0s, guids, out,
                      nprog, ntiles, nterms, nb, TO, BAND, SPAN, WINC, OUTP,
                      clip, (cudaStream_t)stream);
}
