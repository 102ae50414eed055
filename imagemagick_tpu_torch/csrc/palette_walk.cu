// The palette error-diffusion walks: Floyd-Steinberg and Riemersma.
//
// Replaces no Pallas kernel: the JAX package runs these walks as XLA
// loops, imagemagick_tpu/ops/quantize.py:floyd_steinberg (a lax.scan
// over rows around a fori_loop over columns; remap(..., dither=True)
// calls it) and quantize.py:riemersma (a lax.scan along the Hilbert
// curve).  Added because each step depends on the one before, so the
// walk is one long chain of dependent steps that no library call runs.
//
// What bounds it on an H100: latency, not bytes.  An image is H*W steps
// in a row, and each step needs the step before's error: at least one
// shared-memory round trip (the error row, or the palette) and the
// log2(32) = 5 levels of the warp's argmin shuffle (pw_step_cycles
// measures that chain on the card).  The only
// parallelism is across images and across palette entries.  What the
// design does about it:
//  * One warp an image, one block a warp: a batch of N images runs on N
//    SMs at once.  All 32 lanes compute the step's pixel and error (the
//    same values in every lane, so nothing is broadcast), and lane l
//    scores palette entries l, l+32, ..., then a shuffle argmin over the
//    lanes (ties to the lower index) gives every lane the nearest entry.
//  * The palette sits in shared memory transposed (channel-major), so
//    the 32 lanes of a warp read 32 consecutive words, one a bank.
//  * Floyd-Steinberg keeps its two error rows (W*C float32 each) in
//    shared memory while they fit beside the palette (W = 1920 at C = 4:
//    61 KB), else in device memory; at the start of a row the warp adds
//    the row's input into the incoming errors with coalesced loads, so a
//    step reads only shared memory.  Lane c writes channel c's output and
//    makes channel c's three adds to the next row, in the JAX order.
//  * Riemersma reads its pixels in Hilbert order: each lane loads one of
//    the next 32 pixels, the walk takes them from the lanes by shuffle,
//    and the following 32 are loaded while it does.
// Arithmetic: every add, subtract and multiply is __fadd_rn, __fsub_rn
// or __fmul_rn, so that nvcc contracts nothing into an FMA, and the
// squared distance is summed in channel order: the plain PyTorch
// versions (ops/quantize.py) give the same bits, and one rounding apart
// would move every later pixel.  Riemersma's err*decay + (v - new) is
// the one FMA (__fmaf_rn), because XLA contracts it on the CPU and the
// plain version rounds it once too (quantize._fma32).

#include <climits>
#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int MAXC = 8;           // channels the kernels take
constexpr unsigned FULL = 0xffffffffu;

// The index of the palette entry nearest px (first of equal distances),
// the same in every lane.  palT is the palette channel-major, C x K.
__device__ __forceinline__ int nearest(const float* palT, int K, int C,
                                       const float (&px)[MAXC], int lane) {
  float best = INFINITY;
  int bk = INT_MAX;
  for (int k = lane; k < K; k += WARP) {
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < C) {
        const float diff = __fsub_rn(palT[c * K + k], px[c]);
        const float sq = __fmul_rn(diff, diff);
        d = c == 0 ? sq : __fadd_rn(d, sq);
      }
    }
    if (d < best) {
      best = d;
      bk = k;
    }
  }
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, best, off);
    const int ok = __shfl_xor_sync(FULL, bk, off);
    if (od < best || (od == best && ok < bk)) {
      best = od;
      bk = ok;
    }
  }
  return bk == INT_MAX ? 0 : bk;   // no entry scored (NaN): the first
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

__device__ void load_palette(const float* __restrict__ pal, float* palT,
                             int K, int C, int lane) {
  for (int i = lane; i < K * C; i += WARP) {
    const int k = i / C, c = i - k * C;
    palT[c * K + k] = pal[i];
  }
}

__global__ void __launch_bounds__(WARP)
floyd_steinberg_kernel(const float* __restrict__ x,
                       const float* __restrict__ pal, float* __restrict__ out,
                       float* __restrict__ scratch, int H, int W, int C,
                       int K, int rows_in_shared) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const long long rowlen = (long long)W * C;
  float* palT = smem;
  load_palette(pal, palT, K, C, lane);
  float* cur = rows_in_shared ? smem + K * C
                              : scratch + (long long)blockIdx.x * 2 * rowlen;
  float* nxt = cur + rowlen;
  for (long long i = lane; i < rowlen; i += WARP) cur[i] = 0.0f;
  __syncwarp();
  const float* img = x + (long long)blockIdx.x * H * rowlen;
  float* dst = out + (long long)blockIdx.x * H * rowlen;
  int dir = 1;
  for (int y = 0; y < H; ++y) {
    // row = inp + below_err, in place; the next row's errors start at 0
    const float* src = img + (long long)y * rowlen;
#pragma unroll 8
    for (long long i = lane; i < rowlen; i += WARP) {
      cur[i] = __fadd_rn(src[i], cur[i]);
      nxt[i] = 0.0f;
    }
    __syncwarp();
    float* orow = dst + (long long)y * rowlen;
    float right[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) right[c] = 0.0f;
    for (int i = 0; i < W; ++i) {
      const int j = dir > 0 ? i : W - 1 - i;
      const int jl = min(max(j - dir, 0), W - 1);
      const int jr = min(max(j + dir, 0), W - 1);
      float old[MAXC], px[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        old[c] = c < C ? __fadd_rn(cur[j * C + c], right[c]) : 0.0f;
        px[c] = clip01(old[c]);
      }
      const int k = nearest(palT, K, C, px, lane);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          const float nw = palT[c * K + k];
          const float err = __fsub_rn(old[c], nw);
          right[c] = __fmul_rn(err, 0.4375f);
          if (lane == c) {
            orow[j * C + c] = nw;
            nxt[jl * C + c] = __fadd_rn(nxt[jl * C + c],
                                        __fmul_rn(err, 0.1875f));
            nxt[j * C + c] = __fadd_rn(nxt[j * C + c],
                                       __fmul_rn(err, 0.3125f));
            nxt[jr * C + c] = __fadd_rn(nxt[jr * C + c],
                                        __fmul_rn(err, 0.0625f));
          }
        }
      }
    }
    __syncwarp();
    float* t = cur;
    cur = nxt;
    nxt = t;
    dir = -dir;
  }
}

__global__ void __launch_bounds__(WARP)
riemersma_kernel(const float* __restrict__ x, const int* __restrict__ order,
                 const float* __restrict__ pal, float* __restrict__ out,
                 int HW, int C, int K, float decay) {
  extern __shared__ float palT[];
  const int lane = threadIdx.x;
  load_palette(pal, palT, K, C, lane);
  __syncwarp();
  const float* img = x + (long long)blockIdx.x * HW * C;
  float* dst = out + (long long)blockIdx.x * HW * C;
  float err[MAXC], mine[MAXC], ahead[MAXC], res[MAXC];
  int idx = lane < HW ? order[lane] : 0;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    err[c] = 0.0f;
    res[c] = 0.0f;
    ahead[c] = lane < HW && c < C ? img[(long long)idx * C + c] : 0.0f;
  }
  for (int t0 = 0; t0 < HW; t0 += WARP) {
    // this chunk's pixels in hand; the next chunk's loads in flight
    const int cur_idx = idx;
    const int t1 = t0 + WARP + lane;
    idx = t1 < HW ? order[t1] : 0;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      mine[c] = ahead[c];
      ahead[c] = t1 < HW && c < C ? img[(long long)idx * C + c] : 0.0f;
    }
    const int steps = min(WARP, HW - t0);
    for (int s = 0; s < steps; ++s) {
      float v[MAXC];
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        v[c] = clip01(__fadd_rn(__shfl_sync(FULL, mine[c], s), err[c]));
      const int k = nearest(palT, K, C, v, lane);
#pragma unroll
      for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
          const float nw = palT[c * K + k];
          if (lane == s) res[c] = nw;
          err[c] = __fmaf_rn(err[c], decay, __fsub_rn(v[c], nw));
        }
      }
    }
    if (t0 + lane < HW) {
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) dst[(long long)cur_idx * C + c] = res[c];
    }
  }
}

// The latency of one walk step at its narrowest (C = 1, K = 32), for the
// walks' bound: a shared-memory load of the entry the step before chose,
// one distance per lane and nearest()'s five shuffle levels, `steps`
// times in a chain.  Writes the SM cycles they took (clock64) to
// cycles[0], and the last entry to cycles[1] so that the chain is kept.
__global__ void __launch_bounds__(WARP)
step_cycles_kernel(const float* __restrict__ pal, int steps,
                   long long* __restrict__ cycles) {
  __shared__ float palT[WARP];
  const int lane = threadIdx.x;
  palT[lane] = pal[lane];
  __syncwarp();
  float px[MAXC] = {};
  int k = 0;
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
    px[0] = __fadd_rn(palT[k], 0.25f);
    k = nearest(palT, WARP, 1, px, lane);
  }
  const long long t1 = clock64();
  if (lane == 0) {
    cycles[0] = t1 - t0;
    cycles[1] = k;
  }
}

}  // namespace

// pal (32,) float32, cycles (2,) int64: one warp, `steps` dependent steps.
extern "C" int pw_step_cycles(const float* pal, int steps, long long* cycles,
                              void* stream) {
  if (steps < 1) return cudaErrorInvalidValue;
  step_cycles_kernel<<<1, WARP, 0, (cudaStream_t)stream>>>(pal, steps,
                                                           cycles);
  return cudaGetLastError();
}

// x (N, H, W, C), pal (K, C), out like x, all float32; scratch holds N x 2
// error rows where rows_in_shared is 0.  One block of one warp an image.
extern "C" int pw_floyd_steinberg(const float* x, const float* pal,
                                  float* out, float* scratch, int N, int H,
                                  int W, int C, int K, int rows_in_shared,
                                  void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > MAXC || K < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)K * C +
      (rows_in_shared ? 2 * (size_t)W * C : 0));
  cudaError_t err = cudaFuncSetAttribute(
      floyd_steinberg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  floyd_steinberg_kernel<<<N, WARP, smem, (cudaStream_t)stream>>>(
      x, pal, out, scratch, H, W, C, K, rows_in_shared);
  return cudaGetLastError();
}

// x (N, HW, C), order (HW,) int32 flat indices, pal (K, C), out like x.
extern "C" int pw_riemersma(const float* x, const int* order,
                            const float* pal, float* out, int N, int HW,
                            int C, int K, float decay, void* stream) {
  if (N < 1 || HW < 1 || C < 1 || C > MAXC || K < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)K * C;
  cudaError_t err = cudaFuncSetAttribute(
      riemersma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  riemersma_kernel<<<N, WARP, smem, (cudaStream_t)stream>>>(
      x, order, pal, out, HW, C, K, decay);
  return cudaGetLastError();
}
