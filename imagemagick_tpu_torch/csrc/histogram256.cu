// K4: one exact 256-bin histogram per row of a float32 matrix.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_hist_kernel (built by
// _build_hist, entered through pallas_histogram256 from
// histogram._histogram_fixed).  bin = clip(int(v * 255 + 0.5), 0, 255);
// config #3 (-auto-threshold otsu) counts the (N, H*W) intensities of a
// batch in one launch, one row per image.
//
// What bounds it on an H100: device-memory bandwidth, 4 bytes read per
// element and one shared-memory atomic per element.  The TPU kernel's
// 16x16 one-hot matrix product exists only for the TPU's matrix unit and
// is not carried over.  Each block keeps a private int32 histogram in
// shared memory, walks a contiguous share of one row with coalesced loads,
// and adds its non-zero bins into the row's global histogram at the end.
// Counts are exact in int32 (the TPU kernel's float32 sums stop being
// exact at 2^24).  A skewed row (a mostly white page) sends a warp's 32
// atomics to one bin, which serialises them; aggregating them per warp is
// the lever, left for later.
//
// The bin is computed with __fmul_rn and __fadd_rn so that nvcc does not
// contract v * 255 + 0.5 into an FMA (one rounding instead of two moves
// values that sit on a bin edge).  __float2int_rz saturates, and maps NaN
// to 0, before the clip.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BINS = 256;
constexpr int TARGET_BLOCKS = 132 * 8;  // 8 blocks on each of 132 SMs
constexpr int MIN_PER_BLOCK = THREADS * 16;

__global__ void __launch_bounds__(THREADS)
histogram256_kernel(const float* __restrict__ x, int* __restrict__ counts,
                    long long rowlen, int blocks_per_row, long long chunk) {
  __shared__ int hist[BINS];
  for (int b = threadIdx.x; b < BINS; b += THREADS) hist[b] = 0;
  __syncthreads();

  const int row = blockIdx.x / blocks_per_row;
  const long long part = blockIdx.x - (long long)row * blocks_per_row;
  const long long lo = part * chunk;
  const long long hi = lo + chunk < rowlen ? lo + chunk : rowlen;
  const float* src = x + row * rowlen;
  for (long long i = lo + threadIdx.x; i < hi; i += THREADS) {
    const float v = __fadd_rn(__fmul_rn(src[i], 255.0f), 0.5f);
    const int b = min(max(__float2int_rz(v), 0), BINS - 1);
    atomicAdd(&hist[b], 1);
  }
  __syncthreads();

  int* dst = counts + (long long)row * BINS;
  for (int b = threadIdx.x; b < BINS; b += THREADS)
    if (hist[b] != 0) atomicAdd(&dst[b], hist[b]);
}

}  // namespace

// x: (nrows, rowlen) float32, contiguous; counts: (nrows, 256) int32,
// zeroed by the caller, on the same device.
extern "C" int k4_histogram256(const float* x, int* counts, int nrows,
                               long long rowlen, void* stream) {
  if (nrows < 1 || rowlen < 1) return cudaErrorInvalidValue;
  long long per_row = (TARGET_BLOCKS + nrows - 1) / nrows;
  const long long most = (rowlen + MIN_PER_BLOCK - 1) / MIN_PER_BLOCK;
  if (per_row > most) per_row = most;
  const long long chunk = (rowlen + per_row - 1) / per_row;
  const int blocks_per_row = (int)((rowlen + chunk - 1) / chunk);
  const long long blocks = (long long)nrows * blocks_per_row;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  histogram256_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, counts, rowlen, blocks_per_row, chunk);
  return cudaGetLastError();
}
