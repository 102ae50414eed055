// K4: one exact 256-bin histogram per row of a float32 matrix.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_hist_kernel (built by
// _build_hist, entered through pallas_histogram256 from
// histogram._histogram_fixed).  bin = clip(int(v * 255 + 0.5), 0, 255);
// config #3 (-auto-threshold otsu) counts the (N, H*W) intensities of a
// batch in one launch, one row per image.
//
// What bounds it on an H100: device-memory bandwidth, 4 bytes read per
// element (config #3: 55.2 MB, 0.0165 ms at 3.35 TB/s).  The TPU kernel's
// 16x16 one-hot matrix product exists only for the TPU's matrix unit and
// is not carried over.  What the design does about it:
//  * Loads.  Each row is cut into a scalar head of up to 3 values (up to
//    the first 16-byte boundary of the row's own address: row r starts at
//    byte 4 r rowlen, so a row is aligned only when rowlen % 4 == 0), a
//    body of float4s and a scalar tail of up to 3 values.  The row's
//    blocks share its body in equal runs of float4s; the first block also
//    counts the head, the last the tail.  Each thread issues UNROLL float4
//    loads before it counts any of their 16 values, so about 64 KB an SM
//    are in flight.  Four blocks an SM (528 on an H100) read config #3
//    faster than six (k4_split.py).
//  * Skew.  The block counts into 32 copies of the histogram in shared
//    memory, one per lane: hist[bin * 32 + lane].  A warp's 32 lanes then
//    never add to one address in one instruction, whatever their bins (a
//    white page sends them all to bin 255, a near-white one to a few
//    bins), and each lane's copy sits in its own bank.  Warps of the block
//    do share a lane's copy, so the adds are shared-memory atomics.  At
//    the end each of the 256 threads sums one bin over the 32 copies,
//    starting at its own bank.
//  * One launch.  A row read by one block is written as float32 counts
//    by that block.  A row shared by several blocks: each adds its
//    non-zero totals into the row's int32 accumulator in a scratch buffer,
//    fences, and takes a ticket from the row's counter; the block that
//    draws the last ticket reads and zeroes the accumulator (atomicExch),
//    writes the float32 counts and resets the counter.  The scratch is
//    zero when the launch begins and is left zero when it ends, so the
//    wrapper keeps one per device and stream and needs no memset.
// Counts stay exact in int32 until the final conversion to float32
// (round to nearest, as the plain version's int64 -> float32).
//
// The bin is computed with __fmul_rn and __fadd_rn so that nvcc does not
// contract v * 255 + 0.5 into an FMA (one rounding instead of two moves
// values that sit on a bin edge).  __float2int_rz saturates, and maps NaN
// to 0, before the clip.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // also the bins each thread sums
constexpr int BINS = 256;
constexpr int LANES = 32;
constexpr int UNROLL = 4;          // float4 loads a thread has in flight
constexpr int BLOCKS_PER_SM = 4;   // 32 KB of shared memory each
constexpr int MIN_VECS = THREADS * UNROLL;  // float4s a block at least

__device__ __forceinline__ int bin_of(float v) {
  const float f = __fadd_rn(__fmul_rn(v, 255.0f), 0.5f);
  return min(max(__float2int_rz(f), 0), BINS - 1);
}

// floats before the first 16-byte boundary at or after p
__device__ __forceinline__ int head_of(const float* p) {
  return (int)((16 - ((uintptr_t)p & 15)) & 15) / 4;
}

__global__ void __launch_bounds__(THREADS)
histogram256_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int* __restrict__ acc, int* __restrict__ tickets,
                    int rowlen, int per_row) {
  __shared__ int hist[BINS * LANES];
  const int tid = threadIdx.x, lane = tid & (LANES - 1);
  for (int i = tid; i < BINS * LANES / 4; i += THREADS)
    reinterpret_cast<int4*>(hist)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int row = blockIdx.x / per_row;
  const int part = blockIdx.x - row * per_row;
  const float* src = x + (long long)row * rowlen;
  const int head = min(head_of(src), rowlen);
  const int nvec = (rowlen - head) / 4;
  const int tail = rowlen - head - 4 * nvec;
  const int run = (nvec + per_row - 1) / per_row;
  const int lo = min(part * run, nvec), hi = min(lo + run, nvec);
  auto count = [&](float v) {
    atomicAdd(&hist[bin_of(v) * LANES + lane], 1);
  };

  if (part == 0 && tid < head) count(src[tid]);
  if (part == per_row - 1 && tid < tail) count(src[head + 4 * nvec + tid]);
  const float4* body = reinterpret_cast<const float4*>(src + head);
  for (int base = lo + tid; base < hi; base += THREADS * UNROLL) {
    float4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (base + u * THREADS < hi) q[u] = __ldcs(body + base + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (base + u * THREADS < hi) {
        count(q[u].x);
        count(q[u].y);
        count(q[u].z);
        count(q[u].w);
      }
    }
  }
  __syncthreads();

  int total = 0;
#pragma unroll 8
  for (int k = 0; k < LANES; ++k)
    total += hist[tid * LANES + ((k + tid) & (LANES - 1))];
  float* dst = out + (long long)row * BINS;
  if (per_row == 1) {
    dst[tid] = __int2float_rn(total);
    return;
  }
  int* sum = acc + (long long)row * BINS;
  if (total != 0) atomicAdd(&sum[tid], total);
  __threadfence();
  __syncthreads();
  __shared__ bool last;
  if (tid == 0) last = atomicAdd(&tickets[row], 1) == per_row - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  dst[tid] = __int2float_rn(atomicExch(&sum[tid], 0));
  if (tid == 0) tickets[row] = 0;
}

}  // namespace

// x: (nrows, rowlen) float32, contiguous; out: (nrows, 256) float32;
// scratch: (scratch_rows * 257) int32, zero, on the same device: the
// accumulators of up to scratch_rows rows, then their tickets.  Left zero.
extern "C" int k4_histogram256(const float* x, float* out, int* scratch,
                               int scratch_rows, int nrows, int rowlen,
                               void* stream) {
  if (nrows < 1 || rowlen < 1 || (uintptr_t)x % 4 != 0)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // SMs of each device, looked up once; the carveout leaves room for
  // BLOCKS_PER_SM blocks an SM
  static int sms_of[64] = {};
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    err = cudaFuncSetAttribute(histogram256_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int sms = sms_of[dev];
  // blocks a row: one resident wave over all rows, each block at least
  // MIN_VECS float4s of its row
  const long long target = (long long)sms * BLOCKS_PER_SM;
  long long per_row = target / nrows;
  const long long most = (rowlen / 4 + MIN_VECS - 1) / MIN_VECS;
  if (per_row > most) per_row = most;
  if (per_row < 1) per_row = 1;
  if (per_row > 1 && nrows > scratch_rows) return cudaErrorInvalidValue;
  const long long blocks = (long long)nrows * per_row;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  histogram256_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x, out, scratch, scratch + (long long)scratch_rows * BINS, rowlen,
      (int)per_row);
  return cudaGetLastError();
}
