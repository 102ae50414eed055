// K2p: K2's function -- Gaussian blur -> unsharp mask (threshold 0) ->
//      sRGB->Lab->sRGB of an NHWC float32 batch with C = 3, edge-replicate
//      borders -- in a software-pipelined, warp-specialised schedule.
//
// Replaces imagemagick_tpu/ops/fused_pipeline.py:_kernel_pipe, built by
// _build_call_pipe and chosen by fused_blur_unsharp_pipeline when the Lab
// epilogue is on and the pipelined kernel is asked for: there the products
// of tile i run while the elementwise Lab epilogue of tile i-1 runs, and
// the band ring brings later tiles' inputs in the meantime.
//
// It computes K2's function (blur_unsharp.cu) with K2's order of fmaf for
// every value and the same Lab functions (lab_roundtrip.cuh):
//   z = Bg(x), u = Bu(z) read at clamped image coordinates,
//   y = clip(lab_to_rgb(rgb_to_lab(clip((1+g) z - g u)))).
//
// What bounds it on an H100: the bytes set the floor (config #2,
// 8 x 1080 x 1920 x 3: 199 MB in and 199 MB out, 0.1188 ms at 3.35 TB/s),
// but the stencils read shared memory once per FMA (about 75 reads per
// output value at 15 + 9 taps, the halo recomputed per tile) and the Lab
// epilogue spends nine powf / cbrtf per pixel.  K2 runs the two one after
// the other inside each block and leaves their overlap to other resident
// blocks; this schedule overlaps them inside one block.  Measured on an
// H100 SXM at 700 W it is a little slower than K2 (PERF.md): the stencils
// bind a throughput of the SM, which the overlap does not relieve.
// The schedule:
//  * A persistent grid: SMs x the blocks per SM that its shared memory
//    allows (one: 140 KB at 32-pixel tiles and 15 + 9 taps).  Block b
//    walks the tiles b, b + gridDim.x, ... over (image, tile row, tile
//    column), the tile column fastest; the last round of tiles leaves
//    some blocks one short.
//  * Warps split by role, 640 threads.  16 producer warps compute tile i
//    -- the two blur passes, the two unsharp passes, the mix and the clip
//    -- into stage slot i % 2 in shared memory, while 4 consumer warps run
//    the Lab round trip on slot (i - 1) % 2 and store that tile to device
//    memory (k2p_warp_split.py times other splits: more producer warps
//    help up to 16, more consumer warps do not).  Each slot has a full
//    and an empty named barrier: the side that hands the slot over does
//    bar.arrive, the side that waits for it bar.sync.  The producers sync
//    between their passes on a named barrier of their own, so no
//    block-wide barrier stalls the consumers.
//  * The next x window in flight.  Before they start on tile i the
//    producers start cp.async copies of tile i + 1's x window into the
//    second x buffer, one 4-byte copy per value from its clamped address
//    (so the border replicates as in K2), and wait for them only when
//    tile i + 1 begins.
// The block exits when its consumers have stored its last tile.

#include <climits>

#include <cuda_runtime.h>

#include "lab_roundtrip.cuh"

namespace {

constexpr int C = 3;
constexpr int PRODUCERS = 512;  // threads of the stencil warps
constexpr int CONSUMERS = 128;  // threads of the Lab-and-store warps
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int MAX_BLUR_TAPS = 33;
constexpr int MAX_UNSHARP_TAPS = 17;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

// named barriers; 0 is __syncthreads'
constexpr int BAR_PRODUCERS = 1;
constexpr int BAR_FULL = 2;   // + slot: the producers filled it
constexpr int BAR_EMPTY = 4;  // + slot: the consumers emptied it

using lab::clip01;
using lab::lab_roundtrip;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// shared floats: the taps, two x windows, the z window, the vertical-pass
// buffer and two stage slots
__host__ __device__ __forceinline__ int smem_floats(int T, int nb, int nu) {
  const int xs = T + 2 * (nu / 2) + 2 * (nb / 2), zs = T + 2 * (nu / 2);
  return nb + nu + 2 * xs * xs * C + zs * zs * C + zs * xs * C + 2 * T * T * C;
}

struct Tile {
  int n, y0, x0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int per_image,
                                        int T) {
  const int n = t / per_image;
  const int r = t - n * per_image;
  const int ty = r / tiles_x;
  return {n, ty * T, (r - ty * tiles_x) * T};
}

__global__ void __launch_bounds__(THREADS, 1)
blur_unsharp_pipe_kernel(const float* __restrict__ x, float* __restrict__ y,
                         const float* __restrict__ taps, int H, int W,
                         int nb, int nu, float gain, int T, int tiles_x,
                         int per_image, int ntiles) {
  extern __shared__ __align__(16) float smem[];
  const int rb = nb / 2, ru = nu / 2;
  const int xs = T + 2 * ru + 2 * rb;   // x window side, pixels
  const int zs = T + 2 * ru;            // z window side, pixels
  const int xrow = xs * C, zrow = zs * C;
  float* tp = smem;                     // nb blur taps, then nu unsharp taps
  const float* up = tp + nb;
  float* xwin = smem + nb + nu;         // two x windows of xs * xrow floats
  float* zw = xwin + 2 * xs * xrow;     // z window
  float* bw = zw + zs * zrow;           // vertical blur, then vertical unsharp
  float* stage = bw + zs * xrow;        // two slots of T * T * C floats
  const size_t plane = (size_t)H * W * C;
  // this block's tiles: blockIdx.x + k * gridDim.x for k < mine
  const int mine = (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  for (int k = threadIdx.x; k < nb + nu; k += THREADS) tp[k] = taps[k];
  __syncthreads();  // the only block-wide barrier, before the roles part

  if (threadIdx.x < PRODUCERS) {
    const int tid = threadIdx.x;
    // x window row i, pixel p of local tile li: image
    // (clamp(zy0 - rb + i), clamp(zx0 - rb + p)), by cp.async
    auto load_x = [&](int li) {
      const Tile tl = tile_at(blockIdx.x + li * gridDim.x, tiles_x,
                              per_image, T);
      const int zy0 = tl.y0 - ru, zx0 = tl.x0 - ru;
      const float* src = x + tl.n * plane;
      float* dst = xwin + (li & 1) * xs * xrow;
      for (int e = tid; e < xs * xrow; e += PRODUCERS) {
        const int i = e / xrow;
        const int rem = e - i * xrow;
        const int p = rem / C;
        const int c = rem - p * C;
        const int gy = min(max(zy0 - rb + i, 0), H - 1);
        const int gx = min(max(zx0 - rb + p, 0), W - 1);
        cp_async4(dst + e, src + ((size_t)gy * W + gx) * C + c);
      }
      cp_async_commit();
    };

    load_x(0);
    for (int li = 0; li < mine; ++li) {
      if (li + 1 < mine) {
        load_x(li + 1);         // in flight while this tile is computed
        cp_async_wait<1>();     // this tile's window has landed
      } else {
        cp_async_wait<0>();
      }
      bar_sync(BAR_PRODUCERS, PRODUCERS);  // ... for every producer
      const Tile tl = tile_at(blockIdx.x + li * gridDim.x, tiles_x,
                              per_image, T);
      const int zy0 = tl.y0 - ru, zx0 = tl.x0 - ru;
      const float* a = xwin + (li & 1) * xs * xrow;

      // z window (i, j) holds z at image (clamp(zy0 + i), clamp(zx0 + j));
      // its blur reads x rows clamp(zy0 + i) - rb .. + rb, which start at
      // x window row clamp(zy0 + i) - zy0; likewise for columns.
      // Vertical blur, over every column of the x window:
      for (int e = tid; e < zs * xrow; e += PRODUCERS) {
        const int i = e / xrow;
        const int lane = e - i * xrow;
        const float* col =
            a + (min(max(zy0 + i, 0), H - 1) - zy0) * xrow + lane;
        float acc = tp[0] * col[0];
        for (int k = 1; k < nb; ++k) acc = fmaf(tp[k], col[k * xrow], acc);
        bw[e] = acc;
      }
      bar_sync(BAR_PRODUCERS, PRODUCERS);

      // horizontal blur: a shift by one pixel is a shift by C floats
      for (int e = tid; e < zs * zrow; e += PRODUCERS) {
        const int i = e / zrow;
        const int rem = e - i * zrow;
        const int j = rem / C;
        const int c = rem - j * C;
        const float* row =
            bw + i * xrow + (min(max(zx0 + j, 0), W - 1) - zx0) * C + c;
        float acc = tp[0] * row[0];
        for (int k = 1; k < nb; ++k) acc = fmaf(tp[k], row[k * C], acc);
        zw[e] = acc;
      }
      bar_sync(BAR_PRODUCERS, PRODUCERS);

      // vertical unsharp pass: output row i reads z window rows i .. i + 2ru
      for (int e = tid; e < T * zrow; e += PRODUCERS) {
        const int i = e / zrow;
        const int lane = e - i * zrow;
        const float* col = zw + i * zrow + lane;
        float acc = up[0] * col[0];
        for (int k = 1; k < nu; ++k) acc = fmaf(up[k], col[k * zrow], acc);
        bw[e] = acc;
      }
      bar_sync(BAR_PRODUCERS, PRODUCERS);

      // horizontal unsharp pass and the mix into the stage slot, once the
      // consumers are done with the tile it held
      const int s = li & 1;
      if (li >= 2) bar_sync(BAR_EMPTY + s, THREADS);
      float* st = stage + s * T * T * C;
      for (int p = tid; p < T * T; p += PRODUCERS) {
        const int i = p / T;
        const int j = p - i * T;
        if (tl.y0 + i >= H || tl.x0 + j >= W) continue;
        for (int c = 0; c < C; ++c) {
          const float* row = bw + i * zrow + j * C + c;
          float u = up[0] * row[0];
          for (int k = 1; k < nu; ++k) u = fmaf(up[k], row[k * C], u);
          const float z = zw[(i + ru) * zrow + (j + ru) * C + c];
          st[p * C + c] = clip01((1.f + gain) * z - gain * u);
        }
      }
      bar_arrive(BAR_FULL + s, THREADS);
    }
  } else {
    const int tid = threadIdx.x - PRODUCERS;
    for (int li = 0; li < mine; ++li) {
      const int s = li & 1;
      bar_sync(BAR_FULL + s, THREADS);
      const Tile tl = tile_at(blockIdx.x + li * gridDim.x, tiles_x,
                              per_image, T);
      const float* st = stage + s * T * T * C;
      float* dst = y + tl.n * plane;
      for (int p = tid; p < T * T; p += CONSUMERS) {
        const int i = p / T;
        const int j = p - i * T;
        const int gy = tl.y0 + i, gx = tl.x0 + j;
        if (gy >= H || gx >= W) continue;
        float r = st[p * C], g = st[p * C + 1], bl = st[p * C + 2];
        lab_roundtrip(r, g, bl);
        float* o = dst + ((size_t)gy * W + gx) * C;
        o[0] = r;
        o[1] = g;
        o[2] = bl;
      }
      // the producers wait for this slot only if they have a tile for it
      if (li + 2 < mine) bar_arrive(BAR_EMPTY + s, THREADS);
    }
  }
}

}  // namespace

// x, y: (N, H, W, 3) float32, contiguous, on the current device.  taps: nb
// blur taps then nu unsharp taps, float32 on the device, both counts odd,
// nb <= 33, nu <= 17.  Always with the sRGB->Lab->sRGB round trip.
extern "C" int k2p_blur_unsharp_pipe(const float* x, float* y,
                                     const float* taps, int N, int H, int W,
                                     int nb, int nu, float gain,
                                     void* stream) {
  if (N < 1 || H < 1 || W < 1 || nb < 1 || nb > MAX_BLUR_TAPS ||
      nb % 2 == 0 || nu < 1 || nu > MAX_UNSHARP_TAPS || nu % 2 == 0)
    return cudaErrorInvalidValue;
  int T = 32;
  size_t smem = smem_floats(T, nb, nu) * sizeof(float);
  if (smem > MAX_SMEM) {
    T = 16;
    smem = smem_floats(T, nb, nu) * sizeof(float);
  }
  const int tiles_x = (W + T - 1) / T;
  const long long per_image = (long long)tiles_x * ((H + T - 1) / T);
  const long long ntiles = per_image * N;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      blur_unsharp_pipe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, blur_unsharp_pipe_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(ntiles < resident ? ntiles : resident);
  blur_unsharp_pipe_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, taps, H, W, nb, nu, gain, T, tiles_x, (int)per_image,
      (int)ntiles);
  return cudaGetLastError();
}
