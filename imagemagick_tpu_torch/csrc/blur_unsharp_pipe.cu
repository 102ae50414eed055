// K2p: K2's function -- Gaussian blur -> unsharp mask (threshold 0) ->
//      sRGB->Lab->sRGB of an NHWC float32 batch with C = 3, edge-replicate
//      borders -- in a warp-specialised, software-pipelined schedule.
//
// Replaces imagemagick_tpu/ops/fused_pipeline.py:_kernel_pipe, built by
// _build_call_pipe and chosen by fused_blur_unsharp_pipeline when the Lab
// epilogue is on and the pipelined kernel is asked for: there the products
// of tile i run while the elementwise Lab epilogue of tile i-1 runs, and
// the band ring brings later tiles' inputs in the meantime.
//
// It computes K2's function with K2's own tile passes (blur_unsharp.cuh:
// the same register-window stencils, the same chain of fmaf for every
// value, the same mix) and the same Lab functions (lab_roundtrip.cuh), so
// it equals K2 on every value:
//   z = Bg(x), u = Bu(z) read at clamped image coordinates,
//   y = clip(lab_to_rgb(rgb_to_lab(clip((1+g) z - g u)))).
//
// What bounds it on an H100: the bytes set the floor (config #2,
// 8 x 1080 x 1920 x 3: 199 MB in and 199 MB out, 0.1188 ms at 3.35 TB/s);
// above it, the instructions the SM issues: the stencils' loads and FMAs
// and the Lab epilogue's powf, cbrtf and divisions, about half each in K2.
// K2 runs the two one after the other inside each block and leaves their
// overlap to the other resident block; this schedule overlaps them inside
// one block.
// The schedule:
//  * A persistent grid, one block an SM (its shared memory allows no
//    more).  Block b walks the tiles b, b + gridDim.x, ... over (image,
//    tile row, tile column), the tile column fastest; the last round of
//    tiles leaves some blocks one short.
//  * Three roles, by warp.  One load warp copies tile i+1's x window into
//    x slot (i+1) % 2 while the compute warps run K2's four passes of
//    tile i on slot i % 2: the x window becomes the z window in place,
//    and the vertical passes go through one buffer B of the compute
//    warps' own.  The compute warps write the mix of tile i into stage
//    slot i % 2, while the Lab warps convert stage slot (i-1) % 2, four
//    pixels a thread at once, and store that tile's pixels inside the
//    image.  (Staging the converted tile for coalesced row stores, as K2
//    does, was 5 % slower: an extra barrier and two more passes through
//    shared memory for the Lab warps, which bind.)
//  * The load warp's copies: where x's rows are 16-byte aligned, each
//    window row's pixels inside the image as one bulk copy by the TMA
//    unit (cp.async.bulk), rounded out to 16-byte chunks; on left and
//    right border tiles the replicated pixels beyond the image one float
//    at a time by cp.async.  (TMA's tensor copies fill out-of-bounds
//    pixels with zeros, not the edge pixel, and per-float cp.async from
//    one warp took about 19 us a tile, longer than the passes.)
//  * Handover by mbarrier, not bar.sync: each slot has a full and an
//    empty barrier.  The bulk copies count their bytes off the x slot's
//    full barrier and the load warp's cp.async copies arrive on it as
//    they land (cp.async.mbarrier.arrive.noinc); the compute warps arrive
//    on its empty barrier after their last read of it, and on the stage
//    slot's full barrier after writing it; the Lab warps arrive on the
//    stage slot's empty barrier after their stores.  Waits are
//    try_wait.parity on the slot's use count, so each role runs up to a
//    slot ahead of the next.  The compute warps sync between their passes
//    on a named barrier of their own.
//  * Shared memory, config #2 (64 x 32 tiles, 15 + 9 taps, floats): two x
//    slots of 54 rows x 264 (14,256 each: the x window, 86 pixels with the
//    halo, its rows padded to 16 bytes, later the 40 x 217 z window), B of
//    40 x 259 (10,360: the vertical blur, later the 32 x 217 vertical
//    unsharp pass), two stage slots of 32 x 193 (6,176 each), and 8
//    mbarriers: 51,240 floats, 204,960 bytes of the 232,448 a block may
//    use.  A third x slot would not fit.  The generic kernel (run-time tap
//    counts up to 33 + 17, 32 x 32 tiles): at 33 + 17 taps two slots of
//    80 x 244, B of 48 x 241 and two stage slots of 32 x 97: 227,328
//    bytes.
//  * Warps: config #2's kernel 1 load, 15 compute and 16 Lab warps (16 x
//    32 x 4 pixels: one tile a pass), 1024 threads at 64 registers; the
//    generic kernel 1 + 8 + 8 warps (its run-time loops need more
//    registers).  k2p_warp_split.py times other splits, and copies
//    without each role's work.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "blur_unsharp.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr int C = 3;
constexpr int LOADERS = 32;          // threads of the load warp
constexpr int CONFIG2_COMPUTE = 480;  // threads of the stencil warps
constexpr int CONFIG2_LAB = 512;      // threads of the Lab-and-store warps
constexpr int GENERIC_COMPUTE = 256;
constexpr int GENERIC_LAB = 256;
constexpr int LAB_PIXELS = 4;         // pixels a Lab thread converts at once
constexpr int BAR_COMPUTE = 1;       // the compute warps' named barrier
constexpr int BARRIERS = 8;          // x full, x empty, stage full, stage
                                     // empty, two slots each

using bu::Args;
using bu::Geo;
using bu::geometry;
using bu::MAX_BLUR_TAPS;
using bu::MAX_UNSHARP_TAPS;
using lab::lab_roundtrip;

// -- mbarriers in shared memory ---------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(
          smem_addr(bar))
      : "memory");
}

// arrives on bar once every cp.async this thread has issued has landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits until the phase of bar with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// adds `bytes` to what the bulk copies of bar's current phase must bring
__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar,
                                                  unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// copies `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory with the TMA unit, which counts them off
// bar's current phase as they land
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// orders the shared-memory accesses this thread has synchronised with
// before its later bulk copies (which write through the async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// -- the tile walk ---------------------------------------------------------

struct Pipe {
  Args a;
  int tiles_x, per_image, ntiles;
};

template <int TW, int TH>
__device__ __forceinline__ bu::Tile tile_at(const Pipe& q, int li) {
  const int t = blockIdx.x + li * gridDim.x;
  const int n = t / q.per_image;
  const int r = t - n * q.per_image;
  const int ty = r / q.tiles_x;
  return {n, ty * TH, (r - ty * q.tiles_x) * TW};
}

// -- the x window -------------------------------------------------------

// The shift sh of tile t's window rows in their slot: pixel px of window
// row i at A[i * xa + sh + px * C], so that 16-byte chunks of an image
// row land on 16-byte boundaries of the slot (0 where x's rows are not
// 16-byte aligned in step).
template <class T>
__device__ __forceinline__ int slot_shift(const Args& p, const bu::Ctx<T>& k,
                                          bu::Tile t) {
  const int wx0 = t.x0 - k.ru - k.rb;
  return p.vec ? (wx0 * C % 4 + 4) % 4 : 0;
}

// The load warp's copy of tile t's x window into slot A, pixel px of row i
// being image (clamp(wy0 + i), clamp(wx0 + px)) as in K2.  Where x's rows
// are 16-byte aligned: each window row's pixels inside the image as one
// bulk copy of the clamped image row (rounded out to 16-byte chunks,
// never past the row's ends), lane i taking rows i, i + 32, ...; the
// pixels left and right of the image, on border tiles, one float at a
// time from the edge pixel by cp.async.  Else every float by cp.async.
// The bulk copies count their bytes off `full`; the caller arrives on it
// for the cp.async copies.
template <class T>
__device__ __forceinline__ void load_window(const Args& p,
                                            const bu::Ctx<T>& k, bu::Tile t,
                                            int sh, float* A, uint64_t* full,
                                            int lane) {
  const Geo& g = k.g;
  const int H = p.H, W = p.W;
  const int wy0 = t.y0 - k.ru - k.rb, wx0 = t.x0 - k.ru - k.rb;
  const float* src = p.x + t.n * k.plane;
  auto copy_float = [&](int i, int px, int c) {
    const int gy = stencil::clampi(wy0 + i, 0, H - 1);
    const int gx = stencil::clampi(wx0 + px, 0, W - 1);
    stencil::cp_async4(A + i * g.xa + sh + px * C + c,
                       src + gy * k.rowlen + (size_t)gx * C + c);
  };
  if (!p.vec) {
    stencil::for_items3<LOADERS>(lane, g.xh, g.xw, C, copy_float);
    return;
  }
  const int c0 = max(wx0, 0) * C, c1 = min(wx0 + g.xw, W) * C;
  const int a0 = c0 & ~3, a1 = (c1 + 3) & ~3;
  const unsigned bytes = (unsigned)(a1 - a0) * sizeof(float);
  if (lane == 0) mbar_expect_bytes(full, bytes * g.xh);
  __syncwarp();
  for (int i = lane; i < g.xh; i += LOADERS) {
    const int gy = stencil::clampi(wy0 + i, 0, H - 1);
    bulk_copy(A + i * g.xa + sh + a0 - wx0 * C, src + gy * k.rowlen + a0,
              bytes, full);
  }
  const int left = max(-wx0, 0), right = max(wx0 + g.xw - W, 0);
  if (left + right > 0) {
    stencil::for_items3<LOADERS>(lane, g.xh, left + right, C,
                                 [&](int i, int q, int c) {
      copy_float(i, q < left ? q : g.xw - right + (q - left), c);
    });
  }
}

// floats of each region of shared memory, after the barriers: an x slot
// (16-byte aligned), B, a stage slot
struct Layout {
  int xs, b, ss;
};

__host__ __device__ constexpr Layout layout(const Geo& g, int TH) {
  return {(g.a + 3) / 4 * 4, g.b, TH * g.sp};
}

__host__ __device__ constexpr int smem_floats(const Geo& g, int TH) {
  return 2 * BARRIERS + 2 * layout(g, TH).xs + layout(g, TH).b +
         2 * layout(g, TH).ss;
}

// NB, NU: the tap counts, or 0 for those read from the arguments; a TW x
// TH tile; NTC compute threads, NTL Lab threads, after the load warp.
template <int NB, int NU, int TW, int TH, int NTC, int NTL>
__global__ void __launch_bounds__(LOADERS + NTC + NTL, 1)
blur_unsharp_pipe_kernel(const Pipe q) {
  using T = bu::Tiling<C, NB, NU, TW, TH, NTC>;
  extern __shared__ __align__(16) float smem[];
  const Args& p = q.a;
  const bu::Ctx<T> k(p);
  const Geo& g = k.g;
  const Layout L = layout(g, TH);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem);
  uint64_t* const x_full = bars;
  uint64_t* const x_empty = bars + 2;
  uint64_t* const s_full = bars + 4;
  uint64_t* const s_empty = bars + 6;
  float* const xslot = smem + 2 * BARRIERS;
  float* const B = xslot + 2 * L.xs;
  float* const stage = B + L.b;
  // this block's tiles: blockIdx.x + li * gridDim.x for li < mine
  const int mine = (q.ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(x_full + s, LOADERS);
      mbar_init(x_empty + s, NTC);
      mbar_init(s_full + s, NTC);
      mbar_init(s_empty + s, NTL);
    }
  }
  __syncthreads();  // the only block-wide barrier, before the roles part

  // slot s = li % 2 serves local tiles li = s, s + 2, ...; its u-th use
  // (u = li / 2) waits for phase u of its full barrier and, from u = 1,
  // for phase u - 1 of its empty barrier
  if (threadIdx.x < LOADERS) {
    const int tid = threadIdx.x;
    for (int li = 0; li < mine; ++li) {
      const int s = li & 1, u = li >> 1;
      if (u > 0) mbar_wait(x_empty + s, (u - 1) & 1);
      fence_async_shared();
      const bu::Tile t = tile_at<TW, TH>(q, li);
      load_window(p, k, t, slot_shift(p, k, t), xslot + s * L.xs,
                  x_full + s, tid);
      mbar_arrive_copies(x_full + s);
    }
    stencil::cp_async_wait_all();  // exit with no copy in flight
  } else if (threadIdx.x < LOADERS + NTC) {
    const int tid = threadIdx.x - LOADERS;
    for (int li = 0; li < mine; ++li) {
      const int s = li & 1, u = li >> 1;
      const bu::Tile t = tile_at<TW, TH>(q, li);
      float* const A = xslot + s * L.xs;
      mbar_wait(x_full + s, u & 1);
      // every compute thread is done with B from the last tile
      bar_sync(BAR_COMPUTE, NTC);
      bu::vertical_blur<T>(p, k, A, B, slot_shift(p, k, t), tid);
      bar_sync(BAR_COMPUTE, NTC);
      bu::horizontal_blur<T>(p, k, t, A, B, tid);
      bar_sync(BAR_COMPUTE, NTC);
      bu::vertical_unsharp<T>(p, k, t, A, B, tid);
      bar_sync(BAR_COMPUTE, NTC);
      float res[T::PER_THREAD][T::CM][T::RUN4];
      bu::unsharp_mix<T>(p, k, A, B, res, tid);
      mbar_arrive(x_empty + s);
      if (u > 0) mbar_wait(s_empty + s, (u - 1) & 1);
      float* const st = stage + s * L.ss;
#pragma unroll
      for (int m = 0; m < T::PER_THREAD; ++m) {
        const int it = tid + m * NTC;
        if (T::ITEMS % NTC == 0 || it < T::ITEMS) {
          float* o = st + (it % TH) * g.sp + it / TH * T::RUN4 * C;
#pragma unroll
          for (int r = 0; r < T::RUN4; ++r) {
#pragma unroll
            for (int c = 0; c < C; ++c) o[r * C + c] = res[m][c][r];
          }
        }
      }
      mbar_arrive(s_full + s);
    }
  } else {
    const int tid = threadIdx.x - LOADERS - NTC;
    for (int li = 0; li < mine; ++li) {
      const int s = li & 1, u = li >> 1;
      const bu::Tile t = tile_at<TW, TH>(q, li);
      mbar_wait(s_full + s, u & 1);
      const float* const st = stage + s * L.ss;
      const int rows = min(TH, p.H - t.y0), cols = min(TW, p.W - t.x0);
      float* const dst =
          p.y + t.n * k.plane + t.y0 * k.rowlen + (size_t)t.x0 * C;
      // LAB_PIXELS pixels a thread at once, pixel base + r * NTL, so that
      // their Lab chains interleave (outside the image: Lab of a dummy
      // value, not stored)
      for (int base = tid; base < TW * TH; base += NTL * LAB_PIXELS) {
        float v[LAB_PIXELS][C];
        bool in[LAB_PIXELS];
        int at[LAB_PIXELS];
#pragma unroll
        for (int r = 0; r < LAB_PIXELS; ++r) {
          const int px = base + r * NTL;
          const int i = px / TW, j = px - i * TW;
          in[r] = px < TW * TH && i < rows && j < cols;
          at[r] = i * (int)k.rowlen + j * C;
#pragma unroll
          for (int c = 0; c < C; ++c)
            v[r][c] = in[r] ? st[i * g.sp + j * C + c] : 0.5f;
        }
#pragma unroll
        for (int r = 0; r < LAB_PIXELS; ++r)
          lab_roundtrip(v[r][0], v[r][1], v[r][2]);
#pragma unroll
        for (int r = 0; r < LAB_PIXELS; ++r) {
          if (in[r]) {
#pragma unroll
            for (int c = 0; c < C; ++c) dst[at[r] + c] = v[r][c];
          }
        }
      }
      mbar_arrive(s_empty + s);
    }
  }
}

size_t smem_bytes(int TW, int TH, int nb, int nu) {
  return (size_t)smem_floats(geometry(TW, TH, C, nb / 2, nu / 2), TH) *
         sizeof(float);
}

template <int NB, int NU, int TW, int TH, int NTC, int NTL>
cudaError_t launch(const Args& args, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(TW, TH, args.nb, args.nu);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  Pipe q{args, (args.W + TW - 1) / TW, 0, 0};
  const long long per_image = (long long)q.tiles_x * ((args.H + TH - 1) / TH);
  const long long ntiles = per_image * N;
  if (ntiles > INT_MAX) return cudaErrorInvalidValue;
  q.per_image = (int)per_image;
  q.ntiles = (int)ntiles;
  auto* kernel = blur_unsharp_pipe_kernel<NB, NU, TW, TH, NTC, NTL>;
  constexpr int threads = LOADERS + NTC + NTL;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(ntiles < resident ? ntiles : resident);
  kernel<<<grid, threads, smem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, 3) float32, contiguous, on the current device.  taps: nb
// blur taps then nu unsharp taps, float32 in HOST memory (passed to the
// kernel by value), both counts odd, nb <= 33, nu <= 17.  Always with the
// sRGB->Lab->sRGB round trip.
extern "C" int k2p_blur_unsharp_pipe(const float* x, float* y,
                                     const float* taps, int N, int H, int W,
                                     int nb, int nu, float gain,
                                     void* stream) {
  if (N < 1 || H < 1 || W < 1 || nb < 1 || nb > MAX_BLUR_TAPS ||
      nb % 2 == 0 || nu < 1 || nu > MAX_UNSHARP_TAPS || nu % 2 == 0)
    return cudaErrorInvalidValue;
  Args args{};
  args.x = x;
  args.y = y;
  for (int k = 0; k < nb; ++k) args.bt[k] = taps[k];
  for (int k = 0; k < nu; ++k) args.ut[k] = taps[nb + k];
  args.H = H;
  args.W = W;
  args.C = C;
  args.nb = nb;
  args.nu = nu;
  args.lab = 1;
  args.vec = (size_t)W * C % 4 == 0 && (uintptr_t)x % 16 == 0;
  args.gain = gain;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nb == 15 && nu == 9)
    return launch<15, 9, 64, 32, CONFIG2_COMPUTE, CONFIG2_LAB>(args, N, s);
  return launch<0, 0, 32, 32, GENERIC_COMPUTE, GENERIC_LAB>(args, N, s);
}
