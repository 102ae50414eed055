// K2: Gaussian blur -> unsharp mask (threshold 0) -> optional sRGB->Lab->sRGB
//     of an NHWC float32 batch, edge-replicate borders.
//
// Replaces imagemagick_tpu/ops/fused_pipeline.py:_kernel with its unsharp
// epilogue (_vpu_stage), h-pass stencil (_h_mid_stencil), column-chunk
// interleave and Lab epilogue (_lab_roundtrip_rows), built by _build_call
// and entered through fused_blur_unsharp_pipeline.
//
// Computes, for taps bt (odd, <= 33) and ut (odd, <= 17) and gain g:
//   z = Bg(x)                 separable blur by bt, borders replicate x
//   u = Bu(z)                 separable blur by ut, borders replicate z
//   y = clip((1+g) z - g u)
//   y = clip(lab_to_rgb(rgb_to_lab(y)))        when lab (C == 3)
// The unsharp blur reads z at CLAMPED image coordinates: within ut/2
// pixels of a border its halo holds z of the edge pixel, not a blur
// evaluated outside the image (the Pallas kernel's Mv_ext rows and its
// edge-pixel lane padding).  Every value is the chain acc = t[0] v[0],
// then fmaf(t[k], v[k], acc) for k ascending, on the values K2p
// (blur_unsharp_pipe.cu) and the plain version read, so K2 and K2p agree
// bit for bit; the Lab epilogue is lab_roundtrip.cuh's, shared with K2p.
//
// What bounds it on an H100: device-memory traffic sets the floor (config
// #2, 8 x 1080 x 1920 x 3: 199 MB in and 199 MB out, about 0.12 ms at
// 3.35 TB/s).  The stencils' 65-75 FMAs per output value (15 + 9 taps,
// with the halo recomputed per tile) and Lab's nine powf / cbrtf per
// pixel come next; the first version, which loaded a tap and a datum from
// shared memory for each FMA, was bound by those loads.
// What the design does about it: one block per (image, TW x TH output
// tile). Its passes are blur_unsharp.cuh's, which K2p runs too. It copies
// the x tile with a halo of bt/2 + ut/2 pixels once into shared memory with
// cp.async (an interior tile's rows as 16-byte chunks where x's rows are
// 16-byte aligned, else float by float from clamped coordinates), then runs
// four passes: the vertical blur, the horizontal
// blur (z), the vertical unsharp blur, and the horizontal unsharp blur
// with the mix, the clip and Lab.  In each pass a thread computes a run
// of outputs along the stencil's axis from a window of values it loads
// into registers once: R outputs of an n-tap stencil cost R + n - 1
// loads and R n FMAs.  The taps reach the kernel by value, as kernel
// arguments, and feed the FMAs from the constant bank.  Two kernels: one
// for config #2 (C = 3, 15 + 9 taps, all compile-time, so the loops
// unroll exactly) and a generic one that reads C and the tap counts at
// run time, its loops unrolled to the largest counts and left where the
// count ends.  Threads walk their items with 2-D and 3-D indices and
// strides; a thread splits its first item and its stride once a pass,
// so no item costs an integer division.  The buffers the passes read
// across rows have an odd row stride in floats, so the horizontal passes,
// whose warps take 32 rows at one column, load from 32 different banks,
// as do the vertical ones, whose warps take 32 neighbouring lanes of one
// row.
// Clamping: the vertical blur is computed for every z row as if
// unclamped, and the horizontal blur of z row i reads the row of image
// row clamp(zy0 + i), which is the clamped z row's; the horizontal blur
// runs unclamped too, and the vertical unsharp pass reads z of column
// clamp(zx0 + j) on border tiles.  So only the x window copy and two
// per-thread offsets clamp.  Results go through shared memory to a
// coalesced store that drops what lies outside the image.  Config #2's
// tile is 64 x 32 with 512 threads, two blocks an SM (9 % faster than 32 x
// 32 with 256 threads, three blocks an SM: the Lab epilogue wants the
// warps); the generic kernel's is 32 x 32 with 256 threads, or 16 x 16
// where the 32-tile windows would not fit in a block's shared memory
// (C >= 6 at 33 + 17 taps).  The TPU kernel's
// banded matrix products, lane rolls and lane fields serve its matrix
// unit and 128-lane layout and are not carried over.

#include <cstdint>

#include <cuda_runtime.h>

#include "blur_unsharp.cuh"

namespace {

constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

using bu::Args;
using bu::Geo;
using bu::geometry;
using bu::MAX_BLUR_TAPS;
using bu::MAX_CHANNELS;
using bu::MAX_UNSHARP_TAPS;
using lab::lab_roundtrip;
using stencil::clampi;
using stencil::cp_async16;
using stencil::cp_async4;
using stencil::cp_async_wait_all;
using stencil::for_items;
using stencil::for_items3;

// The shift sh of tile t's x window in A (see copy_window), or -1 where
// the window is copied float by float.
template <class T>
__device__ __forceinline__ int window_shift(const Args& p,
                                            const bu::Ctx<T>& k, bu::Tile t) {
  const Geo& g = k.g;
  const int wy0 = t.y0 - k.ru - k.rb, wx0 = t.x0 - k.ru - k.rb;
  if (p.vec && wy0 >= 0 && wy0 + g.xh <= p.H && wx0 >= 0 &&
      wx0 + g.xw <= p.W)
    return (int)((wy0 * k.rowlen + (size_t)wx0 * k.C) & 3);
  return -1;
}

// Starts the copy of tile t's x window into A, the block's threads
// sharing it: x window row i, lane l (pixel l / C) at A[sh + i * xa + l]
// is image (clamp(wy0 + i), clamp(wx0 + l / C)).  An interior tile whose
// rows are 16-byte aligned in step copies each row as one run of 16-byte
// chunks, the shift sh keeping shared and device addresses equal modulo
// 16 bytes (the chunks at the ends take up to 3 floats of the image row
// on either side); a border tile (sh = -1) copies float by float from
// clamped coordinates, unshifted.  The caller waits for the copies.
template <class T>
__device__ __forceinline__ void copy_window(const Args& p,
                                            const bu::Ctx<T>& k, bu::Tile t,
                                            int sh, float* A) {
  const Geo& g = k.g;
  const int C = k.C, H = p.H, W = p.W;
  const int wy0 = t.y0 - k.ru - k.rb, wx0 = t.x0 - k.ru - k.rb;
  const float* src = p.x + t.n * k.plane;
  if (sh >= 0) {
    const float* base = src + (wy0 * k.rowlen + (size_t)wx0 * C - sh);
    for_items<T::NT>(g.xh, (g.xl + sh + 3) / 4, [&](int i, int q) {
      cp_async16(A + i * g.xa + 4 * q, base + i * k.rowlen + 4 * q);
    });
    return;
  }
  for_items3<T::NT>(g.xh, g.xw, C, [&](int i, int px, int c) {
    const int gy = clampi(wy0 + i, 0, H - 1);
    const int gx = clampi(wx0 + px, 0, W - 1);
    cp_async4(A + i * g.xa + px * C + c,
              src + gy * k.rowlen + (size_t)gx * C + c);
  });
}

// CT, NB, NU: the channels and tap counts, or 0 for those read from p at
// run time; NT threads, at least MINB blocks an SM.
template <int CT, int NB, int NU, int TW, int TH, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
blur_unsharp_kernel(const Args p) {
  using T = bu::Tiling<CT, NB, NU, TW, TH, NT>;
  extern __shared__ float smem[];
  const bu::Ctx<T> k(p);
  const Geo& g = k.g;
  const int C = k.C, tid = threadIdx.x;
  float* const A = smem;
  float* const B = smem + g.a;
  const bu::Tile t{(int)blockIdx.z, (int)blockIdx.y * TH,
                   (int)blockIdx.x * TW};

  const int sh = window_shift(p, k, t);
  copy_window(p, k, t, sh, A);
  cp_async_wait_all();
  __syncthreads();
  bu::vertical_blur<T>(p, k, A, B, sh, tid);
  __syncthreads();
  bu::horizontal_blur<T>(p, k, t, A, B, tid);
  __syncthreads();
  bu::vertical_unsharp<T>(p, k, t, A, B, tid);
  __syncthreads();

  // 4. the horizontal unsharp pass, the mix and the clip, then Lab, held
  // in registers until every thread has read B, then staged in B
  float res[T::PER_THREAD][T::CM][T::RUN4];
  bu::unsharp_mix<T>(p, k, A, B, res, tid);
  if constexpr (T::CM >= 3) {
    if (C == 3 && p.lab) {
#pragma unroll
      for (int s = 0; s < T::PER_THREAD; ++s) {
        const int q = tid + s * NT;
        if (T::ITEMS % NT == 0 || q < T::ITEMS) {
#pragma unroll
          for (int r = 0; r < T::RUN4; ++r)
            lab_roundtrip(res[s][0][r], res[s][1][r], res[s][2][r]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < T::PER_THREAD; ++s) {
    const int q = tid + s * NT;
    if (T::ITEMS % NT == 0 || q < T::ITEMS) {
      float* o = B + (q % TH) * g.sp + q / TH * T::RUN4 * C;
#pragma unroll
      for (int r = 0; r < T::RUN4; ++r) {
#pragma unroll
        for (int c = 0; c < T::CM; ++c) {
          if (!CT && c >= C) break;
          o[r * C + c] = res[s][c][r];
        }
      }
    }
  }
  __syncthreads();

  // the tile's rows and pixels inside the image, coalesced
  float* dst = p.y + t.n * k.plane + t.y0 * k.rowlen + (size_t)t.x0 * C;
  for_items<NT>(min(TH, p.H - t.y0), min(TW, p.W - t.x0) * C,
                [&](int i, int l) { dst[i * k.rowlen + l] = B[i * g.sp + l]; });
}

size_t smem_bytes(int TW, int TH, int C, int nb, int nu) {
  const Geo g = geometry(TW, TH, C, nb / 2, nu / 2);
  return (size_t)(g.a + g.b) * sizeof(float);
}

template <int CT, int NB, int NU, int TW, int TH, int NT, int MINB>
cudaError_t launch(const Args& args, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(TW, TH, args.C, args.nb, args.nu);
  if (smem > MAX_SMEM || (args.H + TH - 1) / TH > 65535)
    return cudaErrorInvalidValue;
  auto* kernel = blur_unsharp_kernel<CT, NB, NU, TW, TH, NT, MINB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.W + TW - 1) / TW, (args.H + TH - 1) / TH, N);
  kernel<<<grid, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, C) float32, contiguous, on the current device; C <= 8.
// taps: nb blur taps then nu unsharp taps, float32 in HOST memory (passed
// to the kernel by value), both counts odd, nb <= 33, nu <= 17.  lab
// (C == 3 only): the sRGB->Lab->sRGB round trip after the unsharp mix.
extern "C" int k2_blur_unsharp(const float* x, float* y, const float* taps,
                               int N, int H, int W, int C, int nb, int nu,
                               float gain, int lab, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > MAX_CHANNELS ||
      nb < 1 || nb > MAX_BLUR_TAPS || nb % 2 == 0 || nu < 1 ||
      nu > MAX_UNSHARP_TAPS || nu % 2 == 0 || (lab && C != 3))
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
  args.lab = lab;
  args.vec = (size_t)W * C % 4 == 0 && (uintptr_t)x % 16 == 0;
  args.gain = gain;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 3 && nb == 15 && nu == 9)
    return launch<3, 15, 9, 64, 32, 512, 2>(args, N, s);
  if (smem_bytes(32, 32, C, nb, nu) <= MAX_SMEM)
    return launch<0, 0, 0, 32, 32, 256, 2>(args, N, s);
  return launch<0, 0, 0, 16, 16, 256, 2>(args, N, s);
}
