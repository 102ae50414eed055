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
// tile).  It copies the x tile with a halo of bt/2 + ut/2 pixels once into
// shared memory with cp.async (an interior tile's rows as 16-byte chunks
// where x's rows are 16-byte aligned, else float by float from clamped
// coordinates), then runs four passes: the vertical blur, the horizontal
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

#include "lab_roundtrip.cuh"
#include "stencil.cuh"

namespace {

constexpr int MAX_BLUR_TAPS = 33;
constexpr int MAX_UNSHARP_TAPS = 17;
constexpr int MAX_CHANNELS = 8;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr int RUN = 8;  // outputs a thread computes in passes 1-3

using lab::clip01;
using lab::lab_roundtrip;
using stencil::clampi;
using stencil::cp_async16;
using stencil::cp_async4;
using stencil::cp_async_wait_all;
using stencil::for_items;
using stencil::for_items3;
using stencil::imax;
using stencil::run;

// Everything the kernel reads besides x, by value: the taps sit in the
// constant bank with the other kernel arguments.
struct Args {
  const float* x;
  float* y;
  float bt[MAX_BLUR_TAPS];
  float ut[MAX_UNSHARP_TAPS];
  int H, W, C, nb, nu, lab;
  int vec;  // x is 16-byte aligned and W * C % 4 == 0: so is every row
  float gain;
};

// The buffers of a TW x TH tile with C channels and radii rb, ru, in
// floats.  Buffer A holds the x window, then the z window; buffer B the
// vertical blur, then the vertical unsharp pass, then the output tile.
struct Geo {
  int xw, xh;      // x window: pixels, rows
  int zw, zh;      // z window: pixels, rows
  int xl, zl, sl;  // floats a row: x window (and vertical blur), z window
                   // (and vertical unsharp pass), output tile
  int xa;          // row stride of the x window: a multiple of 4, with
                   // room for a row shifted by up to 3 floats
  int xp, zp, sp;  // row strides of the others: odd
  int a, b;        // floats of A and of B
};

__host__ __device__ constexpr Geo geometry(int TW, int TH, int C, int rb,
                                           int ru) {
  const int xw = TW + 2 * (ru + rb), xh = TH + 2 * (ru + rb);
  const int zw = TW + 2 * ru, zh = TH + 2 * ru;
  const int xa = (xw * C + 6) / 4 * 4;
  const int xp = (xw * C) | 1, zp = (zw * C) | 1, sp = (TW * C) | 1;
  return {xw, xh, zw, zh, xw * C, zw * C, TW * C, xa, xp, zp, sp,
          imax(xh * xa, zh * zp), imax(zh * xp, imax(TH * zp, TH * sp))};
}

// CT, NB, NU: the channels and tap counts, or 0 for those read from p at
// run time; NT threads, at least MINB blocks an SM.
template <int CT, int NB, int NU, int TW, int TH, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
blur_unsharp_kernel(const Args p) {
  extern __shared__ float smem[];
  const int C = CT ? CT : p.C;
  const int nb = NB ? NB : p.nb, nu = NU ? NU : p.nu;
  const int rb = nb / 2, ru = nu / 2;
  const Geo g = geometry(TW, TH, C, rb, ru);
  float* const A = smem;
  float* const B = smem + g.a;
  const int H = p.H, W = p.W;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int zy0 = y0 - ru, zx0 = x0 - ru;    // image position of z (0, 0)
  const int wy0 = zy0 - rb, wx0 = zx0 - rb;  // image position of x (0, 0)
  const size_t rowlen = (size_t)W * C;
  const size_t plane = (size_t)H * rowlen;

  // x window row i, lane l (pixel l / C) at A[sh + i * xa + l]: image
  // (clamp(wy0 + i), clamp(wx0 + l / C)).  An interior tile whose rows are
  // 16-byte aligned in step copies each row as one run of 16-byte chunks,
  // the shift sh keeping shared and device addresses equal modulo 16
  // bytes (the chunks at the ends take up to 3 floats of the image row on
  // either side); a border tile copies float by float from clamped
  // coordinates.
  int sh = 0;
  {
    const float* src = p.x + blockIdx.z * plane;
    if (p.vec && wy0 >= 0 && wy0 + g.xh <= H && wx0 >= 0 &&
        wx0 + g.xw <= W) {
      const size_t s0 = wy0 * rowlen + (size_t)wx0 * C;
      sh = (int)(s0 & 3);
      const float* base = src + (s0 - sh);
      for_items<NT>(g.xh, (g.xl + sh + 3) / 4, [&](int i, int k) {
        cp_async16(A + i * g.xa + 4 * k, base + i * rowlen + 4 * k);
      });
    } else {
      for_items3<NT>(g.xh, g.xw, C, [&](int i, int px, int c) {
        const int gy = clampi(wy0 + i, 0, H - 1);
        const int gx = clampi(wx0 + px, 0, W - 1);
        cp_async4(A + i * g.xa + px * C + c,
                  src + gy * rowlen + (size_t)gx * C + c);
      });
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // 1. vertical blur of every lane of the x window, z rows 0 .. zh-1 as if
  // unclamped: run ri covers rows i0 .. i0+RUN-1 (the last run overlaps
  // its neighbour rather than run past the window)
  for_items<NT>((g.zh + RUN - 1) / RUN, g.xl, [&](int ri, int l) {
    const int i0 = min(ri * RUN, g.zh - RUN);
    const float* col = A + sh + i0 * g.xa + l;
    float out[RUN];
    run<RUN, NB>(p.bt, nb, [&](int q) { return col[q * g.xa]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) B[(i0 + r) * g.xp + l] = out[r];
  });
  __syncthreads();

  // 2. horizontal blur into the z window: z row i is z of image row
  // clamp(zy0 + i), so it reads that row's vertical blur; columns as if
  // unclamped.  Rows fastest: a warp takes 32 rows of one column run.
  for_items3<NT>((g.zw + RUN - 1) / RUN, C, g.zh, [&](int m, int c, int i) {
    const int j0 = min(m * RUN, g.zw - RUN);
    const float* row =
        B + (clampi(zy0 + i, 0, H - 1) - zy0) * g.xp + j0 * C + c;
    float out[RUN];
    run<RUN, NB>(p.bt, nb, [&](int q) { return row[q * C]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) A[i * g.zp + (j0 + r) * C + c] = out[r];
  });
  __syncthreads();

  // 3. vertical unsharp pass, tile rows 0 .. TH-1 over every lane of the z
  // window; on a tile at the left or right border, lane (j, c) reads z of
  // column clamp(zx0 + j)
  const bool inside_x = zx0 >= 0 && zx0 + g.zw <= W;
  for_items3<NT>(TH / RUN, g.zw, C, [&](int ri, int j, int c) {
    const int l = j * C + c;
    const int ls =
        inside_x ? l : (clampi(zx0 + j, 0, W - 1) - zx0) * C + c;
    const float* col = A + ri * RUN * g.zp + ls;
    float out[RUN];
    run<RUN, NU>(p.ut, nu, [&](int q) { return col[q * g.zp]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) B[(ri * RUN + r) * g.zp + l] = out[r];
  });
  __syncthreads();

  // 4. horizontal unsharp pass, the mix, the clip and Lab, RUN4 pixels of
  // all channels a thread (up to 4, fewer where the tile has fewer pixels
  // than 4 a thread), rows fastest; held in registers until every thread
  // has read B, then staged in B.  The channel loops unroll to CM, the
  // most channels the kernel takes, and stop at C, so res is indexed by
  // constants and stays in registers.
  constexpr int CM = CT ? CT : MAX_CHANNELS;
  constexpr int RUN4 = TW * TH >= 4 * NT ? 4 : TW * TH >= 2 * NT ? 2 : 1;
  constexpr int ITEMS = TH * (TW / RUN4);
  constexpr int PER_THREAD = (ITEMS + NT - 1) / NT;
  float res[PER_THREAD][CM][RUN4];
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) {
    const int q = threadIdx.x + s * NT;
    if (ITEMS % NT == 0 || q < ITEMS) {
      const int i = q % TH, j0 = q / TH * RUN4;  // TH is a power of two
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (!CT && c >= C) break;
        const float* row = B + i * g.zp + j0 * C + c;
        float u[RUN4];
        run<RUN4, NU>(p.ut, nu, [&](int k) { return row[k * C]; }, u);
        const float* zc = A + (i + ru) * g.zp + (j0 + ru) * C + c;
#pragma unroll
        for (int r = 0; r < RUN4; ++r)
          res[s][c][r] = clip01((1.f + p.gain) * zc[r * C] - p.gain * u[r]);
      }
      if constexpr (CM >= 3) {
        if (C == 3 && p.lab) {
#pragma unroll
          for (int r = 0; r < RUN4; ++r)
            lab_roundtrip(res[s][0][r], res[s][1][r], res[s][2][r]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < PER_THREAD; ++s) {
    const int q = threadIdx.x + s * NT;
    if (ITEMS % NT == 0 || q < ITEMS) {
      float* o = B + (q % TH) * g.sp + q / TH * RUN4 * C;
#pragma unroll
      for (int r = 0; r < RUN4; ++r) {
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (!CT && c >= C) break;
          o[r * C + c] = res[s][c][r];
        }
      }
    }
  }
  __syncthreads();

  // the tile's rows and pixels inside the image, coalesced
  float* dst = p.y + blockIdx.z * plane + y0 * rowlen + (size_t)x0 * C;
  for_items<NT>(min(TH, H - y0), min(TW, W - x0) * C, [&](int i, int l) {
    dst[i * rowlen + l] = B[i * g.sp + l];
  });
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
