// K3: separable odd-tap blur of an NHWC float32 batch, edge-replicate borders.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_blur_kernel (built by
// _build_blur, entered through fused_separable_blur from
// blur._separable_conv).
//
// Computes, for n odd taps t (n <= 33) and C <= 8 channels:
//   v = vertical blur of x by t, rows clamped to the image
//   y = horizontal blur of v by t, columns clamped to the image
// Every value is the chain acc = t[0] w[0], then fmaf(t[k], w[k], acc) for
// k ascending, on the clamped window: the vertical pass first, as the
// first version of this kernel computed it, so the two agree bit for bit.
//
// What bounds it on an H100: device-memory bandwidth.  An output value
// costs 2n FMAs against one 4-byte read and one 4-byte write (config #2,
// 8 x 1080 x 1920 x 3: 199 MB each way, 0.1188 ms at 3.35 TB/s; at 15 taps
// the 1.49 G FMAs take 0.045 ms at the FP32 peak).  The first version
// loaded a tap and a datum from shared memory for each FMA, and shared
// memory bound it at 5-7x the floor.
// What the design does about it: one block per (image, TW x TH output
// tile).  It copies the x window, the tile with a halo of n/2 pixels on
// each side, once into shared memory with cp.async (an interior tile's
// rows as 16-byte chunks where x's rows are 16-byte aligned, else float by
// float from clamped coordinates), runs the vertical pass into a second
// buffer and the horizontal pass out of it, and stages the tile in shared
// memory for a coalesced store that drops what lies outside the image.
// In each pass a thread computes a run of RUN outputs along the stencil's
// axis from RUN + n - 1 values it loads into registers once
// (stencil.cuh's run, shared with K2), and the taps reach the kernel by
// value, as kernel arguments, so the FMAs read them from the constant
// bank.  The vertical pass takes 32 neighbouring lanes of a row a warp;
// the horizontal pass takes 32 rows at one column run a warp, over an
// odd row stride, so both hit 32 banks.  Items are walked with 2-D and
// 3-D indices (stencil.cuh), with no integer division per item.  Two
// kernels: one with C = 3 and the tap count compile-time, for config #1's
// and config #2's blurs (15 and 9 taps), on 64 x 32 tiles of 512 threads
// (the window 1.75 times the tile at 15 taps, against 2.07 on 32 x 32);
// and a generic one that reads C and n at run time, its loops unrolled to
// 33 taps and left where n ends, on 32 x 32 tiles of 256 threads (198 KB
// of shared memory at C = 8 and 33 taps).

#include <cstdint>

#include <cuda_runtime.h>

#include "stencil.cuh"

namespace {

constexpr int MAX_TAPS = 33;
constexpr int MAX_CHANNELS = 8;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr int RUN = 8;               // outputs a thread computes a pass

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
  float t[MAX_TAPS];
  int H, W, C, n;
  int vec;  // x is 16-byte aligned and W * C % 4 == 0: so is every row
};

// The buffers of a TW x TH tile with C channels and radius r, in floats.
// Buffer A holds the x window, then the output tile; buffer B the
// vertical pass.
struct Geo {
  int xw, xh;  // x window: pixels, rows
  int xl;      // floats a row of the x window and of the vertical pass
  int xa;      // row stride of the x window: a multiple of 4, with room
               // for a row shifted by up to 3 floats
  int bp, sp;  // row strides of the vertical pass and the output tile: odd
  int a, b;    // floats of A and of B
};

__host__ __device__ constexpr Geo geometry(int TW, int TH, int C, int r) {
  const int xw = TW + 2 * r, xh = TH + 2 * r;
  const int xa = (xw * C + 6) / 4 * 4;
  const int bp = (xw * C) | 1, sp = (TW * C) | 1;
  return {xw, xh, xw * C, xa, bp, sp, imax(xh * xa, TH * sp), TH * bp};
}

// CT, NTAPS: the channels and the tap count, or 0 for those read from p at
// run time; NT threads, at least MINB blocks an SM.
template <int CT, int NTAPS, int TW, int TH, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
separable_blur_kernel(const Args p) {
  static_assert(TW % RUN == 0 && TH % RUN == 0, "runs tile the tile");
  extern __shared__ float smem[];
  const int C = CT ? CT : p.C;
  const int n = NTAPS ? NTAPS : p.n;
  const int r = n / 2;
  const Geo g = geometry(TW, TH, C, r);
  float* const A = smem;
  float* const B = smem + g.a;
  const int H = p.H, W = p.W;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wy0 = y0 - r, wx0 = x0 - r;  // image position of the window
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

  // 1. vertical pass over every lane of the window, tile rows 0 .. TH-1
  // (window rows i .. i+n-1 for tile row i); a warp takes 32 neighbouring
  // lanes of one run of rows
  for_items<NT>(TH / RUN, g.xl, [&](int ri, int l) {
    const float* col = A + sh + ri * RUN * g.xa + l;
    float out[RUN];
    run<RUN, NTAPS>(p.t, n, [&](int q) { return col[q * g.xa]; }, out);
#pragma unroll
    for (int k = 0; k < RUN; ++k) B[(ri * RUN + k) * g.bp + l] = out[k];
  });
  __syncthreads();

  // 2. horizontal pass into the output tile in A, the window no longer
  // needed: pixel j of channel c reads the vertical pass at pixels j ..
  // j+n-1 of the window.  Rows fastest: a warp takes 32 rows of one
  // column run.
  for_items3<NT>(TW / RUN, C, TH, [&](int m, int c, int i) {
    const float* row = B + i * g.bp + m * RUN * C + c;
    float out[RUN];
    run<RUN, NTAPS>(p.t, n, [&](int q) { return row[q * C]; }, out);
#pragma unroll
    for (int k = 0; k < RUN; ++k)
      A[i * g.sp + (m * RUN + k) * C + c] = out[k];
  });
  __syncthreads();

  // the tile's rows and pixels inside the image, coalesced
  float* dst = p.y + blockIdx.z * plane + y0 * rowlen + (size_t)x0 * C;
  for_items<NT>(min(TH, H - y0), min(TW, W - x0) * C, [&](int i, int l) {
    dst[i * rowlen + l] = A[i * g.sp + l];
  });
}

size_t smem_bytes(int TW, int TH, int C, int n) {
  const Geo g = geometry(TW, TH, C, n / 2);
  return (size_t)(g.a + g.b) * sizeof(float);
}

template <int CT, int NTAPS, int TW, int TH, int NT, int MINB>
cudaError_t launch(const Args& args, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(TW, TH, args.C, args.n);
  if (smem > MAX_SMEM || (args.H + TH - 1) / TH > 65535)
    return cudaErrorInvalidValue;
  auto* kernel = separable_blur_kernel<CT, NTAPS, TW, TH, NT, MINB>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((args.W + TW - 1) / TW, (args.H + TH - 1) / TH, N);
  kernel<<<grid, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

// x, y: (N, H, W, C) float32, contiguous, on the current device; C <= 8.
// taps: ntaps float32 in HOST memory (passed to the kernel by value),
// ntaps odd and at most 33.
extern "C" int k3_separable_blur(const float* x, float* y, const float* taps,
                                 int N, int H, int W, int C, int ntaps,
                                 void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > MAX_CHANNELS || N > 65535 ||
      ntaps < 1 || ntaps > MAX_TAPS || ntaps % 2 == 0)
    return cudaErrorInvalidValue;
  Args args{};
  args.x = x;
  args.y = y;
  for (int k = 0; k < ntaps; ++k) args.t[k] = taps[k];
  args.H = H;
  args.W = W;
  args.C = C;
  args.n = ntaps;
  args.vec = (size_t)W * C % 4 == 0 && (uintptr_t)x % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 3 && ntaps == 15)
    return launch<3, 15, 64, 32, 512, 2>(args, N, s);
  if (C == 3 && ntaps == 9) return launch<3, 9, 64, 32, 512, 2>(args, N, s);
  return launch<0, 0, 32, 32, 256, 2>(args, N, s);
}
