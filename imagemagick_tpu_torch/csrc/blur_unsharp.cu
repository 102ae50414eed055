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
// edge-pixel lane padding).
//
// What bounds it on an H100: device-memory traffic sets the floor (config
// #2, 8 x 1080 x 1920 x 3: 199 MB in and 199 MB out, about 0.12 ms at
// 3.35 TB/s), but this simple version does one shared-memory load per FMA
// (about 75 per output value at 15 + 9 taps, with the halo recomputed
// per tile) and nine powf/cbrtf per pixel with Lab, so shared-memory
// bandwidth and the Lab math bind it first.
// What the design does about it: one block per (image, T x T output
// tile).  It loads the x tile with a halo of bt/2 + ut/2 pixels once, at
// clamped coordinates, into shared memory, computes z on the
// (T + ut-1)^2 window in two passes, the vertical unsharp pass over that
// window, then the horizontal unsharp pass, the mix and the Lab round
// trip per pixel in registers, and writes only the output: no
// intermediate reaches device memory.  T is 32, or 16 where the 32-tile
// windows would not fit in a block's shared memory (many channels and
// wide taps).  The TPU kernel's banded matrix products, lane rolls and
// lane fields serve its matrix unit and 128-lane layout and are not
// carried over; the Lab math is the colorspace module's, with powf and
// cbrtf in place of its exp2/log2 seed and Newton step.

#include <cuda_runtime.h>

#include "lab_roundtrip.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLUR_TAPS = 33;
constexpr int MAX_UNSHARP_TAPS = 17;
constexpr int MAX_CHANNELS = 8;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may use

using lab::clip01;
using lab::lab_roundtrip;

__host__ __device__ __forceinline__ int tap_floats(int nb, int nu) {
  return (nb + nu + 3) / 4 * 4;  // keep the windows 16-byte aligned
}

// floats of the x window (later the z window) and of the vertical-pass
// buffer (later the vertical unsharp pass) for a T x T tile
__host__ __device__ __forceinline__ int buf_a(int T, int C, int rb, int ru) {
  const int xs = T + 2 * ru + 2 * rb, zs = T + 2 * ru;
  return xs * xs * C > zs * zs * C ? xs * xs * C : zs * zs * C;
}

__host__ __device__ __forceinline__ int buf_b(int T, int C, int rb, int ru) {
  const int xs = T + 2 * ru + 2 * rb, zs = T + 2 * ru;
  return zs * xs * C > T * zs * C ? zs * xs * C : T * zs * C;
}

__global__ void __launch_bounds__(THREADS)
blur_unsharp_kernel(const float* __restrict__ x, float* __restrict__ y,
                    const float* __restrict__ taps, int H, int W, int C,
                    int nb, int nu, float gain, int lab, int T) {
  extern __shared__ __align__(16) float smem[];
  const int rb = nb / 2, ru = nu / 2;
  const int xs = T + 2 * ru + 2 * rb;   // x window side, pixels
  const int zs = T + 2 * ru;            // z window side, pixels
  const int xrow = xs * C, zrow = zs * C;
  float* tp = smem;                     // nb blur taps, then nu unsharp taps
  const float* up = tp + nb;
  float* a = smem + tap_floats(nb, nu); // x window, then z window
  float* b = a + buf_a(T, C, rb, ru);   // vertical blur, then vertical unsharp
  const int y0 = blockIdx.y * T, x0 = blockIdx.x * T;
  const int zy0 = y0 - ru, zx0 = x0 - ru;  // image position of z window (0, 0)
  const size_t plane = (size_t)H * W * C;
  const float* src = x + blockIdx.z * plane;
  float* dst = y + blockIdx.z * plane;

  for (int k = threadIdx.x; k < nb + nu; k += THREADS) tp[k] = taps[k];
  // x window row i, pixel p: image (clamp(zy0 - rb + i), clamp(zx0 - rb + p))
  for (int e = threadIdx.x; e < xs * xrow; e += THREADS) {
    const int i = e / xrow;
    const int rem = e - i * xrow;
    const int p = rem / C;
    const int c = rem - p * C;
    const int gy = min(max(zy0 - rb + i, 0), H - 1);
    const int gx = min(max(zx0 - rb + p, 0), W - 1);
    a[e] = src[((size_t)gy * W + gx) * C + c];
  }
  __syncthreads();

  // z window (i, j) holds z at image (clamp(zy0 + i), clamp(zx0 + j)).
  // Its blur reads x rows clamp(zy0 + i) - rb .. + rb, which start at x
  // window row clamp(zy0 + i) - zy0; likewise for columns.
  // Vertical blur, over every column of the x window:
  for (int e = threadIdx.x; e < zs * xrow; e += THREADS) {
    const int i = e / xrow;
    const int lane = e - i * xrow;
    const float* col = a + (min(max(zy0 + i, 0), H - 1) - zy0) * xrow + lane;
    float acc = tp[0] * col[0];
    for (int k = 1; k < nb; ++k) acc = fmaf(tp[k], col[k * xrow], acc);
    b[e] = acc;
  }
  __syncthreads();

  // horizontal blur: a shift by one pixel is a shift by C floats
  for (int e = threadIdx.x; e < zs * zrow; e += THREADS) {
    const int i = e / zrow;
    const int rem = e - i * zrow;
    const int j = rem / C;
    const int c = rem - j * C;
    const float* row =
        b + i * xrow + (min(max(zx0 + j, 0), W - 1) - zx0) * C + c;
    float acc = tp[0] * row[0];
    for (int k = 1; k < nb; ++k) acc = fmaf(tp[k], row[k * C], acc);
    a[e] = acc;
  }
  __syncthreads();

  // vertical unsharp pass: output row i reads z window rows i .. i + 2ru
  for (int e = threadIdx.x; e < T * zrow; e += THREADS) {
    const int i = e / zrow;
    const int lane = e - i * zrow;
    const float* col = a + i * zrow + lane;
    float acc = up[0] * col[0];
    for (int k = 1; k < nu; ++k) acc = fmaf(up[k], col[k * zrow], acc);
    b[e] = acc;
  }
  __syncthreads();

  // horizontal unsharp pass, the mix, Lab and the store: one pixel a thread
  for (int p = threadIdx.x; p < T * T; p += THREADS) {
    const int i = p / T;
    const int j = p - i * T;
    const int gy = y0 + i, gx = x0 + j;
    if (gy >= H || gx >= W) continue;
    auto sharpen = [&](int c) {
      const float* row = b + i * zrow + j * C + c;
      float u = up[0] * row[0];
      for (int k = 1; k < nu; ++k) u = fmaf(up[k], row[k * C], u);
      const float z = a[(i + ru) * zrow + (j + ru) * C + c];
      return clip01((1.f + gain) * z - gain * u);
    };
    float* o = dst + ((size_t)gy * W + gx) * C;
    if (lab) {
      float r = sharpen(0), g = sharpen(1), bl = sharpen(2);
      lab_roundtrip(r, g, bl);
      o[0] = r;
      o[1] = g;
      o[2] = bl;
    } else {
      for (int c = 0; c < C; ++c) o[c] = sharpen(c);
    }
  }
}

size_t smem_bytes(int T, int C, int nb, int nu) {
  return (size_t)(tap_floats(nb, nu) + buf_a(T, C, nb / 2, nu / 2) +
                  buf_b(T, C, nb / 2, nu / 2)) * sizeof(float);
}

}  // namespace

// x, y: (N, H, W, C) float32, contiguous, on the current device; C <= 8.
// taps: nb blur taps then nu unsharp taps, float32 on the device, both
// counts odd, nb <= 33, nu <= 17.  lab (C == 3 only): the sRGB->Lab->sRGB
// round trip after the unsharp mix.
extern "C" int k2_blur_unsharp(const float* x, float* y, const float* taps,
                               int N, int H, int W, int C, int nb, int nu,
                               float gain, int lab, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || C < 1 || C > MAX_CHANNELS ||
      nb < 1 || nb > MAX_BLUR_TAPS || nb % 2 == 0 || nu < 1 ||
      nu > MAX_UNSHARP_TAPS || nu % 2 == 0 || (lab && C != 3))
    return cudaErrorInvalidValue;
  int T = 32;
  size_t smem = smem_bytes(T, C, nb, nu);
  if (smem > MAX_SMEM) {
    T = 16;
    smem = smem_bytes(T, C, nb, nu);
  }
  if ((H + T - 1) / T > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      blur_unsharp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + T - 1) / T, (H + T - 1) / T, N);
  blur_unsharp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, taps, H, W, C, nb, nu, gain, lab, T);
  return cudaGetLastError();
}
