// K3: separable odd-tap blur of an NHWC float32 batch, edge-replicate borders.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_blur_kernel (built by
// _build_blur, entered through fused_separable_blur from
// blur._separable_conv).
//
// What bounds it on an H100: device-memory bandwidth.  An output element
// costs 2 * ntaps FLOP against one 4-byte read and one 4-byte write (about
// 2r FLOP per byte for radius r), far below the card's FLOP/byte balance.
// What the design does about it: each block reads its tile plus an r-pixel
// halo from device memory once, runs the vertical pass into a second
// shared-memory buffer and the horizontal pass out of it, so the
// intermediate never reaches device memory.  The border policy is applied
// by clamping the load coordinates: no padded copy of the image is made.
// A simple kernel: one thread per shared-memory element in each phase.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;          // output rows per block
constexpr int TW = 32;          // output pixels per row per block
constexpr int THREADS = 256;
constexpr int MAX_TAPS = 33;

__global__ void __launch_bounds__(THREADS)
separable_blur_kernel(const float* __restrict__ x, float* __restrict__ y,
                      const float* __restrict__ taps, int H, int W, int C,
                      int ntaps) {
  extern __shared__ float smem[];
  const int r = ntaps / 2;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int in_w = (TW + 2 * r) * C;  // floats in one shared row
  const int in_h = TH + 2 * r;
  float* tile = smem;                 // in_h x in_w: tile + halo
  float* mid = tile + in_h * in_w;    // TH x in_w: vertical pass
  float* tp = mid + TH * in_w;        // ntaps
  const size_t plane = (size_t)H * W * C;
  const float* src = x + blockIdx.z * plane;
  float* dst = y + blockIdx.z * plane;

  for (int k = threadIdx.x; k < ntaps; k += THREADS) tp[k] = taps[k];
  for (int e = threadIdx.x; e < in_h * in_w; e += THREADS) {
    const int i = e / in_w;
    const int rem = e - i * in_w;
    const int px = rem / C;
    const int c = rem - px * C;
    const int gy = min(max(y0 - r + i, 0), H - 1);
    const int gx = min(max(x0 - r + px, 0), W - 1);
    tile[e] = src[((size_t)gy * W + gx) * C + c];
  }
  __syncthreads();

  // vertical pass over every column of the tile, halo columns included
  for (int e = threadIdx.x; e < TH * in_w; e += THREADS) {
    const float* col = tile + e;  // mid and tile share the row stride
    float acc = tp[0] * col[0];
    for (int k = 1; k < ntaps; ++k) acc = fmaf(tp[k], col[k * in_w], acc);
    mid[e] = acc;
  }
  __syncthreads();

  // horizontal pass: a shift by one pixel is a shift by C floats
  const int out_w = TW * C;
  for (int e = threadIdx.x; e < TH * out_w; e += THREADS) {
    const int i = e / out_w;
    const int lane = e - i * out_w;
    const int gy = y0 + i;
    if (gy >= H || x0 + lane / C >= W) continue;
    const float* row = mid + i * in_w + lane;
    float acc = tp[0] * row[0];
    for (int k = 1; k < ntaps; ++k) acc = fmaf(tp[k], row[k * C], acc);
    dst[((size_t)gy * W + x0) * C + lane] = acc;
  }
}

}  // namespace

// x, y: (N, H, W, C) float32, contiguous, on the current device.
// taps: ntaps float32 on the device, ntaps odd and at most 33.
extern "C" int k3_separable_blur(const float* x, float* y, const float* taps,
                                 int N, int H, int W, int C, int ntaps,
                                 void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || N > 65535 || ntaps < 1 ||
      ntaps > MAX_TAPS || ntaps % 2 == 0)
    return cudaErrorInvalidValue;
  const int r = ntaps / 2;
  const size_t smem =
      ((size_t)(TH + 2 * r) * (TW + 2 * r) * C +
       (size_t)TH * (TW + 2 * r) * C + ntaps) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      separable_blur_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  separable_blur_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, taps, H, W, C, ntaps);
  return cudaGetLastError();
}
