// K5: threshold -> open square:1 -> close square:1 -> edge 1 of a float32
// batch of single-channel images, one threshold per image.
//
// Replaces imagemagick_tpu/ops/pallas_kernels.py:_morph_edge_kernel (built
// by _build_morph_edge_v2, entered through fused_bilevel_morph_edge): the
// tail of config #3, -auto-threshold otsu -> -morphology open square:1 ->
// -morphology close square:1 -> -edge 1.  The stages:
//   t = x > thr[n]                      (bilevel, as the op route compares)
//   erode, dilate (open), dilate, erode (close): 3x3 min / max
//   edge = clip(9 v - sum over the 3x3 window, 0, 1)
// The reference pads each stage's own input by replicating its border, so
// every neighbour read of every stage goes to the coordinate clamped to the
// image.  A halo computed once from the clamped input and then carried
// through the stages would be wrong near every border: an eroded halo cell
// would hold min(a, b) where the next stage must see a again.
//
// What bounds it on an H100: device-memory bandwidth (4 bytes read and 4
// written per pixel) against about 45 shared-memory reads per pixel for the
// five 3x3 stages.  What the design does about it: one block per (image,
// 32x64 tile) loads the tile and a 5-pixel halo once, runs the five stages
// ping-ponging between two shared-memory buffers, and writes the tile once;
// the intermediates never reach device memory.  Stage s is computed on the
// tile grown by 5 - s pixels on each side.  A cell's neighbours are read at
// the image-clamped coordinates of its own neighbours, which always lie
// inside the region the previous stage computed, so each stage sees its own
// edge-replicated input.  Cells outside the image are computed but never
// read by a cell inside it.  All values are exactly 0 or 1, so the result
// matches the op chain bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;                // output rows per block
constexpr int TW = 64;                // output columns per block
constexpr int HALO = 5;               // four 3x3 stages and the edge stage
constexpr int RH = TH + 2 * HALO;     // region rows
constexpr int RW = TW + 2 * HALO;     // region columns
constexpr int THREADS = 256;

// One 3x3 stage on region cells [s, RH - s) x [s, RW - s).  OP 0: min,
// 1: max, 2: edge.  (gy0, gx0) is the image coordinate of region cell (0,
// 0); rows and columns read by a cell are clamped to the image.
template <int OP>
__device__ void stage(const float* __restrict__ in, float* __restrict__ out,
                      int s, int gy0, int gx0, int H, int W) {
  const int h = RH - 2 * s;
  const int w = RW - 2 * s;
  for (int e = threadIdx.x; e < h * w; e += THREADS) {
    const int i = s + e / w;
    const int j = s + e % w;
    const int gy = gy0 + i;
    const int gx = gx0 + j;
    int rows[3], cols[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      rows[d] = min(max(gy + d - 1, 0), H - 1) - gy0;
      cols[d] = min(max(gx + d - 1, 0), W - 1) - gx0;
    }
    float acc = in[rows[0] * RW + cols[0]];
    float sum = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float v = in[rows[dy] * RW + cols[dx]];
        if (OP == 0) acc = fminf(acc, v);
        if (OP == 1) acc = fmaxf(acc, v);
        if (OP == 2) sum += v;
      }
    }
    if (OP == 2) {
      const float c = in[rows[1] * RW + cols[1]];
      acc = fminf(fmaxf(9.0f * c - sum, 0.0f), 1.0f);
    }
    out[i * RW + j] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
morph_edge_kernel(const float* __restrict__ x, const float* __restrict__ thr,
                  float* __restrict__ y, int H, int W) {
  __shared__ float a[RH * RW];
  __shared__ float b[RH * RW];
  const int n = blockIdx.z;
  const int gy0 = blockIdx.y * TH - HALO;
  const int gx0 = blockIdx.x * TW - HALO;
  const size_t plane = (size_t)H * W;
  const float* src = x + n * plane;
  const float t = thr[n];

  for (int e = threadIdx.x; e < RH * RW; e += THREADS) {
    const int i = e / RW;
    const int j = e - i * RW;
    const int gy = min(max(gy0 + i, 0), H - 1);
    const int gx = min(max(gx0 + j, 0), W - 1);
    a[e] = src[(size_t)gy * W + gx] > t ? 1.0f : 0.0f;
  }
  __syncthreads();
  stage<0>(a, b, 1, gy0, gx0, H, W);  // erode  \ open
  __syncthreads();
  stage<1>(b, a, 2, gy0, gx0, H, W);  // dilate /
  __syncthreads();
  stage<1>(a, b, 3, gy0, gx0, H, W);  // dilate \ close
  __syncthreads();
  stage<0>(b, a, 4, gy0, gx0, H, W);  // erode  /
  __syncthreads();
  stage<2>(a, b, 5, gy0, gx0, H, W);  // edge 1
  __syncthreads();

  float* dst = y + n * plane;
  for (int e = threadIdx.x; e < TH * TW; e += THREADS) {
    const int i = e / TW;
    const int j = e - i * TW;
    const int gy = gy0 + HALO + i;
    const int gx = gx0 + HALO + j;
    if (gy < H && gx < W)
      dst[(size_t)gy * W + gx] = b[(i + HALO) * RW + j + HALO];
  }
}

}  // namespace

// x, y: (N, H, W) float32, contiguous; thr: N float32; all on the current
// device.
extern "C" int k5_morph_edge(const float* x, const float* thr, float* y,
                             int N, int H, int W, void* stream) {
  if (N < 1 || H < 1 || W < 1 || N > 65535 || (H + TH - 1) / TH > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, N);
  morph_edge_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(x, thr, y, H,
                                                                 W);
  return cudaGetLastError();
}
