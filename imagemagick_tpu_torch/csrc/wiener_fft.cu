// K6a, K6b, K6c: the Wiener FFT denoise of BASELINE config #4, in FP32.
//
// Replaces imagemagick_tpu/ops/fourier_pallas.py: _w_fwd_kernel (K6a),
// _h_mask_kernel with _h_axis (K6b) and _w_inv_kernel (K6c), entered
// through wiener_pallas.  For P real (H, W) planes:
//
//   K6a  spec = DFT_W(x)                                 (P, H, W) complex
//   K6b  g = IDFT_H(F * p / (p + noise * pmean)),  F = DFT_H(spec),
//        p = |F|^2, one pmean = sum(x^2) per plane read from device memory
//   K6c  out = clip(Re(IDFT_W(g)), 0, 1)                 (P, H, W) real
//
// Each axis of length N = n1 * n2 is a four-step DFT, natural order in and
// out:  X[k2*n1 + k1] = sum_m2 w2^(m2 k2) tw(m2, k1) sum_m1 w1^(m1 k1)
// x[m1*n2 + m2], with w1, w2 the n1- and n2-point roots of unity and tw
// the N-point twiddle.  The tables come from the host (_axis_consts in
// fourier_kernels.py, float64 cast to float32): n1 roots, n2 roots, then
// the twiddle field at m2*n1 + k1.  A sub-DFT entry (k, m) is root
// (k*m) mod n, the index carried along the sum with one add and compare.
//
// What bounds it on an H100: the dense sub-DFTs do (n1 + n2) complex
// multiply-adds per element and transform, about 3,500 flops per pixel
// over the four transforms, against 24 bytes of device traffic per pixel
// and kernel: operations, not bytes, at this design.  A radix FFT would do
// about 5 log2(N) flops per element and transform; the TPU kernels' dense
// sub-DFTs fed its matrix unit, and are kept here.  Each sub-DFT is a small
// complex matrix product out of shared memory, so each thread holds a 4x4
// tile of outputs in registers: per term it loads four roots (the same
// for the whole warp) and four operands (neighbouring threads, neighbouring
// words) for sixteen complex multiply-adds.  On an H100 at 700 W this runs
// at 13-19 TFLOP/s of the dense count (PERF.md), a fifth to a quarter of
// the FP32 peak.
//
// Layouts: K6a and K6c give each row of a plane to one block (coalesced
// loads and stores of whole rows).  K6b gives a block `cols` (<= 2)
// neighbouring columns of all H rows, and the H x cols spectrum lives in
// shared memory through both H transforms and the mask.  A stage-one
// output (k1, m2) goes to row m2 of a buffer whose rows are ld = n1 | 1
// elements long (odd, so that the transposed stores of neighbouring
// threads fall in different banks), where stage two reads it back as a
// row.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int TK = 4;   // sub-DFT outputs a thread holds along k
constexpr int TC = 4;   // and along the other index

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 load(const float2* a, int i) { return a[i]; }
__device__ __forceinline__ float2 load(const float* a, int i) {
  return make_float2(a[i], 0.f);
}

// out(k, c) = sum_m root[(k*m) mod nm] * a[m*lda + c] for k < nm, c < nc;
// store(k, c, value) for each.  T is float (real a) or float2.  RE_ONLY:
// only the real part of each output is formed (its .y is 0).
template <bool RE_ONLY, typename T, typename Store>
__device__ __forceinline__ void sub_dft(const T* a, int nm, int nc, int lda,
                                        const float2* root, Store store) {
  constexpr bool REAL_IN = sizeof(T) == sizeof(float);
  const int kt_n = (nm + TK - 1) / TK, ct_n = (nc + TC - 1) / TC;
  for (int tile = threadIdx.x; tile < kt_n * ct_n; tile += blockDim.x) {
    const int kt = tile / ct_n, ct = tile - kt * ct_n;
    int k[TK], e[TK], c[TC];
#pragma unroll
    for (int i = 0; i < TK; ++i) {
      k[i] = min(kt + i * kt_n, nm - 1);   // past the end: repeat, dropped
      e[i] = 0;
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) c[j] = min(ct + j * ct_n, nc - 1);
    float2 acc[TK][TC];
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] = make_float2(0.f, 0.f);

    for (int m = 0; m < nm; ++m) {
      float2 v[TC], w[TK];
#pragma unroll
      for (int j = 0; j < TC; ++j) v[j] = load(a, m * lda + c[j]);
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        w[i] = root[e[i]];
        e[i] += k[i];
        if (e[i] >= nm) e[i] -= nm;
      }
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float2& s = acc[i][j];
          if (REAL_IN) {
            s.x = fmaf(v[j].x, w[i].x, s.x);
            s.y = fmaf(v[j].x, w[i].y, s.y);
          } else if (RE_ONLY) {
            s.x = fmaf(v[j].x, w[i].x, fmaf(-v[j].y, w[i].y, s.x));
          } else {
            s.x = fmaf(v[j].x, w[i].x, fmaf(-v[j].y, w[i].y, s.x));
            s.y = fmaf(v[j].x, w[i].y, fmaf(v[j].y, w[i].x, s.y));
          }
        }
    }
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j)
        if (kt + i * kt_n < nm && ct + j * ct_n < nc)
          store(kt + i * kt_n, ct + j * ct_n, acc[i][j]);
  }
}

// Stage one of an axis: the n1-point sub-DFT (roots w1, in shared memory)
// of the columns of a natural (n1, n2 * cols) buffer, times the twiddle tw
// (device memory, m2*n1 + k1), into the transposed buffer y at
// (m2 * ld + k1) * cols + col.
template <typename T>
__device__ __forceinline__ void stage_one(const T* a, float2* y, int n1,
                                          int n2, int cols, int ld,
                                          const float2* w1,
                                          const float2* __restrict__ tw) {
  sub_dft<false>(a, n1, n2 * cols, n2 * cols, w1,
                 [&](int k1, int c, float2 v) {
                   const int m2 = c / cols, col = c - m2 * cols;
                   y[(m2 * ld + k1) * cols + col] =
                       cmul(v, __ldg(&tw[m2 * n1 + k1]));
                 });
}

// -- K6a: DFT along W of one real row per block -----------------------------

__global__ void __launch_bounds__(MAX_THREADS)
w_forward_kernel(const float* __restrict__ x, float2* __restrict__ spec,
                 const float2* __restrict__ tab, int W, int n1, int n2,
                 int ld) {
  extern __shared__ float2 smem[];
  float2* y = smem;                   // n2 * ld: stage one's output
  float2* roots = y + n2 * ld;        // n1 roots, then n2 roots
  float* xs = reinterpret_cast<float*>(roots + n1 + n2);   // W: the row
  const long long row = blockIdx.x;
  const float* src = x + row * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) xs[i] = src[i];
  for (int i = threadIdx.x; i < n1 + n2; i += blockDim.x) roots[i] = tab[i];
  __syncthreads();
  stage_one(xs, y, n1, n2, 1, ld, roots, tab + n1 + n2);
  __syncthreads();
  float2* dst = spec + row * W;
  sub_dft<false>(y, n2, n1, ld, roots + n1,
                 [&](int k2, int k1, float2 v) { dst[k2 * n1 + k1] = v; });
}

// -- K6c: inverse DFT along W of one complex row per block, real, clipped ---

__global__ void __launch_bounds__(MAX_THREADS)
w_inverse_kernel(const float2* __restrict__ g, float* __restrict__ out,
                 const float2* __restrict__ tab, int W, int n1, int n2,
                 int ld) {
  extern __shared__ float2 smem[];
  float2* gs = smem;                  // W: the row
  float2* y = gs + W;                 // n2 * ld
  float2* roots = y + n2 * ld;
  const long long row = blockIdx.x;
  const float2* src = g + row * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) gs[i] = src[i];
  for (int i = threadIdx.x; i < n1 + n2; i += blockDim.x) roots[i] = tab[i];
  __syncthreads();
  stage_one(gs, y, n1, n2, 1, ld, roots, tab + n1 + n2);
  __syncthreads();
  float* dst = out + row * W;
  const float n = (float)W;
  sub_dft<true>(y, n2, n1, ld, roots + n1, [&](int k2, int k1, float2 v) {
    dst[k2 * n1 + k1] = fminf(fmaxf(v.x / n, 0.f), 1.f);
  });
}

// -- K6b: DFT along H, Wiener mask, inverse DFT along H ---------------------

__global__ void __launch_bounds__(MAX_THREADS)
h_mask_kernel(const float2* __restrict__ spec, const float* __restrict__ pmean,
              float2* __restrict__ out, const float2* __restrict__ tab_f,
              const float2* __restrict__ tab_i, int H, int W, int n1, int n2,
              int ld, int cols, int chunks, float noise) {
  extern __shared__ float2 smem[];
  float2* buf = smem;                 // H * cols, natural: row r at r * cols
  float2* y = buf + H * cols;         // n2 * ld * cols: stage one's output
  float2* rf = y + n2 * ld * cols;    // forward roots, inverse roots
  float2* ri = rf + n1 + n2;
  const int plane = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - plane * chunks) * cols;
  const long long base = (long long)plane * H * W + c0;

  for (int i = threadIdx.x; i < H * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    buf[i] = c0 + c < W ? spec[base + (long long)r * W + c]
                        : make_float2(0.f, 0.f);
  }
  for (int i = threadIdx.x; i < n1 + n2; i += blockDim.x) {
    rf[i] = tab_f[i];
    ri[i] = tab_i[i];
  }
  __syncthreads();

  // forward: stage one into y, stage two and the mask back into buf
  stage_one(buf, y, n1, n2, cols, ld, rf, tab_f + n1 + n2);
  __syncthreads();
  const float floor_ = noise * pmean[plane];
  sub_dft<false>(y, n2, n1 * cols, ld * cols, rf + n1,
                 [&](int k2, int c, float2 f) {
                   const float p = f.x * f.x + f.y * f.y;
                   const float m = p / (p + floor_);
                   buf[k2 * n1 * cols + c] = make_float2(f.x * m, f.y * m);
                 });
  __syncthreads();

  // inverse: stage one into y, stage two (/H) to device memory
  stage_one(buf, y, n1, n2, cols, ld, ri, tab_i + n1 + n2);
  __syncthreads();
  const float n = (float)H;
  sub_dft<false>(y, n2, n1 * cols, ld * cols, ri + n1,
                 [&](int k2, int c, float2 f) {
                   const int k1 = c / cols, col = c - k1 * cols;
                   if (c0 + col < W)
                     out[base + (long long)(k2 * n1 + k1) * W + col] =
                         make_float2(f.x / n, f.y / n);
                 });
}

// Threads for a block whose sub-DFTs are (nm x nm) by nc products: one
// 4x4 output tile each, whole warps, at most MAX_THREADS (more tiles loop).
int threads_for(int nm_a, int nc_a, int nm_b, int nc_b) {
  const int a = ((nm_a + TK - 1) / TK) * ((nc_a + TC - 1) / TC);
  const int b = ((nm_b + TK - 1) / TK) * ((nc_b + TC - 1) / TC);
  const int t = ((a > b ? a : b) + 31) / 32 * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// The dynamic shared memory of a launch, allowed above 48 KB first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool bad_axis(int n, int n1, int n2) {
  return n1 < 2 || n2 < 2 || (long long)n1 * n2 != n;
}

}  // namespace

// x: (P, H, W) float32; spec: (P, H, W) complex64 (float2); tab: the W
// axis's forward tables, (n1 + n2 + W) float2.  All contiguous, on one
// device.
extern "C" int k6a_w_forward(const float* x, void* spec, const void* tab,
                             int P, int H, int W, int n1, int n2,
                             void* stream) {
  const long long rows = (long long)P * H;
  if (P < 1 || H < 1 || bad_axis(W, n1, n2) || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int ld = n1 | 1;
  const size_t smem = ((size_t)n2 * ld + n1 + n2) * 8 + (size_t)W * 4;
  cudaError_t err = allow_smem(w_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  w_forward_kernel<<<(unsigned)rows, threads_for(n1, n2, n2, n1), smem,
                     (cudaStream_t)stream>>>(
      x, static_cast<float2*>(spec), static_cast<const float2*>(tab), W, n1,
      n2, ld);
  return cudaGetLastError();
}

// spec, out: (P, H, W) complex64; pmean: (P,) float32; tab_f, tab_i: the H
// axis's forward and inverse tables, (n1 + n2 + H) float2 each; cols
// (1 or 2) columns per block.
extern "C" int k6b_h_mask(const void* spec, const float* pmean, void* out,
                          const void* tab_f, const void* tab_i, int P, int H,
                          int W, int n1, int n2, int cols, float noise,
                          void* stream) {
  if (P < 1 || W < 1 || bad_axis(H, n1, n2) || cols < 1 || cols > 2)
    return cudaErrorInvalidValue;
  const int chunks = (W + cols - 1) / cols;
  const long long blocks = (long long)P * chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int ld = n1 | 1;
  const size_t smem =
      ((size_t)H * cols + (size_t)n2 * ld * cols + 2 * (size_t)(n1 + n2)) * 8;
  cudaError_t err = allow_smem(h_mask_kernel, smem);
  if (err != cudaSuccess) return err;
  h_mask_kernel<<<(unsigned)blocks,
                  threads_for(n1, n2 * cols, n2, n1 * cols), smem,
                  (cudaStream_t)stream>>>(
      static_cast<const float2*>(spec), pmean, static_cast<float2*>(out),
      static_cast<const float2*>(tab_f), static_cast<const float2*>(tab_i), H,
      W, n1, n2, ld, cols, chunks, noise);
  return cudaGetLastError();
}

// g: (P, H, W) complex64; out: (P, H, W) float32; tab: the W axis's
// inverse tables, (n1 + n2 + W) float2.
extern "C" int k6c_w_inverse(const void* g, float* out, const void* tab,
                             int P, int H, int W, int n1, int n2,
                             void* stream) {
  const long long rows = (long long)P * H;
  if (P < 1 || H < 1 || bad_axis(W, n1, n2) || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int ld = n1 | 1;
  const size_t smem = ((size_t)W + (size_t)n2 * ld + n1 + n2) * 8;
  cudaError_t err = allow_smem(w_inverse_kernel, smem);
  if (err != cudaSuccess) return err;
  w_inverse_kernel<<<(unsigned)rows, threads_for(n1, n2, n2, n1), smem,
                     (cudaStream_t)stream>>>(
      static_cast<const float2*>(g), out, static_cast<const float2*>(tab), W,
      n1, n2, ld);
  return cudaGetLastError();
}
