// Helpers of the register-window stencil kernels, shared by K2
// (blur_unsharp.cu), K2p (blur_unsharp_pipe.cu) and K3
// (separable_blur.cu): asynchronous window copies, item walks with no
// integer division per item, and the stencil run that keeps every
// output's chain of FMAs in one fixed order.

#pragma once

#include <cuda_runtime.h>

namespace stencil {

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// One float, or four 16-byte aligned ones, from device memory to shared
// memory, asynchronously: a thread keeps all of its window's copies in
// flight at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" :::
               "memory");
}

// Calls f(a, b) for the items of an na x nb grid, b fastest, that thread
// tid takes when NT threads deal them out in turn.
template <int NT, class F>
__device__ __forceinline__ void for_items(int tid, int na, int nb, F f) {
  int a = 0, b = tid;
  while (b >= nb) {
    b -= nb;
    ++a;
  }
  while (a < na) {
    f(a, b);
    b += NT;
    while (b >= nb) {
      b -= nb;
      ++a;
    }
  }
}

// Calls f(a, b, c) for the items of an na x nb x nc grid, c fastest, that
// thread tid takes when NT threads deal them out in turn.  The thread
// splits its first item and the stride NT into (b, c) steps once; each
// item after costs adds and compares.
template <int NT, class F>
__device__ __forceinline__ void for_items3(int tid, int na, int nb, int nc,
                                           F f) {
  const int qc = NT / nc, rc = NT - qc * nc;
  int c = tid % nc, b = tid / nc, a = 0;
  while (b >= nb) {
    b -= nb;
    ++a;
  }
  while (a < na) {
    f(a, b, c);
    c += rc;
    b += qc;
    if (c >= nc) {
      c -= nc;
      ++b;
    }
    while (b >= nb) {
      b -= nb;
      ++a;
    }
  }
}

// The same walks for the block's thread threadIdx.x, when all NT threads
// of the block deal the items out.
template <int NT, class F>
__device__ __forceinline__ void for_items(int na, int nb, F f) {
  for_items<NT>((int)threadIdx.x, na, nb, f);
}

template <int NT, class F>
__device__ __forceinline__ void for_items3(int na, int nb, int nc, F f) {
  for_items3<NT>((int)threadIdx.x, na, nb, nc, f);
}

// R outputs of a stencil along a window that load(q) reads:
// out[r] = t[0] w[r], then fmaf(t[k], w[r + k], out[r]) for k = 1 .. n-1.
// The window w[0 .. R+n-2] is loaded into registers once.  N > 0: n == N
// taps; N == 0: n taps known at run time, the loops unrolled to NMAX and
// left where n ends.
template <int R, int N, int NMAX, class Load>
__device__ __forceinline__ void run(const float (&t)[NMAX], int n, Load load,
                                    float (&out)[R]) {
  constexpr int K = N ? N : NMAX;
  float w[R + K - 1];
#pragma unroll
  for (int q = 0; q < R + K - 1; ++q) {
    if (!N && q >= R + n - 1) break;
    w[q] = load(q);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = t[0] * w[r];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (!N && k >= n) break;
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = fmaf(t[k], w[r + k], out[r]);
  }
}

}  // namespace stencil
