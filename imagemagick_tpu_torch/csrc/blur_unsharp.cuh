// The tile passes of K2's function, shared by K2 (blur_unsharp.cu) and K2p
// (blur_unsharp_pipe.cu): the vertical and horizontal blurs, the vertical
// unsharp pass, and the horizontal unsharp pass with the mix and the clip,
// on an x window that each kernel copies in its own way. Both kernels run
// these functions, so every value is the same chain of fmaf in the same
// order in both (see blur_unsharp.cu for the function and the clamping
// rules). Each takes the index tid of the calling thread among the NT
// threads that share the pass.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "lab_roundtrip.cuh"
#include "stencil.cuh"

namespace bu {

constexpr int MAX_BLUR_TAPS = 33;
constexpr int MAX_UNSHARP_TAPS = 17;
constexpr int MAX_CHANNELS = 8;
constexpr int RUN = 8;  // outputs a thread computes in passes 1-3

using lab::clip01;
using stencil::clampi;
using stencil::for_items;
using stencil::for_items3;
using stencil::imax;
using stencil::run;

// Everything the kernels read besides x, by value: the taps sit in the
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
// vertical blur, then the vertical unsharp pass (and, in K2, the output
// tile).
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

// A kernel's tiling: CT, NB, NU the channels and tap counts, or 0 for
// those read from the arguments at run time; a TW x TH tile; NT threads
// run the passes.  The last pass gives each of its ITEMS items RUN4
// pixels of all channels (up to 4, fewer where the tile has fewer pixels
// than 4 a thread), rows fastest, PER_THREAD items a thread; the channel
// loops unroll to CM, the most channels the kernel takes, and stop at C,
// so its results are indexed by constants and stay in registers.
template <int CT_, int NB_, int NU_, int TW_, int TH_, int NT_>
struct Tiling {
  static constexpr int CT = CT_, NB = NB_, NU = NU_, TW = TW_, TH = TH_,
                       NT = NT_;
  static constexpr int CM = CT ? CT : MAX_CHANNELS;
  static constexpr int RUN4 =
      TW * TH >= 4 * NT ? 4 : TW * TH >= 2 * NT ? 2 : 1;
  static constexpr int ITEMS = TH * (TW / RUN4);
  static constexpr int PER_THREAD = (ITEMS + NT - 1) / NT;
};

// What a block derives from the arguments once.
template <class T>
struct Ctx {
  int C, nb, nu, rb, ru;
  Geo g;
  size_t rowlen, plane;  // floats of an image row, of an image
  __device__ explicit Ctx(const Args& p)
      : C(T::CT ? T::CT : p.C),
        nb(T::NB ? T::NB : p.nb),
        nu(T::NU ? T::NU : p.nu),
        rb(nb / 2),
        ru(nu / 2),
        g(geometry(T::TW, T::TH, C, rb, ru)),
        rowlen((size_t)p.W * C),
        plane((size_t)p.H * p.W * C) {}
};

// The tile of image n whose top left output pixel is (y0, x0).
struct Tile {
  int n, y0, x0;
};

// 1. vertical blur of every lane of the x window (A, shifted by sh, 0
// where sh = -1) into B, z rows 0 .. zh-1 as if unclamped: run ri covers
// rows i0 .. i0+RUN-1 (the last run overlaps its neighbour rather than run
// past the window)
template <class T>
__device__ __forceinline__ void vertical_blur(const Args& p,
                                              const Ctx<T>& k, const float* A,
                                              float* B, int sh, int tid) {
  const Geo& g = k.g;
  for_items<T::NT>(tid, (g.zh + RUN - 1) / RUN, g.xl, [&](int ri, int l) {
    const int i0 = min(ri * RUN, g.zh - RUN);
    const float* col = A + max(sh, 0) + i0 * g.xa + l;
    float out[RUN];
    run<RUN, T::NB>(p.bt, k.nb, [&](int q) { return col[q * g.xa]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) B[(i0 + r) * g.xp + l] = out[r];
  });
}

// 2. horizontal blur of B into the z window (A): z row i is z of image
// row clamp(zy0 + i), so it reads that row's vertical blur; columns as if
// unclamped.  Rows fastest: a warp takes 32 rows of one column run.
template <class T>
__device__ __forceinline__ void horizontal_blur(const Args& p,
                                                const Ctx<T>& k, Tile t,
                                                float* A, const float* B,
                                                int tid) {
  const Geo& g = k.g;
  const int C = k.C, zy0 = t.y0 - k.ru;
  for_items3<T::NT>(tid, (g.zw + RUN - 1) / RUN, C, g.zh,
                    [&](int m, int c, int i) {
    const int j0 = min(m * RUN, g.zw - RUN);
    const float* row =
        B + (clampi(zy0 + i, 0, p.H - 1) - zy0) * g.xp + j0 * C + c;
    float out[RUN];
    run<RUN, T::NB>(p.bt, k.nb, [&](int q) { return row[q * C]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) A[i * g.zp + (j0 + r) * C + c] = out[r];
  });
}

// 3. vertical unsharp pass of the z window (A) into B, tile rows 0 ..
// TH-1 over every lane of the z window; on a tile at the left or right
// border, lane (j, c) reads z of column clamp(zx0 + j)
template <class T>
__device__ __forceinline__ void vertical_unsharp(const Args& p,
                                                 const Ctx<T>& k, Tile t,
                                                 const float* A, float* B,
                                                 int tid) {
  const Geo& g = k.g;
  const int C = k.C, zx0 = t.x0 - k.ru;
  const bool inside_x = zx0 >= 0 && zx0 + g.zw <= p.W;
  for_items3<T::NT>(tid, T::TH / RUN, g.zw, C, [&](int ri, int j, int c) {
    const int l = j * C + c;
    const int ls =
        inside_x ? l : (clampi(zx0 + j, 0, p.W - 1) - zx0) * C + c;
    const float* col = A + ri * RUN * g.zp + ls;
    float out[RUN];
    run<RUN, T::NU>(p.ut, k.nu, [&](int q) { return col[q * g.zp]; }, out);
#pragma unroll
    for (int r = 0; r < RUN; ++r) B[(ri * RUN + r) * g.zp + l] = out[r];
  });
}

// 4. horizontal unsharp pass of B, the mix with z (A) and the clip:
// res[s][c][r] is channel c of pixel (i, j0 + r) of item q = tid + s NT,
// i = q % TH, j0 = q / TH * RUN4 (TH is a power of two).
template <class T>
__device__ __forceinline__ void unsharp_mix(
    const Args& p, const Ctx<T>& k, const float* A, const float* B,
    float (&res)[T::PER_THREAD][T::CM][T::RUN4], int tid) {
  const Geo& g = k.g;
  const int C = k.C, ru = k.ru;
#pragma unroll
  for (int s = 0; s < T::PER_THREAD; ++s) {
    const int q = tid + s * T::NT;
    if (T::ITEMS % T::NT == 0 || q < T::ITEMS) {
      const int i = q % T::TH, j0 = q / T::TH * T::RUN4;
#pragma unroll
      for (int c = 0; c < T::CM; ++c) {
        if (!T::CT && c >= C) break;
        const float* row = B + i * g.zp + j0 * C + c;
        float u[T::RUN4];
        run<T::RUN4, T::NU>(p.ut, k.nu, [&](int q4) { return row[q4 * C]; },
                            u);
        const float* zc = A + (i + ru) * g.zp + (j0 + ru) * C + c;
#pragma unroll
        for (int r = 0; r < T::RUN4; ++r)
          res[s][c][r] = clip01((1.f + p.gain) * zc[r * C] - p.gain * u[r]);
      }
    }
  }
}

}  // namespace bu
