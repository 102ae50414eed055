// K6a, K6b, K6c: the Wiener FFT denoise of BASELINE config #4, in FP32.
//
// Replaces imagemagick_tpu/ops/fourier_pallas.py: _w_fwd_kernel (K6a,
// :85), _h_mask_kernel with _h_axis (K6b, :137) and _w_inv_kernel (K6c,
// :161), entered through wiener_pallas.  For P real (H, W) planes:
//
//   K6a  spec = DFT_W(x)                                 (P, H, W) complex
//   K6b  g = IDFT_H(F * p / (p + noise * pmean)),  F = DFT_H(spec),
//        p = |F|^2, one pmean = sum(x^2) per plane read from device memory
//   K6c  out = clip(Re(IDFT_W(g)), 0, 1)                 (P, H, W) real
//
// K6a and K6c are radix FFTs in shared memory.  The host factors W into
// passes (_radix_plan in fourier_kernels.py: radix 8, then 4 and 2, then
// 3, 5 and 7; any other prime factor one generic pass) and uploads one
// table of the W roots exp(-+2 pi i k / W), computed in float64 and cast
// to float32 (_roots_on); every twiddle, and every root of a generic pass,
// is an entry of it (the twiddles read in pass order from a copy,
// _twiddles_on).  The passes are Stockham autosort passes between two row
// buffers in shared memory (radix_pass), natural order in and out, one
// barrier between passes.  Two real rows share one complex transform: K6a
// transforms x_a + i x_b and splits the spectrum by Hermitian symmetry;
// K6c transforms h(g_a) + i h(g_b), h(g)[k] = (g[k] + conj g[-k]) / 2,
// whose inverse DFT is Re IDFT(g_a) + i Re IDFT(g_b) for any g.
//
// What bounds K6a and K6c on an H100: device memory.  Each moves 12 bytes
// a pixel (4 in and 8 out, or 8 in and 4 out: 0.0317 ms at 2160 x 4096 and
// 3.35 TB/s) against about 2.5 log2 W operations a pixel with the packing
// (30 at W = 4096, 0.0040 ms at the FP32 peak).  So each pixel crosses
// device memory once each way and everything between stays in shared
// memory: 16 W bytes a block (about 68 KB at 4096, rows padded against
// bank conflicts, three blocks an SM), W/16 threads up to 256 (two radix-8
// butterflies a thread and pass at 4096).
// Shared memory then carries the most traffic, so K6a's first pass reads
// its rows straight from device memory and K6c's last pass writes its rows
// straight to it, each one pass fewer through shared memory.
//
// K6b keeps its four-step DFTs along H: each axis of length N = n1 * n2,
// natural order in and out, X[k2*n1 + k1] = sum_m2 w2^(m2 k2) tw(m2, k1)
// sum_m1 w1^(m1 k1) x[m1*n2 + m2], with w1, w2 the n1- and n2-point roots
// and tw the N-point twiddle, from the host's tables (_axis_consts, float64
// cast to float32: n1 roots, n2 roots, then the twiddle field at
// m2*n1 + k1).  Each sub-DFT is a small complex matrix product out of
// shared memory with a 4x4 tile of outputs a thread; it does (n1 + n2)
// complex multiply-adds per element and transform, so operations, not
// bytes, bound it (PERF.md).  A block holds `cols` (<= 2) neighbouring
// columns of all H rows, and the H x cols spectrum lives in shared memory
// through both H transforms and the mask.  A stage-one output (k1, m2) goes
// to row m2 of a buffer whose rows are ld = n1 | 1 elements long (odd, so
// that the transposed stores of neighbouring threads fall in different
// banks), where stage two reads it back as a row.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr int TK = 4;   // sub-DFT outputs a thread holds along k
constexpr int TC = 4;   // and along the other index

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// out(k, c) = sum_m root[(k*m) mod nm] * a[m*lda + c] for k < nm, c < nc;
// store(k, c, value) for each.
template <typename Store>
__device__ __forceinline__ void sub_dft(const float2* a, int nm, int nc,
                                        int lda, const float2* root,
                                        Store store) {
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
      for (int j = 0; j < TC; ++j) v[j] = a[m * lda + c[j]];
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
          s.x = fmaf(v[j].x, w[i].x, fmaf(-v[j].y, w[i].y, s.x));
          s.y = fmaf(v[j].x, w[i].y, fmaf(v[j].y, w[i].x, s.y));
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
__device__ __forceinline__ void stage_one(const float2* a, float2* y, int n1,
                                          int n2, int cols, int ld,
                                          const float2* w1,
                                          const float2* __restrict__ tw) {
  sub_dft(a, n1, n2 * cols, n2 * cols, w1, [&](int k1, int c, float2 v) {
    const int m2 = c / cols, col = c - m2 * cols;
    y[(m2 * ld + k1) * cols + col] = cmul(v, __ldg(&tw[m2 * n1 + k1]));
  });
}

// -- K6a and K6c: radix FFTs of two real rows in shared memory ---------------

constexpr int FFT_MAX_PASSES = 16;    // fourier_kernels.MAX_PASSES
constexpr int FFT_MAX_THREADS = 256;
constexpr int FFT_BLOCKS_PER_SM = 3;  // 3 x 68 KB of shared memory at 4096
constexpr int FFT_MAX_N = 8192;       // two padded rows of float2: 136 KB

// Where element i of a row lives in its shared-memory buffer: one float2 of
// padding after every 16, so that a pass's stores at stride 8 (the first
// pass's, ns = 1) fall in different banks, while 16 neighbouring elements
// from 16 aligned threads stay one run of banks.
__host__ __device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The radices of one length's passes, from _radix_plan on the host.
struct RadixPlan {
  int passes;
  int radix[FFT_MAX_PASSES];
};

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// a times -i (forward) or +i (inverse): a quarter turn of the transform's
// own direction
template <bool INV>
__device__ __forceinline__ float2 quarter(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// (cos, sin) of 2 pi i / R for the odd radices, 1 <= i <= (R - 1) / 2
__device__ __forceinline__ float2 odd_root(int R, int i) {
  switch (R * 8 + i) {
    case 3 * 8 + 1: return make_float2(-0.5f, 0.8660254037844387f);
    case 5 * 8 + 1: return make_float2(0.30901699437494745f,
                                       0.9510565162951535f);
    case 5 * 8 + 2: return make_float2(-0.8090169943749473f,
                                       0.5877852522924732f);
    case 7 * 8 + 1: return make_float2(0.6234898018587336f,
                                       0.7818314824680298f);
    case 7 * 8 + 2: return make_float2(-0.22252093395631434f,
                                       0.9749279121818236f);
    default:        return make_float2(-0.900968867902419f,     // 7, 3
                                       0.43388373911755823f);
  }
}

template <bool INV>
__device__ __forceinline__ void bfly4(float2* v) {
  const float2 y0 = cadd(v[0], v[2]), y1 = csub(v[0], v[2]);
  const float2 y2 = cadd(v[1], v[3]), y3 = quarter<INV>(csub(v[1], v[3]));
  v[0] = cadd(y0, y2);
  v[1] = cadd(y1, y3);
  v[2] = csub(y0, y2);
  v[3] = csub(y1, y3);
}

// Two 4-point DFTs of the even and odd inputs, the odd ones turned by
// w8^k = ((1 -+ i) / sqrt 2)^k, then one radix-2 step.
template <bool INV>
__device__ __forceinline__ void bfly8(float2* v) {
  constexpr float h = 0.7071067811865476f;
  float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
  bfly4<INV>(e);
  bfly4<INV>(o);
  o[1] = INV ? make_float2(h * (o[1].x - o[1].y), h * (o[1].x + o[1].y))
             : make_float2(h * (o[1].x + o[1].y), h * (o[1].y - o[1].x));
  o[2] = quarter<INV>(o[2]);
  o[3] = INV ? make_float2(-h * (o[3].x + o[3].y), h * (o[3].x - o[3].y))
             : make_float2(h * (o[3].y - o[3].x), -h * (o[3].x + o[3].y));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = cadd(e[k], o[k]);
    v[k + 4] = csub(e[k], o[k]);
  }
}

// An odd R-point DFT from the sums and differences of mirrored inputs:
// out[k], out[R - k] = a_k +- quarter(b_k), a_k = v0 + sum_m (v_m +
// v_{R-m}) cos(2 pi m k / R), b_k = sum_m (v_m - v_{R-m}) sin(2 pi m k / R).
template <int R, bool INV>
__device__ __forceinline__ void bfly_odd(float2* v) {
  constexpr int h = (R - 1) / 2;
  float2 s[h], d[h], out[R];
  out[0] = v[0];
#pragma unroll
  for (int m = 1; m <= h; ++m) {
    s[m - 1] = cadd(v[m], v[R - m]);
    d[m - 1] = csub(v[m], v[R - m]);
    out[0] = cadd(out[0], s[m - 1]);
  }
#pragma unroll
  for (int k = 1; k <= h; ++k) {
    float2 a = v[0], b = make_float2(0.f, 0.f);
#pragma unroll
    for (int m = 1; m <= h; ++m) {
      const int q = m * k % R;
      float2 w = odd_root(R, q <= h ? q : R - q);
      if (q > h) w.y = -w.y;
      a.x = fmaf(s[m - 1].x, w.x, a.x);
      a.y = fmaf(s[m - 1].y, w.x, a.y);
      b.x = fmaf(d[m - 1].x, w.y, b.x);
      b.y = fmaf(d[m - 1].y, w.y, b.y);
    }
    out[k] = cadd(a, quarter<INV>(b));
    out[R - k] = csub(a, quarter<INV>(b));
  }
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = out[k];
}

template <int R, bool INV>
__device__ __forceinline__ void butterfly(float2* v) {
  if constexpr (R == 2) {
    const float2 t = v[0];
    v[0] = cadd(t, v[1]);
    v[1] = csub(t, v[1]);
  } else if constexpr (R == 4) {
    bfly4<INV>(v);
  } else if constexpr (R == 8) {
    bfly8<INV>(v);
  } else {
    bfly_odd<R, INV>(v);
  }
}

// One Stockham pass of radix R over an n-point row, after passes whose
// radices multiply to ns.  Butterfly j < n/R takes v_r = element
// j + r n/R (load), turns v_r by root[r (j mod ns) n/(ns R)] (none in the
// first pass), does its R-point DFT in registers and puts out_k at
// (j - j mod ns) R + j mod ns + k ns (store).  tw holds this pass's
// twiddles at (r - 1) ns + j mod ns, so that neighbouring butterflies read
// neighbouring words.
template <int R, bool INV, typename Load, typename Store>
__device__ __forceinline__ void radix_pass(Load load, Store store, int n,
                                           int ns,
                                           const float2* __restrict__ tw) {
  const int m = n / R;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int j0 = j % ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = load(j + r * m);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        v[r] = cmul(v[r], __ldg(&tw[(r - 1) * ns + j0]));
    }
    butterfly<R, INV>(v);
    const int d = (j - j0) * R + j0;
#pragma unroll
    for (int r = 0; r < R; ++r) store(d + r * ns, v[r]);
  }
}

// A pass of a prime radix p > 7: output (j, k) is the p-term sum of
// element j + q n/p times root[(q e) mod n], e = (j mod ns) n/(ns p) +
// k n/p: the twiddle and the p-point root in one entry, the index carried
// along the sum with one add and compare.  Four partial sums (q mod 4)
// shorten the chain of roundings and of dependent FMAs.
template <typename Load, typename Store>
__device__ __forceinline__ void generic_pass(Load load, Store store, int n,
                                             int ns, int p,
                                             const float2* __restrict__ roots) {
  const int m = n / p, step = n / (ns * p);
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int k = o / m, j = o - k * m, j0 = j % ns;
    const int e = j0 * step + k * m;
    float2 acc[4] = {};
    int idx = 0;
    for (int q = 0; q < p; ++q) {
      const float2 v = load(j + q * m), w = __ldg(&roots[idx]);
      float2& s = acc[q & 3];
      s.x = fmaf(v.x, w.x, fmaf(-v.y, w.y, s.x));
      s.y = fmaf(v.x, w.y, fmaf(v.y, w.x, s.y));
      idx += e;
      if (idx >= n) idx -= n;
    }
    store((j - j0) * p + j0 + k * ns,
          cadd(cadd(acc[0], acc[2]), cadd(acc[1], acc[3])));
  }
}

// One pass of radix r, which a plan holds: 2, 3, 4, 5, 7, 8 or a prime
// above 7.
template <bool INV, typename Load, typename Store>
__device__ __forceinline__ void one_pass(int r, Load load, Store store, int n,
                                         int ns, const float2* __restrict__ tw,
                                         const float2* __restrict__ roots) {
  switch (r) {
    case 2: radix_pass<2, INV>(load, store, n, ns, tw); break;
    case 3: radix_pass<3, INV>(load, store, n, ns, tw); break;
    case 4: radix_pass<4, INV>(load, store, n, ns, tw); break;
    case 5: radix_pass<5, INV>(load, store, n, ns, tw); break;
    case 7: radix_pass<7, INV>(load, store, n, ns, tw); break;
    case 8: radix_pass<8, INV>(load, store, n, ns, tw); break;
    default: generic_pass(load, store, n, ns, r, roots);
  }
}

// After a pass of radix r: the next pass's ns and twiddles (a pass with a
// butterfly of its own after the first used (r - 1) ns of them; a generic
// radix is >= 11).
__device__ __forceinline__ void advance(int r, int& ns,
                                        const float2*& tw) {
  if (ns > 1 && r <= 8) tw += (r - 1) * ns;
  ns *= r;
}

struct SmemLoad {
  const float2* a;
  __device__ float2 operator()(int i) const { return a[slot(i)]; }
};
struct SmemStore {
  float2* b;
  __device__ void operator()(int i, float2 v) const { b[slot(i)] = v; }
};

// Passes s0 <= s < s1 of `plan` between the shared-memory buffers a and b
// (the row in a, written before a barrier), a barrier after each; a, b,
// ns and tw follow the passes, so the result is in a.
template <bool INV>
__device__ void smem_passes(float2*& a, float2*& b, int& ns,
                            const float2*& tw, int n, const RadixPlan& plan,
                            int s0, int s1,
                            const float2* __restrict__ roots) {
  for (int s = s0; s < s1; ++s) {
    const int r = plan.radix[s];
    one_pass<INV>(r, SmemLoad{a}, SmemStore{b}, n, ns, tw, roots);
    __syncthreads();
    advance(r, ns, tw);
    float2* t = a;
    a = b;
    b = t;
  }
}

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

// -- K6a: DFT along W of two real rows per block ------------------------------
//
// Block i takes rows 2i and 2i + 1 of the (P*H, W) stack (the last block of
// an odd count one row, x_b = 0): z = x_a + i x_b, Z = DFT(z), then
// X_a[k] = (Z[k] + conj Z[W-k]) / 2 and X_b[k] = (Z[k] - conj Z[W-k]) / 2i.
// The first pass reads z straight from device memory (neighbouring
// threads, neighbouring words); the split reads Z[k] and Z[W-k] from
// shared memory and writes both rows in order, as float4 (two complex
// values) when vec: W even and spec 16-byte aligned.

__global__ void __launch_bounds__(FFT_MAX_THREADS, FFT_BLOCKS_PER_SM)
w_forward_kernel(const float* __restrict__ x, float2* __restrict__ spec,
                 const float2* __restrict__ roots,
                 const float2* __restrict__ twiddles, long long rows, int n,
                 RadixPlan plan, bool vec) {
  extern __shared__ float2 smem[];
  const float2* tw = twiddles;
  float2* a = smem;
  float2* b = smem + slot(n);
  const long long r0 = 2LL * blockIdx.x;
  const bool two = r0 + 1 < rows;
  const float* xa = x + r0 * n;
  const float* xb = xa + n;
  int ns = 1;
  one_pass<false>(
      plan.radix[0],
      [&](int i) {
        return make_float2(__ldg(&xa[i]), two ? __ldg(&xb[i]) : 0.f);
      },
      SmemStore{a}, n, ns, tw, roots);
  __syncthreads();
  advance(plan.radix[0], ns, tw);
  smem_passes<false>(a, b, ns, tw, n, plan, 1, plan.passes, roots);

  float2* sa = spec + r0 * n;
  float2* sb = sa + n;
  // the two rows' values at k from Z[k] and Z[W-k]
  auto split = [&](int k, float2& va, float2& vb) {
    const float2 p = a[slot(k)], q = a[slot(k == 0 ? 0 : n - k)];
    va = make_float2(0.5f * (p.x + q.x), 0.5f * (p.y - q.y));
    vb = make_float2(0.5f * (p.y + q.y), 0.5f * (q.x - p.x));
  };
  if (vec) {
    float4* sa4 = reinterpret_cast<float4*>(sa);
    float4* sb4 = reinterpret_cast<float4*>(sb);
    for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
      float2 a0, b0, a1, b1;
      split(2 * i, a0, b0);
      split(2 * i + 1, a1, b1);
      sa4[i] = make_float4(a0.x, a0.y, a1.x, a1.y);
      if (two) sb4[i] = make_float4(b0.x, b0.y, b1.x, b1.y);
    }
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      float2 va, vb;
      split(k, va, vb);
      sa[k] = va;
      if (two) sb[k] = vb;
    }
  }
}

// -- K6c: inverse DFT along W of two complex rows per block, real, clipped ---
//
// Block i takes rows 2i and 2i + 1 (the last block of an odd count one row,
// g_b = 0): Z = (h(g_a) + i h(g_b)) / W with h(g)[k] = (g[k] + conj g[W-k])
// / 2, so that IDFT(h(g)) = Re IDFT(g) for every g, Hermitian or not;
// z = IDFT(Z), out_a = clip(Re z), out_b = clip(Im z).  Thread k forms
// Z[k] and Z[W-k] from g[k] and g[W-k] of both rows, read straight from
// device memory; the last pass writes its outputs straight to device
// memory (neighbouring threads, neighbouring words).

__global__ void __launch_bounds__(FFT_MAX_THREADS, FFT_BLOCKS_PER_SM)
w_inverse_kernel(const float2* __restrict__ g, float* __restrict__ out,
                 const float2* __restrict__ roots,
                 const float2* __restrict__ twiddles, long long rows, int n,
                 RadixPlan plan) {
  extern __shared__ float2 smem[];
  const float2* tw = twiddles;
  float2* a = smem;
  float2* b = smem + slot(n);
  const long long r0 = 2LL * blockIdx.x;
  const bool two = r0 + 1 < rows;
  const float2* ga = g + r0 * n;
  const float2* gb = ga + n;
  const float2 zero = make_float2(0.f, 0.f);
  const float s = 0.5f / n;
  for (int k = threadIdx.x; k <= n / 2; k += blockDim.x) {
    const int kk = k == 0 ? 0 : n - k;
    const float2 p = __ldg(&ga[k]), pm = __ldg(&ga[kk]);
    const float2 q = two ? __ldg(&gb[k]) : zero;
    const float2 qm = two ? __ldg(&gb[kk]) : zero;
    const float2 ha = make_float2(p.x + pm.x, p.y - pm.y);
    const float2 hb = make_float2(q.x + qm.x, q.y - qm.y);
    a[slot(k)] = make_float2((ha.x - hb.y) * s, (ha.y + hb.x) * s);
    if (kk != k)
      a[slot(kk)] = make_float2((ha.x + hb.y) * s, (hb.x - ha.y) * s);
  }
  __syncthreads();
  int ns = 1;
  smem_passes<true>(a, b, ns, tw, n, plan, 0, plan.passes - 1, roots);

  float* oa = out + r0 * n;
  float* ob = oa + n;
  one_pass<true>(
      plan.radix[plan.passes - 1], SmemLoad{a},
      [&](int i, float2 v) {
        oa[i] = clip01(v.x);
        if (two) ob[i] = clip01(v.y);
      },
      n, ns, tw, roots);
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
  sub_dft(y, n2, n1 * cols, ld * cols, rf + n1, [&](int k2, int c, float2 f) {
    const float p = f.x * f.x + f.y * f.y;
    const float m = p / (p + floor_);
    buf[k2 * n1 * cols + c] = make_float2(f.x * m, f.y * m);
  });
  __syncthreads();

  // inverse: stage one into y, stage two (/H) to device memory
  stage_one(buf, y, n1, n2, cols, ld, ri, tab_i + n1 + n2);
  __syncthreads();
  const float n = (float)H;
  sub_dft(y, n2, n1 * cols, ld * cols, ri + n1, [&](int k2, int c, float2 f) {
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

// Threads for an n-point FFT block: n/16 (two radix-8 butterflies each a
// pass), whole warps, at least one warp and at most FFT_MAX_THREADS (more
// loop).  At 4096 no other split timed by k6_block_split.py (256 or 512
// threads, one to four blocks an SM) ran K6a or K6c faster by more than
// its noise; unpadded rows ran K6c slower.
int fft_threads(int n) {
  const int t = ((n + 15) / 16 + 31) / 32 * 32;
  return t < FFT_MAX_THREADS ? t : FFT_MAX_THREADS;
}

// The plan from the host's radices; false unless they multiply to n.
bool make_plan(const int* radices, int passes, int n, RadixPlan& plan) {
  if (radices == nullptr || passes < 1 || passes > FFT_MAX_PASSES || n < 2 ||
      n > FFT_MAX_N)
    return false;
  long long prod = 1;
  plan.passes = passes;
  for (int s = 0; s < passes; ++s) {
    if (radices[s] < 2) return false;
    plan.radix[s] = radices[s];
    prod *= radices[s];
  }
  return prod == n;
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The launch of K6a or K6c: one block per pair of rows, two padded float2
// rows of shared memory, the plan from the host's radices.
struct RowLaunch {
  RadixPlan plan;
  long long rows;
  unsigned blocks;
  int threads;
  size_t smem;
};

// false when the kernels refuse the plan or the shape.
bool row_launch(const int* radices, int passes, int P, int H, int W,
                RowLaunch& l) {
  if (P < 1 || H < 1 || !make_plan(radices, passes, W, l.plan)) return false;
  l.rows = (long long)P * H;
  const long long blocks = (l.rows + 1) / 2;
  if (blocks > 0x7fffffffLL) return false;
  l.blocks = (unsigned)blocks;
  l.threads = fft_threads(W);
  l.smem = 2 * (size_t)slot(W) * sizeof(float2);
  return true;
}

}  // namespace

// x: (P, H, W) float32; spec: (P, H, W) complex64 (float2); roots, tw: the
// W forward roots, (W) float2, and the passes' twiddles in pass order;
// radices: the radices of the plan's passes, in host memory.  All tensors
// contiguous, on one device.
extern "C" int k6a_w_forward(const float* x, void* spec, const void* roots,
                             const void* tw, const int* radices, int P, int H,
                             int W, int passes, void* stream) {
  RowLaunch l;
  if (!row_launch(radices, passes, P, H, W, l)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(w_forward_kernel, l.smem);
  if (err != cudaSuccess) return err;
  const bool vec = W % 2 == 0 && aligned16(spec);
  w_forward_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
      x, static_cast<float2*>(spec), static_cast<const float2*>(roots),
      static_cast<const float2*>(tw), l.rows, W, l.plan, vec);
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

// g: (P, H, W) complex64; out: (P, H, W) float32; roots, tw: the W inverse
// roots and the passes' twiddles; radices as for K6a.
extern "C" int k6c_w_inverse(const void* g, float* out, const void* roots,
                             const void* tw, const int* radices, int P, int H,
                             int W, int passes, void* stream) {
  RowLaunch l;
  if (!row_launch(radices, passes, P, H, W, l)) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(w_inverse_kernel, l.smem);
  if (err != cudaSuccess) return err;
  w_inverse_kernel<<<l.blocks, l.threads, l.smem, (cudaStream_t)stream>>>(
      static_cast<const float2*>(g), out, static_cast<const float2*>(roots),
      static_cast<const float2*>(tw), l.rows, W, l.plan);
  return cudaGetLastError();
}
