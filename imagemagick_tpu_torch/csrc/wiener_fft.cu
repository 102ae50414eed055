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
// All three are radix FFTs in shared memory.  The host factors the length
// n (W for K6a and K6c, H for K6b) into passes (_radix_plan in
// fourier_kernels.py: radix 8, then 4 and 2, then 3, 5 and 7; any other
// prime factor one generic pass) and uploads one table of the n roots
// exp(-+2 pi i k / n), computed in float64 and cast to float32
// (_roots_on); every twiddle, and every root of a generic pass, is an
// entry of it (the twiddles read in pass order from a copy,
// _twiddles_on).  The passes are Stockham autosort passes between two
// buffers in shared memory (radix_pass), natural order in and out, one
// barrier between passes.  A pass runs over a strip of COLS transforms at
// once: element i of transform c lives at slot(i * COLS + c).  Between
// shared-memory buffers a thread takes one butterfly of all COLS
// transforms, so that its index arithmetic and twiddles serve COLS
// butterflies; a pass that reads or writes device memory gives
// neighbouring threads the neighbouring transforms of one butterfly, so
// that a warp moves whole rows of the strip.
//
// K6a and K6c transform rows, one strip of COLS = 1 a block.  Two real
// rows share one complex transform: K6a transforms x_a + i x_b and splits
// the spectrum by Hermitian symmetry; K6c transforms h(g_a) + i h(g_b),
// h(g)[k] = (g[k] + conj g[-k]) / 2, whose inverse DFT is
// Re IDFT(g_a) + i Re IDFT(g_b) for any g.
// K6b transforms columns, a strip of COLS = 4 neighbouring columns a
// block: four complex64 values are one 32-byte sector of a row, so every
// row's read and write moves whole sectors.  Where two buffers of four
// columns would not fit in a block's shared memory (H > 3418) the strip
// narrows to two columns, and above H = 6837 to one.  Its first forward
// pass reads the strip straight from device memory, the Wiener mask is
// applied as the first inverse pass loads its inputs, and the last
// inverse pass writes the strip, times 1/H, straight to device memory:
// the spectrum crosses device memory once each way.
//
// What bounds them on an H100: device memory.  K6a and K6c each move 12
// bytes a pixel (4 in and 8 out, or 8 in and 4 out: 0.0317 ms at
// 2160 x 4096 and 3.35 TB/s) against about 2.5 log2 W operations a pixel
// with the packing (30 at W = 4096, 0.0040 ms at the FP32 peak); K6b moves
// 16 (0.0423 ms) against about 2 x 5 log2 H (111 at H = 2160, 0.0143 ms).
// So each value crosses device memory once each way and everything
// between stays in shared memory: K6a and K6c hold 16 W bytes a block
// (about 68 KB at 4096, three blocks an SM), W/16 threads up to 256 (two
// radix-8 butterflies a thread and pass at 4096); K6b 2 x 8 x COLS x H
// bytes (147 KB at H = 2160, one block an SM) and H / 4 threads up to
// 512.  Shared memory then carries the most traffic, so each kernel's
// first pass reads straight from device memory or its last pass writes
// straight to it, one pass fewer through shared memory.
// In K6b at 2160 x 4096 the passes, not device memory, take most of the
// time (a copy that touches no device memory runs in 3/4 of it,
// k6b_strip_split.py): the instructions of their index arithmetic are
// what a thread a butterfly of the whole strip cuts, and what config #4's
// plan known at compile time (Plan2160) folds away; the persistent grid
// with an L2 prefetch of each block's next strip keeps the SM's one block
// from waiting on device memory at the start of a strip.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// -- radix FFTs in shared memory: K6a, K6b, K6c ------------------------------

constexpr int FFT_MAX_PASSES = 16;    // fourier_kernels.MAX_PASSES
constexpr int FFT_MAX_THREADS = 256;
constexpr int FFT_BLOCKS_PER_SM = 3;  // 3 x 68 KB of shared memory at 4096
constexpr int FFT_MAX_N = 8192;       // two padded rows of float2: 136 KB

// Where element e of a strip (element i of transform c at e = i COLS + c)
// lives in its shared-memory buffer: one float2 of padding after every 16,
// so that a pass's stores at stride 8 (the first pass's, ns = 1) fall in
// different banks, while 16 neighbouring elements from 16 aligned threads
// stay one run of banks.
__host__ __device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The radices of one length's passes, from _radix_plan on the host.
struct RadixPlan {
  int passes;
  int radix[FFT_MAX_PASSES];
  __host__ __device__ int count() const { return passes; }
  __host__ __device__ int at(int s) const { return radix[s]; }
  __host__ __device__ int length(int n) const { return n; }
};

// The plan of config #4's H = 2160 known at compile time, so that every
// pass's radix, ns and n/R are constants and its index arithmetic folds
// (K6b's passes are bound by their instructions, PERF.md).
struct Plan2160 {
  __host__ __device__ static constexpr int count() { return 6; }
  __host__ __device__ static constexpr int at(int s) {
    return s == 0 ? 8 : s == 1 ? 2 : s < 5 ? 3 : 5;
  }
  __host__ __device__ static constexpr int length(int) { return 2160; }
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

// One Stockham pass of radix R over COLS n-point transforms, after passes
// whose radices multiply to ns.  Butterfly j < n/R of transform c takes
// v_r = element j + r n/R (load(i, c)), turns v_r by
// root[r (j mod ns) n/(ns R)] (none in the first pass), does its R-point
// DFT in registers and puts out_k at (j - j mod ns) R + j mod ns + k ns
// (store(i, c, value)).  A thread takes butterfly j of CPT neighbouring
// transforms, so that its index arithmetic and twiddles serve CPT
// butterflies; with CPT < COLS neighbouring threads take the next
// transforms of the same butterfly (a pass that reads or writes device
// memory: a warp then moves whole rows of the strip).  tw holds this
// pass's twiddles at (r - 1) ns + j mod ns, so that neighbouring
// butterflies read neighbouring words.
template <int R, bool INV, int COLS, int CPT, typename Load, typename Store>
__device__ __forceinline__ void radix_pass(Load load, Store store, int n,
                                           int ns,
                                           const float2* __restrict__ tw) {
  constexpr int GROUPS = COLS / CPT;
  const int m = n / R;
  for (int t = threadIdx.x; t < m * GROUPS; t += blockDim.x) {
    const int j = t / GROUPS, c0 = t % GROUPS * CPT;
    const int j0 = j % ns;
    float2 v[CPT][R];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) v[c][r] = load(j + r * m, c0 + c);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(&tw[(r - 1) * ns + j0]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) v[c][r] = cmul(v[c][r], w);
      }
    }
    const int d = (j - j0) * R + j0;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      butterfly<R, INV>(v[c]);
#pragma unroll
      for (int r = 0; r < R; ++r) store(d + r * ns, c0 + c, v[c][r]);
    }
  }
}

// A pass of a prime radix p > 7: output (j, k) is the p-term sum of
// element j + q n/p times root[(q e) mod n], e = (j mod ns) n/(ns p) +
// k n/p: the twiddle and the p-point root in one entry, the index carried
// along the sum with one add and compare.  Four partial sums (q mod 4)
// shorten the chain of roundings and of dependent FMAs.  A thread takes
// output o of CPT neighbouring transforms, each root serving CPT products.
template <int COLS, int CPT, typename Load, typename Store>
__device__ __forceinline__ void generic_pass(Load load, Store store, int n,
                                             int ns, int p,
                                             const float2* __restrict__ roots) {
  constexpr int GROUPS = COLS / CPT;
  const int m = n / p, step = n / (ns * p);
  for (int t = threadIdx.x; t < n * GROUPS; t += blockDim.x) {
    const int o = t / GROUPS, c0 = t % GROUPS * CPT;
    const int k = o / m, j = o - k * m, j0 = j % ns;
    const int e = j0 * step + k * m;
    float2 acc[CPT][4] = {};
    int idx = 0;
    for (int q = 0; q < p; ++q) {
      const float2 w = __ldg(&roots[idx]);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float2 v = load(j + q * m, c0 + c);
        float2& s = acc[c][q & 3];
        s.x = fmaf(v.x, w.x, fmaf(-v.y, w.y, s.x));
        s.y = fmaf(v.x, w.y, fmaf(v.y, w.x, s.y));
      }
      idx += e;
      if (idx >= n) idx -= n;
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store((j - j0) * p + j0 + k * ns, c0 + c,
            cadd(cadd(acc[c][0], acc[c][2]), cadd(acc[c][1], acc[c][3])));
  }
}

// One pass of radix r, which a plan holds: 2, 3, 4, 5, 7, 8 or a prime
// above 7; a thread takes CPT of the COLS transforms (CPT divides COLS).
template <bool INV, int COLS, int CPT, typename Load, typename Store>
__device__ __forceinline__ void one_pass(int r, Load load, Store store, int n,
                                         int ns, const float2* __restrict__ tw,
                                         const float2* __restrict__ roots) {
  switch (r) {
    case 2: radix_pass<2, INV, COLS, CPT>(load, store, n, ns, tw); break;
    case 3: radix_pass<3, INV, COLS, CPT>(load, store, n, ns, tw); break;
    case 4: radix_pass<4, INV, COLS, CPT>(load, store, n, ns, tw); break;
    case 5: radix_pass<5, INV, COLS, CPT>(load, store, n, ns, tw); break;
    case 7: radix_pass<7, INV, COLS, CPT>(load, store, n, ns, tw); break;
    case 8: radix_pass<8, INV, COLS, CPT>(load, store, n, ns, tw); break;
    default: generic_pass<COLS, CPT>(load, store, n, ns, r, roots);
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

template <int COLS>
struct SmemLoad {
  const float2* a;
  __device__ float2 operator()(int i, int c) const {
    return a[slot(i * COLS + c)];
  }
};
template <int COLS>
struct SmemStore {
  float2* b;
  __device__ void operator()(int i, int c, float2 v) const {
    b[slot(i * COLS + c)] = v;
  }
};

// Passes s0 <= s < s1 of `plan` between the shared-memory buffers a and b
// (the strip in a, written before a barrier), a barrier after each; a, b,
// ns and tw follow the passes, so the result is in a.
template <bool INV, int COLS, class Plan>
__device__ __forceinline__ void smem_passes(float2*& a, float2*& b, int& ns,
                                            const float2*& tw, int n,
                                            const Plan& plan, int s0, int s1,
                                            const float2* __restrict__ roots) {
#pragma unroll
  for (int s = s0; s < s1; ++s) {
    const int r = plan.at(s);
    one_pass<INV, COLS, COLS>(r, SmemLoad<COLS>{a}, SmemStore<COLS>{b}, n, ns,
                              tw, roots);
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
  one_pass<false, 1, 1>(
      plan.radix[0],
      [&](int i, int) {
        return make_float2(__ldg(&xa[i]), two ? __ldg(&xb[i]) : 0.f);
      },
      SmemStore<1>{a}, n, ns, tw, roots);
  __syncthreads();
  advance(plan.radix[0], ns, tw);
  smem_passes<false, 1>(a, b, ns, tw, n, plan, 1, plan.passes, roots);

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
  smem_passes<true, 1>(a, b, ns, tw, n, plan, 0, plan.passes - 1, roots);

  float* oa = out + r0 * n;
  float* ob = oa + n;
  one_pass<true, 1, 1>(
      plan.radix[plan.passes - 1], SmemLoad<1>{a},
      [&](int i, int, float2 v) {
        oa[i] = clip01(v.x);
        if (two) ob[i] = clip01(v.y);
      },
      n, ns, tw, roots);
}

// -- K6b: DFT along H, Wiener mask, inverse DFT along H ---------------------
//
// Strip s is a strip of COLS neighbouring columns (plane s / chunks,
// columns c0 .. c0 + COLS - 1; the last strip of a plane may hang over W,
// where it reads zeros and writes nothing).  The first forward pass reads
// row i of the strip straight from device memory, neighbouring threads
// on neighbouring columns; the forward passes leave F in natural order in
// shared memory; the first inverse pass loads F times the mask
// p / (p + noise pmean), p = |F|^2; the last inverse pass writes its
// outputs times 1/H straight to device memory.  The grid is persistent:
// as many blocks as fit on the card at once, block b taking strips b,
// b + G, b + 2G, ...  A strip's reads would leave the SM idle for a
// trip to device memory, so as soon as a block has read one strip it asks
// for its next one to be brought into L2, and the next strip's first pass
// reads from L2.

constexpr int K6B_MAX_THREADS = 512;
constexpr int K6B_BLOCKS_PER_SM = 1;     // 147 KB of shared memory at 2160
constexpr size_t K6B_MAX_SMEM = 232448;  // bytes a block may use

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];" ::"l"(p));
}

template <int COLS, class Plan>
__global__ void __launch_bounds__(K6B_MAX_THREADS, K6B_BLOCKS_PER_SM)
h_mask_kernel(const float2* __restrict__ spec, const float* __restrict__ pmean,
              float2* __restrict__ out, const float2* __restrict__ roots_f,
              const float2* __restrict__ tw_f,
              const float2* __restrict__ roots_i,
              const float2* __restrict__ tw_i, int H, int W, int chunks,
              int strips, Plan plan, float noise) {
  extern __shared__ float2 smem[];
  const int n = plan.length(H);
  const float2 zero = make_float2(0.f, 0.f);
  const float scale = 1.f / n;
  const int last = plan.count() - 1;
  for (int s = blockIdx.x; s < strips; s += gridDim.x) {
    float2* a = smem;
    float2* b = smem + slot(n * COLS);
    const int plane = s / chunks;
    const int c0 = (s - plane * chunks) * COLS;
    const long long base = (long long)plane * n * W + c0;
    const float2* src = spec + base;
    float2* dst = out + base;
    const int cols = min(COLS, W - c0);  // columns of the strip inside W

    // forward: F = DFT_H of each column, natural order, in a
    const float2* tw = tw_f;
    int ns = 1;
    one_pass<false, COLS, 1>(
        plan.at(0),
        [&](int i, int c) {
          return c < cols ? __ldg(&src[(long long)i * W + c]) : zero;
        },
        SmemStore<COLS>{a}, n, ns, tw, roots_f);
    __syncthreads();
    const int next = s + gridDim.x;
    if (next < strips) {
      const int np = next / chunks;
      const float2* nsrc =
          spec + (long long)np * n * W + (next - np * chunks) * COLS;
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        prefetch_l2(nsrc + (long long)i * W);
    }
    advance(plan.at(0), ns, tw);
    smem_passes<false, COLS>(a, b, ns, tw, n, plan, 1, plan.count(), roots_f);

    // inverse: the first pass loads F * mask, the last one stores g / H
    const float floor_ = noise * __ldg(&pmean[plane]);
    const float2* f = a;
    auto masked = [&](int i, int c) {
      const float2 v = f[slot(i * COLS + c)];
      const float p = v.x * v.x + v.y * v.y;
      const float m = p / (p + floor_);
      return make_float2(v.x * m, v.y * m);
    };
    auto store_out = [&](int i, int c, float2 v) {
      if (c < cols)
        dst[(long long)i * W + c] = make_float2(v.x * scale, v.y * scale);
    };
    tw = tw_i;
    ns = 1;
    if (last == 0) {
      one_pass<true, COLS, 1>(plan.at(0), masked, store_out, n, ns, tw,
                              roots_i);
    } else {
      one_pass<true, COLS, COLS>(plan.at(0), masked, SmemStore<COLS>{b}, n,
                                 ns, tw, roots_i);
      __syncthreads();
      advance(plan.at(0), ns, tw);
      float2* t = a;
      a = b;
      b = t;
      smem_passes<true, COLS>(a, b, ns, tw, n, plan, 1, last, roots_i);
      one_pass<true, COLS, 1>(plan.at(last), SmemLoad<COLS>{a}, store_out,
                              n, ns, tw, roots_i);
    }
    __syncthreads();  // the next strip's first pass overwrites the buffers
  }
}

// The dynamic shared memory of a launch, allowed above 48 KB first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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

// Whether the host's plan for an n-point transform is the static plan's.
template <class Static>
bool same_plan(const RadixPlan& plan, Static, int n) {
  if (n != Static::length(n) || plan.passes != Static::count()) return false;
  for (int s = 0; s < plan.passes; ++s)
    if (plan.radix[s] != Static::at(s)) return false;
  return true;
}

// The bytes of K6b's two strip buffers of `cols` columns of n rows.
size_t h_mask_smem(int n, int cols) {
  return 2 * (size_t)slot(n * cols) * sizeof(float2);
}

template <int COLS, class Plan>
cudaError_t h_mask_launch(const float2* spec, const float* pmean,
                          float2* out, const float2* roots_f,
                          const float2* tw_f, const float2* roots_i,
                          const float2* tw_i, const Plan& plan, int P, int H,
                          int W, float noise, cudaStream_t stream) {
  const int chunks = (W + COLS - 1) / COLS;
  const long long strips = (long long)P * chunks;
  if (strips > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = h_mask_smem(H, COLS);
  cudaError_t err = allow_smem(h_mask_kernel<COLS, Plan>, smem);
  if (err != cudaSuccess) return err;
  // H / 4 threads (one radix-4 butterfly of the strip each), whole warps,
  // at most K6B_MAX_THREADS
  const int want = ((H + 3) / 4 + 31) / 32 * 32;
  const int threads = want < K6B_MAX_THREADS ? want : K6B_MAX_THREADS;
  // the persistent grid: as many blocks as are resident on the card at once
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, h_mask_kernel<COLS, Plan>, threads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(strips < resident ? strips : resident);
  h_mask_kernel<COLS, Plan><<<blocks, threads, smem, stream>>>(
      spec, pmean, out, roots_f, tw_f, roots_i, tw_i, H, W, chunks,
      (int)strips, plan, noise);
  return cudaGetLastError();
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

// spec, out: (P, H, W) complex64; pmean: (P,) float32; roots_f, tw_f and
// roots_i, tw_i: the H forward and inverse roots, (H) float2, and their
// passes' twiddles in pass order; radices: the radices of the plan's
// passes, in host memory.  All tensors contiguous, on one device.  The
// strip is 4 columns, or 2 or 1 where 4 or 2 do not fit.
extern "C" int k6b_h_mask(const void* spec, const float* pmean, void* out,
                          const void* roots_f, const void* tw_f,
                          const void* roots_i, const void* tw_i,
                          const int* radices, int P, int H, int W, int passes,
                          float noise, void* stream) {
  RadixPlan plan;
  if (P < 1 || W < 1 || !make_plan(radices, passes, H, plan))
    return cudaErrorInvalidValue;
  const auto* s = static_cast<const float2*>(spec);
  auto* o = static_cast<float2*>(out);
  const auto* rf = static_cast<const float2*>(roots_f);
  const auto* tf = static_cast<const float2*>(tw_f);
  const auto* ri = static_cast<const float2*>(roots_i);
  const auto* ti = static_cast<const float2*>(tw_i);
  const cudaStream_t st = (cudaStream_t)stream;
  if (same_plan(plan, Plan2160{}, H))
    return h_mask_launch<4>(s, pmean, o, rf, tf, ri, ti, Plan2160{}, P, H, W,
                            noise, st);
  if (h_mask_smem(H, 4) <= K6B_MAX_SMEM)
    return h_mask_launch<4>(s, pmean, o, rf, tf, ri, ti, plan, P, H, W,
                            noise, st);
  if (h_mask_smem(H, 2) <= K6B_MAX_SMEM)
    return h_mask_launch<2>(s, pmean, o, rf, tf, ri, ti, plan, P, H, W,
                            noise, st);
  return h_mask_launch<1>(s, pmean, o, rf, tf, ri, ti, plan, P, H, W, noise,
                          st);
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
