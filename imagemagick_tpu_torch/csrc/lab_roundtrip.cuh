// sRGB -> Lab -> sRGB of one pixel, the Lab epilogue shared by K2
// (blur_unsharp.cu) and K2p (blur_unsharp_pipe.cu): both include these
// functions, so the two kernels run the same Lab math on each pixel.

#pragma once

namespace lab {

// colorspace.py's constants, rounded to float32 as PyTorch rounds them
constexpr float kDecodeKnee = 0.0404482362771076f;
constexpr float kEncodeKnee = 0.0031306684425005883f;
constexpr float kInv24 = (float)(1.0 / 2.4);
constexpr float kEps = (float)(216.0 / 24389.0);
constexpr float kK = (float)(24389.0 / 27.0);
constexpr float kKEps = (float)((24389.0 / 27.0) * (216.0 / 24389.0));

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.f), 1.f);
}

__device__ __forceinline__ float decode(float v) {      // sRGB -> linear
  const float p = powf(fmaxf((v + 0.055f) / 1.055f, 1e-12f), 2.4f);
  return v <= kDecodeKnee ? v / 12.92f : p;
}

__device__ __forceinline__ float encode(float v) {      // linear -> sRGB
  const float p = powf(fmaxf(v, 1e-12f), kInv24);
  return v <= kEncodeKnee ? 12.92f * v : 1.055f * p - 0.055f;
}

__device__ __forceinline__ float lab_f(float r) {
  return r > kEps ? cbrtf(fmaxf(r, 0.f)) : (kK * r + 16.f) / 116.f;
}

__device__ __forceinline__ float lab_finv(float f) {
  const float f3 = f * f * f;
  return f3 > kEps ? f3 : (116.f * f - 16.f) / kK;
}

// sRGB -> Lab -> sRGB of one pixel, clipped: colorspace.py's rgb_to_lab
// then lab_to_rgb, the out-of-gamut lift included.  Inline: both kernels'
// sources include it, and each links its own copy.
__device__ inline void lab_roundtrip(float& r, float& g, float& b) {
  const float lr = decode(r), lg = decode(g), lb = decode(b);
  const float fx = lab_f((0.4123955889674142161f * lr +
                          0.3575834307637148171f * lg +
                          0.1804926473817015735f * lb) / 0.95047f);
  const float fy = lab_f(0.2125862307855955516f * lr +
                         0.7151703037034108499f * lg +
                         0.07220049864333622685f * lb);
  const float fz = lab_f((0.01929721549174694484f * lr +
                          0.1191838645808485318f * lg +
                          0.9504971251315797660f * lb) / 1.08883f);
  // rgb_to_lab stores L/100, a/255 + 0.5, b/255 + 0.5; lab_to_rgb undoes it
  const float Ls = (116.f * fy - 16.f) / 100.f;
  const float as = 500.f * (fx - fy) / 255.f + 0.5f;
  const float bs = 200.f * (fy - fz) / 255.f + 0.5f;
  const float L = 100.f * Ls;
  const float A = 255.f * (as - 0.5f);
  const float B = 255.f * (bs - 0.5f);
  const float y = (L + 16.f) / 116.f;
  const float X = lab_finv(y + A / 500.f) * 0.95047f;
  const float Y = L > kKEps ? y * y * y : L / kK;
  const float Z = lab_finv(y - B / 200.f) * 1.08883f;
  float R = 3.240969941904521f * X - 1.537383177570093f * Y -
            0.498610760293f * Z;
  float G = -0.96924363628087f * X + 1.87596750150772f * Y +
            0.041555057407175f * Z;
  float Bl = 0.055630079696993f * X - 0.20397695888897f * Y +
             1.056971514242878f * Z;
  const float mn = fminf(R, fminf(G, Bl));
  if (mn < 0.f) {
    R -= mn;
    G -= mn;
    Bl -= mn;
  }
  r = clip01(encode(R));
  g = clip01(encode(G));
  b = clip01(encode(Bl));
}

}  // namespace lab
