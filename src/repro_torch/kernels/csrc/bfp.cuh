// Shared device helpers of the port's kernels: the exact power of two of
// core.bfp.pow2 and one element of the quantizer (_quantize_tile of
// src/repro/kernels/fused_linear.py), bit for bit.
#pragma once

#include <stdint.h>

namespace repro {

// Exact 2^e from the exponent bits; below 2^-126 defined as 0.
__device__ __forceinline__ float pow2f(int e) {
  if (e < -126) return 0.0f;
  if (e > 127) e = 127;
  return __int_as_float((e + 127) << 23);
}

// Unbiased exponent of a p-magnitude-bit BFP scale.
__device__ __forceinline__ int scale_exp(int e_biased, int p) {
  return e_biased - 127 - 23 + (24 - p);
}

// Effective biased exponent of a float (sub-normals count as 1).
__device__ __forceinline__ int eff_exp(float x) {
  const int b = (int)((__float_as_uint(x) >> 23) & 0xFFu);
  return b > 1 ? b : 1;
}

// Unpack the IEEE pattern, align to the shared exponent, threshold-compare
// rounding (stochastic against r, or half up), clamp the 2^p - 1 rounding
// overflow, re-apply the sign.  s >= 0 because e_shared is the maximum
// exponent of its group.
__device__ __forceinline__ int quantize_one(float x, uint32_t r, int e_shared,
                                            int p, bool stochastic) {
  const uint32_t b = __float_as_uint(x);
  const uint32_t sign = b >> 31;
  const int bexp = (int)((b >> 23) & 0xFFu);
  const uint32_t frac = b & 0x7FFFFFu;
  const uint32_t mant = bexp > 0 ? (frac | (1u << 23)) : frac;
  const int eff = bexp > 1 ? bexp : 1;
  const int s = (e_shared - eff) + (24 - p);
  const uint32_t s31 = (uint32_t)(s < 31 ? s : 31);
  const uint32_t base = s < 32 ? (mant >> s31) : 0u;
  const uint32_t m_lo = mant & ((1u << s31) - 1u);
  const int l = 32 - s;
  const uint32_t left = (uint32_t)(l < 0 ? 0 : (l > 31 ? 31 : l));
  const int o = s - 32;
  const uint32_t over = (uint32_t)(o < 0 ? 0 : (o > 31 ? 31 : o));
  const uint32_t thr = s <= 31 ? (m_lo << left) : (s == 32 ? mant : (mant >> over));
  bool up = stochastic ? (r < thr) : (thr >= 0x80000000u);
  up = up && (s > 0);
  uint32_t mag = base + (up ? 1u : 0u);
  const uint32_t lim = (1u << p) - 1u;
  if (mag > lim) mag = lim;
  return sign ? -(int)mag : (int)mag;
}

}  // namespace repro
