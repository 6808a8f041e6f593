// Float32 functions rounded as the reference's CPU build (XLA) rounds them,
// the device side of core/fmath.py: the Cephes exp evaluated with fused
// multiply-adds, the logistic 1 / (1 + exp(-x)) on it, Eigen's rational
// tanh and the tanh-form GELU on it, and the sum of a row in windows of 32
// (warp_sum_windows).  The kernels are built without
// contraction, so every other float operation is the single IEEE operation
// it spells.
#pragma once

namespace repro {

// core/fmath.py _exp: e^x = e^a * 2^n, n = floor(x log2 e + 1/2), a Cephes
// polynomial on the reduced argument, every step an fmaf as XLA's CPU
// build evaluates it; 2^-127 flushes to 0.
__device__ __forceinline__ float cephes_expf(float x) {
  x = fminf(fmaxf(x, -87.8f), 88.8f);
  float n = floorf(fmaf(x, 1.44269504088896341f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float a = fmaf(-0.693359375f, n, x);
  a = fmaf(2.12194440e-4f, n, a);
  float z = fmaf(a, 1.9875691500e-4f, 1.3981999507e-3f);
  z = fmaf(z, a, 8.3334519073e-3f);
  z = fmaf(z, a, 4.1665795894e-2f);
  z = fmaf(z, a, 1.6666665459e-1f);
  z = fmaf(z, a, 5.0000001201e-1f);
  z = fmaf(z, __fmul_rn(a, a), a);
  z = __fadd_rn(1.0f, z);
  const int ni = (int)n;
  const float p2 = ni == -127 ? 0.0f : __int_as_float((ni + 127) << 23);
  return __fmul_rn(z, p2);
}

// core/fmath.py logistic: 1 / (1 + e^-x), a sub-normal result flushed to 0
// as XLA's CPU build flushes it.
__device__ __forceinline__ float cephes_logisticf(float x) {
  const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, cephes_expf(-x)));
  return s < 1.17549435e-38f ? 0.0f : s;
}

// The sum of v[0, n) in core/fmath.py sum_windows's order, by one warp: n <=
// 32 in index order from 0; otherwise windows of 32 (the padding split before
// and after), each summed in index order, and the window sums summed the
// same way again.  `scratch` holds ceil(n / 32) floats; every lane returns
// the sum.
__device__ __forceinline__ float warp_sum_windows(const float* v, int n,
                                                  float* scratch, int lane) {
  float tot = 0.0f;
  if (n <= 32) {
    for (int i = 0; i < n; ++i) tot = __fadd_rn(tot, v[i]);
    return tot;
  }
  int m = (n + 31) / 32;
  const int before = (m * 32 - n) / 2;
  for (int w = lane; w < m; w += 32) {
    float part = 0.0f;
    for (int i = 0; i < 32; ++i) {
      const int t = w * 32 + i - before;
      if (t >= 0 && t < n) part = __fadd_rn(part, v[t]);
    }
    scratch[w] = part;
  }
  __syncwarp();
  // more than 32 window sums (n > 1024): window them again, in place by one
  // lane (window w reads only sums at or past index w)
  while (m > 32) {
    const int m2 = (m + 31) / 32, b2 = (m2 * 32 - m) / 2;
    if (lane == 0)
      for (int w = 0; w < m2; ++w) {
        float part = 0.0f;
        for (int i = 0; i < 32; ++i) {
          const int t = w * 32 + i - b2;
          if (t >= 0 && t < m) part = __fadd_rn(part, scratch[t]);
        }
        scratch[w] = part;
      }
    __syncwarp();
    m = m2;
  }
  for (int i = 0; i < m; ++i) tot = __fadd_rn(tot, scratch[i]);
  return tot;
}

// core/fmath.py tanh: Eigen's rational form as XLA's CPU build lowers it,
// x * P(x^2) / Q(x^2) on x clamped to +-7.9988 (NaN passes), each Horner
// step an fmaf; x itself below 4e-4, +-1 from 20 on.
__device__ __forceinline__ float xla_tanhf(float x) {
  constexpr int kP[7] = {(int)0xa59f25c0, 0x2a61337e, (int)0xaebd37ff,
                         0x335c0041, 0x3779434a, 0x3a270ded, 0x3ba059dc};
  constexpr int kQ[4] = {0x35a0d3d8, 0x38f895d6, 0x3b14aa05, 0x3ba059dd};
  const float clamp = __int_as_float(0x40fff644);
  const float a = fabsf(x);
  if (a >= 20.0f) return copysignf(1.0f, x);
  if (a < __int_as_float(0x39d1b717)) return x;
  float c = x < -clamp ? -clamp : x;
  c = c > clamp ? clamp : c;
  const float x2 = __fmul_rn(c, c);
  float p = __fmaf_rn(x2, __int_as_float(kP[0]), __int_as_float(kP[1]));
#pragma unroll
  for (int i = 2; i < 7; ++i) p = __fmaf_rn(x2, p, __int_as_float(kP[i]));
  float q = __fmaf_rn(x2, __int_as_float(kQ[0]), __int_as_float(kQ[1]));
#pragma unroll
  for (int i = 2; i < 4; ++i) q = __fmaf_rn(x2, q, __int_as_float(kQ[i]));
  return __fdiv_rn(__fmul_rn(c, p), q);
}

// core/fmath.py gelu (jax.nn.gelu's tanh form):
// x * (0.5 * (1 + tanh(sqrt(2/pi) * fma(0.044715, x^3, x)))), a sub-normal
// result flushed to a zero of its sign as XLA's CPU build flushes it.
__device__ __forceinline__ float xla_geluf(float x) {
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float t =
      xla_tanhf(__fmul_rn(0.7978845834732056f, __fmaf_rn(0.044715f, x3, x)));
  const float y = __fmul_rn(x, __fmul_rn(0.5f, __fadd_rn(1.0f, t)));
  return fabsf(y) < 1.17549435e-38f ? __fmul_rn(y, 0.0f) : y;
}

// gelu(g) * u, the reference's GELU-GLU.
__device__ __forceinline__ float gelu_glu(float g, float u) {
  return __fmul_rn(xla_geluf(g), u);
}

// silu(g) * u as the reference's SiLU-GLU computes it: (g * s) * u.
__device__ __forceinline__ float silu_glu(float g, float u) {
  return __fmul_rn(__fmul_rn(g, cephes_logisticf(g)), u);
}

}  // namespace repro
