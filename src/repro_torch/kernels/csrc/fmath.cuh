// Float32 functions rounded as the reference's CPU build (XLA) rounds them,
// the device side of core/fmath.py: the Cephes exp evaluated with fused
// multiply-adds, the logistic 1 / (1 + exp(-x)) on it, and the sum of a
// row in windows of 32.  The kernels are built without contraction, so
// every other float operation is the single IEEE operation it spells.
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

// silu(g) * u as the reference's SiLU-GLU computes it: (g * s) * u.
__device__ __forceinline__ float silu_glu(float g, float u) {
  return __fmul_rn(__fmul_rn(g, cephes_logisticf(g)), u);
}

}  // namespace repro
