// The standalone BFP quantizer, for Hopper (sm_90a).
//
// Replaces bfp_quantize_pallas of src/repro/kernels/bfp_quant.py: the paper's
// Fig. 1(a) mapping of f32 (M, N) to int8 mantissas against one shared
// biased exponent per row (int32 (M,); a per-tensor exponent arrives
// broadcast), stochastic rounding against streamed uint32 bits (M, N).  The
// arithmetic is repro::quantize_one of bfp.cuh with p = 7 and stochastic
// rounding, the same circuit the fused kernels use, so the bit-level
// quantizer exists once in the port.
//
// Design.  The TPU kernel tiles (block_rows, N) in VMEM and pads the rows
// to 8 and the lanes to 128.  Here nothing is padded: a grid-stride
// elementwise pass over the flat M * N elements, four a thread per step (one
// 16-byte load of x, one of the bits, one 4-byte store of four int8), each
// element reading its row's exponent; an odd tail, or operands not aligned
// to 16 bytes, take the scalar path.
//
// Bound on the H100: bytes, 9 per element (4 of x, 4 of bits, 1 out) over
// 3.35 TB/s; there is no reuse to exploit, so the only lever is full-width
// coalesced loads, which the four-element step gives.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"

namespace {

using repro::quantize_one;

constexpr int THREADS = 256;
constexpr int P = 7;  // int8: 7 magnitude bits

__device__ __forceinline__ int8_t q1(const float* x, const uint32_t* r,
                                     const int* e_rows, size_t i, int n) {
  return (int8_t)quantize_one(x[i], r[i], e_rows[i / n], P, true);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) bfp_quantize_kernel(
    const float* __restrict__ x, const uint32_t* __restrict__ r,
    const int* __restrict__ e_rows, int8_t* __restrict__ out, size_t total,
    int n) {
  const size_t n4 = total / 4;
  const size_t stride = (size_t)gridDim.x * THREADS;
  for (size_t q = (size_t)blockIdx.x * THREADS + threadIdx.x; q < n4; q += stride) {
    const size_t i = 4 * q;
    if (VEC) {
      const float4 v = reinterpret_cast<const float4*>(x)[q];
      const uint4 b = reinterpret_cast<const uint4*>(r)[q];
      // one division a step: the four elements span at most two rows
      // when n >= 4, and each is placed by comparison
      const size_t row = i / n, next = (row + 1) * n;
      int e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e[j] = n >= 4 ? e_rows[i + j < next ? row : row + 1] : e_rows[(i + j) / n];
      char4 o;
      o.x = (signed char)quantize_one(v.x, b.x, e[0], P, true);
      o.y = (signed char)quantize_one(v.y, b.y, e[1], P, true);
      o.z = (signed char)quantize_one(v.z, b.z, e[2], P, true);
      o.w = (signed char)quantize_one(v.w, b.w, e[3], P, true);
      reinterpret_cast<char4*>(out)[q] = o;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i + j] = q1(x, r, e_rows, i + j, n);
    }
  }
  // the last total % 4 elements
  const size_t t = 4 * n4 + (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (t < total) out[t] = q1(x, r, e_rows, t, n);
}

}  // namespace

extern "C" {

// x (M,N) f32, r (M,N) uint32, e_rows (M) int32 -> out (M,N) int8.
int repro_bfp_quantize(const void* x, const void* r, const void* e_rows,
                       void* out, int M, int N, void* stream) {
  const size_t total = (size_t)M * N;
  if (total == 0) return 0;
  const size_t n4 = total / 4;
  size_t blocks = (n4 + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r)) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 4 == 0);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* rb = static_cast<const uint32_t*>(r);
  const auto* er = static_cast<const int*>(e_rows);
  auto* o = static_cast<int8_t*>(out);
  if (vec)
    bfp_quantize_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(xf, rb, er, o, total, N);
  else
    bfp_quantize_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(xf, rb, er, o, total, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
