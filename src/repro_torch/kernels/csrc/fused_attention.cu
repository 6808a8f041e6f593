// Fused decode attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces fused_attn_decode_pallas of src/repro/kernels/fused_attention.py
// (its _decode_core).  One block serves one (batch * KV-head) slice: the
// grouped query rows qm (GS, D) int8 with one per-tensor exponent eq, and the
// cache rows km/vm (T, D) int8 with one exponent per row (ek, ev).
//
//   scores  s[r,t] = int32 dot(qm[r], km[t]) * 2^(sq + sk[t]), masked;
//   softmax p = exp(s - max_t s) / sum_t, in float32;
//   fold    p2[r,t] = p[r,t] * 2^(sv[t])  (exact: V runs at unit scale);
//   p2 quantized per query row over the whole band (shared exponent =
//           max effective exponent of the row), against streamed bits;
//   PV      y[r,d] = int32 sum_t ph[r,t] * vm[t,d] * 2^(scale of the row).
//
// Design.  The TPU kernel keeps the band in VMEM in one program.  Here the
// softmax needs the whole row before p can be quantized (its shared
// exponent is the row max of eff_exp(p2)), so the scores of the slice are
// held in shared memory: 5 bytes per (row, position) plus the query and the
// int32 PV sums.  That bounds T (planned in kernels.dispatch.plan_attention:
// about 6600 positions for qwen2's GS = 7, D = 64).  Scores use __dp4a on
// the packed query words; one warp per query row does the max, exp, sum,
// normalise, fold and quantize with warp shuffles; the PV sums accumulate
// exactly in int32 (shared-memory atomics, order-free).  expf and the
// division are IEEE (no fast math), so the result differs from the plain
// version only by the order of the float sum of the softmax.
//
// Bound on the H100: the cache rows, 2*T*D bytes plus 8*T bytes of row
// exponents per slice, and the rounding bits, 4*GS*T bytes, over
// 3.35 TB/s.  The qwen2 decode grid is only B * 2 blocks: it cannot fill
// the card, and per-launch latency dominates at these sizes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"

namespace {

using repro::eff_exp;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;  // models.attention._NEG

__device__ __forceinline__ bool visible(int t, int qpos, int kv_len, int causal,
                                        int window) {
  bool m = t < kv_len;
  if (causal) m = m && t <= qpos;
  if (window) m = m && (qpos - t) < window;
  return m;
}

template <bool STOCH>
__global__ void __launch_bounds__(THREADS) attn_decode_kernel(
    const int8_t* __restrict__ qm, const int* __restrict__ eq_ptr,
    const int8_t* __restrict__ km, const int8_t* __restrict__ vm,
    const int* __restrict__ ek, const int* __restrict__ ev,
    const uint32_t* __restrict__ rp, float* __restrict__ y, int GS, int T,
    int D, int s, int q_off, int kv_len, int causal, int window, int p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DW = D / 4;
  float* sf = reinterpret_cast<float*>(smem);                    // GS*T
  int* acc = reinterpret_cast<int*>(sf + (size_t)GS * T);        // GS*D
  int* qs = acc + GS * D;                                        // GS*DW
  int* erow = qs + GS * DW;                                      // GS
  int8_t* ph = reinterpret_cast<int8_t*>(erow + GS);             // GS*T

  const size_t bh = blockIdx.x;
  qm += bh * GS * D;
  km += bh * T * D;
  vm += bh * T * D;
  ek += bh * T;
  ev += bh * T;
  if (STOCH) rp += bh * GS * T;
  y += bh * GS * D;
  const int sq = scale_exp(*eq_ptr, p);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int* qw = reinterpret_cast<const int*>(qm);
  for (int i = tid; i < GS * DW; i += THREADS) qs[i] = qw[i];
  for (int i = tid; i < GS * D; i += THREADS) acc[i] = 0;
  __syncthreads();

  // Scores: one thread per cache position, query rows in chunks of 8.
  for (int t = tid; t < T; t += THREADS) {
    const int* kw = reinterpret_cast<const int*>(km + (size_t)t * D);
    const float sc = pow2f(sq + scale_exp(ek[t], p));
    for (int r0 = 0; r0 < GS; r0 += 8) {
      int dot[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int w = 0; w < DW; ++w) {
        const int k4 = kw[w];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (r0 + i < GS) dot[i] = __dp4a(qs[(r0 + i) * DW + w], k4, dot[i]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = r0 + i;
        if (r >= GS) break;
        const int qpos = r % s + q_off;
        sf[(size_t)r * T + t] =
            visible(t, qpos, kv_len, causal, window) ? __int2float_rn(dot[i]) * sc : NEG;
      }
    }
  }
  __syncthreads();

  // Softmax, V-exponent fold and quantization of p: one warp per query row.
  for (int r = warp; r < GS; r += WARPS) {
    float* row = sf + (size_t)r * T;
    const int qpos = r % s + q_off;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, row[t]);
    for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    int emax = 1;
    for (int t = lane; t < T; t += 32) {
      const float pn = visible(t, qpos, kv_len, causal, window) ? row[t] / sum : 0.0f;
      const float p2 = pn * pow2f(scale_exp(ev[t], p));
      row[t] = p2;
      emax = max(emax, eff_exp(p2));
    }
    for (int o = 16; o > 0; o /= 2) emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, o));
    if (lane == 0) erow[r] = emax;
    for (int t = lane; t < T; t += 32)
      ph[(size_t)r * T + t] = (int8_t)quantize_one(
          row[t], STOCH ? rp[(size_t)r * T + t] : 0u, emax, p, STOCH);
  }
  __syncthreads();

  // PV: thread (d, g) sums positions t = g, g + G, ... exactly in int32.
  if (D <= THREADS) {
    const int G = THREADS / D;
    const int d = tid % D, g = tid / D;
    if (g < G) {
      for (int r0 = 0; r0 < GS; r0 += 8) {
        int part[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int t = g; t < T; t += G) {
          const int v = vm[(size_t)t * D + d];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (r0 + i < GS) part[i] += (int)ph[(size_t)(r0 + i) * T + t] * v;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (r0 + i < GS) atomicAdd(&acc[(r0 + i) * D + d], part[i]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < GS * D; i += THREADS) {
    const int r = i / D;
    y[i] = __int2float_rn(acc[i]) * pow2f(scale_exp(erow[r], p));
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs for a (GS, T, D) slice.
long long repro_attn_decode_smem(int GS, int T, int D) {
  return 4LL * GS * T + 4LL * GS * D + (long long)GS * D + 4LL * GS + (long long)GS * T;
}

// qm (BH,GS,D) int8, eq int32 scalar, km/vm (BH,T,D) int8, ek/ev (BH,T)
// int32, rp (BH,GS,T) uint32 or null -> y (BH,GS,D) f32.  D % 4 == 0,
// D <= 256.
int repro_attn_decode(const void* qm, const void* eq, const void* km,
                      const void* vm, const void* ek, const void* ev,
                      const void* rp, void* y, int BH, int GS, int T, int D,
                      int s, int q_off, int kv_len, int causal, int window,
                      int p, int stochastic, void* stream) {
  const size_t smem = (size_t)repro_attn_decode_smem(GS, T, D);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stochastic) {
    err = cudaFuncSetAttribute(attn_decode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_decode_kernel<true><<<BH, THREADS, smem, st>>>(
        static_cast<const int8_t*>(qm), static_cast<const int*>(eq),
        static_cast<const int8_t*>(km), static_cast<const int8_t*>(vm),
        static_cast<const int*>(ek), static_cast<const int*>(ev),
        static_cast<const uint32_t*>(rp), static_cast<float*>(y), GS, T, D, s,
        q_off, kv_len, causal, window, p);
  } else {
    err = cudaFuncSetAttribute(attn_decode_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attn_decode_kernel<false><<<BH, THREADS, smem, st>>>(
        static_cast<const int8_t*>(qm), static_cast<const int*>(eq),
        static_cast<const int8_t*>(km), static_cast<const int8_t*>(vm),
        static_cast<const int*>(ek), static_cast<const int*>(ev), nullptr,
        static_cast<float*>(y), GS, T, D, s, q_off, kv_len, causal, window, p);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
