// Fused quantize -> int8 GEMM -> exponent-add rescale, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_linear.py:
//   fused_qq_pt_pallas  (both operands f32, quantized in the kernel)
//   fused_qi_pt_pallas  (a f32 quantized in the kernel, b pre-quantized int8)
// Contraction-last layout: a (B, M, K) x b (B, N, K) -> y (B, M, N), with a
// batch grid dimension (the JAX package maps the 2-D kernel over slices).
// The shared exponents are per tensor (over the whole batched tensor) and
// arrive as device scalars, so no host synchronisation is needed; rounding
// bits are streamed in (uint32, one per element), none are drawn here.
//
// Design.  The TPU kernel keeps the whole (N, K) b side resident in VMEM.
// On Hopper that cannot hold (the tied LM head alone is 151936 x 896 int8,
// 136 MB), so the grid tiles M and N and the block loop walks K in 32-wide
// slices: each slice of a (and of b for qq) is quantized in registers from
// its f32 value and rounding bits, packed four int8 to a 32-bit word in
// shared memory and contracted with __dp4a into int32 accumulators.  The
// blocks of the first N tile write the a mantissas, those of the first M
// tile the b mantissas (the residual outputs of the TPU kernel).  y is
// float(int32) * 2^(sa + sb): exactly the plain version's arithmetic, so the
// two agree bit for bit.
//
// Bounds on the H100.  Each call must move (4+4)*M*K bytes of a and its
// rounding bits, N*K (qi) or 8*N*K (qq) bytes of b, 4*M*N bytes of y and
// the mantissas it writes, against 2*M*N*K int8 operations at 1979 TOP/s:
// bytes over 3.35 TB/s bound every shape of the serving path, the prefill
// projections (M = 512) and decode (M = batch = 4, where the N*K weight
// read dominates).  This first kernel uses __dp4a, not the tensor cores
// (wgmma), and no asynchronous copies: it is right first; fast is later
// work.  A 16-row tile variant serves M <= 16 so decode wastes at most 4x
// of the dot products on padding rows instead of 16x.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"

namespace {

using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;

constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // contraction slice per step (int8)
constexpr int KW = BK / 4;      // 32-bit words per tile row
constexpr int LD = KW + 1;      // padded shared-memory row stride (words)
constexpr int THREADS = 256;    // 16 x 16 threads

// Fill one tile of ROWS x BK int8 mantissas (packed words) in shared memory.
// From f32 + bits (quantized here) or from int8 mantissas (loaded).
template <int ROWS, bool FLOAT_SRC, bool STOCH, bool VEC>
__device__ __forceinline__ void load_tile(
    int (*tile)[LD], const float* __restrict__ xf, const uint32_t* __restrict__ xr,
    const int8_t* __restrict__ xi, int e_shared, int p, int row0, int rows,
    int k0, int K, int8_t* __restrict__ m_out) {
  for (int w = threadIdx.x; w < ROWS * KW; w += THREADS) {
    const int row = w / KW, kw = w % KW;
    const int gr = row0 + row, gk = k0 + kw * 4;
    uint32_t packed = 0;
    if (gr < rows && gk < K) {
      const size_t idx = (size_t)gr * K + gk;
      if (FLOAT_SRC) {
        int q[4];
        if (VEC) {
          const float4 v = *reinterpret_cast<const float4*>(xf + idx);
          uint4 r = make_uint4(0u, 0u, 0u, 0u);
          if (STOCH) r = *reinterpret_cast<const uint4*>(xr + idx);
          q[0] = quantize_one(v.x, r.x, e_shared, p, STOCH);
          q[1] = quantize_one(v.y, r.y, e_shared, p, STOCH);
          q[2] = quantize_one(v.z, r.z, e_shared, p, STOCH);
          q[3] = quantize_one(v.w, r.w, e_shared, p, STOCH);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[j] = gk + j < K ? quantize_one(xf[idx + j], STOCH ? xr[idx + j] : 0u,
                                             e_shared, p, STOCH)
                              : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          packed |= ((uint32_t)q[j] & 0xFFu) << (8 * j);
          if (m_out != nullptr && gk + j < K) m_out[idx + j] = (int8_t)q[j];
        }
      } else if (VEC) {
        packed = *reinterpret_cast<const uint32_t*>(xi + idx);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < K) packed |= ((uint32_t)(uint8_t)xi[idx + j]) << (8 * j);
      }
    }
    tile[row][kw] = (int)packed;
  }
}

// TM rows per thread: the block covers 16*TM rows of a and BN columns of b.
template <int TM, bool B_FLOAT, bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS) qgemm_kernel(
    const float* __restrict__ a, const uint32_t* __restrict__ ra,
    const float* __restrict__ bf, const uint32_t* __restrict__ rb,
    const int8_t* __restrict__ bi, const int* __restrict__ ea_ptr,
    const int* __restrict__ eb_ptr, float* __restrict__ y,
    int8_t* __restrict__ am_out, int8_t* __restrict__ bm_out,
    int M, int N, int K, int pa, int pb) {
  constexpr int BM = 16 * TM;
  __shared__ int As[BM][LD];
  __shared__ int Bs[BN][LD];
  const size_t z = blockIdx.z;
  a += z * M * K;
  if (STOCH) ra += z * M * K;
  if (B_FLOAT) {
    bf += z * N * K;
    if (STOCH) rb += z * N * K;
  } else {
    bi += z * N * K;
  }
  y += z * M * N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int8_t* am_w = (am_out != nullptr && blockIdx.x == 0) ? am_out + z * M * K : nullptr;
  int8_t* bm_w = (bm_out != nullptr && blockIdx.y == 0) ? bm_out + z * N * K : nullptr;
  const int ea = *ea_ptr, eb = *eb_ptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, true, STOCH, VEC>(As, a, ra, nullptr, ea, pa, m0, M, k0, K, am_w);
    load_tile<BN, B_FLOAT, STOCH, VEC>(Bs, bf, rb, bi, eb, pb, n0, N, k0, K, bm_w);
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < KW; ++kw) {
      int av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float scale = pow2f(scale_exp(ea, pa) + scale_exp(eb, pb));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) y[(size_t)gm * N + gn] = __int2float_rn(acc[i][j]) * scale;
    }
  }
}

template <int TM, bool B_FLOAT, bool STOCH, bool VEC>
cudaError_t launch(const float* a, const uint32_t* ra, const float* bf,
                   const uint32_t* rb, const int8_t* bi, const int* ea,
                   const int* eb, float* y, int8_t* am, int8_t* bm, int B,
                   int M, int N, int K, int pa, int pb, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + 16 * TM - 1) / (16 * TM), B);
  qgemm_kernel<TM, B_FLOAT, STOCH, VEC><<<grid, THREADS, 0, stream>>>(
      a, ra, bf, rb, bi, ea, eb, y, am, bm, M, N, K, pa, pb);
  return cudaGetLastError();
}

template <bool B_FLOAT, bool STOCH>
cudaError_t dispatch(const float* a, const uint32_t* ra, const float* bf,
                     const uint32_t* rb, const int8_t* bi, const int* ea,
                     const int* eb, float* y, int8_t* am, int8_t* bm, int B,
                     int M, int N, int K, int pa, int pb, cudaStream_t stream) {
  const bool vec = K % 4 == 0;
  if (M <= 16) {
    return vec ? launch<1, B_FLOAT, STOCH, true>(a, ra, bf, rb, bi, ea, eb, y, am, bm, B, M, N, K, pa, pb, stream)
               : launch<1, B_FLOAT, STOCH, false>(a, ra, bf, rb, bi, ea, eb, y, am, bm, B, M, N, K, pa, pb, stream);
  }
  return vec ? launch<4, B_FLOAT, STOCH, true>(a, ra, bf, rb, bi, ea, eb, y, am, bm, B, M, N, K, pa, pb, stream)
             : launch<4, B_FLOAT, STOCH, false>(a, ra, bf, rb, bi, ea, eb, y, am, bm, B, M, N, K, pa, pb, stream);
}

}  // namespace

extern "C" {

// qq: a (B,M,K) f32 [+ ra], b (B,N,K) f32 [+ rb] -> y (B,M,N), am, bm int8.
// ra/rb are null when stochastic == 0 (half-up rounding).
int repro_fused_qq(const void* a, const void* ra, const void* b, const void* rb,
                   const void* ea, const void* eb, void* y, void* am, void* bm,
                   int B, int M, int N, int K, int p, int stochastic,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto fb = static_cast<const float*>(b);
  auto pe_a = static_cast<const int*>(ea);
  auto pe_b = static_cast<const int*>(eb);
  auto out = static_cast<float*>(y);
  auto oa = static_cast<int8_t*>(am);
  auto ob = static_cast<int8_t*>(bm);
  cudaError_t err =
      stochastic ? dispatch<true, true>(fa, static_cast<const uint32_t*>(ra), fb,
                                        static_cast<const uint32_t*>(rb), nullptr,
                                        pe_a, pe_b, out, oa, ob, B, M, N, K, p, p, s)
                 : dispatch<true, false>(fa, nullptr, fb, nullptr, nullptr, pe_a,
                                         pe_b, out, oa, ob, B, M, N, K, p, p, s);
  return (int)err;
}

// qi: a (B,M,K) f32 [+ ra], b_m (B,N,K) int8 -> y (B,M,N), am int8.
int repro_fused_qi(const void* a, const void* ra, const void* b_m,
                   const void* ea, const void* eb, void* y, void* am, int B,
                   int M, int N, int K, int pa, int pb, int stochastic,
                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto fa = static_cast<const float*>(a);
  auto ib = static_cast<const int8_t*>(b_m);
  auto pe_a = static_cast<const int*>(ea);
  auto pe_b = static_cast<const int*>(eb);
  auto out = static_cast<float*>(y);
  auto oa = static_cast<int8_t*>(am);
  cudaError_t err =
      stochastic ? dispatch<false, true>(fa, static_cast<const uint32_t*>(ra), nullptr,
                                         nullptr, ib, pe_a, pe_b, out, oa, nullptr,
                                         B, M, N, K, pa, pb, s)
                 : dispatch<false, false>(fa, nullptr, nullptr, nullptr, ib, pe_a,
                                          pe_b, out, oa, nullptr, B, M, N, K, pa, pb, s);
  return (int)err;
}

}  // extern "C"
