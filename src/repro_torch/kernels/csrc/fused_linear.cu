// Fused quantize -> int8 GEMM -> exponent-add rescale, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/fused_linear.py:
//   fused_qq_pt_pallas  (both operands f32, quantized in the kernel)
//   fused_qi_pt_pallas  (a f32 quantized in the kernel, b pre-quantized int8)
//   fused_ii_pt_pallas  (both operands pre-quantized int8: the backward's
//                        dW = X^T G on the residual mantissas)
//   fused_qq_blk_pallas (both operands f32, quantized in the kernel with one
//                        exponent per blk elements of K; see qq_blk below)
//   fused_gemm_epi_pallas (the qq GEMM with its bias / activation epilogue
//                        on each output tile; see gemm_epi below)
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
// its f32 value and rounding bits, or loaded as int8 mantissas (b for qi,
// both sides for ii), packed four int8 to a 32-bit word in shared memory and
// contracted with __dp4a into int32 accumulators.  The blocks of the first N
// tile write the a mantissas, those of the first M tile the b mantissas (the
// residual outputs of the TPU kernel).  y is float(int32) * 2^(sa + sb):
// exactly the plain version's arithmetic, so the two agree bit for bit.
//
// Bounds on the H100.  Each call must move (4+4)*M*K bytes of a and its
// rounding bits (M*K for ii), N*K (qi, ii) or 8*N*K (qq) bytes of b, 4*M*N
// bytes of y and the mantissas it writes, against 2*M*N*K int8 operations
// at 1979 TOP/s: bytes over 3.35 TB/s bound every shape of the serving path,
// the prefill projections (M = 512) and decode (M = batch = 4, where the
// N*K weight read dominates), and the training dW (K = 512 tokens, where
// the 4*M*N f32 output dominates: 545 MB at the tied LM head).  This first
// kernel uses __dp4a, not the tensor cores (wgmma), and no asynchronous
// copies: it is right first; fast is later work.  A 16-row tile variant
// serves M <= 16 so decode wastes at most 4x of the dot products on padding
// rows instead of 16x.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"
#include "fmath.cuh"

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
template <int TM, bool A_FLOAT, bool B_FLOAT, bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS) qgemm_kernel(
    const float* __restrict__ a, const uint32_t* __restrict__ ra,
    const int8_t* __restrict__ ai,
    const float* __restrict__ bf, const uint32_t* __restrict__ rb,
    const int8_t* __restrict__ bi, const int* __restrict__ ea_ptr,
    const int* __restrict__ eb_ptr, float* __restrict__ y,
    int8_t* __restrict__ am_out, int8_t* __restrict__ bm_out,
    int M, int N, int K, int pa, int pb) {
  constexpr int BM = 16 * TM;
  __shared__ int As[BM][LD];
  __shared__ int Bs[BN][LD];
  const size_t z = blockIdx.z;
  if (A_FLOAT) {
    a += z * M * K;
    if (STOCH) ra += z * M * K;
  } else {
    ai += z * M * K;
  }
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
    load_tile<BM, A_FLOAT, STOCH, VEC>(As, a, ra, ai, ea, pa, m0, M, k0, K, am_w);
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

// One launch: the operands of a side that is not float (A_FLOAT / B_FLOAT
// false) come as int8 mantissas (ai / bi) and are not quantized.
struct Args {
  const float* a; const uint32_t* ra; const int8_t* ai;
  const float* bf; const uint32_t* rb; const int8_t* bi;
  const int* ea; const int* eb; float* y; int8_t* am; int8_t* bm;
  int B, M, N, K, pa, pb;
};

template <int TM, bool A_FLOAT, bool B_FLOAT, bool STOCH, bool VEC>
cudaError_t launch(const Args& g, cudaStream_t stream) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + 16 * TM - 1) / (16 * TM), g.B);
  qgemm_kernel<TM, A_FLOAT, B_FLOAT, STOCH, VEC><<<grid, THREADS, 0, stream>>>(
      g.a, g.ra, g.ai, g.bf, g.rb, g.bi, g.ea, g.eb, g.y, g.am, g.bm, g.M,
      g.N, g.K, g.pa, g.pb);
  return cudaGetLastError();
}

template <bool A_FLOAT, bool B_FLOAT, bool STOCH>
cudaError_t dispatch(const Args& g, cudaStream_t stream) {
  const bool vec = g.K % 4 == 0;
  if (g.M <= 16) {
    return vec ? launch<1, A_FLOAT, B_FLOAT, STOCH, true>(g, stream)
               : launch<1, A_FLOAT, B_FLOAT, STOCH, false>(g, stream);
  }
  return vec ? launch<4, A_FLOAT, B_FLOAT, STOCH, true>(g, stream)
             : launch<4, A_FLOAT, B_FLOAT, STOCH, false>(g, stream);
}

// ---------------------------------------------------------------------------
// qq_blk: per-K-block exponents (the MX-style variant, fused_qq_blk_pallas).
//
// Every row of a and b has one biased exponent per blk elements of K (ea
// (B, M, K/blk), eb (B, N, K/blk), computed before the launch as the
// reference computes them outside its kernel).  The block loop walks K one
// exponent block at a time, in order: its a and b tiles are quantized in
// 32-wide slices against their rows' block exponents, contracted with
// __dp4a into an int32 partial (exact: blk x 127^2 < 2^24 for blk <= 1040,
// so its conversion to f32 is exact too), and the partial times
// 2^(sa + sb) (0 below 2^-126) is added to the f32 accumulator, each step
// rounded on its own (__fmul_rn / __fadd_rn: the product is exact, the sum
// rounds once, in block order, as the plain version's does).
//
// Bounds on the H100: the same bytes as qq (f32 + bits of both operands in,
// y out, the mantissas when asked for) plus 4 bytes per row and block of
// exponents, against 2*M*N*K int8 operations: bytes bound every shape of
// the training path.  Each N tile quantizes its a tile again (and each M
// tile its b tile); the grid runs the M tiles of one N tile next to each
// other, so the b tile they share comes from L2.  Quantizing each operand
// once, wgmma and TMA are later work.

constexpr int BLK_TM = 4;                 // rows per thread
constexpr int BLK_BM = 16 * BLK_TM;       // a rows per block

// Quantize elements [k_lo, k_lo + w) of ROWS rows (w <= BK) against each
// row's exponent of block bi into packed words; words past w hold zeros.
template <int ROWS, bool STOCH, bool VEC>
__device__ __forceinline__ void load_blk_tile(
    int (*tile)[LD], const float* __restrict__ x,
    const uint32_t* __restrict__ xr, const int* __restrict__ e, int nb,
    int bi, int p, int row0, int rows, int k_lo, int w, int K,
    int8_t* __restrict__ m_out) {
  for (int t = threadIdx.x; t < ROWS * KW; t += THREADS) {
    const int row = t / KW, off = (t % KW) * 4;
    const int gr = row0 + row;
    uint32_t packed = 0;
    if (gr < rows && off < w) {
      const size_t idx = (size_t)gr * K + k_lo + off;
      const int es = e[(size_t)gr * nb + bi];
      int q[4];
      if (VEC) {                 // K, blk multiples of 4: off + 3 < w
        const float4 v = *reinterpret_cast<const float4*>(x + idx);
        uint4 r = make_uint4(0u, 0u, 0u, 0u);
        if (STOCH) r = *reinterpret_cast<const uint4*>(xr + idx);
        q[0] = quantize_one(v.x, r.x, es, p, STOCH);
        q[1] = quantize_one(v.y, r.y, es, p, STOCH);
        q[2] = quantize_one(v.z, r.z, es, p, STOCH);
        q[3] = quantize_one(v.w, r.w, es, p, STOCH);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = off + j < w ? quantize_one(x[idx + j], STOCH ? xr[idx + j] : 0u,
                                            es, p, STOCH)
                             : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        packed |= ((uint32_t)q[j] & 0xFFu) << (8 * j);
        if (m_out != nullptr && off + j < w) m_out[idx + j] = (int8_t)q[j];
      }
    }
    tile[row][t % KW] = (int)packed;
  }
}

// Grid (M tiles, N tiles, B); 256 threads, each 4 x 4 outputs.
template <bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS) qq_blk_kernel(
    const float* __restrict__ a, const uint32_t* __restrict__ ra,
    const int* __restrict__ ea, const float* __restrict__ b,
    const uint32_t* __restrict__ rb, const int* __restrict__ eb,
    float* __restrict__ y, int8_t* __restrict__ am_out,
    int8_t* __restrict__ bm_out, int M, int N, int K, int blk, int p) {
  __shared__ int As[BLK_BM][LD];
  __shared__ int Bs[BN][LD];
  const int nb = K / blk;
  const size_t z = blockIdx.z;
  a += z * M * K;
  b += z * N * K;
  if (STOCH) {
    ra += z * M * K;
    rb += z * N * K;
  }
  ea += z * M * nb;
  eb += z * N * nb;
  y += z * M * N;
  const int m0 = blockIdx.x * BLK_BM, n0 = blockIdx.y * BN;
  int8_t* am_w = (am_out != nullptr && blockIdx.y == 0) ? am_out + z * M * K : nullptr;
  int8_t* bm_w = (bm_out != nullptr && blockIdx.x == 0) ? bm_out + z * N * K : nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[BLK_TM][4];
#pragma unroll
  for (int i = 0; i < BLK_TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int bi = 0; bi < nb; ++bi) {
    int part[BLK_TM][4];
#pragma unroll
    for (int i = 0; i < BLK_TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0;
    for (int s0 = 0; s0 < blk; s0 += BK) {
      const int k_lo = bi * blk + s0;
      const int w = blk - s0 < BK ? blk - s0 : BK;
      load_blk_tile<BLK_BM, STOCH, VEC>(As, a, ra, ea, nb, bi, p, m0, M, k_lo,
                                        w, K, am_w);
      load_blk_tile<BN, STOCH, VEC>(Bs, b, rb, eb, nb, bi, p, n0, N, k_lo, w,
                                    K, bm_w);
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        int av[BLK_TM], bv[4];
#pragma unroll
        for (int i = 0; i < BLK_TM; ++i) av[i] = As[ty + 16 * i][kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < BLK_TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = __dp4a(av[i], bv[j], part[i][j]);
      }
      __syncthreads();
    }
    int sb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      sb[j] = gn < N ? scale_exp(eb[(size_t)gn * nb + bi], p) : 0;
    }
#pragma unroll
    for (int i = 0; i < BLK_TM; ++i) {
      const int gm = m0 + ty + 16 * i;
      const int sa = gm < M ? scale_exp(ea[(size_t)gm * nb + bi], p) : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(__int2float_rn(part[i][j]),
                                                   pow2f(sa + sb[j])));
    }
  }
#pragma unroll
  for (int i = 0; i < BLK_TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

struct BlkArgs {
  const float* a; const uint32_t* ra; const int* ea;
  const float* b; const uint32_t* rb; const int* eb;
  float* y; int8_t* am; int8_t* bm;
  int B, M, N, K, blk, p;
};

template <bool STOCH>
cudaError_t launch_blk(const BlkArgs& g, cudaStream_t stream) {
  const dim3 grid((g.M + BLK_BM - 1) / BLK_BM, (g.N + BN - 1) / BN, g.B);
  if (g.K % 4 == 0 && g.blk % 4 == 0) {
    qq_blk_kernel<STOCH, true><<<grid, THREADS, 0, stream>>>(
        g.a, g.ra, g.ea, g.b, g.rb, g.eb, g.y, g.am, g.bm, g.M, g.N, g.K,
        g.blk, g.p);
  } else {
    qq_blk_kernel<STOCH, false><<<grid, THREADS, 0, stream>>>(
        g.a, g.ra, g.ea, g.b, g.rb, g.eb, g.y, g.am, g.bm, g.M, g.N, g.K,
        g.blk, g.p);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gemm_epi: the qq GEMM with its f32 epilogue (fused_gemm_epi_pallas).
//
// The qgemm_kernel tiling (64 rows x 64 columns, K in 32-wide slices
// quantized in registers, __dp4a), and in registers on each output tile:
// ylin = float(acc) * 2^(sa + sb), + bias, then the activation: relu, the
// tanh-form GELU, or the SiLU- or GELU-GLU that gates output column j (b
// row j) against b row j + N/2.  For a GLU a block's 64 tile rows of b are
// 32 gate rows and the 32 matching up rows, so thread (tx, ty)'s
// accumulators j = 0, 1 (gate columns tx, tx + 16) pair with j = 2, 3 (the
// same up columns): both halves of one output are in one thread.  It
// writes y, the pre-activation ylin (the backward's residual), and the a
// and b mantissas (the blocks of the first column tile write a's, those of
// the first row tile b's).  Each
// float step is one IEEE operation in the plain version's order, SiLU's
// logistic the Cephes exp of fmath.cuh and GELU's tanh its xla_tanhf, so y
// and ylin equal the plain version's bit for bit.
//
// Bounds on the H100: the qq bytes (f32 + bits of a and b in, both
// mantissas out) plus 4*M*N of ylin and 4*M*N_out of y; at the gate|up
// GEMM of minicpm-2b's training (512 x 2304 -> 11520) the 212 MB of b and
// its bits dominate (starcoder2-7b's, 512 x 4608 -> 36864: 1.36 of 1.66
// GB), against 2*M*N*K int8 operations far below the bytes.  Each of the
// M/64 row tiles quantizes its b tiles again (from L2); quantizing b once,
// wgmma and TMA are later work.

// The act codes are the indices of kernels/fused_linear.py EPI_ACTS.
enum EpiAct {
  EPI_NONE = 0, EPI_RELU = 1, EPI_GELU = 2, EPI_SILU_GLU = 3, EPI_GELU_GLU = 4
};

__host__ __device__ constexpr bool epi_glu(int act) {
  return act == EPI_SILU_GLU || act == EPI_GELU_GLU;
}

template <int ACT, bool STOCH, bool VEC>
__global__ void __launch_bounds__(THREADS) gemm_epi_kernel(
    const float* __restrict__ a, const uint32_t* __restrict__ ra,
    const float* __restrict__ b, const uint32_t* __restrict__ rb,
    const float* __restrict__ bias, const int* __restrict__ ea_ptr,
    const int* __restrict__ eb_ptr, float* __restrict__ y,
    float* __restrict__ ylin, int8_t* __restrict__ am_out,
    int8_t* __restrict__ bm_out, int M, int N, int K, int p) {
  constexpr int TM = 4, BM = 16 * TM, HALF = BN / 2;
  constexpr bool GLU = epi_glu(ACT);
  __shared__ int As[BM][LD];
  __shared__ int Bs[BN][LD];
  const int n_out = GLU ? N / 2 : N;
  const int m0 = blockIdx.y * BM;
  // first b row of the tile (of its gate half for the GLU)
  const int n0 = blockIdx.x * (GLU ? HALF : BN);
  int8_t* am_w = (am_out != nullptr && blockIdx.x == 0) ? am_out : nullptr;
  int8_t* bm_w = (bm_out != nullptr && blockIdx.y == 0) ? bm_out : nullptr;
  const int ea = *ea_ptr, eb = *eb_ptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  int acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<BM, true, STOCH, VEC>(As, a, ra, nullptr, ea, p, m0, M, k0, K, am_w);
    if (GLU) {
      load_tile<HALF, true, STOCH, VEC>(Bs, b, rb, nullptr, eb, p, n0, n_out, k0,
                                        K, bm_w);
      load_tile<HALF, true, STOCH, VEC>(Bs + HALF, b, rb, nullptr, eb, p,
                                        n_out + n0, N, k0, K, bm_w);
    } else {
      load_tile<BN, true, STOCH, VEC>(Bs, b, rb, nullptr, eb, p, n0, N, k0, K, bm_w);
    }
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
  const float scale = pow2f(scale_exp(ea, p) + scale_exp(eb, p));
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    float lin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // b row (= ylin column) of accumulator j
      const int c = tx + 16 * (GLU ? (j & 1) : j);
      const int gn = GLU ? (j < 2 ? n0 + c : n_out + n0 + c) : n0 + c;
      const bool ok = GLU ? n0 + c < n_out : gn < N;
      lin[j] = __fmul_rn(__int2float_rn(acc[i][j]), scale);
      if (bias != nullptr && ok) lin[j] = __fadd_rn(lin[j], bias[gn]);
      if (!ok) continue;
      if (ylin != nullptr) ylin[(size_t)gm * N + gn] = lin[j];
      if (ACT == EPI_NONE) y[(size_t)gm * N + gn] = lin[j];
      if (ACT == EPI_RELU) {
        const float v = lin[j];
        y[(size_t)gm * N + gn] = v > 0.0f ? v : (v != v ? v : 0.0f);
      }
      if (ACT == EPI_GELU) y[(size_t)gm * N + gn] = repro::xla_geluf(lin[j]);
    }
    if (GLU) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int gc = n0 + tx + 16 * j;
        if (gc < n_out)
          y[(size_t)gm * n_out + gc] = ACT == EPI_GELU_GLU
              ? repro::gelu_glu(lin[j], lin[j + 2])
              : repro::silu_glu(lin[j], lin[j + 2]);
      }
    }
  }
}

struct EpiArgs {
  const float* a; const uint32_t* ra; const float* b; const uint32_t* rb;
  const float* bias; const int* ea; const int* eb;
  float* y; float* ylin; int8_t* am; int8_t* bm;
  int M, N, K, p;
};

template <int ACT, bool STOCH>
cudaError_t launch_epi(const EpiArgs& g, cudaStream_t stream) {
  const int cols = epi_glu(ACT) ? g.N / 2 : g.N;
  const int tile = epi_glu(ACT) ? BN / 2 : BN;
  const dim3 grid((cols + tile - 1) / tile, (g.M + 63) / 64, 1);
  if (g.K % 4 == 0) {
    gemm_epi_kernel<ACT, STOCH, true><<<grid, THREADS, 0, stream>>>(
        g.a, g.ra, g.b, g.rb, g.bias, g.ea, g.eb, g.y, g.ylin, g.am, g.bm,
        g.M, g.N, g.K, g.p);
  } else {
    gemm_epi_kernel<ACT, STOCH, false><<<grid, THREADS, 0, stream>>>(
        g.a, g.ra, g.b, g.rb, g.bias, g.ea, g.eb, g.y, g.ylin, g.am, g.bm,
        g.M, g.N, g.K, g.p);
  }
  return cudaGetLastError();
}

template <bool STOCH>
cudaError_t dispatch_epi(const EpiArgs& g, int act, cudaStream_t stream) {
  if (act == EPI_RELU) return launch_epi<EPI_RELU, STOCH>(g, stream);
  if (act == EPI_SILU_GLU) return launch_epi<EPI_SILU_GLU, STOCH>(g, stream);
  if (act == EPI_GELU) return launch_epi<EPI_GELU, STOCH>(g, stream);
  if (act == EPI_GELU_GLU) return launch_epi<EPI_GELU_GLU, STOCH>(g, stream);
  return launch_epi<EPI_NONE, STOCH>(g, stream);
}

}  // namespace

extern "C" {

// qq: a (B,M,K) f32 [+ ra], b (B,N,K) f32 [+ rb] -> y (B,M,N), am, bm int8.
// ra/rb are null when stochastic == 0 (half-up rounding).
int repro_fused_qq(const void* a, const void* ra, const void* b, const void* rb,
                   const void* ea, const void* eb, void* y, void* am, void* bm,
                   int B, int M, int N, int K, int p, int stochastic,
                   void* stream) {
  const Args g{static_cast<const float*>(a), static_cast<const uint32_t*>(ra),
               nullptr, static_cast<const float*>(b),
               static_cast<const uint32_t*>(rb), nullptr,
               static_cast<const int*>(ea), static_cast<const int*>(eb),
               static_cast<float*>(y), static_cast<int8_t*>(am),
               static_cast<int8_t*>(bm), B, M, N, K, p, p};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(stochastic ? dispatch<true, true, true>(g, s)
                          : dispatch<true, true, false>(g, s));
}

// qi: a (B,M,K) f32 [+ ra], b_m (B,N,K) int8 -> y (B,M,N), am int8.
int repro_fused_qi(const void* a, const void* ra, const void* b_m,
                   const void* ea, const void* eb, void* y, void* am, int B,
                   int M, int N, int K, int pa, int pb, int stochastic,
                   void* stream) {
  const Args g{static_cast<const float*>(a), static_cast<const uint32_t*>(ra),
               nullptr, nullptr, nullptr, static_cast<const int8_t*>(b_m),
               static_cast<const int*>(ea), static_cast<const int*>(eb),
               static_cast<float*>(y), static_cast<int8_t*>(am), nullptr, B,
               M, N, K, pa, pb};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(stochastic ? dispatch<true, false, true>(g, s)
                          : dispatch<true, false, false>(g, s));
}

// ii: a_m (B,M,K) int8, b_m (B,N,K) int8 -> y (B,M,N) f32.
int repro_fused_ii(const void* a_m, const void* b_m, const void* ea,
                   const void* eb, void* y, int B, int M, int N, int K,
                   int pa, int pb, void* stream) {
  const Args g{nullptr, nullptr, static_cast<const int8_t*>(a_m), nullptr,
               nullptr, static_cast<const int8_t*>(b_m),
               static_cast<const int*>(ea), static_cast<const int*>(eb),
               static_cast<float*>(y), nullptr, nullptr, B, M, N, K, pa, pb};
  return (int)dispatch<false, false, false>(g, static_cast<cudaStream_t>(stream));
}

// qq_blk: a (B,M,K) f32 [+ ra], ea (B,M,K/blk) int32, b (B,N,K) f32 [+ rb],
// eb (B,N,K/blk) int32 -> y (B,M,N) f32 [+ am, bm int8 when not null].
int repro_fused_qq_blk(const void* a, const void* ra, const void* ea,
                       const void* b, const void* rb, const void* eb, void* y,
                       void* am, void* bm, int B, int M, int N, int K, int blk,
                       int p, int stochastic, void* stream) {
  const BlkArgs g{static_cast<const float*>(a), static_cast<const uint32_t*>(ra),
                  static_cast<const int*>(ea), static_cast<const float*>(b),
                  static_cast<const uint32_t*>(rb), static_cast<const int*>(eb),
                  static_cast<float*>(y), static_cast<int8_t*>(am),
                  static_cast<int8_t*>(bm), B, M, N, K, blk, p};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(stochastic ? launch_blk<true>(g, s) : launch_blk<false>(g, s));
}

// gemm_epi: a (M,K) f32 [+ ra], b (N,K) f32 [+ rb], bias (N) f32 or null ->
// y (M, N or N/2) f32, ylin (M,N) f32 (null when act == 0), am, bm int8.
// act: 0 none, 1 relu, 2 gelu, 3 silu_glu, 4 gelu_glu.
int repro_gemm_epi(const void* a, const void* ra, const void* b, const void* rb,
                   const void* bias, const void* ea, const void* eb, void* y,
                   void* ylin, void* am, void* bm, int M, int N, int K, int p,
                   int act, int stochastic, void* stream) {
  const EpiArgs g{static_cast<const float*>(a), static_cast<const uint32_t*>(ra),
                  static_cast<const float*>(b), static_cast<const uint32_t*>(rb),
                  static_cast<const float*>(bias), static_cast<const int*>(ea),
                  static_cast<const int*>(eb), static_cast<float*>(y),
                  static_cast<float*>(ylin), static_cast<int8_t*>(am),
                  static_cast<int8_t*>(bm), M, N, K, p};
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(stochastic ? dispatch_epi<true>(g, act, s)
                          : dispatch_epi<false>(g, act, s));
}

}  // extern "C"
