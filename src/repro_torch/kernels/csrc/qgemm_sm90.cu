// The qq, qi, ii, qq_blk, int8_matmul, gemm_epi and norm_gemm GEMMs
// redesigned for Hopper (sm_90a): int8 tensor cores fed by TMA through a
// ring of shared-memory stages.
//
// Replaces, beside the __dp4a kernels of fused_linear.cu and fused_chain.cu
// and the wmma kernel of int8_matmul.cu (which keep the shapes this file
// does not take), the TPU kernels
//   fused_qq_pt_pallas  (both operands f32, quantized: every forward
//                        projection, QK^T and PV of training and prefill)
//   fused_qi_pt_pallas  (a f32 quantized, b pre-quantized int8: every
//                        projection and LM head of serving, the backward's dX)
//   fused_ii_pt_pallas  (both operands int8 mantissas: the backward's dW)
//   fused_qq_blk_pallas (both operands f32, one exponent per row and blk
//                        elements of K: every int8_block contraction)
//   fused_gemm_epi_pallas (kinds qq / qi / ii with the bias, relu, GELU or
//                        SiLU- / GELU-GLU epilogue and the per-tensor
//                        out-quantize: the gate|up GEMM of fused_proj)
// of src/repro/kernels/fused_linear.py, int8_matmul_pallas of
// src/repro/kernels/int8_matmul.py (both operands int8, one f32 scale: the
// unfused rung), and the GEMM half of fused_norm_gemm_pallas of
// src/repro/kernels/fused_chain.py (xq against the weight, one exponent per
// row and one per column; fused_chain.cu's norm pass writes xq first).
// Layout: a (B, M, K) x b (B, N, K), both contraction-last (K-major, the
// only layout wgmma takes for 8-bit types) -> y (B, M, N) f32.  The shared
// exponents are per tensor, device scalars; rounding bits come in as uint32.
//
// Exactness.  Mantissas lie in [-127, 127], dispatch plans qq / qi / ii
// only for K <= 65536 and int8_matmul's wrapper takes only K * 127^2 <
// 2^31, so every int32 partial sum is exact in any order; no .satfinite.
// Nothing here bounds K further: K is a tensor-map extent (64 bits) and a
// count of 128-byte chunks; every offset into an operand is 64-bit.  The
// epilogue is float(acc) * s (__int2float_rn, __fmul_rn), s = 2^(sa + sb)
// from the exponents or int8_matmul's scalar, read once per block (a
// template parameter, not a branch in the loop); the quantizer is
// repro::quantize_one: y and the mantissas equal the plain versions bit
// for bit.
//
// Variants, chosen by the wrappers from the shapes alone
// (kernels/fused_linear.py qgemm_variant / qq_variant / qq_blk_variant /
// gemm_epi_variant, kernels/int8_matmul.py int8_matmul_variant,
// kernels/fused_chain.py norm_gemm_variant): K % 16 == 0 (TMA's 16-byte
// row stride) and 16-byte aligned operands, else the __dp4a kernel of
// fused_linear.cu (qq, qi, ii, qq_blk, gemm_epi) or fused_chain.cu
// (norm_gemm), or the wmma kernel of int8_matmul.cu.
//
// wgmma (M > 16).  A persistent grid, one block per SM, walks 128 x 128
// output tiles, M fastest (the blocks at work at one time share b tiles in
// L2).  One producer warp keeps TMA loads of 128 x 128-byte a and b tiles
// (128-byte swizzle) in flight through a ring of 4 stages with mbarrier
// completion; two consumer warpgroups each run wgmma.m64n128k32.s32.s8.s8
// on 64 of the tile's rows with int32 accumulators in registers, one
// commit group a stage, releasing a stage once the next one's group is
// issued.  The epilogue stages the tile through padded shared memory and
// writes y with 16-byte coalesced stores (4-byte ones where N % 4 != 0,
// whose rows are not 16-byte aligned); while it runs, the producer already
// loads the next tile.  TMA zero-fills reads past M, N and K; the epilogue
// writes nothing past M x N.
//
// Quantize once.  qi and qq quantize each f32 operand once per call: one
// pass (one more launch, counted with the call) reads the operand and its
// bits once and writes the mantissas, which qi and qq return anyway as
// residuals (qq without residuals writes them to scratch); the GEMM then
// reads them as int8.  qq's pass takes both operands in one launch, a's
// groups of 16 first, then b's.  Quantizing inside the GEMM instead would
// repeat it for every tile (the __dp4a kernel's 76 passes over a at N =
// 4864, 4 over b at M = 512) or hold a strip of rows in shared memory
// beside the ring.
//
// qq_blk (the block mode of the wgmma kernel; M > 16, blk % 32 == 0 and
// blk dividing the 128-byte stage or a multiple of it).  A per-block pass
// quantizes a, then b, once, each element against its row's exponent of
// its block (repro::quantize_one), and writes each row's scale column once,
// transposed ((B, K/blk, rows rounded up to 128)).  The GEMM's producer
// copies the stage's block columns beside its a and b tiles (1-D bulk
// copies on the same mbarrier).  A consumer warpgroup issues a block's k32
// steps (the first without accumulating), waits for the group and promotes
// it: acc = acc + float(d) * 2^(sa + sb), each step rounded on its own in
// block order from a zero start, never split -- blk_combine's order
// exactly, so K is never split across blocks of the grid either.  Two
// tilings: 128 x 128 (two consumer warpgroups, the one waiting while the
// other's wgmmas run) where they make 132 tiles or more; else 64 x 64, one
// warpgroup with two int32 accumulators at blocks of 128, so stage kc's
// wgmmas run while stage kc - 1 is promoted (the LM head's dX: N 896 gives
// 28 tiles of 128 x 128, 112 of 64 x 64).  The 128 x 128 tiling holds one
// accumulator: 9 warps a block leave 168 registers a thread (3 warps on one
// SM sub-partition), too few for a second 64.
//
// stream (M <= 16: decode, batch 4).  Bandwidth-bound on b (the LM head's
// 136 MB).  Each block quantizes (qi, qq) or loads (ii, int8_matmul) the
// few a rows into shared memory itself, with no extra launch, then streams
// its slab of 64-row b tiles through a ring of 12 TMA stages (96 KB in
// flight a block) and contracts with mma.sync.m16n8k32.s32.s8.s8 (a rows
// past M zero in registers).  Only the first block of each batch slice
// writes the a mantissas.  qq quantizes b in its own pass first.
//
// gemm_epi (the act mode of the wgmma kernel, a template parameter: bias,
// relu, GELU, SiLU-GLU or GELU-GLU).  The kind's pass quantizes a and b
// (qq, one launch), a (qi) or nothing (ii); the epilogue then computes, on
// the fragment, ylin = float(acc) * 2^(sa + sb) + bias and the act, each
// float step one IEEE operation in the plain version's order (fmath.cuh's
// Cephes logistic and XLA's tanh), and writes ylin (the backward's
// residual) and y through the padded shared tile.  For a GLU a 128-row b
// stage holds the gate rows [j0, j0 + 64) and the matching up rows [N/2 +
// j0, N/2 + j0 + 64): two TMA boxes through two tensor maps over b, one a
// half, each N/2 rows long, so TMA zero-fills past each half (an odd N/2
// never reads the other half's rows) and fragment column c (gate) pairs
// with column c + 64 (up) in the same thread's registers.  The per-tensor
// out-quantize (out_q, rows below m_true) takes two launches, as the
// reference's two-phase grid: the epilogue writes y to f32 scratch and
// folds the largest effective exponent of its rows below m_true into one
// device word (atomicMax); a one-segment pass then quantizes y against
// that word and writes the (1, 128) meta row.  The largest eff_exp of the
// elements equals eff_exp of the largest |y|: eff_exp is the exponent field
// of |y| clamped at 1, and the bit patterns of non-negative floats (inf and
// NaN, at the top, included) order as their values.
//
// norm_gemm (the row-column mode): the same GEMM of xq against the weight,
// y = float(acc) * 2^(se_row[i] + se_w[j]) (pow2f, clamped and flushed as
// the plain version's pow2_f32), the row exponents read from the meta rows
// fused_chain.cu's norm pass wrote; the weight is read once per M tile from
// L2 instead of once per 64-row strip.
//
// Bounds on the H100 (bytes over 3.35 TB/s against 2*M*N*K int8 operations
// at 1979 TOP/s): bytes for every shape of the main path; y's 4*M*N bytes
// for the training dW (545 MB at the tied LM head), b's N*K for decode, the
// f32 values and bits of b (8*N*K) for qq's and qq_blk's LM head and for
// gemm_epi's gate|up (212 MB of b's 249 at minicpm-2b).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bfp.cuh"
#include "fmath.cuh"
#include "sm90.cuh"

namespace {

using repro::align1024;
using repro::bulk_load;
using repro::eff_exp;
using repro::fence_operands;
using repro::gmma_desc;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_fence_init;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_s8_m16n8k32;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;
using repro::smem_u32;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_s8;
using repro::wgmma_wait0;
using repro::wgmma_wait1;

// ---------------------------------------------------------------------------
// PTX helpers: TMA (mbarriers, bulk copies, mma.sync, wgmma: sm90.cuh)
// ---------------------------------------------------------------------------

// One 3-D box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four consecutive f32 values and their bits -> four int8 mantissas packed
// little-endian in one word.
template <bool STOCH>
__device__ __forceinline__ uint32_t quantize4(const float* __restrict__ x,
                                              const uint32_t* __restrict__ r,
                                              size_t idx, int e, int p) {
  const float4 v = *reinterpret_cast<const float4*>(x + idx);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if (STOCH) u = *reinterpret_cast<const uint4*>(r + idx);
  return ((uint32_t)quantize_one(v.x, u.x, e, p, STOCH) & 0xFFu) |
         (((uint32_t)quantize_one(v.y, u.y, e, p, STOCH) & 0xFFu) << 8) |
         (((uint32_t)quantize_one(v.z, u.z, e, p, STOCH) & 0xFFu) << 16) |
         (((uint32_t)quantize_one(v.w, u.w, e, p, STOCH) & 0xFFu) << 24);
}

// ---------------------------------------------------------------------------
// The quantize pass: one or two f32 tensors [+ bits] -> int8 mantissas
// ---------------------------------------------------------------------------

// One tensor of the pass: n4 groups of 4 elements of x (and bits r),
// quantized against the exponent *e into m, then `tail` (< 4) more
// elements one by one.
struct QSeg {
  const float* x;
  const uint32_t* r;
  const int* e;
  int8_t* m;
  size_t n4;
  int tail = 0;
};

// qi quantizes a (s1 empty); qq quantizes a and b in the same launch, the
// groups of s0 first, then those of s1.  Four elements a thread and step,
// as bfp_quantize: more threads in flight than wider steps would leave.
// gemm_epi's out-quantize passes its y (s0, with a tail) and gets its
// exponent written to the 128 words of meta.
template <bool STOCH>
__global__ void __launch_bounds__(256) quantize_pass_kernel(QSeg s0, QSeg s1, int p,
                                                            int* meta) {
  const int e0 = *s0.e, e1 = s1.n4 ? *s1.e : 0;
  const size_t total = s0.n4 + s1.n4;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const bool first = i < s0.n4;
    const size_t j = first ? i : i - s0.n4;
    const uint32_t w = quantize4<STOCH>(first ? s0.x : s1.x, first ? s0.r : s1.r,
                                        j * 4, first ? e0 : e1, p);
    reinterpret_cast<uint32_t*>(first ? s0.m : s1.m)[j] = w;
  }
  if (blockIdx.x == 0) {
    if ((int)threadIdx.x < s0.tail) {
      const size_t k = s0.n4 * 4 + threadIdx.x;
      s0.m[k] = (int8_t)quantize_one(s0.x[k], STOCH ? s0.r[k] : 0u, e0, p, STOCH);
    }
    if (meta != nullptr && threadIdx.x < 128) meta[threadIdx.x] = e0;
  }
}

// The per-block pass of qq_blk: a's and b's rows [+ bits] -> int8
// mantissas, each element against its row's exponent of its block of K.
// One segment per operand: rows = B * (M or N) rows of K elements, e (rows,
// K/blk) biased exponents; each row's exponent of each block is also
// written once, transposed and with the scale-exponent offset added, as the
// GEMM's block scale columns: st[(z * nb + bi) * st_ld + row] = e + st_add.
struct QBlkSeg {
  const float* x;
  const uint32_t* r;
  const int* e;
  int8_t* m;
  int* st;
  int st_ld, st_add, rows_per_z, rows;
};

// A grid-stride walk over the groups of 4 of both segments' rows, as the
// per-tensor pass; each thread steps its (row, group) by the stride's
// quotient and remainder, so no 64-bit division is left in the loop.
template <bool STOCH>
__global__ void __launch_bounds__(256) quantize_blk_pass_kernel(QBlkSeg s0, QBlkSeg s1,
                                                                int K, int blk, int p) {
  const int g4 = K / 4, nb = K / blk;
  const size_t total = (size_t)(s0.rows + s1.rows) * g4;
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const int drow = (int)(stride / g4), dg = (int)(stride % g4);
  int row = (int)(i0 / g4), g = (int)(i0 % g4);
  for (size_t i = i0; i < total; i += stride) {
    const bool first = row < s0.rows;
    const QBlkSeg s = first ? s0 : s1;
    const int rr = first ? row : row - s0.rows;
    const int k = g * 4, bi = k / blk;
    const int e = s.e[(size_t)rr * nb + bi];
    const size_t idx = (size_t)rr * K + k;
    reinterpret_cast<uint32_t*>(s.m)[idx / 4] = quantize4<STOCH>(s.x, s.r, idx, e, p);
    if (k % blk == 0) {
      const int z = rr / s.rows_per_z, ri = rr % s.rows_per_z;
      s.st[((size_t)z * nb + bi) * s.st_ld + ri] = e + s.st_add;
    }
    row += drow;
    g += dg;
    if (g >= g4) {
      g -= g4;
      ++row;
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: persistent warp-specialised tensor-core GEMM, int8 x int8 -> f32
// ---------------------------------------------------------------------------

// What the epilogue scales by: the two shared exponents (qq, qi, ii), one
// given scalar (int8_matmul), a scale per row and block of K (qq_blk: each
// block's exact int32 partial promoted into a float32 accumulator), the
// two shared exponents followed by bias and act (gemm_epi), or one
// exponent per row and one per column (norm_gemm).
constexpr int EPI_EXP = 0, EPI_SCALAR = 1, EPI_BLOCK = 2, EPI_ACT = 3, EPI_ROWCOL = 4;

// gemm_epi's acts, the indices of kernels/fused_linear.py EPI_ACTS.
constexpr int ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU_GLU = 3, ACT_GELU_GLU = 4;

__host__ __device__ constexpr bool act_glu(int act) {
  return act == ACT_SILU_GLU || act == ACT_GELU_GLU;
}

// The epilogue's operands beyond y: gemm_epi's bias (N), ylin (M, N) and
// out-quantize exponent word (rows below m_true folded in), or null;
// norm_gemm's row exponents (row i at se_row[i * se_row_ld]) and column
// exponents (N).
struct EpiOut {
  const float* bias = nullptr;
  float* ylin = nullptr;
  int* emax = nullptr;
  int m_true = 0;
  const int* se_row = nullptr;
  int se_row_ld = 0;
  const int* se_col = nullptr;
};

// The float32 scale of the per-tensor epilogues, read once per block.
template <int EPI>
__device__ __forceinline__ float epi_scale(const int* ea, const int* eb,
                                           const float* scale, int pa, int pb) {
  if (EPI == EPI_SCALAR) return *scale;
  if (EPI == EPI_BLOCK || EPI == EPI_ROWCOL) return 0.0f;
  return pow2f(scale_exp(*ea, pa) + scale_exp(*eb, pb));
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A warpgroup's 64 x W fragment values (v[4 j + 2 h + e] at row r0 + 8 h,
// column 8 j + c0 + e) into its padded shared tile.
template <int W, int LD, int NF>
__device__ __forceinline__ void stage_tile(float* tile, const float (&v)[NF], int r0, int c0) {
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * LD + j * 8 + c0) =
          make_float2(v[i], v[i + 1]);
    }
}

// The staged 64 rows of W columns into dst (row stride ld), 16 bytes a
// store where vec (ld and every first column multiples of 4), else 4.
// Tile column c is logical column q0 + c, stored at that global column
// when below lim; with `split` (a GLU's ylin) the tile's right half is the
// up half, logical column q0 + c - W/2 at global column half + that.  fold
// (gemm_epi's out-quantize): the largest effective exponent of the stored
// values of rows below m_true goes into *fold.
template <int W, int LD>
__device__ __forceinline__ void store_tile(const float* tile, float* dst, size_t ld, int m_base,
                                           int M, int q0, int lim, int half, bool split,
                                           bool vec, int* fold, int m_true) {
  const int tid = threadIdx.x % 128, hw = split ? W / 2 : W;
  int e = 1;
  if (vec) {
    for (int i = tid; i < 64 * (W / 4); i += 128) {
      const int row = i / (W / 4), c4 = (i % (W / 4)) * 4;
      const int gm = m_base + row, q = q0 + (c4 < hw ? c4 : c4 - hw);
      if (gm < M && q < lim) {
        const float4 x = *reinterpret_cast<const float4*>(tile + row * LD + c4);
        *reinterpret_cast<float4*>(dst + (size_t)gm * ld + (c4 < hw ? q : half + q)) = x;
        if (gm < m_true)
          e = max(e, max(max(eff_exp(x.x), eff_exp(x.y)), max(eff_exp(x.z), eff_exp(x.w))));
      }
    }
  } else {
    for (int i = tid; i < 64 * W; i += 128) {
      const int row = i / W, c = i % W;
      const int gm = m_base + row, q = q0 + (c < hw ? c : c - hw);
      if (gm < M && q < lim) {
        const float x = tile[row * LD + c];
        dst[(size_t)gm * ld + (c < hw ? q : half + q)] = x;
        if (gm < m_true) e = max(e, eff_exp(x));
      }
    }
  }
  if (fold != nullptr) {
    e = warp_max_i(e);
    if ((threadIdx.x & 31) == 0) atomicMax(fold, e);
  }
}

// Tiles of WGS * 64 rows of a and BN rows of b, 128 bytes of K a stage; in
// the block mode each stage also carries the scale columns of up to four
// blocks (blk = 32: four blocks a stage).
template <int EPI, int WGS, int BN>
struct Tc {
  static constexpr int BM = 64 * WGS, BK = 128, THREADS = 128 * WGS + 32;
  static constexpr int STAGES = WGS == 2 ? 4 : 6;
  static constexpr int TILE_A = BM * BK, TILE_B = BN * BK;  // bytes
  static constexpr int EXP_SLOT = (BM + BN) * 4;            // one block's columns
  static constexpr int STAGE = TILE_A + TILE_B + (EPI == EPI_BLOCK ? 4 * EXP_SLOT : 0);
  static constexpr int OUT_LD = BN + 8;                     // floats: no bank conflict
  static constexpr int OUT = 64 * OUT_LD * 4;               // bytes per consumer warpgroup
  static constexpr int SMEM = 1024 + STAGES * STAGE + WGS * OUT + 2 * STAGES * 8;
  static_assert(STAGE % 1024 == 0, "stages keep the 128-byte swizzle's alignment");
};

// Block mode: acc += float(d) * 2^(sa + sb) for each element of the
// fragment, then d is free for the next block.  ex holds the block's
// columns: sa + 127 for the tile's BM rows, then sb for its BN columns, so
// e = sa + sb + 127 and 2^(sa + sb) has the bits clamp(e, 0, 254) << 23:
// 0 below 2^-126 and at most 2^127, as pow2f.  float(d) is exact either
// way; below 2^22 (blk <= 256) as the difference of two floats, cheaper
// than the conversion unit.
template <int BN, bool SMALL>
__device__ __forceinline__ void promote_as(float (&acc)[BN / 2], const int (&d)[BN / 2],
                                           const int* ex, int BM, int row0, int c0) {
  const int* eb = ex + BM;
  const int ar[2] = {ex[row0], ex[row0 + 8]};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int2 bc = *reinterpret_cast<const int2*>(eb + j * 8 + c0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        int x = (int)((unsigned)ar[h] + (unsigned)(e ? bc.y : bc.x));
        x = min(max(x, 0), 254);
        const float f = SMALL ? __fsub_rn(__int_as_float(d[i] + 0x4B400000), 12582912.0f)
                              : __int2float_rn(d[i]);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(f, __int_as_float(x << 23)));
      }
  }
}

template <int BN>
__device__ __forceinline__ void promote(float (&acc)[BN / 2], const int (&d)[BN / 2],
                                        const int* ex, int BM, int row0, int c0,
                                        bool small) {
  if (small)
    promote_as<BN, true>(acc, d, ex, BM, row0, c0);
  else
    promote_as<BN, false>(acc, d, ex, BM, row0, c0);
}

// One step of the double-buffered block loop (one warpgroup, blk = 128):
// issue stage kc's four k32 steps into cur (when kc < kc_n), then wait for
// stage kc - 1's group (in prv), promote it with its scale columns and
// release its stage.  stage / phase name the ring slot of kc, pstage that
// of kc - 1.
template <int BN, int BM, int BK, int STAGES>
__device__ __forceinline__ void blk_step(int kc, int kc_n, int (&cur)[BN / 2],
                                         int (&prv)[BN / 2], float (&acc)[BN / 2],
                                         uint8_t* ring, uint64_t* full, uint64_t* empty,
                                         int& stage, uint32_t& phase, int& pstage,
                                         int stage_bytes, int tile_a, int tile_b, int r0,
                                         int c0, bool small) {
  const int tid = threadIdx.x % 128;
  if (kc < kc_n) {
    mbar_wait(&full[stage], phase);
    const uint8_t* st = ring + stage * stage_bytes;
    const uint32_t a_s = smem_u32(st), b_s = smem_u32(st + tile_a);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)
      wgmma_s8<BN>(cur, gmma_desc(a_s + ks * 32), gmma_desc(b_s + ks * 32), ks != 0);
    wgmma_commit();
  }
  if (kc >= 1 && kc <= kc_n) {
    if (kc < kc_n)
      wgmma_wait1();
    else
      wgmma_wait0();
    fence_operands(prv);
    const int* ex = reinterpret_cast<const int*>(ring + pstage * stage_bytes + tile_a + tile_b);
    promote<BN>(acc, prv, ex, BM, r0, c0, small);
    if (tid == 0) mbar_arrive(&empty[pstage]);
  }
  if (kc < kc_n) {
    pstage = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// ACT: gemm_epi's act (EPI_ACT); with a GLU, b's tiles come from two maps,
// tb over its gate half and tb2 over its up half, BN / 2 rows a box each.
template <int EPI, int WGS, int BN, int ACT = ACT_NONE>
__global__ void __launch_bounds__(Tc<EPI, WGS, BN>::THREADS, 1) tc_gemm_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tb2, const int* __restrict__ ea_ptr,
    const int* __restrict__ eb_ptr, const float* __restrict__ scale_ptr,
    const int* __restrict__ sa_t, const int* __restrict__ sb_t, float* __restrict__ y,
    int M, int N, int K, int B, int pa, int pb, int blk, int lda_t, int ldb_t,
    const EpiOut eo) {
  using T = Tc<EPI, WGS, BN>;
  constexpr int BM = T::BM, BK = T::BK, STAGES = T::STAGES, NF = BN / 2;
  constexpr bool GLU = EPI == EPI_ACT && act_glu(ACT);
  // b rows a tile step over, and the rows they step in (a GLU: one half)
  constexpr int BNT = GLU ? BN / 2 : BN;
  const int nrows = GLU ? N / 2 : N;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  float* out = reinterpret_cast<float*>(ring + STAGES * T::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE + WGS * T::OUT);
  uint64_t* empty = full + STAGES;
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (nrows + BNT - 1) / BNT;
  const int total = m_tiles * n_tiles * B, kc_n = (K + BK - 1) / BK;
  // block mode: blocks of K, k32 steps a block, blocks a stage (blk < 128)
  const bool block_mode = EPI == EPI_BLOCK;
  const int nb = block_mode ? K / blk : 0, spb = block_mode ? blk / 32 : 1;
  const int bps = block_mode && blk < BK ? BK / blk : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WGS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const int mt = t % m_tiles, rest = t / m_tiles;
        const int nt = rest % n_tiles, z = rest / n_tiles;
        for (int kc = 0; kc < kc_n; ++kc) {
          // the blocks whose scale columns ride with this stage
          int b0 = 0, nbk = 0;
          if (EPI == EPI_BLOCK) {
            b0 = blk < BK ? kc * bps : kc * BK / blk;
            nbk = blk < BK ? min(bps, nb - b0) : 1;
          }
          mbar_wait(&empty[stage], phase ^ 1u);
          mbar_expect_tx(&full[stage], T::TILE_A + T::TILE_B + nbk * T::EXP_SLOT);
          uint8_t* st = ring + stage * T::STAGE;
          tma_load_3d(st, &ta, &full[stage], kc * BK, mt * BM, z);
          tma_load_3d(st + T::TILE_A, &tb, &full[stage], kc * BK, nt * BNT, z);
          if (GLU)  // the up rows of the same columns (1024-byte aligned)
            tma_load_3d(st + T::TILE_A + BNT * BK, &tb2, &full[stage], kc * BK, nt * BNT, z);
          for (int j = 0; j < nbk; ++j) {
            const size_t col = (size_t)z * nb + b0 + j;
            uint8_t* ex = st + T::TILE_A + T::TILE_B + j * T::EXP_SLOT;
            bulk_load(ex, sa_t + col * lda_t + mt * BM, BM * 4, &full[stage]);
            bulk_load(ex + BM * 4, sb_t + col * ldb_t + nt * BN, BN * 4, &full[stage]);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = warp / 4, tid = threadIdx.x % 128;
  const float scale = epi_scale<EPI>(ea_ptr, eb_ptr, scale_ptr, pa, pb);
  const int r0 = (warp % 4) * 16 + lane / 4, c0 = (lane % 4) * 2;
  const bool small = blk <= 256;
  const int steps = K / 32;  // block mode: K is a multiple of blk, so of 32
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int mt = t % m_tiles, rest = t / m_tiles;
    const int nt = rest % n_tiles, z = rest / n_tiles;
    int d[NF];
    float acc[NF];
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      d[i] = 0;
      acc[i] = 0.0f;
    }
    if (EPI == EPI_BLOCK && WGS == 1 && blk == BK) {
      // One block a stage, one warpgroup: two int32 accumulators, so that
      // the tensor cores take stage kc while stage kc - 1's block is
      // promoted (still in block order); the loop is unrolled by two to
      // keep the accumulators in registers.
      if constexpr (EPI == EPI_BLOCK && WGS == 1) {
        int d2[NF];
#pragma unroll
        for (int i = 0; i < NF; ++i) d2[i] = 0;
        int pstage = 0;
        for (int kc = 0; kc <= kc_n; kc += 2) {
          blk_step<BN, BM, BK, STAGES>(kc, kc_n, d, d2, acc, ring, full, empty, stage, phase,
                                       pstage, T::STAGE, T::TILE_A, T::TILE_B, r0, c0, small);
          blk_step<BN, BM, BK, STAGES>(kc + 1, kc_n, d2, d, acc, ring, full, empty, stage,
                                       phase, pstage, T::STAGE, T::TILE_A, T::TILE_B, r0, c0,
                                       small);
        }
      }
    } else if (EPI == EPI_BLOCK) {
      // Each block from a zero start (the first k32 step of a block does not
      // accumulate), waited for, promoted in block order: never split.
      int in_blk = 0;  // k32 step within the block
      for (int kc = 0; kc < kc_n; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint8_t* st = ring + stage * T::STAGE;
        const uint32_t a_s = smem_u32(st + wg * 64 * BK);
        const uint32_t b_s = smem_u32(st + T::TILE_A);
        const int* ex = reinterpret_cast<const int*>(st + T::TILE_A + T::TILE_B);
        int j = 0;  // the stage's block (blk < 128: several)
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks) {
          if (kc * (BK / 32) + ks < steps) {
            if (in_blk == 0) wgmma_fence();
            wgmma_s8<BN>(d, gmma_desc(a_s + ks * 32), gmma_desc(b_s + ks * 32),
                         in_blk != 0);
            if (++in_blk == spb) {
              in_blk = 0;
              wgmma_commit();
              wgmma_wait0();
              fence_operands(d);
              promote<BN>(acc, d, ex + j * (BM + BN), BM, wg * 64 + r0, c0, small);
              if (blk < BK) ++j;
            }
          }
        }
        wgmma_commit();
        wgmma_wait0();
        if (tid == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    } else {
      // One commit group a stage; a stage is released once the next one's
      // group is issued, so the tensor cores work while the next stage lands.
      int prev = -1;
      for (int kc = 0; kc < kc_n; ++kc) {
        mbar_wait(&full[stage], phase);
        const uint32_t a_s = smem_u32(ring + stage * T::STAGE + wg * 64 * BK);
        const uint32_t b_s = smem_u32(ring + stage * T::STAGE + T::TILE_A);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          wgmma_s8<BN>(d, gmma_desc(a_s + ks * 32), gmma_desc(b_s + ks * 32), 1);
        wgmma_commit();
        wgmma_wait1();
        if (prev >= 0 && tid == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait0();
      fence_operands(d);
      if (tid == 0) mbar_arrive(&empty[prev]);
    }
    // epilogue: fragment -> padded shared tile -> coalesced rows of y
    const int m_base = mt * BM + wg * 64;
    float* my_out = out + wg * 64 * T::OUT_LD;
    float v[NF];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e, c = j * 8 + c0 + e;
          if (EPI == EPI_BLOCK) {
            v[i] = acc[i];
          } else if (EPI == EPI_ROWCOL) {
            const int gm = m_base + r0 + 8 * h, gn = nt * BN + c;
            v[i] = gm < M && gn < N
                       ? __fmul_rn(__int2float_rn(d[i]),
                                   pow2f(eo.se_row[(size_t)gm * eo.se_row_ld] + eo.se_col[gn]))
                       : 0.0f;
          } else {
            v[i] = __fmul_rn(__int2float_rn(d[i]), scale);
            if (EPI == EPI_ACT && eo.bias != nullptr) {
              // the b row (ylin column) of fragment column c
              const int q = nt * BNT + (GLU ? c % BNT : c);
              if (q < nrows) v[i] = __fadd_rn(v[i], eo.bias[GLU && c >= BNT ? nrows + q : q]);
            }
          }
        }
    // y's columns: a GLU's are the gate half's
    int ny = N, q0 = nt * BN;
    if constexpr (EPI == EPI_ACT) {
      if (eo.ylin != nullptr) {  // the pre-activation, the backward's residual
        named_sync(1 + wg, 128);  // the previous readers of the tile are done
        stage_tile<BN, T::OUT_LD>(my_out, v, r0, c0);
        named_sync(1 + wg, 128);
        store_tile<BN, T::OUT_LD>(my_out, eo.ylin, N, m_base, M, nt * BNT, nrows, nrows, GLU,
                                  nrows % 4 == 0, nullptr, 0);
      }
#pragma unroll
      for (int i = 0; i < NF; ++i) {
        if (ACT == ACT_RELU) v[i] = v[i] > 0.0f ? v[i] : (v[i] != v[i] ? v[i] : 0.0f);
        if (ACT == ACT_GELU) v[i] = repro::xla_geluf(v[i]);
      }
      if (GLU) {
        // gate column c (j < BN / 16) pairs with up column c + BN / 2
#pragma unroll
        for (int i = 0; i < NF / 2; ++i)
          v[i] = ACT == ACT_GELU_GLU ? repro::gelu_glu(v[i], v[i + NF / 2])
                                     : repro::silu_glu(v[i], v[i + NF / 2]);
        ny = nrows;
        q0 = nt * BNT;
      }
    }
    constexpr int WY = GLU ? BN / 2 : BN;
    named_sync(1 + wg, 128);  // the previous readers of the tile are done
    stage_tile<WY, T::OUT_LD>(my_out, v, r0, c0);
    named_sync(1 + wg, 128);
    store_tile<WY, T::OUT_LD>(my_out, y + (size_t)z * M * ny, ny, m_base, M, q0, ny, 0, false,
                              ny % 4 == 0, eo.emax, eo.emax != nullptr ? eo.m_true : 0);
  }
}

// ---------------------------------------------------------------------------
// stream: M <= 16, a in shared memory, b streamed through a TMA ring
// ---------------------------------------------------------------------------

constexpr int ST_BN = 64, ST_BK = 128, ST_STAGES = 12;
constexpr int ST_TILE = ST_BN * ST_BK;  // bytes
constexpr int ST_THREADS = 160;         // 4 consumer warps + 1 producer warp
constexpr int ST_A_LIMIT = 98304;       // bytes of a rows (M x padded K) held
constexpr int ST_SMEM = 1024 + ST_STAGES * ST_TILE + ST_A_LIMIT + 2 * ST_STAGES * 8;

__host__ __device__ constexpr int st_lda(int K) {
  return (K + ST_BK - 1) / ST_BK * ST_BK + 16;  // +16: conflict-free row reads
}

// Four a mantissas of row `row` at byte `off` of the rows held in shared
// memory; zero for the rows past M (the mma tile's 16 rows).
__device__ __forceinline__ uint32_t a_word(const uint8_t* ar, int row, int lda,
                                           int M, int off) {
  return row < M ? *reinterpret_cast<const uint32_t*>(ar + row * lda + off) : 0u;
}

template <bool A_FLOAT, bool STOCH, bool SCALAR>
__global__ void __launch_bounds__(ST_THREADS, 1) stream_gemm_kernel(
    const __grid_constant__ CUtensorMap tb, const float* __restrict__ a,
    const uint32_t* __restrict__ ra, const int8_t* __restrict__ ai,
    const int* __restrict__ ea_ptr, const int* __restrict__ eb_ptr,
    const float* __restrict__ scale_ptr, float* __restrict__ y,
    int8_t* __restrict__ am_out, int M, int N, int K, int pa, int pb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);
  const int lda = st_lda(K), kc_n = (K + ST_BK - 1) / ST_BK;
  uint8_t* as = ring + ST_STAGES * ST_TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(as + ((M * lda + 15) & ~15));
  uint64_t* empty = full + ST_STAGES;
  const int z = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ea = A_FLOAT ? *ea_ptr : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_fence_init();
  }
  // the a rows, quantized (qi) or loaded (ii), zero past K
  const size_t a0 = (size_t)z * M * K;
  const bool write_am = A_FLOAT && blockIdx.x == 0;
  const int words = lda / 4;
  for (int w = threadIdx.x; w < M * words; w += ST_THREADS) {
    const int row = w / words, k = (w % words) * 4;
    uint32_t packed = 0;
    if (k < K) {
      const size_t idx = a0 + (size_t)row * K + k;
      if (A_FLOAT) {
        packed = quantize4<STOCH>(a, ra, idx, ea, pa);
        if (write_am) *reinterpret_cast<uint32_t*>(am_out + idx) = packed;
      } else {
        packed = *reinterpret_cast<const uint32_t*>(ai + idx);
      }
    }
    *reinterpret_cast<uint32_t*>(as + row * lda + k) = packed;
  }
  __syncthreads();

  const int n_tiles = (N + ST_BN - 1) / ST_BN;
  if (warp == 4) {  // producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x)
        for (int kc = 0; kc < kc_n; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1u);
          mbar_expect_tx(&full[stage], ST_TILE);
          tma_load_3d(ring + stage * ST_TILE, &tb, &full[stage], kc * ST_BK,
                      t * ST_BN, z);
          if (++stage == ST_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
    }
    return;
  }

  // consumers: warp w owns tile rows [16 w, 16 w + 16), two n8 groups
  const int gid = lane / 4, tig = lane % 4;
  const float scale =
      epi_scale<SCALAR ? EPI_SCALAR : EPI_EXP>(ea_ptr, eb_ptr, scale_ptr, pa, pb);
  float* yz = y + (size_t)z * M * N;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int c[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int kc = 0; kc < kc_n; ++kc) {
      mbar_wait(&full[stage], phase);
      const uint8_t* bt = ring + stage * ST_TILE;
#pragma unroll
      for (int ks = 0; ks < ST_BK / 32; ++ks) {
        const int kb = ks * 32 + tig * 4;  // byte of the tile row
        const uint8_t* ar = as + kc * ST_BK + kb;
        const uint32_t x0 = a_word(ar, gid, lda, M, 0);
        const uint32_t x1 = a_word(ar, gid + 8, lda, M, 0);
        const uint32_t x2 = a_word(ar, gid, lda, M, 16);
        const uint32_t x3 = a_word(ar, gid + 8, lda, M, 16);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          const int n = warp * 16 + g * 8 + gid;  // row of the b tile
          const uint8_t* br = bt + n * ST_BK;
          const int sw = n & 7;                   // the 128-byte swizzle
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
              br + ((((kb >> 4) ^ sw) << 4) | (kb & 15)));
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
              br + (((((kb + 16) >> 4) ^ sw) << 4) | (kb & 15)));
          mma_s8_m16n8k32(c[g], x0, x1, x2, x3, w0, w1);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == ST_STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int col = t * ST_BN + warp * 16 + g * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = gid + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < N)
            yz[(size_t)row * N + col + e] =
                __fmul_rn(__int2float_rn(c[g][2 * h + e]), scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps, launches
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  });
  return fn;
}

// A small cache of encoded maps: a map is a pure function of its key, so a
// hit is always right, whatever else the pointer held before.
struct MapKey {
  const void* ptr;
  int K, rows, B, box_rows;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && K == o.K && rows == o.rows && B == o.B &&
           box_rows == o.box_rows;
  }
};
constexpr int MAP_CACHE = 64;
struct MapEntry {
  MapKey key;
  CUtensorMap map;
  bool used;
};
MapEntry g_maps[MAP_CACHE];
std::mutex g_maps_mu;

// The (B, rows, K) int8 tensor at ptr, boxes of box_rows x 128 bytes, the
// 128-byte swizzle, zero fill past every edge.
cudaError_t int8_map(CUtensorMap* out, const void* ptr, int B, int rows, int K,
                     int box_rows) {
  const MapKey key{ptr, K, rows, B, box_rows};
  const size_t h = (reinterpret_cast<uintptr_t>(ptr) >> 8) ^ (size_t)K * 31u ^
                   (size_t)rows * 131u ^ (size_t)B * 7u ^ (size_t)box_rows;
  MapEntry& slot = g_maps[h % MAP_CACHE];
  std::lock_guard<std::mutex> lock(g_maps_mu);
  if (slot.used && slot.key == key) {
    *out = slot.map;
    return cudaSuccess;
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)K * (cuuint64_t)rows};
  const cuuint32_t box[3] = {128u, (cuuint32_t)box_rows, 1u};
  const cuuint32_t estr[3] = {1u, 1u, 1u};
  const CUresult r = fn(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
                        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  slot.key = key;
  slot.map = *out;
  slot.used = true;
  return cudaSuccess;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The GEMM on tiles of WGS * 64 x BN; the block mode (EPI_BLOCK) reads the
// scale columns sa_t (B, K/blk, lda_t) and sb_t (B, K/blk, ldb_t); the act
// and row-column modes their operands in eo.  A GLU (B == 1) maps b's two
// halves of N/2 rows each.
template <int EPI, int WGS = 2, int BN = 128, int ACT = ACT_NONE>
cudaError_t launch_tc(const int8_t* a, const int8_t* b, const int* ea, const int* eb,
                      const float* scale, float* y, int B, int M, int N, int K, int pa,
                      int pb, cudaStream_t stream, const int* sa_t = nullptr,
                      const int* sb_t = nullptr, int blk = 0, int lda_t = 0,
                      int ldb_t = 0, const EpiOut& eo = EpiOut{}) {
  using T = Tc<EPI, WGS, BN>;
  constexpr bool GLU = EPI == EPI_ACT && act_glu(ACT);
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_kernel<EPI, WGS, BN, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const int nrows = GLU ? N / 2 : N, bnt = GLU ? BN / 2 : BN;
  CUtensorMap ta, tb, tb2;
  cudaError_t e = int8_map(&ta, a, B, M, K, T::BM);
  if (e != cudaSuccess) return e;
  e = int8_map(&tb, b, B, nrows, K, bnt);
  if (e != cudaSuccess) return e;
  tb2 = tb;
  if (GLU) {
    e = int8_map(&tb2, b + (size_t)nrows * K, B, nrows, K, bnt);
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (long long)((M + T::BM - 1) / T::BM) * ((nrows + bnt - 1) / bnt) * B;
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  tc_gemm_kernel<EPI, WGS, BN, ACT><<<grid, T::THREADS, T::SMEM, stream>>>(
      ta, tb, tb2, ea, eb, scale, sa_t, sb_t, y, M, N, K, B, pa, pb, blk, lda_t, ldb_t, eo);
  return cudaGetLastError();
}

template <bool A_FLOAT, bool STOCH, bool SCALAR>
cudaError_t launch_stream(const float* a, const uint32_t* ra, const int8_t* ai,
                          const int8_t* b, const int* ea, const int* eb,
                          const float* scale, float* y, int8_t* am, int B, int M, int N,
                          int K, int pa, int pb, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_gemm_kernel<A_FLOAT, STOCH, SCALAR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ST_SMEM);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  CUtensorMap tb;
  const cudaError_t e = int8_map(&tb, b, B, N, K, ST_BN);
  if (e != cudaSuccess) return e;
  const int n_tiles = (N + ST_BN - 1) / ST_BN;
  int per = sm_count() / B;
  if (per < 1) per = 1;
  const dim3 grid(n_tiles < per ? n_tiles : per, B);
  const int smem = 1024 + ST_STAGES * ST_TILE + ((M * st_lda(K) + 15) & ~15) +
                   2 * ST_STAGES * 8;
  stream_gemm_kernel<A_FLOAT, STOCH, SCALAR><<<grid, ST_THREADS, smem, stream>>>(
      tb, a, ra, ai, ea, eb, scale, y, am, M, N, K, pa, pb);
  return cudaGetLastError();
}

// The stream variant of qq and qi: a quantized in the block.
cudaError_t launch_stream_qa(const float* a, const uint32_t* ra, const int8_t* b,
                             const int* ea, const int* eb, float* y, int8_t* am,
                             int B, int M, int N, int K, int pa, int pb,
                             bool stochastic, cudaStream_t s) {
  return stochastic ? launch_stream<true, true, false>(a, ra, nullptr, b, ea, eb,
                                                       nullptr, y, am, B, M, N, K,
                                                       pa, pb, s)
                    : launch_stream<true, false, false>(a, ra, nullptr, b, ea, eb,
                                                        nullptr, y, am, B, M, N, K,
                                                        pa, pb, s);
}

cudaError_t launch_quantize(QSeg s0, QSeg s1, int p, bool stochastic,
                            cudaStream_t stream, int* meta = nullptr) {
  size_t blocks = (s0.n4 + s1.n4 + 255) / 256;
  const size_t cap = (size_t)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (stochastic)
    quantize_pass_kernel<true><<<(unsigned)blocks, 256, 0, stream>>>(s0, s1, p, meta);
  else
    quantize_pass_kernel<false><<<(unsigned)blocks, 256, 0, stream>>>(s0, s1, p, meta);
  return cudaGetLastError();
}

// gemm_epi's GEMM with its act chosen at run time.
cudaError_t launch_epi(int act, const int8_t* a, const int8_t* b, const int* ea,
                       const int* eb, float* y, int M, int N, int K, int p,
                       const EpiOut& eo, cudaStream_t s) {
  switch (act) {
    case ACT_NONE:
      return launch_tc<EPI_ACT, 2, 128, ACT_NONE>(a, b, ea, eb, nullptr, y, 1, M, N, K, p, p,
                                                  s, nullptr, nullptr, 0, 0, 0, eo);
    case ACT_RELU:
      return launch_tc<EPI_ACT, 2, 128, ACT_RELU>(a, b, ea, eb, nullptr, y, 1, M, N, K, p, p,
                                                  s, nullptr, nullptr, 0, 0, 0, eo);
    case ACT_GELU:
      return launch_tc<EPI_ACT, 2, 128, ACT_GELU>(a, b, ea, eb, nullptr, y, 1, M, N, K, p, p,
                                                  s, nullptr, nullptr, 0, 0, 0, eo);
    case ACT_SILU_GLU:
      return launch_tc<EPI_ACT, 2, 128, ACT_SILU_GLU>(a, b, ea, eb, nullptr, y, 1, M, N, K, p,
                                                      p, s, nullptr, nullptr, 0, 0, 0, eo);
    case ACT_GELU_GLU:
      return launch_tc<EPI_ACT, 2, 128, ACT_GELU_GLU>(a, b, ea, eb, nullptr, y, 1, M, N, K, p,
                                                      p, s, nullptr, nullptr, 0, 0, 0, eo);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_quantize_blk(const QBlkSeg& s0, const QBlkSeg& s1, int K, int blk,
                                int p, bool stochastic, cudaStream_t stream) {
  size_t blocks = ((size_t)(s0.rows + s1.rows) * (K / 4) + 255) / 256;
  const size_t cap = (size_t)sm_count() * 16;
  if (blocks > cap) blocks = cap;
  if (stochastic)
    quantize_blk_pass_kernel<true><<<(unsigned)blocks, 256, 0, stream>>>(s0, s1, K, blk, p);
  else
    quantize_blk_pass_kernel<false><<<(unsigned)blocks, 256, 0, stream>>>(s0, s1, K, blk, p);
  return cudaGetLastError();
}

// The shapes and operands a variant takes; the wrappers' rules keep to them.
bool takes(int variant, int M, int K) {
  if (K <= 0 || K % 16 != 0) return false;
  if (variant == 1) return M <= 16 && M * st_lda(K) <= ST_A_LIMIT;
  return variant == 0;
}

}  // namespace

extern "C" {

// qq: a (B,M,K) f32 [+ ra], b (B,N,K) f32 [+ rb] -> y (B,M,N) f32, am, bm int8.
// variant 0: one quantize launch over a then b, then the wgmma GEMM;
// 1: b's quantize pass, then stream (M <= 16, a quantized in the block).
int repro_qq_sm90(const void* a, const void* ra, const void* b, const void* rb,
                  const void* ea, const void* eb, void* y, void* am, void* bm, int B,
                  int M, int N, int K, int p, int stochastic, int variant,
                  void* stream) {
  if (!takes(variant, M, K) || !aligned16(a) || !aligned16(ra) || !aligned16(b) ||
      !aligned16(rb) || !aligned16(y) || !aligned16(am) || !aligned16(bm))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int* eap = static_cast<const int*>(ea);
  const int* ebp = static_cast<const int*>(eb);
  int8_t* ami = static_cast<int8_t*>(am);
  int8_t* bmi = static_cast<int8_t*>(bm);
  const QSeg sa{static_cast<const float*>(a), static_cast<const uint32_t*>(ra), eap,
                ami, (size_t)B * M * K / 4};
  const QSeg sb{static_cast<const float*>(b), static_cast<const uint32_t*>(rb), ebp,
                bmi, (size_t)B * N * K / 4};
  const QSeg none{nullptr, nullptr, nullptr, nullptr, 0};
  cudaError_t e = launch_quantize(variant == 0 ? sa : sb, variant == 0 ? sb : none,
                                  p, stochastic != 0, s);
  if (e != cudaSuccess) return (int)e;
  if (variant == 1)
    return (int)launch_stream_qa(sa.x, sa.r, bmi, eap, ebp, static_cast<float*>(y),
                                 ami, B, M, N, K, p, p, stochastic != 0, s);
  return (int)launch_tc<EPI_EXP>(ami, bmi, eap, ebp, nullptr, static_cast<float*>(y), B,
                               M, N, K, p, p, s);
}

// qi: a (B,M,K) f32 [+ ra], b_m (B,N,K) int8 -> y (B,M,N) f32, am int8.
// variant 0: the quantize pass, then the wgmma GEMM; 1: stream (M <= 16).
int repro_qi_sm90(const void* a, const void* ra, const void* b_m, const void* ea,
                  const void* eb, void* y, void* am, int B, int M, int N, int K,
                  int pa, int pb, int stochastic, int variant, void* stream) {
  if (!takes(variant, M, K) || !aligned16(a) || !aligned16(ra) ||
      !aligned16(b_m) || !aligned16(y) || !aligned16(am))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const uint32_t* rf = static_cast<const uint32_t*>(ra);
  const int8_t* bi = static_cast<const int8_t*>(b_m);
  const int* eap = static_cast<const int*>(ea);
  const int* ebp = static_cast<const int*>(eb);
  float* yf = static_cast<float*>(y);
  int8_t* ami = static_cast<int8_t*>(am);
  if (variant == 1)
    return (int)launch_stream_qa(af, rf, bi, eap, ebp, yf, ami, B, M, N, K, pa, pb,
                                 stochastic != 0, s);
  const QSeg sa{af, rf, eap, ami, (size_t)B * M * K / 4};
  const QSeg none{nullptr, nullptr, nullptr, nullptr, 0};
  const cudaError_t e = launch_quantize(sa, none, pa, stochastic != 0, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_tc<EPI_EXP>(ami, bi, eap, ebp, nullptr, yf, B, M, N, K, pa, pb, s);
}

// ii: a_m (B,M,K) int8, b_m (B,N,K) int8 -> y (B,M,N) f32.
// variant 0: the wgmma GEMM; 1: stream (M <= 16).
int repro_ii_sm90(const void* a_m, const void* b_m, const void* ea, const void* eb,
                  void* y, int B, int M, int N, int K, int pa, int pb, int variant,
                  void* stream) {
  if (!takes(variant, M, K) || !aligned16(a_m) || !aligned16(b_m) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int8_t* ai = static_cast<const int8_t*>(a_m);
  const int8_t* bi = static_cast<const int8_t*>(b_m);
  const int* eap = static_cast<const int*>(ea);
  const int* ebp = static_cast<const int*>(eb);
  float* yf = static_cast<float*>(y);
  if (variant == 1)
    return (int)launch_stream<false, false, false>(nullptr, nullptr, ai, bi, eap, ebp,
                                                   nullptr, yf, nullptr, B, M, N, K,
                                                   pa, pb, s);
  return (int)launch_tc<EPI_EXP>(ai, bi, eap, ebp, nullptr, yf, B, M, N, K, pa, pb, s);
}

// int8_matmul: a (B,M,K) int8, b (B,N,K) int8, scale f32 scalar -> y (B,M,N)
// f32 = float(acc) * scale.  variant 0: the wgmma GEMM; 1: stream (M <= 16).
int repro_int8_matmul_sm90(const void* a, const void* b, const void* scale, void* y,
                           int B, int M, int N, int K, int variant, void* stream) {
  if (!takes(variant, M, K) || !aligned16(a) || !aligned16(b) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int8_t* ai = static_cast<const int8_t*>(a);
  const int8_t* bi = static_cast<const int8_t*>(b);
  const float* sc = static_cast<const float*>(scale);
  float* yf = static_cast<float*>(y);
  if (variant == 1)
    return (int)launch_stream<false, false, true>(nullptr, nullptr, ai, bi, nullptr,
                                                  nullptr, sc, yf, nullptr, B, M, N, K,
                                                  0, 0, s);
  return (int)launch_tc<EPI_SCALAR>(ai, bi, nullptr, nullptr, sc, yf, B, M, N, K, 0, 0, s);
}

// qq_blk: a (B,M,K) f32 [+ ra], ea (B,M,K/blk) int32, b (B,N,K) f32 [+ rb],
// eb (B,N,K/blk) int32 -> y (B,M,N) f32, am, bm int8 (scratch when the
// caller keeps no residuals); sa_t (B, K/blk, lda_t) and sb_t (B, K/blk,
// ldb_t) int32 scratch for the scale columns, lda_t and ldb_t M and N
// rounded up to 128.  One per-block quantize launch over a then b, then the
// wgmma GEMM in block mode: variant 0 on 128 x 128 tiles, 1 on 64 x 64.
int repro_qq_blk_sm90(const void* a, const void* ra, const void* ea, const void* b,
                      const void* rb, const void* eb, void* y, void* am, void* bm,
                      void* sa_t, void* sb_t, int B, int M, int N, int K, int blk, int p,
                      int stochastic, int variant, void* stream) {
  if (K <= 0 || K % 16 != 0 || blk <= 0 || blk % 32 != 0 || K % blk != 0 ||
      (128 % blk != 0 && blk % 128 != 0) || (variant != 0 && variant != 1) ||
      !aligned16(a) || !aligned16(ra) || !aligned16(b) || !aligned16(rb) ||
      !aligned16(y) || !aligned16(am) || !aligned16(bm) || !aligned16(sa_t) ||
      !aligned16(sb_t))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int lda_t = (M + 127) / 128 * 128, ldb_t = (N + 127) / 128 * 128;
  int8_t* ami = static_cast<int8_t*>(am);
  int8_t* bmi = static_cast<int8_t*>(bm);
  int* sat = static_cast<int*>(sa_t);
  int* sbt = static_cast<int*>(sb_t);
  // a's column holds sa + 127, b's sb: their sum is the exponent field of
  // 2^(sa + sb), sa = e - 126 - p
  const QBlkSeg sa{static_cast<const float*>(a), static_cast<const uint32_t*>(ra),
                   static_cast<const int*>(ea), ami, sat, lda_t, 1 - p, M, B * M};
  const QBlkSeg sb{static_cast<const float*>(b), static_cast<const uint32_t*>(rb),
                   static_cast<const int*>(eb), bmi, sbt, ldb_t, -126 - p, N, B * N};
  const cudaError_t e = launch_quantize_blk(sa, sb, K, blk, p, stochastic != 0, s);
  if (e != cudaSuccess) return (int)e;
  float* yf = static_cast<float*>(y);
  if (variant == 1)
    return (int)launch_tc<EPI_BLOCK, 1, 64>(ami, bmi, nullptr, nullptr, nullptr, yf, B, M,
                                            N, K, p, p, s, sat, sbt, blk, lda_t, ldb_t);
  return (int)launch_tc<EPI_BLOCK, 2, 128>(ami, bmi, nullptr, nullptr, nullptr, yf, B, M,
                                           N, K, p, p, s, sat, sbt, blk, lda_t, ldb_t);
}

// gemm_epi: kind 0 qq (a (M,K), b (N,K) f32 [+ ra, rb], both quantized by
// one pass), 1 qi (a f32 [+ ra], b int8 mantissas), 2 ii (both int8);
// bias (N) f32 or null; act 0 none, 1 relu, 2 gelu, 3 silu_glu, 4 gelu_glu
// (N even) -> ylin (M,N) f32 (null when act == 0), am (M,K) / bm (N,K)
// int8 (qq; am also qi) and either y (M, n_out) f32 or, with out_q, ym
// (M, n_out) int8 against one exponent (the largest over rows below
// m_true; rq (M, n_out) bits or null for half up) and meta (128) int32,
// through the f32 scratch ys (M, n_out) and the int32 word ew.
int repro_gemm_epi_sm90(const void* a, const void* ra, const void* b, const void* rb,
                        const void* bias, const void* rq, const void* ea, const void* eb,
                        void* y, void* ylin, void* am, void* bm, void* ys, void* ew,
                        void* meta, int M, int N, int K, int p, int qp, int m_true,
                        int kind, int act, int out_q, int stochastic, void* stream) {
  if (K <= 0 || K % 16 != 0 || kind < 0 || kind > 2 || act < 0 || act > 4 ||
      (act_glu(act) && N % 2 != 0) || !aligned16(a) || !aligned16(ra) || !aligned16(b) ||
      !aligned16(rb) || !aligned16(rq) || !aligned16(y) || !aligned16(ylin) ||
      !aligned16(am) || !aligned16(bm) || !aligned16(ys))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool sr = stochastic != 0;
  const int* eap = static_cast<const int*>(ea);
  const int* ebp = static_cast<const int*>(eb);
  int8_t* ami = static_cast<int8_t*>(am);
  int8_t* bmi = static_cast<int8_t*>(bm);
  const QSeg none{nullptr, nullptr, nullptr, nullptr, 0};
  cudaError_t e = cudaSuccess;
  if (kind == 0) {
    const QSeg sa{static_cast<const float*>(a), static_cast<const uint32_t*>(ra), eap, ami,
                  (size_t)M * K / 4};
    const QSeg sb{static_cast<const float*>(b), static_cast<const uint32_t*>(rb), ebp, bmi,
                  (size_t)N * K / 4};
    e = launch_quantize(sa, sb, p, sr, s);
  } else if (kind == 1) {
    const QSeg sa{static_cast<const float*>(a), static_cast<const uint32_t*>(ra), eap, ami,
                  (size_t)M * K / 4};
    e = launch_quantize(sa, none, p, sr, s);
  }
  if (e != cudaSuccess) return (int)e;
  const int n_out = act_glu(act) ? N / 2 : N;
  int* ewi = static_cast<int*>(ew);
  EpiOut eo;
  eo.bias = static_cast<const float*>(bias);
  eo.ylin = static_cast<float*>(ylin);
  if (out_q) {
    e = cudaMemsetAsync(ewi, 0, sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    eo.emax = ewi;
    eo.m_true = m_true;
  }
  const int8_t* ag = kind == 2 ? static_cast<const int8_t*>(a) : ami;
  const int8_t* bg = kind == 0 ? bmi : static_cast<const int8_t*>(b);
  float* yo = static_cast<float*>(out_q ? ys : y);
  e = launch_epi(act, ag, bg, eap, ebp, yo, M, N, K, p, eo, s);
  if (e != cudaSuccess || !out_q) return (int)e;
  const size_t total = (size_t)M * n_out;
  QSeg sy{yo, static_cast<const uint32_t*>(rq), ewi, static_cast<int8_t*>(y), total / 4};
  sy.tail = (int)(total % 4);
  return (int)launch_quantize(sy, none, qp, sr, s, static_cast<int*>(meta));
}

// norm_gemm's GEMM: xq (M,K) int8 (norm_rows' output) against w (N,K) int8
// -> y (M,N) f32 = float(acc) * 2^(meta[128 i] + se_w[j]).
int repro_rowcol_gemm_sm90(const void* xq, const void* w, const void* meta, const void* se_w,
                           void* y, int M, int N, int K, void* stream) {
  if (K <= 0 || K % 16 != 0 || !aligned16(xq) || !aligned16(w) || !aligned16(y))
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  EpiOut eo;
  eo.se_row = static_cast<const int*>(meta);
  eo.se_row_ld = 128;
  eo.se_col = static_cast<const int*>(se_w);
  return (int)launch_tc<EPI_ROWCOL>(static_cast<const int8_t*>(xq),
                                    static_cast<const int8_t*>(w), nullptr, nullptr, nullptr,
                                    static_cast<float*>(y), 1, M, N, K, 0, 0,
                                    static_cast<cudaStream_t>(stream), nullptr, nullptr, 0, 0,
                                    0, eo);
}

}  // extern "C"
