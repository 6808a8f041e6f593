// Cross-op chains for Hopper (sm_90a): the fused norm -> GEMM and the
// whole-layer decode block.
//
// Replaces the TPU kernels of src/repro/kernels/fused_chain.py:
//   fused_norm_gemm_pallas    (per-row integer RMS/LayerNorm -> per-row
//                              quantize -> int8 GEMM, residuals xq/meta/c)
//   fused_decode_block_pallas (one decoder layer for one token)
//
// The per-row norm (norm_row below) is the reference's _norm_rows_core
// step for step in int32: a 7-bit per-row quantize of x against its
// largest effective exponent, the exact row sums sum(c) and sum(c^2) (warp
// shuffles; integer sums are exact in any order), the reciprocal-multiply
// divide by n, the integer Newton rsqrt, the gain product and one per-row
// quantize to p bits (stochastic against streamed bits, or half up).  A
// centred row can reach 128 before its int8 store wraps, so the row is
// kept as int16 and recomputed from there in each pass.
//
// norm_gemm.  Two launches, one call (kernels/fused_chain.py
// norm_gemm_variant "wgmma", every main-path shape): norm_rows_kernel
// normalises each row once, one block of 8 warps a row (the row's int16
// scratch in shared memory, 2 K bytes: K up to about 116000), reading x and
// both bit streams once and writing xq, c and meta [se_row, e_c, r, e_r,
// 0...], the backward's residuals; then qgemm_sm90.cu's wgmma GEMM
// contracts xq against the weight in its row-column mode, y = float(acc) *
// 2^(se_row + se_w[col]), the weight read once per 128-row tile from L2.
// (The TPU kernel keeps the whole weight resident in VMEM.)  What bounds
// it on the H100: bytes, at minicpm-2b's QKV (512 x 2304 -> 6912):
// x and its two bit streams (14.2 MB), the weight (15.9 MB), y (14.2 MB),
// the residuals (2.6 MB), against 2*M*N*K int8 operations (16.3 G, 8 us at
// 1979 TOP/s); the norm pass's serial integer reductions are latency more
// than bytes.  norm_gemm_kernel below (grid: row strips of BM = 16*TM rows
// x groups of column tiles; each block normalises its strip, one warp a
// row, keeps the strip's xq in shared memory and walks its 64-column tiles
// of the weight in 32-wide K slices with __dp4a) is the fallback for a K
// that is not a multiple of 16 or a weight off 16-byte alignment.
//
// decode_block.  One launch per layer, one block per SM, every block
// resident (a cooperative launch), the stages separated by grid barriers
// (the TPU kernel holds the whole layer in VMEM: 61 MB of int8 weights at
// minicpm-2b do not fit one SM):
//   1  norm1 of the B rows, in every block, into shared memory;
//   2  the QKV GEMV -> qkv (B, (hq + 2 hkv) dh);                    barrier
//   3  a (batch row, KV head) at a time, by the block's 8 warps, spread
//      over the blocks: rope, the fresh K and V rows quantized per row
//      (written out for the caller's append), the query group quantized
//      with one exponent, then decode attention over the cache with the
//      fresh row at pos: int8 scores, the softmax with the reference's
//      Cephes exp and its windowed sum order (fmath.cuh), the V-row
//      exponents folded into p, p quantized per query row, int8 PV barrier
//   4  the attention rows quantized per row (every block), the out-proj
//      GEMV plus the residual -> h2;                                 barrier
//   5  norm2 of h2 (every block), the gate|up GEMV with the SiLU-GLU;  barrier
//   6  the activation rows quantized per row (every block), the down GEMV
//      plus the residual -> x_out.
// Every float step is one IEEE operation in the plain version's order (the
// build turns off contraction; the rope's first product is an explicit
// fmaf, as XLA contracts it), so x_out and the fresh rows equal the plain
// version's bit for bit; the integer sums are exact in any order.
// Bounds on the H100: bytes: the int8 weights of the layer (61.1 MB at
// minicpm-2b), the cache rows up to pos and their exponents, a few B x d
// float rows: about 0.019 ms a layer.
//
// Weights.  Each block owns fixed groups of rows of each weight (8 rows; a
// gate|up group is 4 gate rows and the matching up rows), and one producer
// warp streams them, from the kernel's first instruction, with 1-D bulk
// copies (a row each, into rows padded against bank conflicts) through a
// ring of shared-memory stages (up to 12 of 8 rows x 2304 bytes of K, or
// shorter chunks where two stages would not fit otherwise) with
// mbarrier completion.  The weights do not depend on the activations, so
// the producer never waits at the grid barriers: only the 8 consumer warps
// meet there (an arrival count a barrier, no reply asked), and while they
// finish a stage and wait, the next stage's rows land.  It keeps one stage
// issued and not landed (measured faster than more on the card), and the
// ring fills over the stages that do not read weights.  A consumer warp
// contracts its group's 8 rows with the B activation rows by
// mma.sync.m16n8k32 (rows past B zero).  Consumer warps run ahead of one
// another by more than the ring, so each slot carries its stage's index
// and a warp waits on a slot's mbarrier only once the index is its own.
//
// Everything else.  The row passes (norms, quantizes) are repeated by
// every block on all B rows, spread over all 8 warps (a norm's tail over
// 8 / B warps a row); the activation rows, the norm rows and the
// attention scratch share one region (never live together), the rest of
// shared memory is the ring.  What bounds the kernel now is not HBM: the
// row passes are integer work and L2 round trips, and 9 warps a block
// leave 168 registers a thread (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"
#include "fmath.cuh"
#include "sm90.cuh"

namespace {

using repro::bulk_load;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_fence_init;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_s8_m16n8k32;
using repro::eff_exp;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BN = 64;          // norm_gemm output columns per tile
constexpr int BK = 32;          // norm_gemm contraction slice (int8)
constexpr int KW = BK / 4;      // words per slice
constexpr int LD = KW + 1;      // padded weight-tile row stride (words)
constexpr float NEG = -1e30f;   // models.attention._NEG

// ---------------------------------------------------------------------------
// int32 helpers of the reference (wrap-around products and shifts)
// ---------------------------------------------------------------------------

__device__ __forceinline__ int bitlen(int v) { return v > 0 ? 32 - __clz(v) : 0; }

__device__ __forceinline__ int clamp31(int s) { return s < 0 ? 0 : (s > 31 ? 31 : s); }

__device__ __forceinline__ int shr(int v, int s) { return v >> clamp31(s); }

__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int wshl(int v, int s) {
  return (int)((unsigned)v << clamp31(s));
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// round(v / 2^s), s >= 0: stochastic against r, else half up (_sr_shift).
__device__ __forceinline__ int sr_shift(int v, int s, bool stoch, uint32_t r) {
  const uint32_t mag = v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
  const uint32_t s31 = (uint32_t)(s < 31 ? s : 31);
  const uint32_t base = s < 32 ? (mag >> s31) : 0u;
  const uint32_t m_lo = mag & ((1u << s31) - 1u);
  const uint32_t left = (uint32_t)clamp31(32 - s);
  const uint32_t over = (uint32_t)clamp31(s - 32);
  const uint32_t thr = s <= 31 ? (m_lo << left) : (s == 32 ? mag : (mag >> over));
  bool up = stoch ? (r < thr) : (thr >= 0x80000000u);
  up = up && s > 0;
  const int out = (int)(base + (up ? 1u : 0u));
  return v < 0 ? -out : out;
}

// Integer Newton 1/sqrt of vm * 2^ev (_int_rsqrt): r 15-bit, e_r.
__device__ __forceinline__ void int_rsqrt(int vm, int ev, int* r_out, int* er_out) {
  const int v = vm > 1 ? vm : 1;
  const int d = bitlen(v) - 16;
  int vn = d >= 0 ? shr(v, d) : wshl(v, -d);
  int e2 = ev + d;
  if (e2 & 1) {
    vn = wshl(vn, 1);
    e2 -= 1;
  }
  int r = vn >= (1 << 16) ? 11585 : 16384;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = wmul(r, r) >> 16;
    r = wmul(r, ((3 << 28) - wmul(vn, t)) >> 14) >> 15;
  }
  *r_out = r;
  *er_out = -22 - (e2 >> 1);
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_maxf(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2)
    v = (int)((unsigned)v + (unsigned)__shfl_xor_sync(FULL, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// one row of _norm_rows_core, by one warp
// ---------------------------------------------------------------------------

struct NormCfg {
  int K, p, eps_m, eps_e, center, j, inv_q;
};

struct RowScales {
  int se_row, sc, r, e_r;
};

// The warps of a row (nws of them, the part-th here) combine a value, a
// sum or a maximum, through nws ints at red and named barrier id.
template <bool MAX>
__device__ __forceinline__ int row_reduce(int v, int nws, int part, int* red, int id) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (nws == 1) return v;
  if ((threadIdx.x & 31) == 0) red[part] = v;
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(32 * nws) : "memory");
  int r = red[0];
  for (int i = 1; i < nws; ++i) r = MAX ? max(r, red[i]) : (int)((unsigned)r + (unsigned)red[i]);
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(32 * nws) : "memory");
  return r;
}

// The row's 7-bit input quantize into ci (int16 scratch of K): returns its
// largest effective exponent e (rin null: half up) and the lane's partial
// sums of c and c^2 in s1, s2.  By nws warps as norm_row_tail (one by
// default), each lane owning the elements it owns there.
__device__ __forceinline__ int norm_row_input(const float* x, const uint32_t* rin, int K,
                                              int16_t* ci, int& s1, int& s2, int part = 0,
                                              int nws = 1, int* red = nullptr, int id = 0) {
  const int k0 = part * 32 + (threadIdx.x & 31), dk = 32 * nws;
  int e = 1;
  for (int k = k0; k < K; k += dk) e = max(e, eff_exp(x[k]));
  e = row_reduce<true>(e, nws, part, red, id);
  s1 = s2 = 0;
  for (int k = k0; k < K; k += dk) {
    const int c = quantize_one(x[k], rin != nullptr ? rin[k] : 0u, e, 7, rin != nullptr);
    ci[k] = (int16_t)c;
    s1 += c;
    s2 += c * c;
  }
  __syncwarp();
  return e;
}

// The rest of the row from ci, its 7-bit mantissas against exponent e,
// and the lane's partial sums s1, s2 of them.  rout: the output bits
// (null: half up); gm, bm: gain and shift mantissas (bm null: RMS); xq_s:
// where the int8 result goes (shared memory); xq_g, c_g: global residual
// rows or null.  By nws warps (the part-th here; red, id: row_reduce's),
// each taking every nws-th 32 elements.
__device__ __forceinline__ RowScales norm_row_tail(int e, int s1, int s2, const uint32_t* rout,
                                                   const int* gm, int se_g, const int* bm,
                                                   int se_b, const NormCfg& nc, int16_t* ci,
                                                   int8_t* xq_s, int8_t* xq_g, int8_t* c_g,
                                                   int part = 0, int nws = 1,
                                                   int* red = nullptr, int id = 0) {
  const int k0 = part * 32 + (threadIdx.x & 31), dk = 32 * nws;
  const int K = nc.K;
  const bool stoch = rout != nullptr;
  int sc = scale_exp(e, 7);
  if (nc.center) {
    s1 = row_reduce<false>(s1, nws, part, red, id);
    const int sh1 = max(bitlen(iabs(s1)) - 15, 0);
    const int mu = wmul(sr_shift(s1, sh1, false, 0u), nc.inv_q);
    const int sub = sr_shift(mu, 6 + nc.j - sh1, false, 0u);
    int amax = 0;
    for (int k = k0; k < K; k += dk) amax = max(amax, iabs(wshl(ci[k], 8) - sub));
    const int shc = max(bitlen(row_reduce<true>(amax, nws, part, red, id)) - 7, 0);
    s2 = 0;
    for (int k = k0; k < K; k += dk) {
      const int v = sr_shift(wshl(ci[k], 8) - sub, shc, false, 0u);
      ci[k] = (int16_t)v;
      s2 += v * v;
    }
    sc = sc - 8 + shc;
  }
  if (c_g != nullptr)
    for (int k = k0; k < K; k += dk) c_g[k] = (int8_t)ci[k];
  s2 = row_reduce<false>(s2, nws, part, red, id);
  const int sh2 = max(bitlen(s2) - 15, 0);
  int vm = wmul(shr(s2, sh2), nc.inv_q);
  int e_v = 2 * sc + sh2 - 14 - nc.j;
  const int sh3 = max(bitlen(vm) - 15, 0);
  vm = shr(vm, sh3);
  e_v += sh3;
  const int e_cm = max(e_v, nc.eps_e);
  const int vs = shr(vm, e_cm - e_v) + shr(nc.eps_m, e_cm - nc.eps_e);
  int r, e_r;
  int_rsqrt(vs, e_cm, &r, &e_r);
  const int e_o0 = sc + e_r + 8 + se_g;
  int amax = 0;
  for (int k = k0; k < K; k += dk)
    amax = max(amax, iabs(wmul(sr_shift(wmul(ci[k], r), 8, false, 0u), gm[k])));
  amax = row_reduce<true>(amax, nws, part, red, id);
  // with a shift: o narrowed to 15 bits, both aligned to the larger scale
  int sho = 0, e_o = e_o0;
  if (bm != nullptr) {
    sho = max(bitlen(amax) - 15, 0);
    e_o = max(e_o0 + sho, se_b);
  }
  auto o_at = [&](int k) {
    const int o = wmul(sr_shift(wmul(ci[k], r), 8, false, 0u), gm[k]);
    if (bm == nullptr) return o;
    return sr_shift(sr_shift(o, sho, false, 0u), e_o - e_o0 - sho, false, 0u) +
           sr_shift(bm[k], e_o - se_b, false, 0u);
  };
  if (bm != nullptr) {
    amax = 0;
    for (int k = k0; k < K; k += dk) amax = max(amax, iabs(o_at(k)));
    amax = row_reduce<true>(amax, nws, part, red, id);
  }
  const int shq = max(bitlen(amax) - nc.p, 0);
  const int lim = (1 << nc.p) - 1;
  for (int k = k0; k < K; k += dk) {
    int q = sr_shift(o_at(k), shq, stoch, stoch ? rout[k] : 0u);
    q = q < -lim ? -lim : (q > lim ? lim : q);
    xq_s[k] = (int8_t)q;
    if (xq_g != nullptr) xq_g[k] = (int8_t)q;
  }
  return RowScales{e_o + shq, sc, r, e_r};
}

// One row of _norm_rows_core, by one warp: x, rin, rout the row and its
// bits (null: half up); the rest as norm_row_tail.
__device__ __forceinline__ RowScales norm_row(const float* x, const uint32_t* rin,
                              const uint32_t* rout, const int* gm, int se_g,
                              const int* bm, int se_b, const NormCfg& nc,
                              int16_t* ci, int8_t* xq_s, int8_t* xq_g,
                              int8_t* c_g) {
  int s1, s2;
  const int e = norm_row_input(x, rin, nc.K, ci, s1, s2);
  return norm_row_tail(e, s1, s2, rout, gm, se_g, bm, se_b, nc, ci, xq_s, xq_g, c_g);
}

// ---------------------------------------------------------------------------
// norm_gemm
// ---------------------------------------------------------------------------

struct NormGemmArgs {
  const float* x; const uint32_t* rin; const uint32_t* rout;
  const int* gm; const int* se_g; const int* bm; const int* se_b;
  const int8_t* w; const int* se_w;
  float* y; int8_t* xq; int* meta; int8_t* c;
  int M, N, K;
  NormCfg nc;
};

// Words of one strip row: K rounded up to whole 32-wide slices, odd.
__host__ __device__ __forceinline__ int strip_ld(int K) { return ((K + BK - 1) / BK) * KW + 1; }

template <int TM, bool VEC>
__global__ void __launch_bounds__(THREADS) norm_gemm_kernel(NormGemmArgs g) {
  constexpr int BM = 16 * TM;
  extern __shared__ int smem[];
  const int K = g.K, lds = strip_ld(K);
  int* strip = smem;                                          // BM x lds words
  int16_t* cbuf = reinterpret_cast<int16_t*>(strip + BM * lds);  // WARPS x K
  int* se_row = reinterpret_cast<int*>(cbuf + WARPS * K);     // BM
  __shared__ int Bs[BN][LD];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * BM;
  const bool writer = blockIdx.y == 0;

  for (int w = threadIdx.x; w < BM * lds; w += THREADS) strip[w] = 0;
  __syncthreads();
  const int se_g = *g.se_g, se_b = g.se_b != nullptr ? *g.se_b : 0;
  for (int r = warp; r < BM; r += WARPS) {
    const int gr = m0 + r;
    if (gr >= g.M) {
      if (lane == 0) se_row[r] = 0;
      continue;
    }
    const size_t off = (size_t)gr * K;
    const RowScales rs = norm_row(
        g.x + off, g.rin != nullptr ? g.rin + off : nullptr,
        g.rout != nullptr ? g.rout + off : nullptr, g.gm, se_g, g.bm, se_b, g.nc,
        cbuf + warp * K, reinterpret_cast<int8_t*>(strip + r * lds),
        writer ? g.xq + off : nullptr, writer ? g.c + off : nullptr);
    if (lane == 0) se_row[r] = rs.se_row;
    if (writer) {
      int* mrow = g.meta + (size_t)gr * 128;
      for (int i = lane; i < 128; i += 32)
        mrow[i] = i == 0 ? rs.se_row : i == 1 ? rs.sc : i == 2 ? rs.r : i == 3 ? rs.e_r : 0;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntiles = (g.N + BN - 1) / BN;
  for (int nt = blockIdx.y; nt < ntiles; nt += gridDim.y) {
    const int n0 = nt * BN;
    int acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int w = threadIdx.x; w < BN * KW; w += THREADS) {
        const int row = w / KW, kw = w % KW;
        const int gn = n0 + row, gk = k0 + kw * 4;
        uint32_t packed = 0;
        if (gn < g.N && gk < K) {
          const int8_t* src = g.w + (size_t)gn * K + gk;
          if (VEC) {
            packed = *reinterpret_cast<const uint32_t*>(src);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (gk + j < K) packed |= ((uint32_t)(uint8_t)src[j]) << (8 * j);
          }
        }
        Bs[row][kw] = (int)packed;
      }
      __syncthreads();
      const int kw0 = k0 / 4;
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        int av[TM], bv[4];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = strip[(ty + 16 * i) * lds + kw0 + kw];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][kw];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i, gm = m0 + r;
      if (gm >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + tx + 16 * j;
        if (gn < g.N)
          g.y[(size_t)gm * g.N + gn] =
              __fmul_rn(__int2float_rn(acc[i][j]), pow2f(se_row[r] + g.se_w[gn]));
      }
    }
  }
}

int norm_gemm_smem(int bm, int K) {
  return 4 * bm * strip_ld(K) + 2 * WARPS * K + 4 * bm;
}

template <int TM, bool VEC>
cudaError_t launch_norm_gemm(const NormGemmArgs& g, cudaStream_t stream) {
  const int smem = norm_gemm_smem(16 * TM, g.K);
  auto kern = norm_gemm_kernel<TM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int mtiles = (g.M + 16 * TM - 1) / (16 * TM);
  const int ntiles = (g.N + BN - 1) / BN;
  int groups = sms / mtiles;
  groups = groups < 1 ? 1 : (groups > ntiles ? ntiles : groups);
  kern<<<dim3(mtiles, groups), THREADS, smem, stream>>>(g);
  return cudaGetLastError();
}

// The weight's 4-byte loads need K % 4 == 0 and a 4-byte aligned weight:
// the variant rule sends an unaligned weight here, read byte by byte.
template <int TM>
cudaError_t dispatch_norm_gemm(const NormGemmArgs& g, cudaStream_t stream) {
  return g.K % 4 == 0 && reinterpret_cast<uintptr_t>(g.w) % 4 == 0
             ? launch_norm_gemm<TM, true>(g, stream)
             : launch_norm_gemm<TM, false>(g, stream);
}

// ---------------------------------------------------------------------------
// norm_rows: the norm pass of norm_gemm's wgmma variant
// ---------------------------------------------------------------------------

struct NormRowsArgs {
  const float* x; const uint32_t* rin; const uint32_t* rout;
  const int* gm; const int* se_g; const int* bm; const int* se_b;
  int8_t* xq; int* meta; int8_t* c;
  int M;
  NormCfg nc;
};

// One row a block at a time, its 8 warps sharing it (norm_row_input and
// norm_row_tail with nws = 8, named barrier 1): ci, the row's int16
// scratch, in dynamic shared memory.
__global__ void __launch_bounds__(THREADS) norm_rows_kernel(NormRowsArgs g) {
  extern __shared__ int16_t ci[];
  __shared__ int red[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, K = g.nc.K;
  const int se_g = *g.se_g, se_b = g.se_b != nullptr ? *g.se_b : 0;
  for (int row = blockIdx.x; row < g.M; row += gridDim.x) {
    const size_t off = (size_t)row * K;
    int s1, s2;
    const int e = norm_row_input(g.x + off, g.rin != nullptr ? g.rin + off : nullptr, K, ci,
                                 s1, s2, warp, WARPS, red, 1);
    const RowScales rs = norm_row_tail(
        e, s1, s2, g.rout != nullptr ? g.rout + off : nullptr, g.gm, se_g, g.bm, se_b, g.nc,
        ci, g.xq + off, nullptr, g.c + off, warp, WARPS, red, 1);
    if (warp == 0) {
      int* mrow = g.meta + (size_t)row * 128;
      for (int i = lane; i < 128; i += 32)
        mrow[i] = i == 0 ? rs.se_row : i == 1 ? rs.sc : i == 2 ? rs.r : i == 3 ? rs.e_r : 0;
    }
    __syncthreads();  // ci and red serve the next row
  }
}

// ---------------------------------------------------------------------------
// decode_block
// ---------------------------------------------------------------------------

constexpr int DEC_THREADS = THREADS + 32;  // 8 consumer warps, 1 producer warp
constexpr int DEC_STAMPS = 20;             // clock64 stamps per block (probe)

struct DecArgs {
  const float* x;
  const int8_t* wqkv; const int* se_qkv;
  const int8_t* wo; const int* se_o;
  const int8_t* wgu; const int* se_gu;
  const int8_t* wd; const int* se_d;
  const int* g1m; const int* g2m;
  const int8_t* km; const int* ke; const int8_t* vm; const int* ve;
  const float* cossin;
  float* x_out; int8_t* k_new; int* ek_new; int8_t* v_new; int* ev_new;
  // stage outputs, read after a grid barrier by other blocks: plain
  // (coherent) loads, never the read-only path
  float* qkv; float* attn; float* h2; float* act;
  unsigned* bar;          // grid barriers: an arrival count each (words 1-4)
  long long* stamps;      // null, or DEC_STAMPS clock64 values per block
  int B, d, n_ff, hq, hkv, dh, T, pos, window, p, se_g1, se_g2;
  int nst;       // ring stages
  int kch;       // longest K chunk of a ring stage (bytes, a multiple of 32)
  int inflight;  // stages the producer keeps issued but not yet landed
  NormCfg nc;
};

__host__ __device__ __forceinline__ int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ __forceinline__ int round32(int v) { return (v + 31) & ~31; }

// The four weights in streaming order: wqkv (rows nqkv), wo (d), wgu (n_ff
// gate|up pairs, 4 pairs a group), wd (d); K of each; groups of 8 rows.
struct DecMat {
  int K, nch, L;  // contraction length, chunks of it a group, chunk bytes
  int groups;
};

__host__ __device__ __forceinline__ DecMat dec_mat(int m, int d, int n_ff, int hq, int hkv,
                                                   int dh, int kch) {
  const int K = m == 1 ? hq * dh : (m == 3 ? n_ff : d);
  const int rows = m == 0 ? (hq + 2 * hkv) * dh : (m == 2 ? 2 * n_ff : d);
  DecMat r;
  r.K = K;
  r.nch = (K + kch - 1) / kch;
  r.L = round32((K + r.nch - 1) / r.nch);
  r.groups = m == 2 ? (n_ff + 3) / 4 : (rows + 7) / 8;
  return r;
}

// The attention scratch of a block (one unit at a time): byte offsets of
// the unit's f32 query group, K and V rows and rope row, the K and V rows'
// scale exponents over T, the scores or probabilities (gs x T f32), the
// PV sums (gs x dh int32), the reductions' words, the query group's and the
// fresh rows' int8, the int8 p (gs x T) and each query row's p exponent.
struct AttLayout {
  int fq, sek, sf, acc, red, qb, ph, erow, total;
};

__host__ __device__ __forceinline__ AttLayout att_layout(int gs, int dh, int T) {
  AttLayout A;
  A.fq = 0;
  A.sek = A.fq + 4 * (gs + 4) * dh;
  A.sf = A.sek + align16(8 * T);
  A.acc = A.sf + align16(4 * gs * T);
  A.red = A.acc + align16(4 * gs * dh);
  A.qb = A.red + 4 * 48;
  A.ph = A.qb + align16(gs * dh + 2 * dh);
  A.erow = A.ph + align16(gs * T);
  A.total = A.erow + align16(4 * gs);
  return A;
}

struct DecLayout {
  int ldx, ldw, slot, att, xs, y, rows, ring, bars, total;
};

// ldx, ldw: rows of 16 bytes past a multiple of 32, so the 8 rows an mma
// fragment reads fall in 32 different banks.
__host__ __device__ __forceinline__ DecLayout dec_layout(int B, int d, int n_ff, int hq,
                                                         int hkv, int dh, int T, int nst,
                                                         int kch) {
  const int gs = hq / hkv;
  DecLayout L;
  L.ldx = round32(imax(imax(d, hq * dh), n_ff)) + 16;
  int lw = 0;
  for (int m = 0; m < 4; ++m) lw = imax(lw, dec_mat(m, d, n_ff, hq, hkv, dh, kch).L);
  L.ldw = lw + 16;
  L.slot = 8 * L.ldw;
  L.att = att_layout(gs, dh, T).total;
  L.xs = 0;
  // the norm rows, or (stage 3) the attention scratch
  L.y = align16(B * L.ldx);
  L.rows = L.y + imax(align16(2 * B * d), L.att);
  L.ring = L.rows + 128;  // the rows' scales, exponents, reductions: 8, 8, 16 ints
  L.bars = L.ring + nst * L.slot;  // full, empty mbarriers, then each slot's stage tag
  L.total = L.bars + 24 * nst;
  return L;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

__device__ __forceinline__ void stamp(const DecArgs& g, int i) {
  if (g.stamps != nullptr && threadIdx.x == 0)
    g.stamps[blockIdx.x * DEC_STAMPS + i] = clock64();
}

// All blocks' consumer warps meet (the producer warp streams on).  Barrier
// k (1-4) counts arrivals in its own word, bar[k], added to without a
// reply and polled until it holds every block; block 0 zeroes bar[k - 1]
// once barrier k is passed (nobody polls it any more), and bar[4] at the
// next launch's first barrier, so each word is 0 before its barrier.
// Writes before it are seen after it, as after cooperative groups' sync.
__device__ __forceinline__ void grid_barrier(const DecArgs& g, int k) {
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(g.bar + k, 1u);  // no reply asked: a reduction, not a round trip
    const volatile unsigned* word = g.bar + k;
    while (*word < gridDim.x) __nanosleep(32);
    __threadfence();
    if (blockIdx.x == 0) g.bar[k == 1 ? 4 : k - 1] = 0u;
  }
  consumer_sync();
}

// Zero bytes [K, round32(K)) of the B rows: a last k32 step past K reads
// zeros, whatever the ring holds there.
__device__ __forceinline__ void pad_rows(int8_t* xs, int B, int K, int ldx) {
  const int pad = round32(K) - K;
  for (int i = threadIdx.x; i < B * pad; i += THREADS) xs[(i / pad) * ldx + K + i % pad] = 0;
}

// The passes over the B rows of a (B, K) f32 tensor in global memory
// (K % 4 == 0) use all 8 consumer warps, whatever B: warp w takes row
// w % B, 16-byte groups i0, i0 + stride, ... of it, DEC_RL loads in flight
// a lane (a pass a warp a row waited on one load at a time).
constexpr int DEC_RL = 8;
struct RowShare {
  int b, i0, stride;
};

__device__ __forceinline__ RowShare row_share(int B) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31, b = warp % B;
  return RowShare{b, (warp / B) * 32 + lane, ((WARPS - 1 - b) / B + 1) * 32};
}

__device__ __forceinline__ int eff_exp4(float4 v) {
  return max(max(eff_exp(v.x), eff_exp(v.y)), max(eff_exp(v.z), eff_exp(v.w)));
}

// emax[b] = the largest effective exponent of row b (at least 1).
__device__ __forceinline__ void row_exps(const float* src, int B, int K, int* emax) {
  const RowShare rs = row_share(B);
  if (threadIdx.x < B) emax[threadIdx.x] = 1;
  consumer_sync();
  const float4* r4 = reinterpret_cast<const float4*>(src + (size_t)rs.b * K);
  const int n4 = K / 4;
  int e = 1;
  for (int i = rs.i0; i < n4; i += DEC_RL * rs.stride) {
    float4 v[DEC_RL];
#pragma unroll
    for (int j = 0; j < DEC_RL; ++j)
      v[j] = i + j * rs.stride < n4 ? r4[i + j * rs.stride] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < DEC_RL; ++j) e = max(e, eff_exp4(v[j]));
  }
  e = warp_max(e);
  if ((threadIdx.x & 31) == 0) atomicMax(&emax[rs.b], e);
  consumer_sync();
}

// Each row's elements quantized (half up) to p bits against emax[row]:
// four int8 mantissas a word into xs (ldx bytes a row), or (P7 true) 7-bit
// mantissas as int16 into ci (K a row).
template <bool P7>
__device__ __forceinline__ void quantize_row_groups(const float* src, int B, int K, int p, const int* emax,
                                    int8_t* xs, int ldx, int16_t* ci) {
  const RowShare rs = row_share(B);
  const float4* r4 = reinterpret_cast<const float4*>(src + (size_t)rs.b * K);
  const int n4 = K / 4, e = emax[rs.b];
  for (int i = rs.i0; i < n4; i += DEC_RL * rs.stride) {
    float4 v[DEC_RL];
#pragma unroll
    for (int j = 0; j < DEC_RL; ++j)
      if (i + j * rs.stride < n4) v[j] = r4[i + j * rs.stride];
#pragma unroll
    for (int j = 0; j < DEC_RL; ++j) {
      const int k = 4 * (i + j * rs.stride);
      if (k >= K) continue;
      const int q0 = quantize_one(v[j].x, 0u, e, p, false);
      const int q1 = quantize_one(v[j].y, 0u, e, p, false);
      const int q2 = quantize_one(v[j].z, 0u, e, p, false);
      const int q3 = quantize_one(v[j].w, 0u, e, p, false);
      if (P7) {
        int16_t* c = ci + rs.b * K + k;
        c[0] = (int16_t)q0;
        c[1] = (int16_t)q1;
        c[2] = (int16_t)q2;
        c[3] = (int16_t)q3;
      } else {
        *reinterpret_cast<uint32_t*>(xs + rs.b * ldx + k) =
            ((uint32_t)q0 & 0xFFu) | (((uint32_t)q1 & 0xFFu) << 8) |
            (((uint32_t)q2 & 0xFFu) << 16) | (((uint32_t)q3 & 0xFFu) << 24);
      }
    }
  }
}

// Each of the B rows of src (B, K) f32 quantized with its own exponent
// (nearest) into xs; sc[b] = its scale exponent.  Consumer warps.
__device__ __forceinline__ void quantize_rows(const float* src, int B, int K, int p,
                                              int8_t* xs, int ldx, int* sc, int* emax) {
  row_exps(src, B, K, emax);
  quantize_row_groups<false>(src, B, K, p, emax, xs, ldx, nullptr);
  if (threadIdx.x < B) sc[threadIdx.x] = scale_exp(emax[threadIdx.x], p);
  pad_rows(xs, B, K, ldx);
  consumer_sync();
}

// norm (RMS, deterministic) of the B rows of src (B, d) into xs; se[b]:
// the input quantize by all warps, the rest of each row by one.
__device__ __forceinline__ void norm_rows(const float* src, const int* gm, int se_g,
                                          const DecArgs& g, int8_t* xs, int ldx, int16_t* cbuf,
                                          int* se, int* emax) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  row_exps(src, g.B, g.d, emax);
  quantize_row_groups<true>(src, g.B, g.d, 7, emax, nullptr, 0, cbuf);
  consumer_sync();
  // the rest of each row by WARPS / B warps (named barriers 2 + row)
  const int nws = WARPS / g.B, b = warp / nws, part = warp % nws;
  if (b < g.B) {
    const int16_t* c = cbuf + b * g.d;
    int s1 = 0, s2 = 0;
    for (int k = part * 32 + lane; k < g.d; k += 32 * nws) {
      s1 += c[k];
      s2 += c[k] * c[k];
    }
    const RowScales rs = norm_row_tail(emax[b], s1, s2, nullptr, gm, se_g, nullptr, 0, g.nc,
                                       cbuf + b * g.d, xs + b * ldx, nullptr, nullptr, part,
                                       nws, emax + 8 + b * nws, 2 + b);
    if (lane == 0 && part == 0) se[b] = rs.se_row;
  }
  pad_rows(xs, g.B, g.d, ldx);
  consumer_sync();
}

// Weights of this block: groups [lo, hi) of each matrix, in streaming
// order; consumer warp w takes the block's groups w, w + 8, ... of each.
struct DecPlan {
  DecMat mat[4];
  int lo[4], hi[4], base[4];  // base: the ring index of the matrix's first stage
};

__device__ __forceinline__ DecPlan dec_plan(const DecArgs& g) {
  DecPlan P;
  int base = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    P.mat[m] = dec_mat(m, g.d, g.n_ff, g.hq, g.hkv, g.dh, g.kch);
    const long long G = P.mat[m].groups;
    P.lo[m] = (int)(G * blockIdx.x / gridDim.x);
    P.hi[m] = (int)(G * (blockIdx.x + 1) / gridDim.x);
    P.base[m] = base;
    base += (P.hi[m] - P.lo[m]) * P.mat[m].nch;
  }
  return P;
}

// Row r (0-7) of group grp of matrix m: its weight row, or -1 past the end.
// A gate|up group holds gate rows 4 grp + 0..3, then the matching up rows.
__device__ __forceinline__ int dec_row(const DecArgs& g, int m, int grp, int r) {
  if (m == 2) {
    const int j = 4 * grp + (r & 3);
    return j < g.n_ff ? (r < 4 ? j : g.n_ff + j) : -1;
  }
  const int rows = m == 0 ? (g.hq + 2 * g.hkv) * g.dh : g.d;
  const int row = 8 * grp + r;
  return row < rows ? row : -1;
}

// The producer warp: every stage of the block's weights, in order, into
// the ring, from the kernel's first instruction, whatever barrier the
// consumers wait at; one bulk copy a weight row (a lane each), into rows
// padded against bank conflicts.  It keeps at most `inflight` stages
// issued and not landed: enough to keep HBM busy, few enough that the
// consumers' own loads do not queue behind megabytes of weights.  Each
// slot's tag names the stage it was last given, written once the slot is
// free and before its copies.
__device__ __forceinline__ void dec_produce(const DecArgs& g, const DecPlan& P, const DecLayout& L,
                            uint8_t* ring, uint64_t* full, uint64_t* empty,
                            volatile int* tag) {
  const int lane = threadIdx.x & 31;
  const int8_t* w[4] = {g.wqkv, g.wo, g.wgu, g.wd};
  int s = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const DecMat& M = P.mat[m];
    for (int grp = P.lo[m]; grp < P.hi[m]; ++grp) {
      const int row = lane < 8 ? dec_row(g, m, grp, lane) : -1;
      const unsigned valid = __ballot_sync(FULL, row >= 0);
      for (int c = 0; c < M.nch; ++c, ++s) {
        const int slot = s % g.nst;
        const int len = min(M.L, M.K - c * M.L);
        if (s >= g.inflight) {  // the latest issue of its slot: no parity alias
          const int o = s - g.inflight;
          mbar_wait(&full[o % g.nst], (o / g.nst) & 1u);
        }
        mbar_wait(&empty[slot], ((s / g.nst) & 1u) ^ 1u);
        if (lane == 0) {
          tag[slot] = s;
          mbar_expect_tx(&full[slot], __popc(valid) * len);
        }
        __syncwarp();
        if (row >= 0)
          bulk_load(ring + slot * L.slot + lane * L.ldw, w[m] + (size_t)row * M.K + c * M.L,
                    len, &full[slot]);
      }
    }
  }
}

// One consumer warp: group grp of matrix m (the q-th of the block),
// contracted with the B activation rows of xs: c[e] = sum_k act[gid][k] *
// w[row 2 tig + e][k] for lanes gid < B.  A warp may run ahead of the
// others by more than the ring, so it waits on a slot's mbarrier only once
// the slot's tag names its stage: the slot's earlier stages have landed
// then, and the parity it waits on is that of its own stage.
__device__ __forceinline__ void dec_consume(const DecArgs& g, const DecPlan& P,
                                            const DecLayout& L, int m, int q, const int8_t* xs,
                                            const uint8_t* ring, uint64_t* full, uint64_t* empty,
                                            const volatile int* tag, int (&c)[4]) {
  const int lane = threadIdx.x & 31, gid = lane / 4, tig = lane % 4;
  const DecMat& M = P.mat[m];
  // two accumulators, even and odd k32 steps: half the mma dependency chain
  int c2[4] = {0, 0, 0, 0};
  c[0] = c[1] = c[2] = c[3] = 0;
  const int8_t* xr = xs + gid * L.ldx + tig * 4;
  const bool row = gid < g.B;
  for (int ch = 0; ch < M.nch; ++ch) {
    const int s = P.base[m] + q * M.nch + ch, slot = s % g.nst;
    const int koff = ch * M.L, steps = (min(M.L, M.K - koff) + 31) / 32;
    while (tag[slot] != s) __nanosleep(32);
    mbar_wait(&full[slot], (s / g.nst) & 1u);
    const uint8_t* wr = ring + slot * L.slot + gid * L.ldw + tig * 4;
    for (int k0 = 0; k0 < steps; k0 += 4) {
      uint32_t a[4][2], w[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kb = (k0 + j) * 32;
        const bool in = k0 + j < steps;
        a[j][0] = row && in ? *reinterpret_cast<const uint32_t*>(xr + koff + kb) : 0u;
        a[j][1] = row && in ? *reinterpret_cast<const uint32_t*>(xr + koff + kb + 16) : 0u;
        w[j][0] = in ? *reinterpret_cast<const uint32_t*>(wr + kb) : 0u;
        w[j][1] = in ? *reinterpret_cast<const uint32_t*>(wr + kb + 16) : 0u;
      }
      // rows 8-15 of the activation tile are zero: the batch is at most 8
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8_m16n8k32(j & 1 ? c2 : c, a[j][0], 0u, a[j][1], 0u, w[j][0], w[j][1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = (int)((unsigned)c[i] + (unsigned)c2[i]);
}

__device__ __forceinline__ bool dec_visible(int t, int pos, int window) {
  return t <= pos && (window == 0 || pos - t < window);
}

__device__ __forceinline__ float rope_at(const float* v, int i, int dh, const float* cossin) {
  const int h = dh / 2;
  const float rot = i < h ? -v[i + h] : v[i - h];
  return __fmaf_rn(v[i], cossin[i], __fmul_rn(rot, cossin[dh + i]));
}

// The maximum over the 8 consumer warps, through red[0..8), of floats
// (FLOAT) or of ints carried in a float's bits.
template <bool FLOAT>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = FLOAT ? warp_maxf(v) : __int_as_float(warp_max(__float_as_int(v)));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  consumer_sync();
  float r = red[0];
  for (int i = 1; i < WARPS; ++i)
    r = FLOAT ? fmaxf(r, red[i]) : __int_as_float(max(__float_as_int(r), __float_as_int(red[i])));
  consumer_sync();
  return r;
}

// PV of one query row over the visible positions, by the 8 consumer
// warps: lane (rl, wl) of warp w takes the W bytes wl of V rows t_lo + rl
// + 4 rps w, ... (a masked p is 0), four rows in flight; each column's
// int32 partial sums are added into acc (exact in any order).  W = 16
// where dh allows, else 4.
template <int W>
__device__ __forceinline__ void pv_rows(const DecArgs& g, const int8_t* ph, const int8_t* vn,
                                        size_t slice, int* acc) {
  constexpr int NW = W / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int dh = g.dh, pos = g.pos;
  const int cpr = dh / W, rps = 32 / cpr, wl = lane % cpr, rl = lane / cpr;
  const bool on = rl < rps;
  const int t_lo = g.window ? max(0, pos - g.window + 1) : 0;
  int a[W];
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = 0;
  for (int t0 = t_lo + 4 * rps * warp; t0 <= pos; t0 += 4 * rps * WARPS) {
    uint32_t v[4][NW];
    int pp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + rl + j * rps;
      const bool ok = on && t <= pos;
      const int8_t* src = (t == pos ? vn : g.vm + (slice + t) * dh) + W * wl;
      if constexpr (NW == 4) {
        const uint4 q = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
        v[j][0] = q.x;
        v[j][1] = q.y;
        v[j][2] = q.z;
        v[j][3] = q.w;
      } else {
        v[j][0] = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      }
      pp[j] = ok ? ph[t] : 0;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < NW; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[4 * q + c] += pp[j] * (int)(int8_t)(v[j][q] >> (8 * c));
  }
  if (on)
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (a[i] != 0) atomicAdd(&acc[W * wl + i], a[i]);
}

// Stage 3 for one (batch row b, KV head h), by the 8 consumer warps: the
// unit's rows loaded; the fresh K (roped) and V rows quantized per row (the
// cache's rule; warp 0) while the query group is roped and quantized with
// one exponent (warp 1); the int8 scores over the band; per query row the
// softmax with the reference's Cephes exp and windowed sum order, the
// V-row exponents folded into p, p quantized with one exponent; int8 PV.
// st: thread 0's clock at each step, or null.
__device__ __forceinline__ void attention_unit(const DecArgs& g, int b, int h, char* ws,
                                               long long* st) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int dh = g.dh, T = g.T, pos = g.pos, p = g.p;
  const int gs = g.hq / g.hkv, dhw = dh / 4;
  const int nq = g.hq * dh, nk = g.hkv * dh, nqkv = nq + 2 * nk;
  const AttLayout A = att_layout(gs, dh, T);
  float* fq = reinterpret_cast<float*>(ws + A.fq);  // gs x dh, then K, V, rope rows
  float* fk = fq + gs * dh;
  float* fv = fk + dh;
  float* cs = fv + dh;
  int* sek = reinterpret_cast<int*>(ws + A.sek);    // T, then sev: T
  int* sev = sek + T;
  float* sf = reinterpret_cast<float*>(ws + A.sf);  // gs x T
  int* acc = reinterpret_cast<int*>(ws + A.acc);    // gs x dh
  float* red = reinterpret_cast<float*>(ws + A.red);
  int* qw = reinterpret_cast<int*>(ws + A.qb);      // gs x dhw
  int8_t* qb = reinterpret_cast<int8_t*>(qw);
  int8_t* kn = qb + gs * dh;                        // dh
  int8_t* vn = kn + dh;                             // dh
  int8_t* ph = reinterpret_cast<int8_t*>(ws + A.ph);  // gs x T
  int* erow = reinterpret_cast<int*>(ws + A.erow);    // gs
  int* shared_int = reinterpret_cast<int*>(red + 40);  // eq, and the sum's windows
  const float* row = g.qkv + (size_t)b * nqkv;
  const int u = b * g.hkv + h;
  const size_t slice = (size_t)u * T;

  for (int i = tid; i < (gs + 4) * dh; i += THREADS) {
    const int r = i / dh, c = i % dh;
    fq[i] = r < gs ? row[(h * gs + r) * dh + c]
                   : r == gs ? row[nq + h * dh + c]
                             : r == gs + 1 ? row[nq + nk + h * dh + c] : g.cossin[i - (gs + 2) * dh];
  }
  for (int t = tid; t < T; t += THREADS) {
    sek[t] = scale_exp(g.ke[slice + t], p);
    sev[t] = scale_exp(g.ve[slice + t], p);
  }
  for (int i = tid; i < gs * dh; i += THREADS) acc[i] = 0;
  consumer_sync();
  if (st != nullptr && tid == 0) st[10] = clock64();

  if (warp == 0) {  // fresh K (roped) and V rows, quantized per row
    int ek = 1, ev = 1;
    for (int i = lane; i < dh; i += 32) {
      ek = max(ek, eff_exp(rope_at(fk, i, dh, cs)));
      ev = max(ev, eff_exp(fv[i]));
    }
    ek = warp_max(ek);
    ev = warp_max(ev);
    for (int i = lane; i < dh; i += 32) {
      const int8_t kq = (int8_t)quantize_one(rope_at(fk, i, dh, cs), 0u, ek, p, false);
      const int8_t vq = (int8_t)quantize_one(fv[i], 0u, ev, p, false);
      kn[i] = kq;
      vn[i] = vq;
      g.k_new[(size_t)u * dh + i] = kq;
      g.v_new[(size_t)u * dh + i] = vq;
    }
    if (lane == 0) {
      g.ek_new[u] = ek;
      g.ev_new[u] = ev;
      sek[pos] = scale_exp(ek, p);
      sev[pos] = scale_exp(ev, p);
    }
  } else if (warp == 1) {  // the query group (gs heads), roped, one exponent
    int eq = 1;
    for (int i = lane; i < gs * dh; i += 32)
      eq = max(eq, eff_exp(rope_at(fq + (i / dh) * dh, i % dh, dh, cs)));
    eq = warp_max(eq);
    for (int i = lane; i < gs * dh; i += 32)
      qb[i] = (int8_t)quantize_one(rope_at(fq + (i / dh) * dh, i % dh, dh, cs), 0u, eq, p, false);
    if (lane == 0) shared_int[0] = eq;
  }
  consumer_sync();
  if (st != nullptr && tid == 0) st[11] = clock64();

  // scores over the band, masked to NEG: thread t's K row (dh <= 128, 32
  // words at most) loaded at once
  const int sq = scale_exp(shared_int[0], p);
  for (int t = tid; t < T; t += THREADS) {
    const bool vis = dec_visible(t, pos, g.window);
    const uint32_t* kr = reinterpret_cast<const uint32_t*>(t == pos ? kn : g.km + (slice + t) * dh);
    uint32_t kw[32];
#pragma unroll
    for (int w = 0; w < 32; ++w) kw[w] = vis && w < dhw ? kr[w] : 0u;
    for (int r = 0; r < gs; ++r) {
      int a = 0;
#pragma unroll
      for (int w = 0; w < 32; ++w)
        if (w < dhw) a = __dp4a(qw[r * dhw + w], (int)kw[w], a);
      sf[r * T + t] = vis ? __fmul_rn(__int2float_rn(a), pow2f(sq + sek[t])) : NEG;
    }
  }
  consumer_sync();
  if (st != nullptr && tid == 0) st[12] = clock64();

  // softmax, V-exponent fold and p quantization, row by row
  const int nwin = T <= 32 ? 1 : (T + 31) / 32;
  const int before = T <= 32 ? 0 : (nwin * 32 - T) / 2;
  float* win = red + 8;  // the window sums (nwin <= 32)
  for (int r = 0; r < gs; ++r) {
    float* s = sf + r * T;
    float mx = NEG;
    for (int t = tid; t < T; t += THREADS) mx = fmaxf(mx, s[t]);
    mx = block_max<true>(mx, red);
    for (int t = tid; t < T; t += THREADS) s[t] = repro::cephes_expf(__fsub_rn(s[t], mx));
    consumer_sync();
    // the reference's order: windows of 32 (the padding split before and
    // after), each summed in index order, then the window sums in order
    if (tid < nwin) {
      float part = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int t = tid * 32 + i - before;
        if (t >= 0 && t < T) part = __fadd_rn(part, s[t]);
      }
      win[tid] = part;
    }
    consumer_sync();
    float tot = 0.0f;
    for (int w = 0; w < nwin; ++w) tot = __fadd_rn(tot, win[w]);
    int e = 1;
    for (int t = tid; t < T; t += THREADS) {
      const float pn = dec_visible(t, pos, g.window) ? __fdiv_rn(s[t], tot) : 0.0f;
      const float p2 = __fmul_rn(pn, pow2f(sev[t]));
      s[t] = p2;
      e = max(e, eff_exp(p2));
    }
    e = __float_as_int(block_max<false>(__int_as_float(e), red));
    for (int t = tid; t < T; t += THREADS) ph[r * T + t] = (int8_t)quantize_one(s[t], 0u, e, p, false);
    if (tid == 0) erow[r] = e;
    consumer_sync();
  }
  if (st != nullptr && tid == 0) st[13] = clock64();

  // PV over the visible positions, then the rows scaled by their exponents
  for (int r = 0; r < gs; ++r) {
    if (dh % 16 == 0)
      pv_rows<16>(g, ph + r * T, vn, slice, acc + r * dh);
    else
      pv_rows<4>(g, ph + r * T, vn, slice, acc + r * dh);
  }
  consumer_sync();
  for (int i = tid; i < gs * dh; i += THREADS)
    g.attn[(size_t)b * nq + h * gs * dh + i] =
        __fmul_rn(__int2float_rn(acc[i]), pow2f(scale_exp(erow[i / dh], p)));
  consumer_sync();
  if (st != nullptr && tid == 0) st[14] = clock64();
}

__global__ void __launch_bounds__(DEC_THREADS, 1) decode_block_kernel(DecArgs g) {
  extern __shared__ __align__(128) uint8_t dsm[];
  const DecLayout L = dec_layout(g.B, g.d, g.n_ff, g.hq, g.hkv, g.dh, g.T, g.nst, g.kch);
  const DecPlan P = dec_plan(g);
  uint8_t* ring = dsm + L.ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(dsm + L.bars);
  uint64_t* empty = full + g.nst;
  volatile int* tag = reinterpret_cast<volatile int*>(empty + g.nst);
  int8_t* xs = reinterpret_cast<int8_t*>(dsm + L.xs);
  int16_t* cbuf = reinterpret_cast<int16_t*>(dsm + L.y);
  int* rsc = reinterpret_cast<int*>(dsm + L.rows);
  int* emax = rsc + 8;
  const int warp = threadIdx.x / 32, gid = (threadIdx.x & 31) / 4, tig = threadIdx.x % 4;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.nst; ++s) {
      tag[s] = -1;
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == WARPS) {  // the producer never meets the consumers again
    dec_produce(g, P, L, ring, full, empty, tag);
    if (g.stamps != nullptr && threadIdx.x == WARPS * 32)
      g.stamps[blockIdx.x * DEC_STAMPS + 19] = clock64();
    return;
  }
  stamp(g, 0);
  const int B = g.B, d = g.d, n_ff = g.n_ff;
  const int nq = g.hq * g.dh, nqkv = nq + 2 * g.hkv * g.dh;
  int c[4];

  // 1-2: norm1, QKV
  norm_rows(g.x, g.g1m, g.se_g1, g, xs, L.ldx, cbuf, rsc, emax);
  stamp(g, 15);
  for (int q = warp; q < P.hi[0] - P.lo[0]; q += WARPS) {
    dec_consume(g, P, L, 0, q, xs, ring, full, empty, tag, c);
    const int n0 = 8 * (P.lo[0] + q) + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (gid < B && n0 + e < nqkv)
        g.qkv[(size_t)gid * nqkv + n0 + e] =
            __fmul_rn(__int2float_rn(c[e]), pow2f(rsc[gid] + g.se_qkv[n0 + e]));
  }
  stamp(g, 1);
  grid_barrier(g, 1);
  stamp(g, 2);

  // 3: attention, a (batch row, KV head) at a time by the block's 8 warps
  char* ws = reinterpret_cast<char*>(dsm + L.y);
  long long* st = g.stamps != nullptr ? g.stamps + blockIdx.x * DEC_STAMPS : nullptr;
  for (int u = blockIdx.x; u < B * g.hkv; u += gridDim.x)
    attention_unit(g, u / g.hkv, u % g.hkv, ws, u == (int)blockIdx.x ? st : nullptr);
  stamp(g, 3);
  grid_barrier(g, 2);
  stamp(g, 4);

  // 4: out-projection + residual
  quantize_rows(g.attn, B, nq, g.p, xs, L.ldx, rsc, emax);
  stamp(g, 16);
  for (int q = warp; q < P.hi[1] - P.lo[1]; q += WARPS) {
    dec_consume(g, P, L, 1, q, xs, ring, full, empty, tag, c);
    const int n0 = 8 * (P.lo[1] + q) + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (gid < B && n0 + e < d) {
        const size_t i = (size_t)gid * d + n0 + e;
        const float o = __fmul_rn(__int2float_rn(c[e]), pow2f(rsc[gid] + g.se_o[n0 + e]));
        g.h2[i] = __fadd_rn(g.x[i], o);
      }
  }
  stamp(g, 5);
  grid_barrier(g, 3);
  stamp(g, 6);

  // 5: norm2, gate|up with the SiLU-GLU: lanes tig 0-1 hold gate columns
  // j, tig 2-3 the up columns of the same j
  norm_rows(g.h2, g.g2m, g.se_g2, g, xs, L.ldx, cbuf, rsc, emax);
  stamp(g, 17);
  for (int q = warp; q < P.hi[2] - P.lo[2]; q += WARPS) {
    dec_consume(g, P, L, 2, q, xs, ring, full, empty, tag, c);
    const int j0 = 4 * (P.lo[2] + q) + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int up = __shfl_xor_sync(FULL, c[e], 2);
      if (gid < B && tig < 2 && j0 + e < n_ff) {
        const int j = j0 + e;
        const float gt = __fmul_rn(__int2float_rn(c[e]), pow2f(rsc[gid] + g.se_gu[j]));
        const float uv = __fmul_rn(__int2float_rn(up), pow2f(rsc[gid] + g.se_gu[n_ff + j]));
        g.act[(size_t)gid * n_ff + j] = repro::silu_glu(gt, uv);
      }
    }
  }
  stamp(g, 7);
  grid_barrier(g, 4);
  stamp(g, 8);

  // 6: down projection + residual
  quantize_rows(g.act, B, n_ff, g.p, xs, L.ldx, rsc, emax);
  stamp(g, 18);
  for (int q = warp; q < P.hi[3] - P.lo[3]; q += WARPS) {
    dec_consume(g, P, L, 3, q, xs, ring, full, empty, tag, c);
    const int n0 = 8 * (P.lo[3] + q) + 2 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (gid < B && n0 + e < d) {
        const size_t i = (size_t)gid * d + n0 + e;
        const float dn = __fmul_rn(__int2float_rn(c[e]), pow2f(rsc[gid] + g.se_d[n0 + e]));
        g.x_out[i] = __fadd_rn(g.h2[i], dn);
      }
  }
  stamp(g, 9);
}

}  // namespace

extern "C" {

// norm_gemm: x (M,K) f32 [+ rin, rout (M,K) u32], gm (K) int32, se_g int32
// scalar, bm (K) int32 + se_b scalar or null, w (N,K) int8, se_w (N) int32
// -> y (M,N) f32, xq (M,K) int8, meta (M,128) int32, c (M,K) int8.
int repro_norm_gemm(const void* x, const void* rin, const void* rout, const void* gm,
                    const void* se_g, const void* bm, const void* se_b, const void* w,
                    const void* se_w, void* y, void* xq, void* meta, void* c, int M,
                    int N, int K, int p, int eps_m, int eps_e, int center, int j,
                    int inv_q, int bm_rows, int stochastic, void* stream) {
  const NormGemmArgs g{static_cast<const float*>(x),
                       stochastic ? static_cast<const uint32_t*>(rin) : nullptr,
                       stochastic ? static_cast<const uint32_t*>(rout) : nullptr,
                       static_cast<const int*>(gm), static_cast<const int*>(se_g),
                       static_cast<const int*>(bm), static_cast<const int*>(se_b),
                       static_cast<const int8_t*>(w), static_cast<const int*>(se_w),
                       static_cast<float*>(y), static_cast<int8_t*>(xq),
                       static_cast<int*>(meta), static_cast<int8_t*>(c), M, N, K,
                       NormCfg{K, p, eps_m, eps_e, center, j, inv_q}};
  auto s = static_cast<cudaStream_t>(stream);
  if (bm_rows == 64) return (int)dispatch_norm_gemm<4>(g, s);
  if (bm_rows == 32) return (int)dispatch_norm_gemm<2>(g, s);
  if (bm_rows == 16) return (int)dispatch_norm_gemm<1>(g, s);
  return (int)cudaErrorInvalidValue;
}

// norm_rows: the norm pass of norm_gemm (the arguments of repro_norm_gemm
// without the weight and y): xq, meta and c, one row a block.
int repro_norm_rows(const void* x, const void* rin, const void* rout, const void* gm,
                    const void* se_g, const void* bm, const void* se_b, void* xq, void* meta,
                    void* c, int M, int K, int p, int eps_m, int eps_e, int center, int j,
                    int inv_q, int stochastic, void* stream) {
  const NormRowsArgs g{static_cast<const float*>(x),
                       stochastic ? static_cast<const uint32_t*>(rin) : nullptr,
                       stochastic ? static_cast<const uint32_t*>(rout) : nullptr,
                       static_cast<const int*>(gm), static_cast<const int*>(se_g),
                       static_cast<const int*>(bm), static_cast<const int*>(se_b),
                       static_cast<int8_t*>(xq), static_cast<int*>(meta),
                       static_cast<int8_t*>(c), M,
                       NormCfg{K, p, eps_m, eps_e, center, j, inv_q}};
  if (K <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int smem = 2 * K;
  cudaError_t err = cudaFuncSetAttribute(
      norm_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = M < 16 * sms ? M : 16 * sms;
  norm_rows_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(g);
  return (int)cudaGetLastError();
}

// decode_block: one decoder layer for one token: one block per SM, every
// block resident (a cooperative launch), nst ring stages of chunks of at
// most kch bytes of K, at most `inflight` of them in flight; bar (5 uint32, zero before the first launch
// on the device), stamps null or DEC_STAMPS int64 per block.
int repro_decode_block(const void* x, const void* wqkv, const void* se_qkv, const void* wo,
                       const void* se_o, const void* wgu, const void* se_gu, const void* wd,
                       const void* se_d, const void* g1m, const void* g2m, const void* km,
                       const void* ke, const void* vm, const void* ve, const void* cossin,
                       void* x_out, void* k_new, void* ek_new, void* v_new, void* ev_new,
                       void* qkv, void* attn, void* h2, void* act, void* bar, void* stamps,
                       int B, int d, int n_ff, int hq, int hkv, int dh, int T, int pos,
                       int window, int p, int eps_m, int eps_e, int se_g1, int se_g2, int j,
                       int inv_q, int nst, int kch, int inflight, int smem_expect,
                       void* stream) {
  DecArgs g{static_cast<const float*>(x),
            static_cast<const int8_t*>(wqkv), static_cast<const int*>(se_qkv),
            static_cast<const int8_t*>(wo), static_cast<const int*>(se_o),
            static_cast<const int8_t*>(wgu), static_cast<const int*>(se_gu),
            static_cast<const int8_t*>(wd), static_cast<const int*>(se_d),
            static_cast<const int*>(g1m), static_cast<const int*>(g2m),
            static_cast<const int8_t*>(km), static_cast<const int*>(ke),
            static_cast<const int8_t*>(vm), static_cast<const int*>(ve),
            static_cast<const float*>(cossin),
            static_cast<float*>(x_out), static_cast<int8_t*>(k_new),
            static_cast<int*>(ek_new), static_cast<int8_t*>(v_new),
            static_cast<int*>(ev_new), static_cast<float*>(qkv),
            static_cast<float*>(attn), static_cast<float*>(h2), static_cast<float*>(act),
            static_cast<unsigned*>(bar), static_cast<long long*>(stamps),
            B, d, n_ff, hq, hkv, dh, T, pos, window, p, se_g1, se_g2, nst, kch, inflight,
            NormCfg{d, p, eps_m, eps_e, 0, j, inv_q}};
  if (B > 8 || nst < 1 || inflight < 1 || kch < 32 || kch % 32 != 0)
    return (int)cudaErrorInvalidValue;
  // the alignment of each load (kernels/fused_chain.py
  // decode_block_misaligned): 16 bytes for the weight rows' bulk copies, x
  // as float4 and the V cache as uint4 (4 where dh % 16 != 0), 4 for the
  // K cache's uint32 rows and the exponents' and rope row's words
  const auto off = [](const void* q, uintptr_t a) {
    return reinterpret_cast<uintptr_t>(q) % a != 0;
  };
  if (off(wqkv, 16) || off(wo, 16) || off(wgu, 16) || off(wd, 16) || off(x, 16) ||
      off(vm, dh % 16 == 0 ? 16 : 4) || off(km, 4) || off(ke, 4) || off(ve, 4) ||
      off(cossin, 4))
    return (int)cudaErrorInvalidValue;
  const int smem = dec_layout(B, d, n_ff, hq, hkv, dh, T, nst, kch).total;
  if (smem != smem_expect) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_block_kernel,
                                                      DEC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)decode_block_kernel, dim3(sms),
                                    dim3(DEC_THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
