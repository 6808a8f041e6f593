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
// norm_gemm.  Grid (row strips of BM = 16*TM rows, groups of column
// tiles).  Each block normalises its strip (one warp per row) and keeps the
// strip's xq mantissas in shared memory, packed four to a word; then it
// walks its column tiles (BN = 64) of the (N, K) int8 weight in 32-wide K
// slices with __dp4a, y = float(acc) * 2^(se_row + se_w[col]).  The blocks
// of the first column group write xq, meta [se_row, e_c, r, e_r, 0...] and
// c.  The TPU kernel keeps the whole weight resident in VMEM; here it
// streams through shared memory from L2 once per strip.  The norm is
// computed again by each column group of a strip (M*K elements per group)
// so that the card is filled at M = 512.  Bounds on the H100: bytes, at
// minicpm-2b's QKV (512 x 2304 -> 6912): x and its two bit streams
// (14.2 MB), the weight (15.9 MB), y (14.2 MB), the residuals (2.6 MB),
// against 2*M*N*K int8 operations (16.3 G, 8 us at 1979 TOP/s).
//
// decode_block.  One cooperative launch per layer over every SM, the
// stages separated by grid barriers (the TPU kernel holds the whole layer
// in VMEM: 61 MB of int8 weights at minicpm-2b do not fit one SM):
//   1  norm1 of the B rows, in every block, into shared memory;
//   2  the QKV GEMV: one warp per weight row (16-byte loads, __dp4a), all B
//      rows at once -> qkv (B, (hq + 2 hkv) dh);                  barrier
//   3  one warp per (batch row, KV head): rope, the fresh K and V rows
//      quantized per row (written out for the caller's append), the query
//      group quantized with one exponent, then decode attention over the
//      cache with the fresh row at pos: int8 scores, the softmax with the
//      reference's Cephes exp and its windowed sum order (fmath.cuh), the
//      V-row exponents folded into p, p quantized per query row, int8 PV
//                                                                  barrier
//   4  the attention rows quantized per row (every block), the out-proj
//      GEMV plus the residual -> h2;                                barrier
//   5  norm2 of h2 (every block), the gate|up GEMV with the SiLU-GLU, one
//      warp computing gate row j and up row j + n_ff together;      barrier
//   6  the activation rows quantized per row (every block), the down GEMV
//      plus the residual -> x_out.
// Every float step is one IEEE operation in the plain version's order (the
// build turns off contraction; the rope's first product is an explicit
// fmaf, as XLA contracts it), so x_out and the fresh rows equal the plain
// version's bit for bit.  Bounds on the H100: bytes: the int8 weights of
// the layer (61.1 MB at minicpm-2b), the cache rows up to pos and their
// exponents, a few B x d float rows: about 0.019 ms a layer.  The GEMVs
// read each weight row once with coalesced 16-byte loads; the tensor cores
// and TMA are later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"
#include "fmath.cuh"

namespace cg = cooperative_groups;

namespace {

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
constexpr int MAXB = 8;         // decode block: rows held in registers
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

// x, rin, rout: the row (rin / rout null: half up); gm, bm: gain and shift
// mantissas (bm null: RMS); ci: int16 scratch of K; xq_s: where the int8
// result goes (shared memory); xq_g, c_g: global residual rows or null.
__device__ RowScales norm_row(const float* x, const uint32_t* rin,
                              const uint32_t* rout, const int* gm, int se_g,
                              const int* bm, int se_b, const NormCfg& nc,
                              int16_t* ci, int8_t* xq_s, int8_t* xq_g,
                              int8_t* c_g) {
  const int lane = threadIdx.x & 31;
  const int K = nc.K;
  const bool stoch = rout != nullptr;
  int e = 1;
  for (int k = lane; k < K; k += 32) e = max(e, eff_exp(x[k]));
  e = warp_max(e);
  int sc = scale_exp(e, 7);
  int s1 = 0, s2 = 0;
  for (int k = lane; k < K; k += 32) {
    const int c = quantize_one(x[k], stoch ? rin[k] : 0u, e, 7, stoch);
    ci[k] = (int16_t)c;
    s1 += c;
    s2 += c * c;
  }
  if (nc.center) {
    s1 = warp_sum(s1);
    const int sh1 = max(bitlen(iabs(s1)) - 15, 0);
    const int mu = wmul(sr_shift(s1, sh1, false, 0u), nc.inv_q);
    const int sub = sr_shift(mu, 6 + nc.j - sh1, false, 0u);
    int amax = 0;
    for (int k = lane; k < K; k += 32) amax = max(amax, iabs(wshl(ci[k], 8) - sub));
    const int shc = max(bitlen(warp_max(amax)) - 7, 0);
    s2 = 0;
    for (int k = lane; k < K; k += 32) {
      const int v = sr_shift(wshl(ci[k], 8) - sub, shc, false, 0u);
      ci[k] = (int16_t)v;
      s2 += v * v;
    }
    sc = sc - 8 + shc;
  }
  if (c_g != nullptr)
    for (int k = lane; k < K; k += 32) c_g[k] = (int8_t)ci[k];
  s2 = warp_sum(s2);
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
  for (int k = lane; k < K; k += 32)
    amax = max(amax, iabs(wmul(sr_shift(wmul(ci[k], r), 8, false, 0u), gm[k])));
  amax = warp_max(amax);
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
    for (int k = lane; k < K; k += 32) amax = max(amax, iabs(o_at(k)));
    amax = warp_max(amax);
  }
  const int shq = max(bitlen(amax) - nc.p, 0);
  const int lim = (1 << nc.p) - 1;
  for (int k = lane; k < K; k += 32) {
    int q = sr_shift(o_at(k), shq, stoch, stoch ? rout[k] : 0u);
    q = q < -lim ? -lim : (q > lim ? lim : q);
    xq_s[k] = (int8_t)q;
    if (xq_g != nullptr) xq_g[k] = (int8_t)q;
  }
  return RowScales{e_o + shq, sc, r, e_r};
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

template <int TM>
cudaError_t dispatch_norm_gemm(const NormGemmArgs& g, cudaStream_t stream) {
  return g.K % 4 == 0 ? launch_norm_gemm<TM, true>(g, stream)
                      : launch_norm_gemm<TM, false>(g, stream);
}

// ---------------------------------------------------------------------------
// decode_block
// ---------------------------------------------------------------------------

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
  int B, d, n_ff, hq, hkv, dh, T, pos, window, p, se_g1, se_g2;
  NormCfg nc;
};

__host__ __device__ __forceinline__ int align16(int v) { return (v + 15) & ~15; }

__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

struct DecLayout {
  int widest, xs, cbuf, rows, per_warp, total;
};

__host__ __device__ __forceinline__ DecLayout dec_layout(int B, int d, int n_ff, int hq,
                                                         int hkv, int dh, int T) {
  const int gs = hq / hkv;
  DecLayout L;
  L.widest = imax(imax(d, hq * dh), n_ff);
  L.xs = 0;
  L.cbuf = align16(B * L.widest);
  L.rows = L.cbuf + align16(2 * B * d);
  // per warp: the query group's words, the fresh K and V rows, the
  // group's scores and int8 p over T, and each query row's p exponent
  L.per_warp = align16(gs * dh + 2 * dh + 5 * gs * T) + align16(4 * gs);
  L.total = L.rows + align16(16 * B) + WARPS * L.per_warp;
  return L;
}

// Each of the B rows of src (B, K) f32 quantized with its own exponent
// (nearest) into xs; sc[b] = its scale exponent.  Every block, all warps.
__device__ void quantize_rows(const float* src, int B, int K, int p, int8_t* xs, int* sc) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int b = warp; b < B; b += WARPS) {
    const float* row = src + (size_t)b * K;
    int e = 1;
    for (int k = lane; k < K; k += 32) e = max(e, eff_exp(row[k]));
    e = warp_max(e);
    for (int k = lane; k < K; k += 32) xs[b * K + k] = (int8_t)quantize_one(row[k], 0u, e, p, false);
    if (lane == 0) sc[b] = scale_exp(e, p);
  }
  __syncthreads();
}

// norm (RMS, deterministic) of the B rows of src (B, d) into xs; se[b].
__device__ void norm_rows(const float* src, const int* gm, int se_g, const DecArgs& g,
                          int8_t* xs, int16_t* cbuf, int* se) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int b = warp; b < g.B; b += WARPS) {
    const RowScales rs = norm_row(src + (size_t)b * g.d, nullptr, nullptr, gm, se_g, nullptr,
                                  0, g.nc, cbuf + b * g.d, xs + b * g.d, nullptr, nullptr);
    if (lane == 0) se[b] = rs.se_row;
  }
  __syncthreads();
}

// acc[b] = sum_k w_row[k] * xs[b, k] over K (K % 16 == 0), by one warp.
__device__ __forceinline__ void gemv_row(const int8_t* __restrict__ w_row, const int8_t* xs,
                                         int K, int B, int acc[MAXB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0;
  const int4* wv4 = reinterpret_cast<const int4*>(w_row);
  for (int c = lane; c < K / 16; c += 32) {
    const int4 wv = __ldg(wv4 + c);
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b < B) {
        const int4 xv = reinterpret_cast<const int4*>(xs + b * K)[c];
        acc[b] = __dp4a(wv.x, xv.x, acc[b]);
        acc[b] = __dp4a(wv.y, xv.y, acc[b]);
        acc[b] = __dp4a(wv.z, xv.z, acc[b]);
        acc[b] = __dp4a(wv.w, xv.w, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = warp_sum(acc[b]);
}

__device__ __forceinline__ float rope_at(const float* v, int i, int dh, const float* cossin) {
  const int h = dh / 2;
  const float rot = i < h ? -v[i + h] : v[i - h];
  return __fmaf_rn(v[i], cossin[i], __fmul_rn(rot, cossin[dh + i]));
}

__device__ __forceinline__ bool dec_visible(int t, int pos, int window) {
  return t <= pos && (window == 0 || pos - t < window);
}

// Stage 3 for one (batch row b, KV head h), by one warp.
__device__ void attention_unit(const DecArgs& g, int b, int h, char* ws) {
  const int lane = threadIdx.x & 31;
  const int dh = g.dh, T = g.T, pos = g.pos, p = g.p;
  const int gs = g.hq / g.hkv, dhw = dh / 4;
  const int nq = g.hq * dh, nk = g.hkv * dh, nqkv = nq + 2 * nk;
  int* qw = reinterpret_cast<int*>(ws);                       // gs x dhw
  int8_t* kn = reinterpret_cast<int8_t*>(ws + gs * dh);       // dh
  int8_t* vn = kn + dh;                                       // dh
  float* sf = reinterpret_cast<float*>(vn + dh);              // gs x T
  int8_t* ph = reinterpret_cast<int8_t*>(sf + gs * T);        // gs x T
  int* erow = reinterpret_cast<int*>(ws + align16(gs * dh + 2 * dh + 5 * gs * T));
  const float* row = g.qkv + (size_t)b * nqkv;
  const int u = b * g.hkv + h;

  // fresh K (roped) and V rows, quantized per row: the cache's rule
  int ek = 1, ev = 1;
  for (int i = lane; i < dh; i += 32) {
    ek = max(ek, eff_exp(rope_at(row + nq + h * dh, i, dh, g.cossin)));
    ev = max(ev, eff_exp(row[nq + nk + h * dh + i]));
  }
  ek = warp_max(ek);
  ev = warp_max(ev);
  for (int i = lane; i < dh; i += 32) {
    const int8_t kq = (int8_t)quantize_one(rope_at(row + nq + h * dh, i, dh, g.cossin), 0u, ek, p, false);
    const int8_t vq = (int8_t)quantize_one(row[nq + nk + h * dh + i], 0u, ev, p, false);
    kn[i] = kq;
    vn[i] = vq;
    g.k_new[(size_t)u * dh + i] = kq;
    g.v_new[(size_t)u * dh + i] = vq;
  }
  if (lane == 0) {
    g.ek_new[u] = ek;
    g.ev_new[u] = ev;
  }
  // the query group (gs heads), roped, one exponent
  const float* qrow = row + h * gs * dh;
  int eq = 1;
  for (int i = lane; i < gs * dh; i += 32)
    eq = max(eq, eff_exp(rope_at(qrow + (i / dh) * dh, i % dh, dh, g.cossin)));
  eq = warp_max(eq);
  int8_t* qb = reinterpret_cast<int8_t*>(qw);
  for (int i = lane; i < gs * dh; i += 32)
    qb[i] = (int8_t)quantize_one(rope_at(qrow + (i / dh) * dh, i % dh, dh, g.cossin), 0u, eq, p, false);
  __syncwarp();

  // scores over the band, masked to NEG
  const size_t slice = (size_t)u * T;
  const int sq = scale_exp(eq, p);
  for (int t = lane; t < T; t += 32) {
    const bool vis = dec_visible(t, pos, g.window);
    const int* kr = reinterpret_cast<const int*>(t == pos ? kn : g.km + (slice + t) * dh);
    const int se_k = scale_exp(t == pos ? ek : g.ke[slice + t], p);
    for (int r = 0; r < gs; ++r) {
      int acc = 0;
      if (vis)
        for (int w = 0; w < dhw; ++w) acc = __dp4a(qw[r * dhw + w], kr[w], acc);
      sf[r * T + t] = vis ? __fmul_rn(__int2float_rn(acc), pow2f(sq + se_k)) : NEG;
    }
  }
  __syncwarp();
  // softmax, V-exponent fold and p quantization, row by row
  const int nwin = T <= 32 ? 1 : (T + 31) / 32;
  const int before = T <= 32 ? 0 : (nwin * 32 - T) / 2;
  for (int r = 0; r < gs; ++r) {
    float* s = sf + r * T;
    float mx = NEG;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, s[t]);
    mx = warp_maxf(mx);
    for (int t = lane; t < T; t += 32) s[t] = repro::cephes_expf(__fsub_rn(s[t], mx));
    __syncwarp();
    // the reference's order: windows of 32 (the padding split before and
    // after), each summed in index order, then the window sums in order
    float part = 0.0f;
    if (lane < nwin)
      for (int i = 0; i < 32; ++i) {
        const int t = lane * 32 + i - before;
        if (t >= 0 && t < T) part = __fadd_rn(part, s[t]);
      }
    float tot = 0.0f;
    for (int w = 0; w < nwin; ++w) tot = __fadd_rn(tot, __shfl_sync(FULL, part, w));
    int e = 1;
    for (int t = lane; t < T; t += 32) {
      const float pn = dec_visible(t, pos, g.window) ? __fdiv_rn(s[t], tot) : 0.0f;
      const int sev = scale_exp(t == pos ? ev : g.ve[slice + t], p);
      const float p2 = __fmul_rn(pn, pow2f(sev));
      s[t] = p2;
      e = max(e, eff_exp(p2));
    }
    e = warp_max(e);
    for (int t = lane; t < T; t += 32) ph[r * T + t] = (int8_t)quantize_one(s[t], 0u, e, p, false);
    if (lane == 0) erow[r] = e;
    __syncwarp();
  }
  // PV over the visible positions (a masked p is 0)
  const int t_lo = g.window ? max(0, pos - g.window + 1) : 0;
  for (int i = lane; i < gs * dh; i += 32) {
    const int r = i / dh, c = i % dh;
    int acc = 0;
    for (int t = t_lo; t <= pos; ++t) {
      const int v = t == pos ? vn[c] : g.vm[(slice + t) * dh + c];
      acc += (int)ph[r * T + t] * v;
    }
    g.attn[(size_t)b * nq + (h * gs + r) * dh + c] =
        __fmul_rn(__int2float_rn(acc), pow2f(scale_exp(erow[r], p)));
  }
  __syncwarp();
}

__global__ void __launch_bounds__(THREADS) decode_block_kernel(DecArgs g) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) char dsm[];
  const DecLayout L = dec_layout(g.B, g.d, g.n_ff, g.hq, g.hkv, g.dh, g.T);
  int8_t* xs = reinterpret_cast<int8_t*>(dsm + L.xs);
  int16_t* cbuf = reinterpret_cast<int16_t*>(dsm + L.cbuf);
  int* rsc = reinterpret_cast<int*>(dsm + L.rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + warp, nw = gridDim.x * WARPS;
  const int B = g.B, d = g.d, n_ff = g.n_ff;
  const int nq = g.hq * g.dh, nqkv = nq + 2 * g.hkv * g.dh;
  int acc[MAXB], acc2[MAXB];

  // 1-2: norm1, QKV GEMV
  norm_rows(g.x, g.g1m, g.se_g1, g, xs, cbuf, rsc);
  for (int n = gw; n < nqkv; n += nw) {
    gemv_row(g.wqkv + (size_t)n * d, xs, d, B, acc);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B && lane == b)
        g.qkv[(size_t)b * nqkv + n] = __fmul_rn(__int2float_rn(acc[b]), pow2f(rsc[b] + g.se_qkv[n]));
  }
  grid.sync();

  // 3: attention, one warp per (batch row, KV head)
  char* ws = dsm + L.rows + align16(16 * B) + warp * L.per_warp;
  for (int u = gw; u < B * g.hkv; u += nw) attention_unit(g, u / g.hkv, u % g.hkv, ws);
  grid.sync();

  // 4: out-projection + residual
  quantize_rows(g.attn, B, nq, g.p, xs, rsc);
  for (int n = gw; n < d; n += nw) {
    gemv_row(g.wo + (size_t)n * nq, xs, nq, B, acc);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B && lane == b) {
        const float o = __fmul_rn(__int2float_rn(acc[b]), pow2f(rsc[b] + g.se_o[n]));
        g.h2[(size_t)b * d + n] = __fadd_rn(g.x[(size_t)b * d + n], o);
      }
  }
  grid.sync();

  // 5: norm2, gate|up GEMV with SiLU-GLU
  norm_rows(g.h2, g.g2m, g.se_g2, g, xs, cbuf, rsc);
  for (int j = gw; j < n_ff; j += nw) {
    gemv_row(g.wgu + (size_t)j * d, xs, d, B, acc);
    gemv_row(g.wgu + (size_t)(n_ff + j) * d, xs, d, B, acc2);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B && lane == b) {
        const float gt = __fmul_rn(__int2float_rn(acc[b]), pow2f(rsc[b] + g.se_gu[j]));
        const float up = __fmul_rn(__int2float_rn(acc2[b]), pow2f(rsc[b] + g.se_gu[n_ff + j]));
        g.act[(size_t)b * n_ff + j] = repro::silu_glu(gt, up);
      }
  }
  grid.sync();

  // 6: down projection + residual
  quantize_rows(g.act, B, n_ff, g.p, xs, rsc);
  for (int n = gw; n < d; n += nw) {
    gemv_row(g.wd + (size_t)n * n_ff, xs, n_ff, B, acc);
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
      if (b < B && lane == b) {
        const float dn = __fmul_rn(__int2float_rn(acc[b]), pow2f(rsc[b] + g.se_d[n]));
        g.x_out[(size_t)b * d + n] = __fadd_rn(g.h2[(size_t)b * d + n], dn);
      }
  }
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

// decode_block: one decoder layer for one token (cooperative launch).
int repro_decode_block(const void* x, const void* wqkv, const void* se_qkv, const void* wo,
                       const void* se_o, const void* wgu, const void* se_gu, const void* wd,
                       const void* se_d, const void* g1m, const void* g2m, const void* km,
                       const void* ke, const void* vm, const void* ve, const void* cossin,
                       void* x_out, void* k_new, void* ek_new, void* v_new, void* ev_new,
                       void* qkv, void* attn, void* h2, void* act, int B, int d, int n_ff,
                       int hq, int hkv, int dh, int T, int pos, int window, int p, int eps_m,
                       int eps_e, int se_g1, int se_g2, int j, int inv_q, int smem_expect,
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
            B, d, n_ff, hq, hkv, dh, T, pos, window, p, se_g1, se_g2,
            NormCfg{d, p, eps_m, eps_e, 0, j, inv_q}};
  if (B > MAXB) return (int)cudaErrorInvalidValue;
  const int smem = dec_layout(B, d, n_ff, hq, hkv, dh, T).total;
  if (smem != smem_expect) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      decode_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_block_kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int blocks = sms * (per_sm < 2 ? per_sm : 2);
  void* args[] = {&g};
  err = cudaLaunchCooperativeKernel((const void*)decode_block_kernel, dim3(blocks),
                                    dim3(THREADS), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
