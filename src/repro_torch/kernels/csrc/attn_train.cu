// Fused integer attention, forward and backward, for Hopper (sm_90a).
//
// Replaces fused_attn_fwd_pallas and fused_attn_bwd_pallas of
// src/repro/kernels/fused_attention.py (the qflow training path).  Operands
// are per-tensor int8 BFP mantissas quantized once by the caller: the
// grouped query qm (BH, GS, D) (row r sits at position r % s + q_off), the
// keys and values km / vm (BH, T, D), and in the backward the quantized
// output gradient gm (BH, GS, D).  Every exponent is one int32 device
// scalar; rounding bits are streamed in (uint32, one per (row, position),
// drawn by the caller on the unpadded (BH, GS, T) shape).  The KV axis is
// cut into blocks of bt positions (kernels.dispatch.attn_block_t); bt is
// part of the numerics, the query strip BQ is not (a fully masked block is
// an exact no-op, so skipping it changes nothing).
//
// Forward, per (slice, strip of BQ query rows), over the KV blocks j in
// order: s = int32 dot(q, k_j) * 2^(sq+sk), masked to -1e30; the online
// softmax m' = max(m, max_t s), alpha = exp(m - m'), p = exp(s - m');
// p quantized with one exponent per row per block against the bits;
// acc = fma(acc, alpha, int32 dot(p^, v_j) * 2^(se_row + sv)),
// l = fma(l, alpha, sum_t p); finally y = acc / max(l, 1e-30).
//
// Backward (the A.2 integer backward), probabilities recomputed from the
// saved row stats (m, l): pn = exp(s - m) / max(l, 1e-30),
// dp = int32 dot(g, v_j) * 2^(sg+sv), ds = pn * (dp - delta); pn and ds
// are quantized with ONE exponent per (slice, block) tile, the largest
// effective exponent over all GS rows; then dv_j = pn^T g, dq += ds^ k_j
// (in block order), dk_j = ds^T q, every product an int8 dot.
//
// Float order.  The float ops are those of the reference on the CPU (XLA):
// exp is the Cephes polynomial with fused multiply-adds (core/fmath.py),
// the row sum of p over bt positions runs in windows of 32 (each summed in
// index order, then the window sums in order), and the two online-softmax
// updates are single fmaf.  Everything else is a single IEEE operation
// (the build turns off contraction and fast math), and every integer dot
// is exact, so the kernels equal the plain versions of
// kernels/fused_attention.py bit for bit.
//
// Design.  The TPU kernels keep all of T (forward) or all of GS (backward)
// resident in VMEM.  Here the (bt, D) key and value blocks stream through
// shared memory, so the forward has no limit on T.  The backward's tile
// exponent spans all GS rows of a block, more than one block's shared
// memory at long sequence, so it needs a reduction across blocks before it
// can quantize.
//
// The forward has two routes (kernels/fused_attention.py attn_fwd_variant):
// wgmma (D of 32, 64, 96 or 128, 16-byte aligned operands): a block of 64
// query rows, four warpgroups splitting each chunk of 128 KV positions (32
// each: S on wgmma.m64n32k32, its exps, quantize and row sums) and PV's
// columns (D / 4 each, from P^ staged in shared memory); the row maxima,
// exponents and window sums meet in shared memory.  A thread holds 16
// scores of a chunk, not the 64 of one warpgroup a tile: at the qwen2
// training slice the time goes to each thread's exps and quantizes, one
// after another, not to the tensor cores.
// __dp4a (every other head dim): 16 query rows a block, the integer dots
// on words packed in shared memory.
//
// The backward has two routes (kernels/fused_attention.py
// attn_bwd_variant):
//
// wgmma (D of 32, 64, 96 or 128, 16-byte aligned operands): two launches,
// no memset, every product on wgmma.m64nNk32.s32.s8.s8 from swizzled
// K-major tiles (16-byte asynchronous copies; the transposed ones by byte
// permutes of 4 x 4 blocks in shared memory).  A block takes a row tile of
// 128 query rows and one half, 64 positions, of every chunk of 128 KV
// positions, so the qwen2 training slice runs 112 blocks of four
// warpgroups (64 rows x 32 positions of S and dP each):
//   A  grid (row tile x half, KV block, slice): S = Q^K^T and dP = G^V^T,
//      pn and ds recomputed in the fragments, their largest effective
//      exponents written to the block's own (slice, KV block, row tile,
//      half) slot; a grid-stride share zeroes the int32 dk / dv sums and
//      the per-slice completion counts;
//   B  grid (row tile x half, slice), a cluster per row tile's two halves,
//      launched to overlap A (programmatic dependent launch: its tiles
//      load while A runs; it waits for A before reading A's output): the
//      KV blocks in order, each in chunks: the KV block's exponents reduced
//      over its slots, S and dP again, pn and ds quantized against the
//      bits into dS^, P^T and dS^T; dV and dK over the tile's 128 rows,
//      added to the slice's int32 sums by the bulk-copy engine
//      (cp.reduce.async.bulk, element by element atomically: two
//      operations a chunk instead of an atomic an element); dQ's int32
//      sum over the block's half of the KV block, handed by the second
//      half to the first through distributed shared memory, then rounded
//      into dq in block order; the last block of a slice to finish (by its
//      count) scales the slice's dk and dv.
// __dp4a (every other shape, the older kernels, three launches):
//   A  grid (strip, block, slice): recompute pn and ds, reduce their
//      largest effective exponents with an integer atomicMax;
//   B  grid (strip, slice): walk the blocks in index order, recompute,
//      quantize with the known tile exponents, accumulate dq in float32 in
//      block order, and add the int32 partial sums of dk_j and dv_j with
//      integer atomics (exact in any order);
//   C  scale the int32 dk, dv sums by their powers of two.
//
// Bounds on the H100.  Forward: each slice reads GS*D + 2*T*D int8 and
// 4 bytes of rounding bits per visible (row, position) pair, and writes
// 4*GS*D + 8*GS bytes; its 4*D int8 operations per visible pair are far
// below the bytes at qwen2-0.5b's shapes (GS = 896, T = 128, D = 64).
// Backward: 2*GS*D + 2*T*D int8, 12*GS bytes of stats and 8 bytes of bits
// per visible pair in; 4*GS*D + 8*T*D bytes out; 10*D operations per
// visible pair: bytes bound it too.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "bfp.cuh"
#include "fmath.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::cephes_expf;
using repro::eff_exp;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;
using repro::align1024;
using repro::bulk_add_s32;
using repro::bulk_commit;
using repro::bulk_wait_done;
using repro::bulk_wait_read;
using repro::cluster_arrive_relaxed;
using repro::cluster_sync;
using repro::cluster_wait;
using repro::cp_async16;
using repro::cp_async_wait_all;
using repro::fence_operands;
using repro::fence_proxy_async;
using repro::gmma_desc;
using repro::transpose4;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_s8_m64n32k32;
using repro::wgmma_s8_m64n64k32;
using repro::wgmma_wait0;

constexpr float NEG = -1e30f;     // models.attention._NEG
constexpr float L_FLOOR = 1e-30f; // jnp.maximum(l, 1e-30)

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_len,
                                        int causal, int window) {
  bool m = kpos < kv_len;
  if (causal) m = m && kpos <= qpos;
  if (window) m = m && (qpos - kpos) < window;
  return m;
}

// Smallest and largest query position of rows [r0, r1) (r1 > r0): row r
// sits at r % s + q_off, so the rows cover every residue, one run of
// them, or a run that wraps past s - 1 (then 0 and s - 1 both occur).
__device__ __forceinline__ void strip_positions(int r0, int r1, int s, int q_off,
                                                int* qmin, int* qmax) {
  const int a = r0 % s, b = (r1 - 1) % s;
  const bool run = r1 - r0 < s && a <= b;
  *qmin = (run ? a : 0) + q_off;
  *qmax = (run ? b : s - 1) + q_off;
}

// KV blocks [lo, hi) that can hold a visible position for a query strip
// whose positions lie in [qmin, qmax]; every other block is fully masked.
__device__ __forceinline__ void block_range(int qmin, int qmax, int kv_len, int bt,
                                            int causal, int window, int* lo, int* hi) {
  int h = (kv_len + bt - 1) / bt;
  if (causal) h = min(h, qmax / bt + 1);
  int l = 0;
  if (window) {
    const int x = qmin - (window - 1);
    l = x > 0 ? x / bt : 0;
  }
  *lo = l;
  *hi = h;
}

// Pack rows [row0, row0 + rows) of a (*, D) int8 matrix into words along
// D: dst[i * ld + w] holds bytes 4w .. 4w + 3 of row row0 + i (zero past
// D or past nrows).
__device__ __forceinline__ void pack_rows(int* dst, int ld, const int8_t* __restrict__ src,
                                          int row0, int rows, int nrows, int D, int nthreads) {
  const int DW = (D + 3) / 4;
  for (int i = threadIdx.x; i < rows * DW; i += nthreads) {
    const int r = i / DW, w = i % DW;
    const int gr = row0 + r;
    uint32_t packed = 0;
    if (gr < nrows) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = 4 * w + b;
        if (d < D) packed |= ((uint32_t)(uint8_t)src[(size_t)gr * D + d]) << (8 * b);
      }
    }
    dst[r * ld + w] = (int)packed;
  }
}

// Transpose rows [row0, row0 + rows) of a (*, D) int8 matrix into bytes
// dst[d * ldb + i] (ldb in bytes; zero past nrows).  rows % 4 == 0.
__device__ __forceinline__ void pack_cols(int8_t* dst, int ldb, const int8_t* __restrict__ src,
                                          int row0, int rows, int nrows, int D, int nthreads) {
  for (int i = threadIdx.x; i < rows * D; i += nthreads) {
    const int r = i / D, d = i % D;
    const int gr = row0 + r;
    dst[d * ldb + r] = gr < nrows ? src[(size_t)gr * D + d] : (int8_t)0;
  }
}

// An odd row stride in words: rows read by neighbouring threads fall in
// different shared-memory banks.
__host__ __device__ __forceinline__ int odd_ld(int words) { return words | 1; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int FWD_BQ = 16;
constexpr int FWD_THREADS = 128;
constexpr int FWD_WARPS = FWD_THREADS / 32;

struct FwdLayout {
  int DW, KLD, VLD, TW;
  size_t qs, ks, vt, sf, ph, acc, stats, total;
  __host__ __device__ FwdLayout(int D, int bt) {
    DW = (D + 3) / 4;
    KLD = odd_ld(DW);
    TW = bt / 4;
    VLD = odd_ld(TW);
    qs = 0;
    ks = qs + 4 * (size_t)FWD_BQ * DW;
    vt = ks + 4 * (size_t)bt * KLD;
    sf = vt + 4 * (size_t)D * VLD;
    ph = sf + 4 * (size_t)FWD_BQ * bt;
    acc = ph + 4 * (size_t)FWD_BQ * TW;
    stats = acc + 4 * (size_t)FWD_BQ * D;
    total = stats + 4 * 4 * (size_t)FWD_BQ;
  }
};

template <bool STOCH>
__global__ void __launch_bounds__(FWD_THREADS) attn_fwd_kernel(
    const int8_t* __restrict__ qm, const int8_t* __restrict__ km,
    const int8_t* __restrict__ vm, const uint32_t* __restrict__ rp,
    const int* __restrict__ eqp, const int* __restrict__ ekp,
    const int* __restrict__ evp, float* __restrict__ y, float* __restrict__ m_out,
    float* __restrict__ l_out, int GS, int T, int D, int s, int q_off,
    int kv_len, int causal, int window, int p, int bt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdLayout L(D, bt);
  int* qs = reinterpret_cast<int*>(smem + L.qs);
  int* ks = reinterpret_cast<int*>(smem + L.ks);
  int* vt = reinterpret_cast<int*>(smem + L.vt);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  int* ph = reinterpret_cast<int*>(smem + L.ph);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + FWD_BQ;
  float* alpha_s = l_s + FWD_BQ;
  float* pscale_s = alpha_s + FWD_BQ;

  const size_t bh = blockIdx.y;
  const int r0 = blockIdx.x * FWD_BQ;
  const int rows = min(FWD_BQ, GS - r0);
  qm += bh * GS * D;
  km += bh * T * D;
  vm += bh * T * D;
  if (STOCH) rp += bh * GS * T;
  const int sq = scale_exp(*eqp, p), sk = scale_exp(*ekp, p), sv = scale_exp(*evp, p);
  const float sc = pow2f(sq + sk);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  pack_rows(qs, L.DW, qm, r0, FWD_BQ, GS, D, FWD_THREADS);
  for (int i = tid; i < FWD_BQ * D; i += FWD_THREADS) acc[i] = 0.0f;
  if (tid < FWD_BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }
  int qmin, qmax, lo, hi;
  strip_positions(r0, r0 + rows, s, q_off, &qmin, &qmax);
  block_range(qmin, qmax, kv_len, bt, causal, window, &lo, &hi);
  int8_t* vtb = reinterpret_cast<int8_t*>(vt);

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * bt;
    __syncthreads();  // the previous block's PV has read ks / vt / ph
    pack_rows(ks, L.KLD, km, c0, bt, T, D, FWD_THREADS);
    pack_cols(vtb, 4 * L.VLD, vm, c0, bt, T, D, FWD_THREADS);
    __syncthreads();

    // scores, masked
    for (int i = tid; i < FWD_BQ * bt; i += FWD_THREADS) {
      const int r = i / bt, t = i % bt;
      int dot = 0;
      for (int w = 0; w < L.DW; ++w) dot = __dp4a(qs[r * L.DW + w], ks[t * L.KLD + w], dot);
      const bool vis = r < rows &&
                       visible(c0 + t, (r0 + r) % s + q_off, kv_len, causal, window);
      sf[i] = vis ? __fmul_rn(__int2float_rn(dot), sc) : NEG;
    }
    __syncthreads();

    // online softmax and the quantization of p: one warp per row
    for (int r = warp; r < FWD_BQ; r += FWD_WARPS) {
      float* row = sf + r * bt;
      const int qpos = (r0 + r) % s + q_off;
      float mx = NEG;
      for (int t = lane; t < bt; t += 32) mx = fmaxf(mx, row[t]);
      for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = cephes_expf(__fsub_rn(m_old, m_new));
      int emax = 1;
      for (int t = lane; t < bt; t += 32) {
        const bool vis = r < rows && visible(c0 + t, qpos, kv_len, causal, window);
        const float e = vis ? cephes_expf(__fsub_rn(row[t], m_new)) : 0.0f;
        row[t] = e;
        emax = max(emax, eff_exp(e));
      }
      for (int o = 16; o > 0; o /= 2) emax = max(emax, __shfl_xor_sync(0xffffffffu, emax, o));
      __syncwarp();
      for (int tw = lane; tw < L.TW; tw += 32) {
        uint32_t packed = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int t = 4 * tw + b;
          uint32_t bits = 0;
          if (STOCH && r < rows && c0 + t < T) bits = rp[(size_t)(r0 + r) * T + c0 + t];
          const int q = quantize_one(row[t], bits, emax, p, STOCH);
          packed |= ((uint32_t)q & 0xFFu) << (8 * b);
        }
        ph[r * L.TW + tw] = (int)packed;
      }
      // sum_t p in windows of 32, each in index order, then in order
      float win = 0.0f;
      if (lane < bt / 32)
        for (int i = 0; i < 32; ++i) win = __fadd_rn(win, row[32 * lane + i]);
      float total = 0.0f;
      for (int w = 0; w < bt / 32; ++w) total = __fadd_rn(total, __shfl_sync(0xffffffffu, win, w));
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = fmaf(l_s[r], alpha, total);
        alpha_s[r] = alpha;
        pscale_s[r] = pow2f(scale_exp(emax, p) + sv);
      }
    }
    __syncthreads();

    // PV, rescaled into the float accumulator
    for (int i = tid; i < FWD_BQ * D; i += FWD_THREADS) {
      const int r = i / D, d = i % D;
      int dot = 0;
      for (int tw = 0; tw < L.TW; ++tw) dot = __dp4a(ph[r * L.TW + tw], vt[d * L.VLD + tw], dot);
      acc[i] = fmaf(acc[i], alpha_s[r], __fmul_rn(__int2float_rn(dot), pscale_s[r]));
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += FWD_THREADS) {
    const int r = i / D;
    y[(bh * GS + r0) * D + i] = __fdiv_rn(acc[i], fmaxf(l_s[r], L_FLOOR));
  }
  if (tid < rows) {
    m_out[bh * GS + r0 + tid] = m_s[tid];
    l_out[bh * GS + r0 + tid] = l_s[tid];
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// The query strip of the backward: 32 rows, or fewer where the (bt, D)
// tiles leave too little shared memory (kernels/fused_attention.py
// bwd_strip chooses the largest of 32, 16, 8, 4 that fits).
constexpr int BWD_THREADS = 256;
constexpr int BWD_WARPS = BWD_THREADS / 32;

struct BwdLayout {
  int BQ, DW, KLD, RW, RLD, TW, TLD;
  size_t qs, gs, ks, vs, qt, gt, kt, dsw, dst, pnt, dq, stats, total;
  __host__ __device__ BwdLayout(int D, int bt, int bq) {
    BQ = bq;
    DW = (D + 3) / 4;
    KLD = odd_ld(DW);
    RW = BQ / 4;
    RLD = odd_ld(RW);
    TW = bt / 4;
    TLD = odd_ld(TW);
    qs = 0;
    gs = qs + 4 * (size_t)BQ * KLD;
    ks = gs + 4 * (size_t)BQ * KLD;
    vs = ks + 4 * (size_t)bt * KLD;
    qt = vs + 4 * (size_t)bt * KLD;
    gt = qt + 4 * (size_t)D * RLD;
    kt = gt + 4 * (size_t)D * RLD;
    dsw = kt + 4 * (size_t)D * TLD;
    dst = dsw + 4 * (size_t)BQ * TLD;
    pnt = dst + 4 * (size_t)bt * RLD;
    dq = pnt + 4 * (size_t)bt * RLD;
    stats = dq + 4 * (size_t)BQ * D;
    total = stats + 3 * 4 * (size_t)BQ;
  }
};

struct BwdArgs {
  const int8_t* qm; const int8_t* gm; const int8_t* km; const int8_t* vm;
  const float* m; const float* l; const float* delta;
  const uint32_t* rs; const uint32_t* rp2;
  const int* eq; const int* ek; const int* ev; const int* eg;
  int* e_pn; int* e_ds;        // (BH, NB) tile exponents
  int* dk_acc; int* dv_acc;    // (BH, T, D) int32 sums
  float* dq; float* dk; float* dv;
  int GS, T, D, s, q_off, kv_len, causal, window, p, bt, NB, bq;
};

// pn and ds of one (row, position) from the two integer dots.
__device__ __forceinline__ void recompute(int dqk, int dgv, bool vis, float sc_qk,
                                          float sc_gv, float m, float l, float delta,
                                          float* pn, float* ds) {
  float sf = vis ? __fmul_rn(__int2float_rn(dqk), sc_qk) : NEG;
  const float pt = vis ? cephes_expf(__fsub_rn(sf, m)) : 0.0f;
  // 0 / max(l, 1e-30) is +0 for every l: the division only where pt != 0
  float pnv = 0.0f;
  if (pt != 0.0f) pnv = __fdiv_rn(pt, fmaxf(l, L_FLOOR));
  const float dp = __fmul_rn(__int2float_rn(dgv), sc_gv);
  *pn = pnv;
  *ds = __fmul_rn(pnv, __fsub_rn(dp, delta));
}

// Pass A: the largest effective exponents of pn and ds over each
// (slice, block) tile, from every strip's share of the tile.
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_exp_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(a.D, a.bt, a.bq);
  const int BQ = L.BQ;
  int* qs = reinterpret_cast<int*>(smem + L.qs);
  int* gs = reinterpret_cast<int*>(smem + L.gs);
  int* ks = reinterpret_cast<int*>(smem + L.ks);
  int* vs = reinterpret_cast<int*>(smem + L.vs);
  float* stat = reinterpret_cast<float*>(smem + L.stats);
  __shared__ int red[2 * BWD_WARPS];

  const size_t bh = blockIdx.z;
  const int j = blockIdx.y, r0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.GS - r0);
  int qmin, qmax, lo, hi;
  strip_positions(r0, r0 + rows, a.s, a.q_off, &qmin, &qmax);
  block_range(qmin, qmax, a.kv_len, a.bt, a.causal, a.window, &lo, &hi);
  if (j < lo || j >= hi) return;  // fully masked: every pn and ds is 0
  const int GS = a.GS, T = a.T, D = a.D, bt = a.bt, c0 = j * bt;
  const int p = a.p;
  const float sc_qk = pow2f(scale_exp(*a.eq, p) + scale_exp(*a.ek, p));
  const float sc_gv = pow2f(scale_exp(*a.eg, p) + scale_exp(*a.ev, p));
  pack_rows(qs, L.KLD, a.qm + bh * GS * D, r0, BQ, GS, D, BWD_THREADS);
  pack_rows(gs, L.KLD, a.gm + bh * GS * D, r0, BQ, GS, D, BWD_THREADS);
  pack_rows(ks, L.KLD, a.km + bh * T * D, c0, bt, T, D, BWD_THREADS);
  pack_rows(vs, L.KLD, a.vm + bh * T * D, c0, bt, T, D, BWD_THREADS);
  for (int i = threadIdx.x; i < BQ; i += BWD_THREADS) {
    const bool ok = i < rows;
    const size_t g = bh * GS + r0 + i;
    stat[i] = ok ? a.m[g] : 0.0f;
    stat[BQ + i] = ok ? a.l[g] : 0.0f;
    stat[2 * BQ + i] = ok ? a.delta[g] : 0.0f;
  }
  __syncthreads();
  int e_pn = 1, e_ds = 1;
  for (int i = threadIdx.x; i < BQ * bt; i += BWD_THREADS) {
    const int r = i / bt, t = i % bt;
    int dqk = 0, dgv = 0;
    for (int w = 0; w < L.DW; ++w) {
      dqk = __dp4a(qs[r * L.KLD + w], ks[t * L.KLD + w], dqk);
      dgv = __dp4a(gs[r * L.KLD + w], vs[t * L.KLD + w], dgv);
    }
    const bool vis = r < rows &&
                     visible(c0 + t, (r0 + r) % a.s + a.q_off, a.kv_len, a.causal, a.window);
    float pn, ds;
    recompute(dqk, dgv, vis, sc_qk, sc_gv, stat[r], stat[BQ + r], stat[2 * BQ + r],
              &pn, &ds);
    e_pn = max(e_pn, eff_exp(pn));
    e_ds = max(e_ds, eff_exp(ds));
  }
  for (int o = 16; o > 0; o /= 2) {
    e_pn = max(e_pn, __shfl_xor_sync(0xffffffffu, e_pn, o));
    e_ds = max(e_ds, __shfl_xor_sync(0xffffffffu, e_ds, o));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = e_pn;
    red[BWD_WARPS + warp] = e_ds;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < BWD_WARPS; ++w) {
      e_pn = max(e_pn, red[w]);
      e_ds = max(e_ds, red[BWD_WARPS + w]);
    }
    atomicMax(&a.e_pn[bh * a.NB + j], e_pn);
    atomicMax(&a.e_ds[bh * a.NB + j], e_ds);
  }
}

// Pass B: per (strip, slice), the blocks in index order.
template <bool STOCH>
__global__ void __launch_bounds__(BWD_THREADS) attn_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L(a.D, a.bt, a.bq);
  const int BQ = L.BQ;
  int* qs = reinterpret_cast<int*>(smem + L.qs);
  int* gs = reinterpret_cast<int*>(smem + L.gs);
  int* ks = reinterpret_cast<int*>(smem + L.ks);
  int* vs = reinterpret_cast<int*>(smem + L.vs);
  int* qt = reinterpret_cast<int*>(smem + L.qt);
  int* gt = reinterpret_cast<int*>(smem + L.gt);
  int* kt = reinterpret_cast<int*>(smem + L.kt);
  int* dsw = reinterpret_cast<int*>(smem + L.dsw);
  int* dst = reinterpret_cast<int*>(smem + L.dst);
  int* pnt = reinterpret_cast<int*>(smem + L.pnt);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  float* stat = reinterpret_cast<float*>(smem + L.stats);
  int8_t* dswb = reinterpret_cast<int8_t*>(dsw);
  int8_t* dstb = reinterpret_cast<int8_t*>(dst);
  int8_t* pntb = reinterpret_cast<int8_t*>(pnt);

  const size_t bh = blockIdx.y;
  const int r0 = blockIdx.x * BQ;
  const int rows = min(BQ, a.GS - r0);
  const int GS = a.GS, T = a.T, D = a.D, bt = a.bt, p = a.p;
  const int8_t* qm = a.qm + bh * GS * D;
  const int8_t* gm = a.gm + bh * GS * D;
  const int8_t* km = a.km + bh * T * D;
  const int8_t* vm = a.vm + bh * T * D;
  const int sq = scale_exp(*a.eq, p), sk = scale_exp(*a.ek, p);
  const int sv = scale_exp(*a.ev, p), sg = scale_exp(*a.eg, p);
  const float sc_qk = pow2f(sq + sk), sc_gv = pow2f(sg + sv);

  pack_rows(qs, L.KLD, qm, r0, BQ, GS, D, BWD_THREADS);
  pack_rows(gs, L.KLD, gm, r0, BQ, GS, D, BWD_THREADS);
  pack_cols(reinterpret_cast<int8_t*>(qt), 4 * L.RLD, qm, r0, BQ, GS, D, BWD_THREADS);
  pack_cols(reinterpret_cast<int8_t*>(gt), 4 * L.RLD, gm, r0, BQ, GS, D, BWD_THREADS);
  for (int i = threadIdx.x; i < BQ * D; i += BWD_THREADS) dq[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += BWD_THREADS) {
    const bool ok = i < rows;
    const size_t g = bh * GS + r0 + i;
    stat[i] = ok ? a.m[g] : 0.0f;
    stat[BQ + i] = ok ? a.l[g] : 0.0f;
    stat[2 * BQ + i] = ok ? a.delta[g] : 0.0f;
  }
  int qmin, qmax, lo, hi;
  strip_positions(r0, r0 + rows, a.s, a.q_off, &qmin, &qmax);
  block_range(qmin, qmax, a.kv_len, bt, a.causal, a.window, &lo, &hi);

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * bt;
    const int e_pn = max(a.e_pn[bh * a.NB + j], 1);
    const int e_ds = max(a.e_ds[bh * a.NB + j], 1);
    __syncthreads();  // the previous block's contractions are done
    pack_rows(ks, L.KLD, km, c0, bt, T, D, BWD_THREADS);
    pack_rows(vs, L.KLD, vm, c0, bt, T, D, BWD_THREADS);
    pack_cols(reinterpret_cast<int8_t*>(kt), 4 * L.TLD, km, c0, bt, T, D, BWD_THREADS);
    __syncthreads();

    // recompute pn and ds, quantize them with the tile exponents
    for (int i = threadIdx.x; i < BQ * bt; i += BWD_THREADS) {
      const int r = i / bt, t = i % bt;
      int dqk = 0, dgv = 0;
      for (int w = 0; w < L.DW; ++w) {
        dqk = __dp4a(qs[r * L.KLD + w], ks[t * L.KLD + w], dqk);
        dgv = __dp4a(gs[r * L.KLD + w], vs[t * L.KLD + w], dgv);
      }
      const bool vis = r < rows &&
                       visible(c0 + t, (r0 + r) % a.s + a.q_off, a.kv_len, a.causal, a.window);
      float pn, ds;
      recompute(dqk, dgv, vis, sc_qk, sc_gv, stat[r], stat[BQ + r], stat[2 * BQ + r],
                &pn, &ds);
      uint32_t b_pn = 0, b_ds = 0;
      if (STOCH && r < rows && c0 + t < T) {
        const size_t g = (bh * GS + r0 + r) * (size_t)T + c0 + t;
        b_pn = a.rp2[g];
        b_ds = a.rs[g];
      }
      const int8_t qpn = (int8_t)quantize_one(pn, b_pn, e_pn, p, STOCH);
      const int8_t qds = (int8_t)quantize_one(ds, b_ds, e_ds, p, STOCH);
      dswb[r * 4 * L.TLD + t] = qds;
      dstb[t * 4 * L.RLD + r] = qds;
      pntb[t * 4 * L.RLD + r] = qpn;
    }
    __syncthreads();

    // dq += ds^ k_j, in block order
    const float sc_dq = pow2f(scale_exp(e_ds, p) + sk);
    for (int i = threadIdx.x; i < BQ * D; i += BWD_THREADS) {
      const int r = i / D, d = i % D;
      int dot = 0;
      for (int tw = 0; tw < L.TW; ++tw) dot = __dp4a(dsw[r * L.TLD + tw], kt[d * L.TLD + tw], dot);
      dq[i] = __fadd_rn(dq[i], __fmul_rn(__int2float_rn(dot), sc_dq));
    }
    // int32 partial sums of dk_j = ds^T q and dv_j = pn^T g over the strip
    for (int i = threadIdx.x; i < bt * D; i += BWD_THREADS) {
      const int t = i / D, d = i % D;
      if (c0 + t >= T) continue;
      int dk = 0, dv = 0;
      for (int rw = 0; rw < L.RW; ++rw) {
        dk = __dp4a(dst[t * L.RLD + rw], qt[d * L.RLD + rw], dk);
        dv = __dp4a(pnt[t * L.RLD + rw], gt[d * L.RLD + rw], dv);
      }
      const size_t g = (bh * T + c0 + t) * (size_t)D + d;
      if (dk) atomicAdd(&a.dk_acc[g], dk);
      if (dv) atomicAdd(&a.dv_acc[g], dv);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += BWD_THREADS)
    a.dq[(bh * GS + r0) * D + i] = dq[i];
}

// Pass C: dk, dv = int32 sums x 2^(tile exponent + operand exponent).
__global__ void attn_bwd_scale_kernel(BwdArgs a, int BH) {
  const size_t n = (size_t)BH * a.T * a.D;
  const int p = a.p;
  const int sq = scale_exp(*a.eq, p), sg = scale_exp(*a.eg, p);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / a.D;
    const int t = (int)(row % a.T);
    const size_t bh = row / a.T;
    const int j = t / a.bt;
    const int e_pn = max(a.e_pn[bh * a.NB + j], 1);
    const int e_ds = max(a.e_ds[bh * a.NB + j], 1);
    a.dk[i] = __fmul_rn(__int2float_rn(a.dk_acc[i]), pow2f(scale_exp(e_ds, p) + sq));
    a.dv[i] = __fmul_rn(__int2float_rn(a.dv_acc[i]), pow2f(scale_exp(e_pn, p) + sg));
  }
}

// ---------------------------------------------------------------------------
// backward on the tensor cores (wgmma): D % 32 == 0, D <= 128
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 512;  // four warpgroups
constexpr int RT = 128;          // query rows of a row tile
constexpr int CT = 128;          // KV positions a chunk of a block
constexpr int HT = CT / 2;       // positions a block takes of each chunk
constexpr int TILE = 128 * 128;  // bytes of a 128-row tile of 128-byte rows
constexpr int HTILE = HT * 128;  // bytes of a 64-row one

// The tiles of the two passes (kernels/fused_attention.py _tc_bwd_smem
// mirrors pass B's total).  Every tile is K-major with 128-byte rows in the
// 128-byte swizzle wgmma's descriptors read (gmma_desc): Q^ and G^ as 128
// rows of D bytes; K^ and V^ as the block's 64 positions of D bytes; dS^ as
// 128 rows of 64 positions; P^T and dS^T as 64 positions of 128 rows; Q^T
// and G^T as D rows of 128; K^T as D rows of 64 positions.  xq: the dQ
// partial a block's partner hands it, and before that each chunk's int32
// dV and dK of the block's 64 positions on their way to the slice's sums
// (512 D bytes: D / 4 ints a thread of 512, or D / 2 a thread of 256 where
// D % 64 != 0; 2 x 64 x D ints).
struct TcLayout {
  size_t qs, gs, ks, vs, ds, pt, dst, qt, gt, kt, xq, misc, total;
  __host__ __device__ TcLayout(int D, bool pass_b) {
    qs = 0;
    gs = qs + TILE;
    ks = gs + TILE;
    vs = ks + HTILE;
    ds = pt = dst = qt = gt = kt = xq = misc = vs + HTILE;
    if (pass_b) {
      pt = ds + TILE;
      dst = pt + HTILE;
      qt = dst + HTILE;
      gt = qt + (size_t)D * 128;
      kt = gt + (size_t)D * 128;
      xq = kt + (size_t)D * 128;
      misc = xq + (size_t)TC_THREADS * D;
    }
    total = 1024 + misc + 128;  // 1024: the tiles' alignment
  }
};

struct TcArgs {
  const int8_t* qm; const int8_t* gm; const int8_t* km; const int8_t* vm;
  const float* m; const float* l; const float* delta;
  const uint32_t* rs; const uint32_t* rp2;
  const int* eq; const int* ek; const int* ev; const int* eg;
  int* e_tile;                 // (BH, NB, NS, 2): pass A's exponents of pn, ds
  int* dk_acc; int* dv_acc;    // (BH, T, D) int32 sums
  int* done;                   // (BH,) blocks of the slice finished
  float* dq; float* dk; float* dv;
  int GS, T, D, s, q_off, kv_len, causal, window, p, bt, NB, NS;  // NS = 2 x row tiles
};

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// Wait until the grid this one depends on (programmatic launch) is done
// and its writes are visible; a no-op for a grid launched plainly.
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Byte k of row `row` of a swizzled K-major tile of 128-byte rows.
__device__ __forceinline__ int sw128(int row, int k) {
  return row * 128 + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// Rows [0, rows) of a (rows_valid, D) int8 matrix into a K-major tile,
// 16-byte asynchronous copies (complete after cp_async_wait_all); rows past
// rows_valid zero (src is read only below rows_valid; the zero-filled
// copies name `any`, a valid address, and read nothing).
// (NT: the block's threads, every one of which copies.)
template <int NT = TC_THREADS>
__device__ __forceinline__ void tile_rows(uint8_t* tile, const int8_t* __restrict__ src,
                                          int rows, int rows_valid, int D, const int8_t* any) {
  const int cpr = D / 16;
  for (int x = threadIdx.x; x < rows * cpr; x += NT) {
    const int r = x / cpr, c = x % cpr;
    const bool ok = r < rows_valid;
    cp_async16(tile + sw128(r, 16 * c), ok ? src + (size_t)r * D + 16 * c : any, ok ? 16u : 0u);
  }
}

// The transpose of `rows` rows of a K-major tile (D bytes each) into the
// tile dst whose row d holds column d: a thread reads a word of four rows
// and writes the four columns' words (byte permutes of the 4 x 4 block).
template <int NT = TC_THREADS>
__device__ __forceinline__ void tile_transpose(uint8_t* dst, const uint8_t* src, int rows,
                                               int D) {
  const int dw = D / 4;
  for (int x = threadIdx.x; x < rows / 4 * dw; x += NT) {
    const int rg = x / dw, w = x % dw;
    uint32_t in[4], out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      in[j] = *reinterpret_cast<const uint32_t*>(src + sw128(4 * rg + j, 4 * w));
    transpose4(in, out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(dst + sw128(4 * w + i, 4 * rg)) = out[i];
  }
}

// Every tile copy of this thread landed, and the block's tiles are visible
// to the tensor cores.
__device__ __forceinline__ void tiles_ready() {
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
}

// S = Q^ K^^T and dP = G^ V^^T for a warpgroup's 64 rows and 32 positions
// (a, b: shared addresses of the tiles' first rows).
template <int D>
__device__ __forceinline__ void score_tiles(int (&sacc)[16], int (&pacc)[16], uint32_t aq,
                                            uint32_t ag, uint32_t bk, uint32_t bv) {
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < D / 32; ++s)
    wgmma_s8_m64n32k32(sacc, gmma_desc(aq + 32 * s), gmma_desc(bk + 32 * s), s);
#pragma unroll
  for (int s = 0; s < D / 32; ++s)
    wgmma_s8_m64n32k32(pacc, gmma_desc(ag + 32 * s), gmma_desc(bv + 32 * s), s);
  wgmma_commit();
  wgmma_wait0();
  fence_operands(sacc);
  fence_operands(pacc);
}

// d (64 x N) (+)= a (64 x 32) * b (N x 32)^T at shared addresses a, b.
template <int N>
__device__ __forceinline__ void wgmma_nd(int (&d)[N / 2], uint32_t a, uint32_t b, int acc) {
  if constexpr (N == 32) {
    wgmma_s8_m64n32k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else if constexpr (N == 64) {
    wgmma_s8_m64n64k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else {
    static_assert(N == 96, "wgmma_nd takes N of 32, 64 or 96");
    wgmma_s8_m64n64k32(*reinterpret_cast<int(*)[32]>(&d[0]), gmma_desc(a), gmma_desc(b), acc);
    wgmma_s8_m64n32k32(*reinterpret_cast<int(*)[16]>(&d[32]), gmma_desc(a),
                       gmma_desc(b + 64 * 128), acc);
  }
}

// A block's share of the slice: row tile x / 2 (128 rows from r0), the half
// x % 2 of each chunk (positions c0 + 64 ph, ...).  Warpgroup w takes rows
// 64 rh (rh = w % 2) and 32 positions from 32 qh (qh = w / 2) of S and dP;
// this thread's fragment rows rr and rr + 8 of them sit at query positions
// qpos, with their stats.
struct TcRows {
  int r0, rows, ph, w, rh, qh, rr, c2;
  int qpos[2];
  float m[2], l[2], delta[2];
  __device__ TcRows(const TcArgs& a, size_t bh, int x) {
    const int tid = threadIdx.x, w4 = (tid / 32) % 4, lane = tid % 32;
    r0 = x / 2 * RT;
    ph = x % 2;
    rows = min(RT, a.GS - r0);
    w = tid / 128;
    rh = w % 2;
    qh = w / 2;
    rr = 16 * w4 + lane / 4;
    c2 = 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rh * 64 + rr + 8 * h;
      const bool ok = row < rows;
      const size_t gi = bh * a.GS + r0 + row;
      qpos[h] = (r0 + row) % a.s + a.q_off;
      m[h] = ok ? a.m[gi] : 0.0f;
      l[h] = ok ? a.l[gi] : 0.0f;
      delta[h] = ok ? a.delta[gi] : 0.0f;
    }
  }
  __device__ bool ok(int h) const { return rh * 64 + rr + 8 * h < rows; }
};

// The KV blocks [lo, hi) that row tile rt can see.
__device__ __forceinline__ void tile_range(const TcArgs& a, int rt, int* lo, int* hi) {
  const int r0 = rt * RT, rows = min(RT, a.GS - r0);
  int qmin, qmax;
  strip_positions(r0, r0 + rows, a.s, a.q_off, &qmin, &qmax);
  block_range(qmin, qmax, a.kv_len, a.bt, a.causal, a.window, lo, hi);
}


// Pass A, grid (row tile x 2 halves, KV block, slice): zero dk / dv's int32
// sums and the completion counts (a grid-stride share), then the largest
// effective exponents of pn and ds over this block's share of the (tile,
// KV block) into its own slot.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_tc_exp_kernel(TcArgs a, int BH) {
  extern __shared__ uint8_t smem_raw[];
  launch_dependents();  // pass B's prologue may start
  {
    const size_t nblk = (size_t)gridDim.x * gridDim.y * gridDim.z;
    const size_t id = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const size_t n4 = (size_t)BH * a.T * D / 4;  // D % 32 == 0
    const int4 z = make_int4(0, 0, 0, 0);
    for (size_t i = id * TC_THREADS + threadIdx.x; i < n4; i += nblk * TC_THREADS) {
      reinterpret_cast<int4*>(a.dk_acc)[i] = z;
      reinterpret_cast<int4*>(a.dv_acc)[i] = z;
    }
    for (size_t i = id * TC_THREADS + threadIdx.x; i < (size_t)BH; i += nblk * TC_THREADS)
      a.done[i] = 0;
  }
  uint8_t* base = align1024(smem_raw);
  const TcLayout L(D, false);
  int* red = reinterpret_cast<int*>(base + L.misc);
  const size_t bh = blockIdx.z;
  const int j = blockIdx.y;
  int* slot = a.e_tile + 2 * (((size_t)bh * a.NB + j) * a.NS + blockIdx.x);
  const TcRows R(a, bh, blockIdx.x);
  int lo, hi;
  tile_range(a, blockIdx.x / 2, &lo, &hi);
  if (j < lo || j >= hi) {  // fully masked: every pn and ds is 0
    if (threadIdx.x == 0) slot[0] = slot[1] = 1;
    return;
  }
  const int GS = a.GS, T = a.T, p = a.p;
  tile_rows(base + L.qs, a.qm + (bh * GS + R.r0) * (size_t)D, RT, R.rows, D, a.qm);
  tile_rows(base + L.gs, a.gm + (bh * GS + R.r0) * (size_t)D, RT, R.rows, D, a.gm);
  const float sc_qk = pow2f(scale_exp(*a.eq, p) + scale_exp(*a.ek, p));
  const float sc_gv = pow2f(scale_exp(*a.eg, p) + scale_exp(*a.ev, p));
  const uint32_t sb = repro::smem_u32(base);
  const uint32_t aq = sb + (uint32_t)L.qs + R.rh * 64 * 128;
  const uint32_t ag = sb + (uint32_t)L.gs + R.rh * 64 * 128;
  int e_pn = 1, e_ds = 1;
  for (int c0 = j * a.bt + HT * R.ph; c0 < min((j + 1) * a.bt, T); c0 += CT) {
    if (c0 != j * a.bt + HT * R.ph) __syncthreads();  // the previous products are done
    tile_rows(base + L.ks, a.km + (bh * T + c0) * (size_t)D, HT, T - c0, D, a.km);
    tile_rows(base + L.vs, a.vm + (bh * T + c0) * (size_t)D, HT, T - c0, D, a.vm);
    tiles_ready();
    int sacc[16] = {}, pacc[16] = {};
    score_tiles<D>(sacc, pacc, aq, ag, sb + (uint32_t)L.ks + R.qh * 32 * 128,
                   sb + (uint32_t)L.vs + R.qh * 32 * 128);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int h = (i / 2) % 2;
      const int t = c0 + 32 * R.qh + 8 * (i / 4) + R.c2 + i % 2;
      const bool vis = R.ok(h) && visible(t, R.qpos[h], a.kv_len, a.causal, a.window);
      float pn, ds;
      recompute(sacc[i], pacc[i], vis, sc_qk, sc_gv, R.m[h], R.l[h], R.delta[h], &pn, &ds);
      e_pn = max(e_pn, eff_exp(pn));
      e_ds = max(e_ds, eff_exp(ds));
    }
  }
  for (int o = 16; o > 0; o /= 2) {
    e_pn = max(e_pn, __shfl_xor_sync(0xffffffffu, e_pn, o));
    e_ds = max(e_ds, __shfl_xor_sync(0xffffffffu, e_ds, o));
  }
  constexpr int WARPS = TC_THREADS / 32;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp] = e_pn;
    red[WARPS + warp] = e_ds;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
      e_pn = max(e_pn, red[w]);
      e_ds = max(e_ds, red[WARPS + w]);
    }
    slot[0] = e_pn;
    slot[1] = e_ds;
  }
}

// The tile exponents of KV block j, reduced over its NS slots by every warp
// (the slots loaded in parallel, lane by lane).
__device__ __forceinline__ void block_exps(const TcArgs& a, size_t bh, int j, int* e_pn,
                                           int* e_ds) {
  const int* s = a.e_tile + 2 * ((size_t)bh * a.NB + j) * a.NS;
  int x = 1, y = 1;
  for (int t = threadIdx.x % 32; t < a.NS; t += 32) {
    x = max(x, s[2 * t]);
    y = max(y, s[2 * t + 1]);
  }
  for (int o = 16; o > 0; o /= 2) {
    x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
    y = max(y, __shfl_xor_sync(0xffffffffu, y, o));
  }
  *e_pn = x;
  *e_ds = y;
}

// Pass B, grid (row tile x 2 halves, slice), clusters of the two halves of
// a row tile; launched to overlap pass A, it copies its first tiles in,
// then waits for pass A.  The KV blocks its rows see, in index order, each
// in chunks of 128 positions of which a block takes its half's 64: S and dP
// again, pn and ds quantized against the bits with the KV block's
// exponents into dS^ (row-major), P^T and dS^T; dV = P^T G^ (two
// warpgroups, a column half each where D % 64 == 0) and dK = dS^T Q^ (the
// other two) over the tile's 128 rows; dQ's int32 sum over the block's half
// of the KV block, dS^ K^ (rows by warpgroup, columns halved likewise),
// which the second half hands to the first through distributed shared
// memory, and the first rounds the sum into dq in block order.  The dV, dK
// of the row tiles meet in the partial mode as plain stores, and the last
// tile done with a half chunk (by its count) sums them (exact in any order)
// and writes that half's dk, dv; in the sums' mode with one integer atomic
// an element and tile, and the last block of a slice scales the sums.
template <int D, bool STOCH>
__global__ void __launch_bounds__(TC_THREADS, 1) attn_bwd_tc_kernel(TcArgs a) {
  constexpr int NSPLIT = D % 64 == 0 ? 2 : 1;  // column halves of dV / dK / dQ
  constexpr int DN = D / NSPLIT;               // columns a warpgroup takes
  constexpr int DQT = 256 * NSPLIT;            // threads of the dQ warpgroups
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  cluster_arrive_relaxed();  // no block reads its partner before both run
  uint8_t* base = align1024(smem_raw);
  const TcLayout L(D, true);
  int* misc = reinterpret_cast<int*>(base + L.misc);
  int* xq = reinterpret_cast<int*>(base + L.xq);
  const size_t bh = blockIdx.y;
  const int GS = a.GS, T = a.T, p = a.p;
  const TcRows R(a, bh, blockIdx.x);
  const int8_t* qg = a.qm + (bh * GS + R.r0) * (size_t)D;
  const int8_t* gg = a.gm + (bh * GS + R.r0) * (size_t)D;
  const int sq = scale_exp(*a.eq, p), sk = scale_exp(*a.ek, p);
  const int sv = scale_exp(*a.ev, p), sg = scale_exp(*a.eg, p);
  const float sc_qk = pow2f(sq + sk), sc_gv = pow2f(sg + sv);
  const uint32_t sb = repro::smem_u32(base);
  const uint32_t aq = sb + (uint32_t)L.qs + R.rh * 64 * 128;
  const uint32_t ag = sb + (uint32_t)L.gs + R.rh * 64 * 128;
  const uint32_t bk = sb + (uint32_t)L.ks + R.qh * 32 * 128;
  const uint32_t bv = sb + (uint32_t)L.vs + R.qh * 32 * 128;
  // dV / dK: warpgroup w takes product which (0 dV, 1 dK) and column half
  // ch; dQ: rows rh, column half qh
  const int which = NSPLIT == 2 ? R.w / 2 : R.w, ch = NSPLIT == 2 ? R.w % 2 : 0;
  const bool kv_wg = R.w < 2 * NSPLIT, dq_wg = R.qh < NSPLIT;
  const uint32_t akv = sb + (uint32_t)(which ? L.dst : L.pt);
  const uint32_t bkv = sb + (uint32_t)(which ? L.qt : L.gt) + ch * DN * 128;
  const uint32_t ads = sb + (uint32_t)L.ds + R.rh * 64 * 128;
  const uint32_t bkt = sb + (uint32_t)L.kt + R.qh * DN * 128;
  const bool t_even = T % 2 == 0;
  int lo, hi;
  tile_range(a, blockIdx.x / 2, &lo, &hi);

  // a chunk's K^ and V^ tiles (asynchronous copies)
  auto copy_chunk = [&](int c0) {
    tile_rows(base + L.ks, a.km + (bh * T + c0) * (size_t)D, HT, T - c0, D, a.km);
    tile_rows(base + L.vs, a.vm + (bh * T + c0) * (size_t)D, HT, T - c0, D, a.vm);
  };
  tile_rows(base + L.qs, qg, RT, R.rows, D, a.qm);
  tile_rows(base + L.gs, gg, RT, R.rows, D, a.gm);
  if (lo < hi) copy_chunk(lo * a.bt + HT * R.ph);
  cp_async_wait_all();
  __syncthreads();
  tile_transpose(base + L.qt, base + L.qs, RT, D);  // Q^T, G^T from the tiles
  tile_transpose(base + L.gt, base + L.gs, RT, D);
  tile_transpose(base + L.kt, base + L.ks, HT, D);  // K^T of the first chunk
  cluster_wait();  // both halves run
  wait_primary();  // pass A's exponents and zeroed sums

  for (int j = lo; j < hi; ++j) {
    int e_pn, e_ds;
    block_exps(a, bh, j, &e_pn, &e_ds);
    int dqi[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dqi[i] = 0;
    // both halves walk the same chunks (a half past T is all zeros, masked)
    const int c_first = j * a.bt + HT * R.ph;
    for (int cc = j * a.bt; cc < j * a.bt + min(a.bt, T - j * a.bt); cc += CT) {
      const int c0 = cc + HT * R.ph;
      if (j != lo || cc != j * a.bt) {
        __syncthreads();  // the previous chunk's products are done
        copy_chunk(c0);
        cp_async_wait_all();
        __syncthreads();
        tile_transpose(base + L.kt, base + L.ks, HT, D);  // K^T of the chunk
      }
      fence_proxy_async();
      __syncthreads();
      int sacc[16] = {}, pacc[16] = {};
      score_tiles<D>(sacc, pacc, aq, ag, bk, bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int jj = k / 2, h = k % 2;
        const int row = R.rh * 64 + R.rr + 8 * h;
        const int cp = 32 * R.qh + 8 * jj + R.c2;  // position in the block's 64
        const int t = c0 + cp;
        // the pair's rounding bits (positions t, t + 1 of row `row`)
        uint2 bpn = make_uint2(0u, 0u), bds = bpn;
        if (STOCH && R.ok(h) && t < T) {
          const size_t gi = (bh * GS + R.r0 + row) * (size_t)T + t;
          if (t_even) {
            bpn = *reinterpret_cast<const uint2*>(a.rp2 + gi);
            bds = *reinterpret_cast<const uint2*>(a.rs + gi);
          } else {
            bpn.x = a.rp2[gi];
            bds.x = a.rs[gi];
            if (t + 1 < T) {
              bpn.y = a.rp2[gi + 1];
              bds.y = a.rs[gi + 1];
            }
          }
        }
        int qpn[2], qds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * h + e;
          const bool vis = R.ok(h) && visible(t + e, R.qpos[h], a.kv_len, a.causal, a.window);
          float pn, ds;
          recompute(sacc[i], pacc[i], vis, sc_qk, sc_gv, R.m[h], R.l[h], R.delta[h], &pn, &ds);
          qpn[e] = quantize_one(pn, e ? bpn.y : bpn.x, e_pn, p, STOCH);
          qds[e] = quantize_one(ds, e ? bds.y : bds.x, e_ds, p, STOCH);
        }
        *reinterpret_cast<uint16_t*>(base + L.ds + sw128(row, cp)) =
            (uint16_t)((qds[0] & 0xFF) | ((qds[1] & 0xFF) << 8));
        base[L.pt + sw128(cp, row)] = (uint8_t)qpn[0];
        base[L.pt + sw128(cp + 1, row)] = (uint8_t)qpn[1];
        base[L.dst + sw128(cp, row)] = (uint8_t)qds[0];
        base[L.dst + sw128(cp + 1, row)] = (uint8_t)qds[1];
      }
      fence_proxy_async();
      __syncthreads();
      // dV or dK of the 64 positions over the tile's rows, DN columns, and
      // dQ's int32 sum over the block, dS^ K^, in one commit group
      int acc[DN / 2];
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) acc[i] = 0;
      wgmma_fence();
      if (kv_wg)
#pragma unroll
        for (int s = 0; s < RT / 32; ++s) wgmma_nd<DN>(acc, akv + 32 * s, bkv + 32 * s, s);
      if (dq_wg)
#pragma unroll
        for (int s = 0; s < HT / 32; ++s)
          wgmma_nd<DN>(dqi, ads + 32 * s, bkt + 32 * s, c0 == c_first && s == 0 ? 0 : 1);
      wgmma_commit();
      wgmma_wait0();
      fence_operands(acc);
      fence_operands(dqi);
      // the tile's dV, dK added to the slice's sums by the bulk-copy engine
      // (element by element atomically, exact in any order), staged as rows
      // of D ints in the dS^, P^T, dS^T tiles (free once the products are
      // done): both at once where they fit, else dV, then dK
      int* stg = reinterpret_cast<int*>(base + L.ds);
      constexpr int PER = 2 * HT * D * 4 <= TILE + 2 * HTILE ? 2 : 1;
      __syncthreads();  // every warpgroup's products are done
#pragma unroll
      for (int w0 = 0; w0 < 2; w0 += PER) {
        if (kv_wg && which >= w0 && which < w0 + PER) {
          int* dst = stg + (which - w0) * HT * D;
#pragma unroll
          for (int i = 0; i < DN / 2; i += 2) {
            const int pos = R.rr + 8 * ((i / 2) % 2);
            const int d = ch * DN + 8 * (i / 4) + R.c2;
            *reinterpret_cast<int2*>(dst + pos * D + d) = make_int2(acc[i], acc[i + 1]);
          }
        }
        fence_proxy_async();
        __syncthreads();
        if (threadIdx.x == 0 && c0 < T) {
          const uint32_t bytes = (uint32_t)min(HT, T - c0) * D * 4;
          for (int w = w0; w < w0 + PER; ++w)
            bulk_add_s32((w ? a.dk_acc : a.dv_acc) + (bh * T + c0) * (size_t)D,
                         stg + (w - w0) * HT * D, bytes);
          bulk_commit();
          bulk_wait_read();
        }
        __syncthreads();  // the staging is read
      }
    }
    // the second half's dQ sum into the first's; the first rounds
    // float(dS^ K^) * 2^(e_ds + sk) into dq, in block order
    if (R.ph == 1 && dq_wg) {
      int* dst = cl.map_shared_rank(xq, 0);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) dst[i * DQT + threadIdx.x] = dqi[i];
    }
    cluster_sync();
    if (R.ph == 0 && dq_wg) {
      const float sc_dq = pow2f(scale_exp(e_ds, p) + sk);
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) {
        const int h = (i / 2) % 2;
        if (!R.ok(h)) continue;
        float* q = a.dq + (bh * GS + R.r0 + R.rh * 64 + R.rr + 8 * h) * (size_t)D +
                   R.qh * DN + 8 * (i / 4) + R.c2 + i % 2;
        const float v = __fmul_rn(__int2float_rn(dqi[i] + xq[i * DQT + threadIdx.x]), sc_dq);
        *q = j == lo ? __fadd_rn(0.0f, v) : __fadd_rn(*q, v);
      }
    }
    cluster_sync();  // the hand-over is read
  }
  if (lo >= hi && R.ph == 0)  // no visible block: dq stays 0
    for (int x = threadIdx.x; x < R.rows * D; x += TC_THREADS)
      a.dq[(bh * GS + R.r0) * (size_t)D + x] = 0.0f;

  // the last block of the slice to finish scales its dk and dv
  if (threadIdx.x == 0) bulk_wait_done();
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) misc[0] = atomicAdd(&a.done[bh], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!misc[0]) return;
  __threadfence();
  int* eb = reinterpret_cast<int*>(base + L.ds);  // the products are done
  for (int j = threadIdx.x / 32; j < a.NB; j += TC_THREADS / 32) {
    int x, y;
    block_exps(a, bh, j, &x, &y);
    if (threadIdx.x % 32 == 0) {
      eb[2 * j] = x;
      eb[2 * j + 1] = y;
    }
  }
  __syncthreads();
  const size_t off = bh * (size_t)T * D;
  const int4* k4 = reinterpret_cast<const int4*>(a.dk_acc + off);
  const int4* v4 = reinterpret_cast<const int4*>(a.dv_acc + off);
#pragma unroll 4
  for (int x = threadIdx.x; x < T * D / 4; x += TC_THREADS) {
    const int j = 4 * x / D / a.bt;
    const float fk = pow2f(scale_exp(eb[2 * j + 1], p) + sq);
    const float fv = pow2f(scale_exp(eb[2 * j], p) + sg);
    const int4 k = __ldcg(k4 + x), v = __ldcg(v4 + x);
    reinterpret_cast<float4*>(a.dk + off)[x] =
        make_float4(__fmul_rn(__int2float_rn(k.x), fk), __fmul_rn(__int2float_rn(k.y), fk),
                    __fmul_rn(__int2float_rn(k.z), fk), __fmul_rn(__int2float_rn(k.w), fk));
    reinterpret_cast<float4*>(a.dv + off)[x] =
        make_float4(__fmul_rn(__int2float_rn(v.x), fv), __fmul_rn(__int2float_rn(v.y), fv),
                    __fmul_rn(__int2float_rn(v.z), fv), __fmul_rn(__int2float_rn(v.w), fv));
  }
}

// ---------------------------------------------------------------------------
// forward on the tensor cores (wgmma): D % 32 == 0, D <= 128
// ---------------------------------------------------------------------------

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (H100)
constexpr int FT_ROWS = 64;       // query rows of a block (one wgmma row tile)
constexpr int FT_MAXW = 16;       // windows of 32 positions a KV block holds at most

// The forward's shared memory (kernels/fused_attention.py _tc_fwd_layout
// mirrors it): Q^'s tile of 64 rows, V^T of the KV block's chunks (D rows
// of 128 positions each), the row stats the warpgroups exchange (their
// partial maxima and exponents, every window sum of the block), then one
// set, or two where they fit (the next KV block loads while this one
// computes), of the block's K^ chunks and V^ staging chunks (128 positions
// of D bytes each).  Once V^T is built, a set's V^ staging holds the warps'
// row-sum staging (16 KB), then P^'s chunks (64 x 128 bytes each).  Every
// tile K-major with 128-byte rows in the 128-byte swizzle.
struct FwdTcLayout {
  int nch, nset;
  size_t qs, vt, red, ks, set_bytes, total;
  __host__ __device__ FwdTcLayout(int D, int bt) {
    nch = bt / CT;
    qs = 0;
    vt = qs + (size_t)FT_ROWS * 128;
    red = vt + (size_t)nch * D * 128;
    ks = (red + 4 * (2 * 4 * FT_ROWS + FT_ROWS * FT_MAXW) + 1023) / 1024 * 1024;
    set_bytes = 2 * (size_t)nch * TILE;
    nset = 1024 + ks + 2 * set_bytes <= (size_t)SMEM_MAX ? 2 : 1;
    total = 1024 + ks + nset * set_bytes;
  }
  __host__ __device__ size_t k_tile(int set, int k) const {
    return ks + set * set_bytes + (size_t)k * TILE;
  }
  __host__ __device__ size_t v_stage(int set, int k) const {
    return k_tile(set, k) + (size_t)nch * TILE;
  }
};

struct FwdArgs {
  const int8_t* qm; const int8_t* km; const int8_t* vm; const uint32_t* rp;
  const int* eq; const int* ek; const int* ev;
  float* y; float* m; float* l;
  int GS, T, s, q_off, kv_len, causal, window, p, bt, stochastic;
};

// Whether positions [c, c + n) can hold a visible pair for query rows
// whose positions lie in [qmin, qmax] (false only where every pair is
// masked: such a span adds nothing, so skipping it is exact).
__device__ __forceinline__ bool span_visible(int c, int n, int qmin, int qmax, int kv_len,
                                             int causal, int window) {
  if (c >= kv_len || (causal && c > qmax)) return false;
  return !window || c + n - 1 > qmin - window;
}

// d (64 x N int32) (+)= a (64 x 32) * b (N x 32)^T at shared addresses a,
// b, for the N of 8 to 32 a warpgroup's share of PV takes.
template <int N>
__device__ __forceinline__ void wgmma_small(int (&d)[N / 2], uint32_t a, uint32_t b, int acc) {
  if constexpr (N == 8) {
    repro::wgmma_s8_m64n8k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else if constexpr (N == 16) {
    repro::wgmma_s8_m64n16k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else if constexpr (N == 24) {
    repro::wgmma_s8_m64n24k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else if constexpr (N == 32) {
    wgmma_s8_m64n32k32(d, gmma_desc(a), gmma_desc(b), acc);
  } else {
    static_assert(N == 64, "wgmma_small takes N of 8, 16, 24, 32 or 64");
    wgmma_s8_m64n64k32(d, gmma_desc(a), gmma_desc(b), acc);
  }
}

// Grid (row tile of 64 query rows, slice); NW warpgroups a block split
// every chunk of 128 KV positions, 128 / NW positions each, and PV's D
// columns, D / NW each.  Over the KV blocks the tile sees, in order (the
// next one's tiles loading meanwhile where two sets fit): V^T built from
// its staging; S = Q^ K^^T on wgmma for the warpgroup's positions, masked
// and scaled; the online softmax, each row's max and exponent reduced over
// its quad, then over the warpgroups through shared memory; p's row sums
// in windows of 32 (one lane a window, from the warp's staging), the
// windows summed in order; p quantized against its bits (loaded into
// registers while the tiles land) into P^'s tile; PV on wgmma for the
// warpgroup's columns; acc = fma(acc, alpha, float(PV) 2^(se + sv)) in
// registers.  At bt 128 one sweep keeps S and p in registers; at bt 256
// and 512 each row's max and exponent span several chunks, so S is
// computed again in three sweeps (max; exps, exponent and row sums;
// quantize), the tensor cores' work being cheap beside the exps.  (The
// rounding mode is an argument, not a template parameter: one build of
// each shape serves both.)
template <int D, int NW>
__global__ void __launch_bounds__(128 * NW, 1) attn_fwd_tc_kernel(FwdArgs a) {
  constexpr int NT = 128 * NW;
  constexpr int NP = CT / NW;    // positions of a chunk a warpgroup takes
  constexpr int NV = NP / 2;     // of them a thread holds (2 rows x NP / 4)
  constexpr int NWIN = NP / 32;  // windows of 32 among them
  constexpr int DN = D / NW;     // PV columns a warpgroup takes
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const FwdTcLayout L(D, a.bt);
  const uint32_t sb = repro::smem_u32(base);
  const size_t bh = blockIdx.y;
  const int GS = a.GS, T = a.T, bt = a.bt, P = a.p;
  const bool stoch = a.stochastic != 0;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int c2 = 2 * (lane % 4);
  const int R0 = blockIdx.x * FT_ROWS, rows = min(FT_ROWS, GS - R0);
  // this thread's fragment rows (h = 0, 1) of the tile's 64
  int row[2], qpos[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = 16 * warp + lane / 4 + 8 * h;
    ok[h] = row[h] < rows;
    qpos[h] = (R0 + row[h]) % a.s + a.q_off;
  }
  int qmin, qmax, lo, hi;
  strip_positions(R0, R0 + rows, a.s, a.q_off, &qmin, &qmax);
  block_range(qmin, qmax, a.kv_len, bt, a.causal, a.window, &lo, &hi);
  const int sq = scale_exp(*a.eq, P), sk = scale_exp(*a.ek, P), sv = scale_exp(*a.ev, P);
  const float sc = pow2f(sq + sk);
  const int8_t* km = a.km + bh * T * (size_t)D;
  const int8_t* vm = a.vm + bh * T * (size_t)D;
  const uint32_t* rp = stoch ? a.rp + (bh * GS + R0) * (size_t)T : nullptr;
  const bool t_even = T % 2 == 0;
  float* red_m = reinterpret_cast<float*>(base + L.red);  // [NW][64]
  int* red_e = reinterpret_cast<int*>(red_m + 4 * FT_ROWS);  // [NW][64]
  float* wsum = reinterpret_cast<float*>(red_e + 4 * FT_ROWS);  // [64][FT_MAXW]
  const uint32_t aq = sb + (uint32_t)L.qs;

  // which of this thread's NV fragment pairs of the warpgroup's span at c
  // are visible (bit i: row (i / 2) % 2, position c + 8 (i / 4) + c2 + i % 2)
  auto vmask = [&](int c) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int h = (i / 2) % 2, t = c + 8 * (i / 4) + c2 + i % 2;
      if (ok[h] && visible(t, qpos[h], a.kv_len, a.causal, a.window)) v |= 1u << i;
    }
    return v;
  };
  auto sees = [&](int c, int n) {
    return span_visible(c, n, qmin, qmax, a.kv_len, a.causal, a.window);
  };
  // the chunks of KV block j the tile can see (asynchronous copies; a
  // chunk it cannot see keeps whatever its slot held)
  auto load_block = [&](int j, int set) {
    for (int k = 0; k < L.nch; ++k) {
      const int c = j * bt + CT * k;
      if (!sees(c, CT)) continue;
      tile_rows<NT>(base + L.k_tile(set, k), km + (size_t)c * D, CT, T - c, D, a.km);
      tile_rows<NT>(base + L.v_stage(set, k), vm + (size_t)c * D, CT, T - c, D, a.vm);
    }
  };
  // this thread's rounding bits of the warpgroup's NP positions from c
  // (two consecutive words a fragment pair, read only where one of the
  // pair is visible)
  auto load_bits = [&](uint32_t (&bits)[NV], int c, uint32_t vm) {
#pragma unroll
    for (int g = 0; g < NV / 4; ++g)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * g + 2 * h, t = c + 8 * g + c2;
        uint32_t b0 = 0, b1 = 0;
        if (stoch && ((vm >> i) & 3u)) {
          const uint32_t* src = rp + (size_t)row[h] * T + t;
          if (t_even) {
            const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
            b0 = v.x;
            b1 = v.y;
          } else {
            b0 = __ldg(src);
            if (t + 1 < T) b1 = __ldg(src + 1);
          }
        }
        bits[i] = b0;
        bits[i + 1] = b1;
      }
  };
  // S of the warpgroup's NP positions of chunk k (at c) on wgmma, masked
  // and scaled into x
  auto scores = [&](float (&x)[NV], uint32_t kt, int k, uint32_t vm) {
    int s[NV];
    const uint32_t bk = kt + (uint32_t)(k * TILE + wg * NP * 128);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk)
      wgmma_small<NP>(s, aq + 32 * kk, bk + 32 * kk, kk);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      x[i] = (vm >> i) & 1u ? __fmul_rn(__int2float_rn(s[i]), sc) : NEG;
  };
  // p = exp(s - m') on the visible pairs, 0 elsewhere (in place)
  auto exps = [&](float (&x)[NV], uint32_t vm, const float (&m_new)[2]) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      x[i] = (vm >> i) & 1u ? cephes_expf(__fsub_rn(x[i], m_new[(i / 2) % 2])) : 0.0f;
  };
  // the sums of p over each window of 32 of the warpgroup's positions, in
  // index order, into wsum[row][w0 + window]: the warp stages one fragment
  // half at a time (8 rows, chunks of 16 bytes swizzled by the row), one
  // lane sums a (row, window)
  auto window_sums = [&](const float (&x)[NV], float* stg, int w0) {
    const int q = lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int g = 0; g < NV / 4; ++g) {
        const int col = 8 * g + c2;
        *reinterpret_cast<float2*>(stg + q * NP + 4 * ((col / 4) ^ q) + col % 4) =
            make_float2(x[4 * g + 2 * h], x[4 * g + 2 * h + 1]);
      }
      __syncwarp();
      if (lane < 8 * NWIN) {
        const int r = lane % 8, w = lane / 8;
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(stg + r * NP + 4 * ((8 * w + k) ^ r));
          s = __fadd_rn(s, v.x);
          s = __fadd_rn(s, v.y);
          s = __fadd_rn(s, v.z);
          s = __fadd_rn(s, v.w);
        }
        wsum[(16 * warp + r + 8 * h) * FT_MAXW + w0 + w] = s;
      }
      __syncwarp();  // the staging is read before the next half overwrites it
    }
  };
  // ... and 0 for the windows of a span the tile cannot see
  auto zero_windows = [&](int w0) {
    if (lane < 8 * NWIN)
      for (int h = 0; h < 2; ++h)
        wsum[(16 * warp + lane % 8 + 8 * h) * FT_MAXW + w0 + lane / 8] = 0.0f;
  };
  // each row's max of x over the warpgroups (after the block's barrier)
  auto row_max = [&](const float (&mx)[2], float (&m_new)[2], float (&alpha)[2],
                     const float (&m_run)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (lane % 4 == 0) red_m[wg * FT_ROWS + row[h]] = v;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = red_m[row[h]];
#pragma unroll
      for (int w = 1; w < NW; ++w) v = fmaxf(v, red_m[w * FT_ROWS + row[h]]);
      m_new[h] = fmaxf(m_run[h], v);
      alpha[h] = cephes_expf(__fsub_rn(m_run[h], m_new[h]));
    }
  };
  // each row's largest exponent over the warpgroups (after the block's
  // barrier, which also hands over the window sums)
  auto row_exp = [&](int (&em)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int e = max(em[h], __shfl_xor_sync(0xffffffffu, em[h], 1));
      e = max(e, __shfl_xor_sync(0xffffffffu, e, 2));
      if (lane % 4 == 0) red_e[wg * FT_ROWS + row[h]] = e;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int w = 0; w < NW; ++w) em[h] = max(em[h], red_e[w * FT_ROWS + row[h]]);
  };
  // P^ of the warpgroup's positions of chunk k into its tile, p quantized
  // against its bits with its row's exponent
  auto store_p = [&](const float (&x)[NV], const uint32_t (&bits)[NV], uint8_t* pt,
                     const int (&em)[2]) {
#pragma unroll
    for (int i = 0; i < NV; i += 2) {
      const int h = (i / 2) % 2;
      const int q0 = quantize_one(x[i], stoch ? bits[i] : 0u, em[h], P, stoch);
      const int q1 = quantize_one(x[i + 1], stoch ? bits[i + 1] : 0u, em[h], P, stoch);
      *reinterpret_cast<uint16_t*>(pt + sw128(row[h], wg * NP + 8 * (i / 4) + c2)) =
          (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
    }
  };

  tile_rows<NT>(base + L.qs, a.qm + (bh * GS + R0) * (size_t)D, FT_ROWS, rows, D, a.qm);
  if (lo < hi) load_block(lo, 0);
  repro::cp_async_commit();

  float acc[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.0f, 0.0f};

  for (int j = lo; j < hi; ++j) {
    const int set = L.nset == 2 ? (j - lo) & 1 : 0;
    const int cb = j * bt;
    const int cw = cb + wg * NP;  // the warpgroup's first position of chunk 0
    // one chunk a block: its bits load while its tiles land
    uint32_t bits[NV], vm = 0;
    if (L.nch == 1 && sees(cw, NP)) {
      vm = vmask(cw);
      load_bits(bits, cw, vm);
    }
    if (L.nset == 2 && j + 1 < hi) {
      load_block(j + 1, set ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // the block's tiles landed (every thread's copies)
    for (int k = 0; k < L.nch; ++k)
      if (sees(cb + CT * k, CT))
        tile_transpose<NT>(base + L.vt + (size_t)k * D * 128, base + L.v_stage(set, k), CT, D);
    fence_proxy_async();
    __syncthreads();

    const uint32_t kt = sb + (uint32_t)L.k_tile(set, 0);
    float* stg = reinterpret_cast<float*>(base + L.v_stage(set, 0)) + (tid / 32) * 8 * NP;
    float m_new[2], alpha[2];
    int em[2] = {1, 1};
    if (L.nch == 1) {
      // one chunk: S and p stay in registers
      const bool mine = sees(cw, NP);
      float x[NV];
      float mx[2] = {NEG, NEG};
      if (mine) {
        scores(x, kt, 0, vm);
#pragma unroll
        for (int i = 0; i < NV; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x[i]);
      }
      row_max(mx, m_new, alpha, m_run);
      if (mine) {
        exps(x, vm, m_new);
#pragma unroll
        for (int i = 0; i < NV; ++i) em[(i / 2) % 2] = max(em[(i / 2) % 2], eff_exp(x[i]));
        window_sums(x, stg, wg * NWIN);
      } else {
        zero_windows(wg * NWIN);
      }
      row_exp(em);
      if (mine) store_p(x, bits, base + L.v_stage(set, 0), em);
    } else {
      // sweep 1: each row's max over the block
      float mx[2] = {NEG, NEG};
      for (int k = 0; k < L.nch; ++k) {
        const int c = cw + CT * k;
        if (!sees(c, NP)) continue;
        float x[NV];
        scores(x, kt, k, vmask(c));
#pragma unroll
        for (int i = 0; i < NV; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x[i]);
      }
      row_max(mx, m_new, alpha, m_run);
      // sweep 2: the exps' largest exponent and the window sums
      for (int k = 0; k < L.nch; ++k) {
        const int c = cw + CT * k;
        if (!sees(c, NP)) {
          zero_windows(4 * k + wg * NWIN);
          continue;
        }
        const uint32_t kvm = vmask(c);
        float x[NV];
        scores(x, kt, k, kvm);
        exps(x, kvm, m_new);
#pragma unroll
        for (int i = 0; i < NV; ++i) em[(i / 2) % 2] = max(em[(i / 2) % 2], eff_exp(x[i]));
        window_sums(x, stg, 4 * k + wg * NWIN);
      }
      row_exp(em);
      // sweep 3: P^ of every chunk
      for (int k = 0; k < L.nch; ++k) {
        const int c = cw + CT * k;
        if (!sees(c, NP)) continue;
        const uint32_t kvm = vmask(c);
        uint32_t kbits[NV];
        load_bits(kbits, c, kvm);
        float x[NV];
        scores(x, kt, k, kvm);
        exps(x, kvm, m_new);
        store_p(x, kbits, base + L.v_stage(set, k), em);
      }
    }
    // the row sums: every window of the block in order
    float tot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      for (int w = 0; w < 4 * L.nch; ++w)
        tot[h] = __fadd_rn(tot[h], wsum[row[h] * FT_MAXW + w]);
    fence_proxy_async();
    __syncthreads();  // P^ written; every row sum read
    // PV for the warpgroup's columns over the block's visible slices of 32
    int pv[DN / 2];
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) pv[i] = 0;
    wgmma_fence();
    for (int k = 0; k < L.nch; ++k)
#pragma unroll
      for (int sl = 0; sl < 4; ++sl)
        if (sees(cb + CT * k + 32 * sl, 32))
          wgmma_small<DN>(pv, sb + (uint32_t)(L.v_stage(set, k) + 32 * sl),
                          sb + (uint32_t)(L.vt + k * D * 128 + wg * DN * 128 + 32 * sl), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(pv);
    float ps[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) ps[h] = pow2f(scale_exp(em[h], P) + sv);
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) {
      const int h = (i / 2) % 2;
      acc[i] = fmaf(acc[i], alpha[h], __fmul_rn(__int2float_rn(pv[i]), ps[h]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] = fmaf(l_run[h], alpha[h], tot[h]);
      m_run[h] = m_new[h];
    }
    __syncthreads();  // every warpgroup is done with the block's tiles
    if (L.nset == 1 && j + 1 < hi) {
      load_block(j + 1, 0);
      repro::cp_async_commit();
    }
  }
  repro::cp_async_wait<0>();  // (no KV block: the query tile's copies)

  // y = acc / max(l, 1e-30) for the warpgroup's columns: four a thread
  // (the quad's even lane takes a column group's first four, the odd one
  // the next group's last four) where the groups pair up, else two
  constexpr int NG = DN / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lf = fmaxf(l_run[h], L_FLOOR);
    float* yr = a.y + (bh * GS + R0 + row[h]) * (size_t)D + wg * DN;
    if constexpr (NG % 2 == 0) {
      const bool odd = lane & 1;
#pragma unroll
      for (int g = 0; g < NG; g += 2) {
        const float2 lo2 = make_float2(acc[4 * g + 2 * h], acc[4 * g + 2 * h + 1]);
        const float2 hi2 = make_float2(acc[4 * g + 4 + 2 * h], acc[4 * g + 4 + 2 * h + 1]);
        const float2 snd = odd ? lo2 : hi2;
        const float rx = __shfl_xor_sync(0xffffffffu, snd.x, 1);
        const float ry = __shfl_xor_sync(0xffffffffu, snd.y, 1);
        const float4 v = odd ? make_float4(rx, ry, hi2.x, hi2.y) : make_float4(lo2.x, lo2.y, rx, ry);
        if (ok[h])
          *reinterpret_cast<float4*>(yr + (odd ? 8 * g + 8 + c2 - 2 : 8 * g + c2)) =
              make_float4(__fdiv_rn(v.x, lf), __fdiv_rn(v.y, lf), __fdiv_rn(v.z, lf),
                          __fdiv_rn(v.w, lf));
      }
    } else {
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (ok[h])
          *reinterpret_cast<float2*>(yr + 8 * g + c2) =
              make_float2(__fdiv_rn(acc[4 * g + 2 * h], lf), __fdiv_rn(acc[4 * g + 2 * h + 1], lf));
    }
  }
  if (wg) return;
  // m and l by the first warpgroup: a warp's 16 rows as four float4 each
  // (lanes 0-3 m, 4-7 l) where they are whole and aligned, else a word a row
  const size_t g0 = bh * GS + R0 + 16 * warp;
  const int k4 = lane % 4, which = (lane / 4) % 2;
  float v[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int r = 4 * k4 + jj, src = 4 * (r % 8);
    const float m0 = __shfl_sync(0xffffffffu, m_run[0], src);
    const float m1 = __shfl_sync(0xffffffffu, m_run[1], src);
    const float l0 = __shfl_sync(0xffffffffu, l_run[0], src);
    const float l1 = __shfl_sync(0xffffffffu, l_run[1], src);
    v[jj] = which ? (r >= 8 ? l1 : l0) : (r >= 8 ? m1 : m0);
  }
  const bool whole = 16 * warp + 16 <= rows &&
                     reinterpret_cast<uintptr_t>(a.m + g0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.l + g0) % 16 == 0;
  if (whole) {
    if (lane < 8)
      *reinterpret_cast<float4*>((which ? a.l : a.m) + g0 + 4 * k4) =
          make_float4(v[0], v[1], v[2], v[3]);
  } else if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h]) {
        a.m[bh * GS + R0 + row[h]] = m_run[h];
        a.l[bh * GS + R0 + row[h]] = l_run[h];
      }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// qm (BH,GS,D), km/vm (BH,T,D) int8, rp (BH,GS,T) uint32 or null, eq/ek/ev
// int32 scalars -> y (BH,GS,D) f32, m, l (BH,GS) f32.  bt % 128 == 0.
int repro_attn_fwd(const void* qm, const void* km, const void* vm, const void* rp,
                   const void* eq, const void* ek, const void* ev, void* y, void* m,
                   void* l, int BH, int GS, int T, int D, int s, int q_off, int kv_len,
                   int causal, int window, int p, int bt, int stochastic, void* stream) {
  const size_t smem = FwdLayout(D, bt).total;
  const dim3 grid((GS + FWD_BQ - 1) / FWD_BQ, BH);
  auto st = static_cast<cudaStream_t>(stream);
  auto kern = stochastic ? attn_fwd_kernel<true> : attn_fwd_kernel<false>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, FWD_THREADS, smem, st>>>(
      static_cast<const int8_t*>(qm), static_cast<const int8_t*>(km),
      static_cast<const int8_t*>(vm), static_cast<const uint32_t*>(rp),
      static_cast<const int*>(eq), static_cast<const int*>(ek), static_cast<const int*>(ev),
      static_cast<float*>(y), static_cast<float*>(m), static_cast<float*>(l), GS, T, D, s,
      q_off, kv_len, causal, window, p, bt);
  return (int)cudaGetLastError();
}

// The forward on the tensor cores (D of 32, 64, 96 or 128; bt 128, 256 or
// 512): the operands of repro_attn_fwd; nw warpgroups a block of 64 query
// rows, each taking 128 / nw positions of every chunk (4, or 2 at D 64, the
// tiling the rule does not take, kept to time it).  qm, km, vm and y
// 16-byte aligned, rp 8-byte (it is read two words at a time), eq, ek, ev,
// m and l 4-byte, else cudaErrorInvalidValue.
int repro_attn_fwd_tc(const void* qm, const void* km, const void* vm, const void* rp,
                      const void* eq, const void* ek, const void* ev, void* y, void* m,
                      void* l, int BH, int GS, int T, int D, int s, int q_off, int kv_len,
                      int causal, int window, int p, int bt, int stochastic, int nw,
                      void* stream) {
  if ((D != 32 && D != 64 && D != 96 && D != 128) || (bt != 128 && bt != 256 && bt != 512) ||
      (nw != 4 && !(nw == 2 && D == 64)))
    return (int)cudaErrorInvalidValue;
  for (const void* x : {qm, km, vm, (const void*)y})
    if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
  if (stochastic && reinterpret_cast<uintptr_t>(rp) % 8) return (int)cudaErrorInvalidValue;
  for (const void* x : {eq, ek, ev, (const void*)m, (const void*)l})
    if (reinterpret_cast<uintptr_t>(x) % 4) return (int)cudaErrorInvalidValue;
  const FwdTcLayout L(D, bt);
  if (L.total > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.qm = static_cast<const int8_t*>(qm);
  a.km = static_cast<const int8_t*>(km);
  a.vm = static_cast<const int8_t*>(vm);
  a.rp = static_cast<const uint32_t*>(rp);
  a.eq = static_cast<const int*>(eq);
  a.ek = static_cast<const int*>(ek);
  a.ev = static_cast<const int*>(ev);
  a.y = static_cast<float*>(y);
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.GS = GS; a.T = T; a.s = s; a.q_off = q_off; a.kv_len = kv_len; a.causal = causal;
  a.window = window; a.p = p; a.bt = bt; a.stochastic = stochastic;
  void (*kern)(FwdArgs) = nw == 2    ? attn_fwd_tc_kernel<64, 2>
                          : D == 32  ? attn_fwd_tc_kernel<32, 4>
                          : D == 64  ? attn_fwd_tc_kernel<64, 4>
                          : D == 96  ? attn_fwd_tc_kernel<96, 4>
                                     : attn_fwd_tc_kernel<128, 4>;
  cudaError_t err = set_smem(kern, L.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((GS + FT_ROWS - 1) / FT_ROWS, BH);
  kern<<<grid, 128 * nw, L.total, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Shared memory of one block of the tensor-core forward (FwdTcLayout).
long long repro_attn_fwd_tc_smem(int D, int bt) {
  return (long long)FwdTcLayout(D, bt).total;
}

// qm/gm (BH,GS,D), km/vm (BH,T,D) int8; m, l, delta (BH,GS) f32; rs/rp2
// (BH,GS,T) uint32 or null; eq/ek/ev/eg int32 scalars; scratch: e (2,BH,NB)
// int32 and acc (2,BH,T,D) int32 -> dq (BH,GS,D), dk, dv (BH,T,D) f32.
// bq is the query strip, 4, 8, 16 or 32.
int repro_attn_bwd(const void* qm, const void* gm, const void* km, const void* vm,
                   const void* m, const void* l, const void* delta, const void* rs,
                   const void* rp2, const void* eq, const void* ek, const void* ev,
                   const void* eg, void* e_scratch, void* acc_scratch, void* dq, void* dk,
                   void* dv, int BH, int GS, int T, int D, int s, int q_off, int kv_len,
                   int causal, int window, int p, int bt, int bq, int stochastic,
                   void* stream) {
  if (bq != 4 && bq != 8 && bq != 16 && bq != 32) return (int)cudaErrorInvalidValue;
  const int NB = (T + bt - 1) / bt;
  BwdArgs a;
  a.qm = static_cast<const int8_t*>(qm);
  a.gm = static_cast<const int8_t*>(gm);
  a.km = static_cast<const int8_t*>(km);
  a.vm = static_cast<const int8_t*>(vm);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.rs = static_cast<const uint32_t*>(rs);
  a.rp2 = static_cast<const uint32_t*>(rp2);
  a.eq = static_cast<const int*>(eq);
  a.ek = static_cast<const int*>(ek);
  a.ev = static_cast<const int*>(ev);
  a.eg = static_cast<const int*>(eg);
  a.e_pn = static_cast<int*>(e_scratch);
  a.e_ds = a.e_pn + (size_t)BH * NB;
  a.dk_acc = static_cast<int*>(acc_scratch);
  a.dv_acc = a.dk_acc + (size_t)BH * T * D;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.GS = GS; a.T = T; a.D = D; a.s = s; a.q_off = q_off; a.kv_len = kv_len;
  a.causal = causal; a.window = window; a.p = p; a.bt = bt; a.NB = NB; a.bq = bq;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaMemsetAsync(e_scratch, 0, sizeof(int) * 2 * (size_t)BH * NB, st)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(acc_scratch, 0, sizeof(int) * 2 * (size_t)BH * T * D, st)) != cudaSuccess)
    return (int)err;
  const size_t smem = BwdLayout(D, bt, bq).total;
  const int strips = (GS + bq - 1) / bq;
  if ((err = set_smem(attn_bwd_exp_kernel, smem)) != cudaSuccess) return (int)err;
  attn_bwd_exp_kernel<<<dim3(strips, NB, BH), BWD_THREADS, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  auto kern = stochastic ? attn_bwd_kernel<true> : attn_bwd_kernel<false>;
  if ((err = set_smem(kern, smem)) != cudaSuccess) return (int)err;
  kern<<<dim3(strips, BH), BWD_THREADS, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  attn_bwd_scale_kernel<<<264, 256, 0, st>>>(a, BH);
  return (int)cudaGetLastError();
}

// The backward on the tensor cores (D of 32, 64, 96 or 128): the same
// operands as repro_attn_bwd; scratch: e (BH, NB, 2 ceil(GS / 128), 2),
// acc (2, BH, T, D) and done (BH,) int32, none of them zeroed by the caller
// (pass A writes every slot and zeroes acc and done).  Pass B is launched
// on clusters of two blocks and may start before pass A ends (programmatic
// dependent launch: it waits for pass A before reading what pass A
// writes).  qm, gm, km, vm, rs, rp2, acc 16-byte aligned, the stats and
// exponents 4-byte, else cudaErrorInvalidValue.
int repro_attn_bwd_tc(const void* qm, const void* gm, const void* km, const void* vm,
                      const void* m, const void* l, const void* delta, const void* rs,
                      const void* rp2, const void* eq, const void* ek, const void* ev,
                      const void* eg, void* e_scratch, void* acc_scratch, void* done,
                      void* dq, void* dk, void* dv, int BH, int GS, int T, int D, int s,
                      int q_off, int kv_len, int causal, int window, int p, int bt,
                      int stochastic, void* stream) {
  if ((D != 32 && D != 64 && D != 96 && D != 128) || bt % CT || bt <= 0)
    return (int)cudaErrorInvalidValue;
  for (const void* x : {qm, gm, km, vm, rs, rp2, (const void*)acc_scratch})
    if (reinterpret_cast<uintptr_t>(x) % 16) return (int)cudaErrorInvalidValue;
  for (const void* x : {m, l, delta, eq, ek, ev, eg, (const void*)e_scratch, (const void*)done})
    if (reinterpret_cast<uintptr_t>(x) % 4) return (int)cudaErrorInvalidValue;
  TcArgs a;
  a.qm = static_cast<const int8_t*>(qm);
  a.gm = static_cast<const int8_t*>(gm);
  a.km = static_cast<const int8_t*>(km);
  a.vm = static_cast<const int8_t*>(vm);
  a.m = static_cast<const float*>(m);
  a.l = static_cast<const float*>(l);
  a.delta = static_cast<const float*>(delta);
  a.rs = static_cast<const uint32_t*>(rs);
  a.rp2 = static_cast<const uint32_t*>(rp2);
  a.eq = static_cast<const int*>(eq);
  a.ek = static_cast<const int*>(ek);
  a.ev = static_cast<const int*>(ev);
  a.eg = static_cast<const int*>(eg);
  a.e_tile = static_cast<int*>(e_scratch);
  a.dk_acc = static_cast<int*>(acc_scratch);
  a.dv_acc = a.dk_acc + (size_t)BH * T * D;
  a.done = static_cast<int*>(done);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.GS = GS; a.T = T; a.D = D; a.s = s; a.q_off = q_off; a.kv_len = kv_len;
  a.causal = causal; a.window = window; a.p = p; a.bt = bt;
  a.NB = (T + bt - 1) / bt;
  a.NS = 2 * ((GS + RT - 1) / RT);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem_a = TcLayout(D, false).total, smem_b = TcLayout(D, true).total;
  void (*kern_a)(TcArgs, int) = D == 32   ? attn_bwd_tc_exp_kernel<32>
                                : D == 64  ? attn_bwd_tc_exp_kernel<64>
                                : D == 96  ? attn_bwd_tc_exp_kernel<96>
                                           : attn_bwd_tc_exp_kernel<128>;
  cudaError_t err = set_smem(kern_a, smem_a);
  if (err != cudaSuccess) return (int)err;
  kern_a<<<dim3(a.NS, a.NB, BH), TC_THREADS, smem_a, st>>>(a, BH);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  void (*kern)(TcArgs) = nullptr;
  switch (D * 2 + (stochastic ? 1 : 0)) {
    case 64: kern = attn_bwd_tc_kernel<32, false>; break;
    case 65: kern = attn_bwd_tc_kernel<32, true>; break;
    case 128: kern = attn_bwd_tc_kernel<64, false>; break;
    case 129: kern = attn_bwd_tc_kernel<64, true>; break;
    case 192: kern = attn_bwd_tc_kernel<96, false>; break;
    case 193: kern = attn_bwd_tc_kernel<96, true>; break;
    case 256: kern = attn_bwd_tc_kernel<128, false>; break;
    default: kern = attn_bwd_tc_kernel<128, true>; break;
  }
  if ((err = set_smem(kern, smem_b)) != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.NS, (unsigned)BH);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem_b;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  if ((err = cudaLaunchKernelEx(&cfg, kern, a)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
