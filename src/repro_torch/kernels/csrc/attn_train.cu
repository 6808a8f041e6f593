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
// memory at long sequence, so it runs in three launches:
//   A  grid (strip, block, slice): recompute pn and ds, reduce their
//      largest effective exponents with an integer atomicMax;
//   B  grid (strip, slice): walk the blocks in index order, recompute,
//      quantize with the known tile exponents, accumulate dq in float32 in
//      block order, and add the int32 partial sums of dk_j and dv_j with
//      integer atomics (exact in any order);
//   C  scale the int32 dk, dv sums by their powers of two.
// Integer dots use __dp4a on words packed in shared memory; the tensor
// cores (wgmma) and TMA are later work.
//
// Bounds on the H100.  Forward: each slice reads GS*D + 2*T*D int8 and
// 4 bytes of rounding bits per visible (row, position) pair, and writes
// 4*GS*D + 8*GS bytes; its 4*D int8 operations per visible pair are far
// below the bytes at qwen2-0.5b's shapes (GS = 896, T = 128, D = 64).
// Backward: 2*GS*D + 2*T*D int8, 12*GS bytes of stats and 8 bytes of bits
// per visible pair in; 4*GS*D + 8*T*D bytes out; 10*D operations per
// visible pair: bytes bound it too.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"
#include "fmath.cuh"

namespace {

using repro::cephes_expf;
using repro::eff_exp;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;

constexpr float NEG = -1e30f;     // models.attention._NEG
constexpr float L_FLOOR = 1e-30f; // jnp.maximum(l, 1e-30)

__device__ __forceinline__ bool visible(int kpos, int qpos, int kv_len,
                                        int causal, int window) {
  bool m = kpos < kv_len;
  if (causal) m = m && kpos <= qpos;
  if (window) m = m && (qpos - kpos) < window;
  return m;
}

// Smallest and largest query position of rows [r0, r1) (r1 > r0).
__device__ __forceinline__ void strip_positions(int r0, int r1, int s, int q_off,
                                                int* qmin, int* qmax) {
  int lo = 0x7fffffff, hi = -0x7fffffff;
  for (int r = r0; r < r1; ++r) {
    const int q = r % s + q_off;
    lo = min(lo, q);
    hi = max(hi, q);
  }
  *qmin = lo;
  *qmax = hi;
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
  const float pnv = __fdiv_rn(pt, fmaxf(l, L_FLOOR));
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

}  // extern "C"
