// Fused decode attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces fused_attn_decode_pallas of src/repro/kernels/fused_attention.py
// (its _decode_core).  One (batch * KV-head) slice: the grouped query rows
// qm (GS, D) int8 with one per-tensor exponent eq, and the cache rows km/vm
// (T, D) int8 with one exponent per row (ek, ev).
//
//   scores  s[r,t] = int32 dot(qm[r], km[t]) * 2^(sq + sk[t]), masked;
//   softmax p = exp(s - max_t s) / sum_t, in float32;
//   fold    p2[r,t] = p[r,t] * 2^(sv[t])  (exact: V runs at unit scale);
//   p2 quantized per query row over the whole band (shared exponent =
//           max effective exponent of the row), against streamed bits;
//   PV      y[r,d] = int32 sum_t ph[r,t] * vm[t,d] * 2^(scale of the row).
//
// Design.  The TPU kernel keeps the band in VMEM in one program; one block
// of an SM holds at most 227 KB, and one block per slice leaves the card
// idle (qwen2's decode grid is B * 2 slices).  So each slice runs on a
// thread-block cluster of n blocks (kernels/fused_attention.py
// decode_split: at least 8 windows a block, at most 8 blocks, 16 where 8
// do not hold the band), each block a contiguous range of the band that
// starts and ends on a boundary of the row sum's windows of 32 positions
// (core/fmath.py sum_windows: offset by before = (32 ceil(T/32) - T) / 2).
// A block holds its range's f32 scores and int8 p in shared memory, so the
// longest band grows n-fold.  A band of at most 256 positions runs on one
// block, where one warp takes each query row from its scores to its
// quantized p with the row's values in registers.
//
// Each block: one thread issues 1-D bulk copies of its K rows, then its V
// rows, in chunks of 128 positions through a ring of shared-memory stages
// (the V copies land while the softmax runs; a range the ring holds whole
// needs no barrier between its chunks); D % 32 != 0 rows are copied by the
// threads into rows padded with zeros to a multiple of 32.  The query, the
// row exponents and the bits of a short range come in by asynchronous
// copies meanwhile.  Scores
// run on mma.sync.m16n8k32.s8 (the GS rows padded to 16; one 16-byte load
// of a K row feeds two k32 steps, the query read with the same byte order),
// the PV products likewise with the V rows transposed in registers (byte
// permutes of four rows).  The blocks exchange only what the numerics
// need, written into each other's shared memory (distributed shared memory)
// between cluster barriers: the row max (order-free), every window sum
// (each block sums its own windows in index order; every block then sums
// all window sums in fmath's order, windowed again past 1024 positions),
// the row's largest effective exponent of p2 (order-free) and the int32 PV
// partials, added into rank 0's accumulator (exact in any order).  Rank 0
// writes y.  Every float operation is the plain version's: the Cephes exp
// of __fsub_rn(s, max) (fmath.cuh), the windowed row sum, an IEEE division,
// so y is bit-equal to kernels/fused_attention.py attn_decode_plain.
//
// Bound on the H100: the cache rows, 2*T*D bytes plus 8*T bytes of row
// exponents per slice, and the rounding bits, 4*GS*T bytes, over
// 3.35 TB/s.  At qwen2's decode (T 160) the band is a few KB a slice:
// latency sets the time (the first loads, then each phase's dependent
// steps, on a cluster its four barriers).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bfp.cuh"
#include "fmath.cuh"
#include "sm90.cuh"

namespace {

namespace cg = cooperative_groups;

using repro::bulk_load;
using repro::cluster_arrive_relaxed;
using repro::cluster_sync;
using repro::cluster_wait;
using repro::eff_exp;
using repro::mbar_expect_tx;
using repro::mbar_fence_init;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_s8_m16n8k32;
using repro::pow2f;
using repro::quantize_one;
using repro::scale_exp;
using repro::transpose4;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CH = 128;      // positions a ring stage holds
constexpr int NMAX = 16;     // largest cluster
constexpr int BPRE = 2048;   // most rounding bits prefetched into shared memory
constexpr float NEG = -1e30f;  // models.attention._NEG

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// The split of a (GS, T, D) slice over n blocks and one block's shared
// memory (kernels/fused_attention.py _decode_layout mirrors it).
struct DecLayout {
  int n, m, before, W, Dp, MT, stages, kld, ub, wsp, lvl;
  size_t ring, qs, sf, ph, ws, lv, xmax, xe, erow, qp, acc, ekv, bpre, bar, total;
  __host__ __device__ DecLayout(int GS, int T, int D, int n_) {
    n = n_;
    m = (T + 31) / 32;                // windows of the row sum
    before = (32 * m - T) / 2;        // positions of window 0 before t = 0
    W = (m + n - 1) / n;              // windows a block
    Dp = (D + 31) / 32 * 32;          // a row in shared memory
    MT = (GS + 15) / 16;              // 16-row mma tiles of the query
    stages = Dp <= 64 ? 4 : 2;
    const int kch = (32 * W + CH - 1) / CH;
    kld = kch * CH + 16;              // p row stride (bytes): no bank conflict
    ub = 33 * W;                      // a score row: one pad float a window
    wsp = m + m / 32 + 1;             // every window sum of a row, padded
    lvl = (m + 31) / 32;              // sums of the second level and beyond
    ring = 0;
    qs = align16(ring + (size_t)stages * CH * Dp);
    sf = align16(qs + (size_t)16 * MT * Dp);
    ph = align16(sf + 4 * (size_t)GS * ub);
    ws = align16(ph + (size_t)GS * kld);
    lv = align16(ws + 4 * (size_t)GS * wsp);
    xmax = align16(lv + 4 * (size_t)GS * 2 * lvl);
    xe = align16(xmax + 4 * (size_t)NMAX * GS);
    erow = align16(xe + 4 * (size_t)NMAX * GS);
    qp = align16(erow + 4 * (size_t)GS);
    acc = align16(qp + 4 * (size_t)GS);
    ekv = align16(acc + 4 * (size_t)GS * Dp);
    bpre = align16(ekv + 4 * (size_t)2 * THREADS);
    bar = align16(bpre + 4 * (size_t)min(GS * 32 * W, BPRE));
    total = bar + 8 * (size_t)stages;
  }
};

struct DecArgs {
  const int8_t* qm;
  const int* eq;
  const int8_t* km;
  const int8_t* vm;
  const int* ek;
  const int* ev;
  const uint32_t* rp;
  float* y;
  int GS, T, D, s, q_off, kv_len, causal, window, p, bulk;
};

__device__ __forceinline__ bool visible(int t, int qpos, int kv_len, int causal,
                                        int window) {
  bool m = t < kv_len;
  if (causal) m = m && t <= qpos;
  if (window) m = m && (qpos - t) < window;
  return m;
}

__device__ __forceinline__ float warp_max_f(float v) {
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
  for (int o = 16; o > 0; o /= 2) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The row sum from its m window sums (ws[w + w / 32]) in core/fmath.py
// sum_windows's order, by one warp: in order when m <= 32, else windowed
// again (lv: two buffers of L floats) until at most 32 remain, then in
// order.  Every lane returns the sum.
__device__ __forceinline__ float row_total(const float* ws, float* lv, int m, int L,
                                           int lane) {
  const float* cur = ws;
  bool padded = true;
  float* nxt = lv;
  int len = m;
  while (len > 32) {
    const int m2 = (len + 31) / 32, b2 = (32 * m2 - len) / 2;
    for (int w = lane; w < m2; w += 32) {
      float part = 0.0f;
      for (int i = 0; i < 32; ++i) {
        const int x = 32 * w + i - b2;
        if (x >= 0 && x < len) part = __fadd_rn(part, cur[padded ? x + x / 32 : x]);
      }
      nxt[w] = part;
    }
    __syncwarp();
    cur = nxt;
    padded = false;
    nxt = nxt == lv ? lv + L : lv;
    len = m2;
  }
  float v[32];
#pragma unroll
  for (int w = 0; w < 32; ++w) v[w] = w < len ? cur[padded ? w + w / 32 : w] : 0.0f;
  float tot = 0.0f;
#pragma unroll
  for (int w = 0; w < 32; ++w)
    if (w < len) tot = __fadd_rn(tot, v[w]);
  return tot;
}

// A warp's int32 PV sums of m-tile mt (n-tile nt's column c is head column
// 4 (c + 8 blk) + nt) into the block's accumulator (exact in any order).
__device__ __forceinline__ void pv_flush(const int (&c)[4][4], int* acc, int mt, int blk,
                                         int GS, int Dp) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * mt + g + 8 * h, d = 4 * (2 * tig + e + 8 * blk) + nt;
        const int v = c[nt][2 * h + e];
        if (r < GS && v != 0) atomicAdd(&acc[r * Dp + d], v);
      }
}

template <bool STOCH>
__global__ void __launch_bounds__(THREADS, 1) attn_decode_kernel(const DecArgs a, const int n) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cl = cg::this_cluster();
  // no block writes into another before every block of the cluster runs
  if (n > 1) cluster_arrive_relaxed();
  const int rank = (int)cl.block_rank();
  const int GS = a.GS, T = a.T, D = a.D, p = a.p;
  const DecLayout L(GS, T, D, n);
  const size_t bh = blockIdx.x / n;
  int8_t* ring = reinterpret_cast<int8_t*>(smem + L.ring);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + L.qs);
  float* sf = reinterpret_cast<float*>(smem + L.sf);
  int8_t* ph = reinterpret_cast<int8_t*>(smem + L.ph);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* lv = reinterpret_cast<float*>(smem + L.lv);
  float* xmax = reinterpret_cast<float*>(smem + L.xmax);
  int* xe = reinterpret_cast<int*>(smem + L.xe);
  int* erow = reinterpret_cast<int*>(smem + L.erow);
  int* qp = reinterpret_cast<int*>(smem + L.qp);  // each row's query position
  int* acc = reinterpret_cast<int*>(smem + L.acc);
  int* eks = reinterpret_cast<int*>(smem + L.ekv);
  int* evs = eks + THREADS;
  uint32_t* bpre = reinterpret_cast<uint32_t*>(smem + L.bpre);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, tig = lane % 4;
  const int S = L.stages, Dp = L.Dp;
  // one warp owns each query row from the scores to its quantized p: a
  // single block needs no barrier between those phases, a cluster one
  auto exchange = [&]() {
    if (n > 1)
      cluster_sync();
    else
      __syncwarp();
  };
  // this block's windows [w0, w1) and positions [t0, t1); u = t - base
  // indexes its windows from 0 (32 positions each)
  const int w0 = rank * L.W, w1 = min(L.m, w0 + L.W);
  const int base = 32 * w0 - L.before;
  const int t0 = max(0, base), t1 = min(T, 32 * w1 - L.before);
  const int nb = t1 - t0, nkc = (nb + CH - 1) / CH;
  const int8_t* kg = a.km + (bh * T + t0) * (size_t)D;
  const int8_t* vg = a.vm + (bh * T + t0) * (size_t)D;
  const int* ekg = a.ek + bh * T + t0;
  const int* evg = a.ev + bh * T + t0;
  const uint32_t* rpg = STOCH ? a.rp + bh * GS * (size_t)T + t0 : nullptr;

  // ring chunk i: K rows of chunk i (i < nkc), then V rows of chunk i - nkc
  auto rows_of = [&](int i) { return min(CH, nb - (i < nkc ? i : i - nkc) * CH); };
  auto src_of = [&](int i) {
    return (i < nkc ? kg + (size_t)i * CH * D : vg + (size_t)(i - nkc) * CH * D);
  };
  auto slot_of = [&](int i) { return ring + (size_t)(i % S) * CH * Dp; };
  auto issue = [&](int i) {  // one thread, bulk path: D % 32 == 0, Dp == D
    const uint32_t bytes = (uint32_t)rows_of(i) * D;
    mbar_expect_tx(&full[i % S], bytes);
    bulk_load(slot_of(i), src_of(i), bytes, &full[i % S]);
  };
  auto fill = [&](int i) {  // every thread, rows padded with zeros to Dp
    int* dst = reinterpret_cast<int*>(slot_of(i));
    const int8_t* src = src_of(i);
    const int rows = rows_of(i), DW = D / 4, PW = Dp / 4;
    for (int x = tid; x < rows * PW; x += THREADS) {
      const int r = x / PW, w = x % PW;
      dst[x] = w < DW ? *reinterpret_cast<const int*>(src + (size_t)r * D + 4 * w) : 0;
    }
  };
  auto chunk_ready = [&](int i) {
    if (a.bulk) {
      mbar_wait(&full[i % S], (uint32_t)(i / S) & 1u);
    } else {
      fill(i);
      __syncthreads();
    }
  };
  // every chunk of K and V fits the ring at once: no slot is reused, so
  // only the last K chunk ends with a barrier
  const bool resident = a.bulk && 2 * nkc <= S;
  auto chunk_done = [&](int i) {  // every thread is past chunk i
    if (resident && i != nkc - 1) return;
    __syncthreads();
    if (a.bulk && tid == 0 && i + S < 2 * nkc) issue(i + S);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (a.bulk && tid == 0)
    for (int i = 0; i < min(S, 2 * nkc); ++i) issue(i);

  // while the bulk copies land, asynchronous copies of the query (rows past
  // GS and bytes past D zero) and of a short range's row exponents (one
  // group, awaited before the scores), and of its bits (a second group,
  // awaited before p is quantized); 16-byte pieces where aligned
  {
    const int8_t* qg = a.qm + bh * GS * (size_t)D;
    if (D % 16 == 0 && GS * D % 16 == 0) {
      const int PC = Dp / 16, DC = D / 16;
      for (int x = tid; x < 16 * L.MT * PC; x += THREADS) {
        const int r = x / PC, c = x % PC;
        const bool ok = r < GS && c < DC;
        repro::cp_async16(qs + 16 * x, ok ? qg + (size_t)r * D + 16 * c : a.qm, ok ? 16u : 0u);
      }
    } else {
      const int PW = Dp / 4, DW = D / 4;
      for (int x = tid; x < 16 * L.MT * PW; x += THREADS) {
        const int r = x / PW, w = x % PW;
        const bool ok = r < GS && w < DW;
        repro::cp_async4(qs + 4 * x, ok ? qg + (size_t)r * D + 4 * w : a.qm, ok ? 4u : 0u);
      }
    }
    for (int x = tid; x < GS * Dp; x += THREADS) acc[x] = 0;
    for (int r = tid; r < GS; r += THREADS) qp[r] = r % a.s + a.q_off;
  }
  const bool ek_pre = nb <= THREADS;
  if (ek_pre && tid < nb) {
    repro::cp_async4(eks + tid, ekg + tid, 4u);
    repro::cp_async4(evs + tid, evg + tid, 4u);
  }
  repro::cp_async_commit();
  const bool b_pre = STOCH && GS * nb <= min(GS * 32 * L.W, BPRE);
  if (b_pre) {
    if (T % 4 == 0 && t0 % 4 == 0 && nb % 4 == 0 &&
        reinterpret_cast<uintptr_t>(a.rp) % 16 == 0) {
      for (int r = 0; r < GS; ++r)
        for (int k = 4 * tid; k < nb; k += 4 * THREADS)
          repro::cp_async16(bpre + r * nb + k, rpg + (size_t)r * T + k, 16u);
    } else {
      for (int r = 0; r < GS; ++r)
        for (int k = tid; k < nb; k += THREADS)
          repro::cp_async4(bpre + r * nb + k, rpg + (size_t)r * T + k, 4u);
    }
  }
  repro::cp_async_commit();
  const int* ekp = ek_pre ? eks : ekg;
  const int* evp = ek_pre ? evs : evg;
  const int sq = scale_exp(*a.eq, p);
  repro::cp_async_wait<1>();  // the query and row exponents
  __syncthreads();

  // scores of the K chunks: warps take 8-position n-tiles, every m-tile
  const int CR = Dp / 16, CG = (CR + 3) / 4;
  // the K-row scales of this thread's positions of a chunk (its two
  // n-tiles), each chunk's loaded while the one before is scored
  constexpr int NTW = CH / 8 / WARPS;
  int ekn[NTW][2];
  auto load_ek = [&](int i) {
#pragma unroll
    for (int it = 0; it < NTW; ++it)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = i * CH + (warp + WARPS * it) * 8 + 2 * tig + e;
        ekn[it][e] = k < nb ? ekp[k] : 0;
      }
  };
  load_ek(0);
  for (int i = 0; i < nkc; ++i) {
    float sc[NTW][2];
#pragma unroll
    for (int it = 0; it < NTW; ++it)
#pragma unroll
      for (int e = 0; e < 2; ++e) sc[it][e] = pow2f(sq + scale_exp(ekn[it][e], p));
    if (i + 1 < nkc) load_ek(i + 1);
    chunk_ready(i);
    const int8_t* slot = slot_of(i);
    const int rows = rows_of(i);
#pragma unroll
    for (int it = 0; it < NTW; ++it) {
      const int nt = warp + WARPS * it;
      if (nt * 8 >= rows) break;
      const int8_t* krow = slot + (size_t)(nt * 8 + g) * Dp;
      for (int mt = 0; mt < L.MT; ++mt) {
        int c[4] = {0, 0, 0, 0};
        const int8_t* q0 = qs + (size_t)(16 * mt + g) * Dp;
        for (int q = 0; q < CG; ++q) {
          const int ch = tig + 4 * q;
          uint4 kb = make_uint4(0u, 0u, 0u, 0u), qa = kb, qb = kb;
          if (ch < CR) {
            kb = *reinterpret_cast<const uint4*>(krow + 16 * ch);
            qa = *reinterpret_cast<const uint4*>(q0 + 16 * ch);
            qb = *reinterpret_cast<const uint4*>(q0 + 8 * (size_t)Dp + 16 * ch);
          }
          mma_s8_m16n8k32(c, qa.x, qb.x, qa.y, qb.y, kb.x, kb.y);
          mma_s8_m16n8k32(c, qa.z, qb.z, qa.w, qb.w, kb.z, kb.w);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * mt + g + 8 * h;
          if (r >= GS) continue;
          const int qpos = qp[r];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = i * CH + nt * 8 + 2 * tig + e;
            if (k >= nb) continue;
            const int t = t0 + k;
            const unsigned u = t - base;
            sf[(size_t)r * L.ub + u + (u >> 5)] =
                visible(t, qpos, a.kv_len, a.causal, a.window)
                    ? __int2float_rn(c[2 * h + e]) * sc[it][e]
                    : NEG;
          }
        }
      }
    }
    chunk_done(i);
  }

  if (n == 1 && nb <= 8 * 32) {
    // one block, at most 8 windows: one warp takes each row from its scores
    // to its quantized p, the row's values held in registers (8 a lane)
    repro::cp_async_wait<0>();  // the bits
    __syncthreads();
    for (int r = warp; r < GS; r += WARPS) {
      float* row = sf + (size_t)r * L.ub;
      float v[8];
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned u = lane + 32 * i + L.before;  // t0 = 0, base = -before
        v[i] = lane + 32 * i < nb ? row[u + (u >> 5)] : mx;
        mx = fmaxf(mx, v[i]);
      }
      mx = warp_max_f(mx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned u = lane + 32 * i + L.before;
        if (lane + 32 * i < nb) {
          v[i] = repro::cephes_expf(__fsub_rn(v[i], mx));
          row[u + (u >> 5)] = v[i];
        }
      }
      __syncwarp();
      float part = 0.0f;  // window `lane`'s sum, in index order
      if (lane < L.m) {
        float w[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) w[i] = row[33 * lane + i];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int t = 32 * lane + i - L.before;
          if (t >= 0 && t < T) part = __fadd_rn(part, w[i]);
        }
      }
      float tot = 0.0f;  // the window sums in order (m <= 8)
      for (int w = 0; w < L.m; ++w) tot = __fadd_rn(tot, __shfl_sync(0xffffffffu, part, w));
      const int qpos = qp[r];
      int em = 1;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = lane + 32 * i;
        if (k < nb) {
          const float pn =
              visible(k, qpos, a.kv_len, a.causal, a.window) ? __fdiv_rn(v[i], tot) : 0.0f;
          v[i] = __fmul_rn(pn, pow2f(scale_exp(evp[k], p)));
          em = max(em, eff_exp(v[i]));
        }
      }
      em = warp_max_i(em);
      if (lane == 0) erow[r] = em;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = lane + 32 * i;
        if (k < nkc * CH) {
          int q = 0;
          if (k < nb) {
            uint32_t bits = 0;
            if (STOCH) bits = b_pre ? bpre[r * nb + k] : rpg[(size_t)r * T + k];
            q = quantize_one(v[i], bits, em, p, STOCH);
          }
          ph[(size_t)r * L.kld + k] = (int8_t)q;
        }
      }
    }
  } else {
    // row max: each block's, into every block, then the cluster's
    if (n > 1) cluster_wait();
    for (int r = warp; r < GS; r += WARPS) {
      float mx = __int_as_float(0xff800000);  // -inf
#pragma unroll 4
      for (int k = lane; k < nb; k += 32) {
        const unsigned u = t0 + k - base;
        mx = fmaxf(mx, sf[(size_t)r * L.ub + u + (u >> 5)]);
      }
      mx = warp_max_f(mx);
      if (lane < n) cl.map_shared_rank(xmax, lane)[rank * GS + r] = mx;
    }
    exchange();

    // exp(s - max) in place, this block's window sums into every block
    for (int r = warp; r < GS; r += WARPS) {
      float mx = __int_as_float(0xff800000);
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, xmax[j * GS + r]);
      mx = warp_max_f(mx);
      float* row = sf + (size_t)r * L.ub;
#pragma unroll 4
      for (int k = lane; k < nb; k += 32) {
        const unsigned u = t0 + k - base;
        row[u + (u >> 5)] = repro::cephes_expf(__fsub_rn(row[u + (u >> 5)], mx));
      }
      __syncwarp();
      for (int j = lane; j < w1 - w0; j += 32) {
        // the window's 32 loads issued at once, the adds in index order
        float v[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = row[33 * j + i];
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int t = base + 32 * j + i;
          if (t >= t0 && t < t1) part = __fadd_rn(part, v[i]);
        }
        const int w = w0 + j;
        for (int dst = 0; dst < n; ++dst)
          cl.map_shared_rank(ws, dst)[(size_t)r * L.wsp + w + w / 32] = part;
      }
    }
    exchange();

    // the row sum (every block sums every window the same way), p2 and the
    // block's largest effective exponent of each row, into every block
    for (int r = warp; r < GS; r += WARPS) {
      const float tot = row_total(ws + (size_t)r * L.wsp, lv + (size_t)r * 2 * L.lvl, L.m,
                                  L.lvl, lane);
      const int qpos = qp[r];
      float* row = sf + (size_t)r * L.ub;
      int em = 1;
#pragma unroll 8
      for (int k = lane; k < nb; k += 32) {
        const int t = t0 + k;
        const unsigned u = t - base;
        const float pn = visible(t, qpos, a.kv_len, a.causal, a.window)
                             ? __fdiv_rn(row[u + (u >> 5)], tot)
                             : 0.0f;
        const float p2 = __fmul_rn(pn, pow2f(scale_exp(evp[k], p)));
        row[u + (u >> 5)] = p2;
        em = max(em, eff_exp(p2));
      }
      em = warp_max_i(em);
      if (lane < n) cl.map_shared_rank(xe, lane)[rank * GS + r] = em;
    }
    repro::cp_async_wait<0>();  // the bits
    if (n > 1)
      cluster_sync();
    else
      __syncthreads();

    // p quantized against the row's exponent over the whole band; zero past
    // the range up to the last chunk's end
    for (int r = warp; r < GS; r += WARPS) {
      int em = 1;
      for (int j = lane; j < n; j += 32) em = max(em, xe[j * GS + r]);
      em = warp_max_i(em);
      if (lane == 0) erow[r] = em;
      const float* row = sf + (size_t)r * L.ub;
#pragma unroll 8
      for (int k = lane; k < nkc * CH; k += 32) {
        int q = 0;
        if (k < nb) {
          const unsigned u = t0 + k - base;
          uint32_t bits = 0;
          if (STOCH) bits = b_pre ? bpre[r * nb + k] : rpg[(size_t)r * T + k];
          q = quantize_one(row[u + (u >> 5)], bits, em, p, STOCH);
        }
        ph[(size_t)r * L.kld + k] = (int8_t)q;
      }
    }
  }
  __syncthreads();

  // PV of the V chunks: warp w takes the 32 columns blk = w % NBLK of the
  // (padded) head dim and the chunk's k32 steps w / NBLK, + WPB, ...; a
  // thread's four V words (four rows, column quad g + 8 blk) transposed
  // feed four n-tiles: n-tile nt's column c is head column 4 (c + 8 blk) + nt
  const int NBLK = Dp / 32, WPB = WARPS / NBLK;
  const bool pv_warp = warp < NBLK * WPB;
  const int blk = warp % NBLK, ks0 = warp / NBLK, quad = g + 8 * blk;
  int c[4][4] = {};
  for (int vc = 0; vc < nkc; ++vc) {
    const int i = nkc + vc;
    chunk_ready(i);
    const int8_t* slot = slot_of(i);
    if (pv_warp) {
      for (int mt = 0; mt < L.MT; ++mt) {
        if (L.MT > 1)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int x = 0; x < 4; ++x) c[nt][x] = 0;
        const int ra = 16 * mt + g, rb = ra + 8;
        for (int ks = ks0; ks < (rows_of(i) + 31) / 32; ks += WPB) {
          const int kb = ks * 32;
          uint32_t w0r[4], w1r[4], b0[4], b1[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w0r[j] = *reinterpret_cast<const uint32_t*>(slot + (size_t)(kb + 4 * tig + j) * Dp + 4 * quad);
            w1r[j] = *reinterpret_cast<const uint32_t*>(slot + (size_t)(kb + 16 + 4 * tig + j) * Dp + 4 * quad);
          }
          transpose4(w0r, b0);
          transpose4(w1r, b1);
          const size_t kp = (size_t)vc * CH + kb + 4 * tig;
          const uint32_t a0 = ra < GS ? *reinterpret_cast<const uint32_t*>(ph + ra * (size_t)L.kld + kp) : 0u;
          const uint32_t a2 = ra < GS ? *reinterpret_cast<const uint32_t*>(ph + ra * (size_t)L.kld + kp + 16) : 0u;
          const uint32_t a1 = rb < GS ? *reinterpret_cast<const uint32_t*>(ph + rb * (size_t)L.kld + kp) : 0u;
          const uint32_t a3 = rb < GS ? *reinterpret_cast<const uint32_t*>(ph + rb * (size_t)L.kld + kp + 16) : 0u;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_s8_m16n8k32(c[nt], a0, a1, a2, a3, b0[nt], b1[nt]);
        }
        if (L.MT > 1) pv_flush(c, acc, mt, blk, GS, Dp);
      }
    }
    chunk_done(i);
  }
  if (pv_warp && L.MT == 1) pv_flush(c, acc, 0, blk, GS, Dp);  // summed over every chunk first
  __syncthreads();

  // the block's int32 partials into rank 0's accumulator (exact in any order)
  if (rank != 0) {
    int* dst = cl.map_shared_rank(acc, 0);
    for (int x = tid; x < GS * Dp; x += THREADS) {
      const int v = acc[x];
      if (v != 0) atomicAdd(dst + x, v);
    }
  }
  if (n > 1) cluster_sync();
  if (rank == 0)
    for (int x = tid; x < GS * D; x += THREADS) {
      const int r = x / D, d = x % D;
      a.y[(bh * GS + r) * D + d] =
          __int2float_rn(acc[r * Dp + d]) * pow2f(scale_exp(erow[r], p));
    }
}

bool aligned(const void* ptr, uintptr_t bytes) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

}  // namespace

extern "C" {

// Shared memory one block of an n-block cluster needs for a (GS, T, D)
// slice.
long long repro_attn_decode_smem(int GS, int T, int D, int n) {
  return (long long)DecLayout(GS, T, D, n).total;
}

// qm (BH,GS,D) int8, eq int32 scalar, km/vm (BH,T,D) int8, ek/ev (BH,T)
// int32, rp (BH,GS,T) uint32 or null -> y (BH,GS,D) f32, on clusters of n
// blocks (n a split of the band's windows: n == ceil(m / ceil(m / n)),
// m = ceil(T / 32)).  D % 4 == 0, D <= 256; qm, km, vm 16-byte aligned,
// ek, ev, rp and eq 4-byte aligned, else cudaErrorInvalidValue.
int repro_attn_decode(const void* qm, const void* eq, const void* km,
                      const void* vm, const void* ek, const void* ev,
                      const void* rp, void* y, int BH, int GS, int T, int D,
                      int s, int q_off, int kv_len, int causal, int window,
                      int p, int stochastic, int n, void* stream) {
  if (D % 4 || D > 256 || GS < 1 || T < 1 || n < 1 || n > NMAX) return (int)cudaErrorInvalidValue;
  if (!aligned(qm, 16) || !aligned(km, 16) || !aligned(vm, 16) || !aligned(ek, 4) ||
      !aligned(ev, 4) || !aligned(rp, 4) || !aligned(eq, 4))
    return (int)cudaErrorInvalidValue;
  const DecLayout L(GS, T, D, n);
  if ((L.m + L.W - 1) / L.W != n) return (int)cudaErrorInvalidValue;
  auto kern = stochastic ? attn_decode_kernel<true> : attn_decode_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return (int)err;
  if (n > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  DecArgs a;
  a.qm = static_cast<const int8_t*>(qm);
  a.eq = static_cast<const int*>(eq);
  a.km = static_cast<const int8_t*>(km);
  a.vm = static_cast<const int8_t*>(vm);
  a.ek = static_cast<const int*>(ek);
  a.ev = static_cast<const int*>(ev);
  a.rp = static_cast<const uint32_t*>(rp);
  a.y = static_cast<float*>(y);
  a.GS = GS; a.T = T; a.D = D; a.s = s; a.q_off = q_off; a.kv_len = kv_len;
  a.causal = causal; a.window = window; a.p = p; a.bulk = D % 32 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(BH * n));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a, n);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
