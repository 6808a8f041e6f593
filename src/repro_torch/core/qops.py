"""Integer GEMM-shaped ops, forward halves (serving is gradient-free).

The port of the forward paths of ``repro.core.qops``: every op quantizes
its float32 operands to BFP, contracts the integer mantissas with exact
int32 accumulation and applies the exponent-add scale once.  Each
contraction asks ``kernels.dispatch`` for a path: the hand-written kernel
(``fused``) or the plain oracle path below (``jnp``).  Keys are split and
folded exactly as in the JAX package, so the same key gives the same
rounding bits and results compare with ``==``.

Also here: the load-time-quantized weight path (``_qmatmul_pw_fwd``), the
integer embedding gather, ``qdq_st`` and the qcache ops (cache rows
quantized once at append time, one exponent per row, nearest rounding).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dispatch as kd
from ..kernels.fused_linear import int8_dot
from . import prng
from .bfp import (BFP, PER_TENSOR, QuantConfig, biased_exponent, dequantize,
                  pow2, quantize, quantize_cache, quantize_weight,
                  rounding_bits, scale_exponent)
from .policy import NumericPolicy

__all__ = ["qmatmul", "qbmm", "qembed", "qdq_st", "qcache_quantize",
           "qcache_prefill", "qcache_append", "qcache_qk", "qcache_pv",
           "qcache_attention"]


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _chunk_count(k: int, chunk: int) -> int:
    if chunk <= 0 or k <= chunk:
        return 1
    return -(-k // chunk)


def _pt_dot(am: torch.Tensor, bm: torch.Tensor, nbatch: int,
            nchunk: int) -> torch.Tensor:
    """Integer dot, per-tensor scale: (*B, M, K) x (*B, N, K) -> f32.
    ``nchunk`` > 1 splits K (zero-padded) into int32 accumulators whose
    partials are combined in f32 (the accumulator-flush emulation)."""
    k = am.shape[-1]
    if nchunk == 1:
        return int8_dot(am, bm).to(torch.float32)
    kc = -(-k // nchunk)
    pad = nchunk * kc - k
    if pad:
        am = torch.nn.functional.pad(am, (0, pad))
        bm = torch.nn.functional.pad(bm, (0, pad))
    a4 = am.reshape(*am.shape[:-1], nchunk, kc).movedim(-2, nbatch)
    b4 = bm.reshape(*bm.shape[:-1], nchunk, kc).movedim(-2, nbatch)
    return int8_dot(a4, b4).to(torch.float32).sum(dim=nbatch)


def _blk_dot(aq: BFP, bq: BFP, nbatch: int) -> torch.Tensor:
    """Integer dot with per-block scales along the contraction axis."""
    blk = aq.cfg.block
    nb = aq.m.shape[-1] // blk
    a4 = aq.m.reshape(*aq.m.shape[:-1], nb, blk).movedim(-2, nbatch)
    b4 = bq.m.reshape(*bq.m.shape[:-1], nb, blk).movedim(-2, nbatch)
    acc = int8_dot(a4, b4).to(torch.float32)
    ea = scale_exponent(aq.e, aq.cfg).movedim(-1, nbatch)[..., :, None]
    eb = scale_exponent(bq.e, bq.cfg).movedim(-1, nbatch)[..., None, :]
    return (acc * pow2(ea + eb)).sum(dim=nbatch)


def _contract_q(aq: BFP, bq: BFP, nbatch: int, chunk: int) -> torch.Tensor:
    """Contraction of two pre-quantized contraction-last BFP operands."""
    if aq.cfg.block == PER_TENSOR:
        nchunk = _chunk_count(aq.m.shape[-1], chunk)
        acc = _pt_dot(aq.m, bq.m, nbatch, nchunk)
        return acc * pow2(scale_exponent(aq.e, aq.cfg)
                          + scale_exponent(bq.e, bq.cfg))
    return _blk_dot(aq, bq, nbatch)


def _cfg_for_dim(cfg: QuantConfig, dim: int) -> QuantConfig:
    if cfg.block and dim % cfg.block != 0:
        return QuantConfig(cfg.bits, PER_TENSOR, cfg.stochastic, cfg.rng)
    return cfg


def _wcfg_for(xcfg: QuantConfig, policy: NumericPolicy) -> QuantConfig:
    return QuantConfig(policy.fwd_bits, xcfg.block, policy.stochastic,
                       policy.rng)


def _plan(op: str, m: int, k: int, n: int, cfg: QuantConfig,
          policy: NumericPolicy, device: torch.device, kind: str = "qq",
          cfg2: Optional[QuantConfig] = None) -> kd.Decision:
    return kd.plan_contract(op, m, k, n, cfg, kind=kind, cfg2=cfg2,
                            kernel_mode=policy.kernel_mode,
                            accum_chunk=policy.accum_chunk,
                            device=device.type)


# ---------------------------------------------------------------------------
# qmatmul: x (..., K) @ w (K, N)
# ---------------------------------------------------------------------------

def _qmatmul_fwd(x: torch.Tensor, w: torch.Tensor, key: prng.Key,
                 policy: NumericPolicy) -> torch.Tensor:
    """Per-call weights: both operands quantized in the op (kind qq)."""
    cfg = _cfg_for_dim(policy.fwd_cfg(), x.shape[-1])
    kx, kw, _ = prng.split(key, 3)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    plan = _plan("qmatmul_fwd", x2.shape[0], x2.shape[1], w.shape[-1], cfg,
                 policy, x.device)
    if plan.path == kd.JNP:
        xq = quantize(x2, cfg, kx)
        wq = quantize_weight(_t(w), cfg, kw)
        y = _contract_q(xq, wq, 0, policy.accum_chunk)
    else:
        y, _, _ = kd.contract_qq(x2, _t(w), cfg, kx, kw, plan)
    return y.reshape(*lead, w.shape[-1])


def _qmatmul_pw_fwd(x: torch.Tensor, w: BFP, key: prng.Key,
                    policy: NumericPolicy) -> torch.Tensor:
    """Load-time-quantized weight (per tensor, (K, N) mantissas): only
    the activation is quantized in the op (kind qi)."""
    kx, _, _ = prng.split(key, 3)
    lead = x.shape[:-1]
    k, n = x.shape[-1], w.m.shape[-1]
    x2 = x.reshape(-1, k)
    wq = BFP(_t(w.m), w.e, w.cfg)                        # (N, K)
    cfg = _wcfg_for(w.cfg, policy)
    plan = _plan("qmatmul_fwd", x2.shape[0], k, n, cfg, policy, x.device,
                 kind="qi", cfg2=w.cfg)
    if plan.path == kd.JNP:
        y = _contract_q(quantize(x2, cfg, kx), wq, 0, policy.accum_chunk)
    else:
        y, _ = kd.contract_qi(x2, wq, cfg, kx, plan)
    return y.reshape(*lead, n)


def qmatmul(x: torch.Tensor, w, key: Optional[prng.Key] = None,
            policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Quantized linear contraction x (..., K) @ w (K, N); ``w`` may be a
    per-tensor BFP (a load-time-quantized serving weight)."""
    if not policy.enabled:
        wf = dequantize(w) if isinstance(w, BFP) else w
        return x @ wf
    if key is None:
        raise ValueError("qmatmul with an enabled integer policy needs a PRNG key")
    if isinstance(w, BFP) and (w.cfg.block != PER_TENSOR
                               or policy.block != PER_TENSOR):
        w = dequantize(w)
    if isinstance(w, BFP):
        return _qmatmul_pw_fwd(x, w, key, policy)
    return _qmatmul_fwd(x, w, key, policy)


# ---------------------------------------------------------------------------
# qbmm: a (*B, M, K) @ b (*B, K, N)
# ---------------------------------------------------------------------------

def qbmm(a: torch.Tensor, b: torch.Tensor, key: Optional[prng.Key] = None,
         policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Quantized batched matmul (both operands quantized in the op)."""
    if not policy.enabled:
        return a @ b
    if key is None:
        raise ValueError("qbmm with an enabled integer policy needs a PRNG key")
    cfg = _cfg_for_dim(policy.fwd_cfg(), a.shape[-1])
    ka, kb_, _ = prng.split(key, 3)
    nbatch = a.ndim - 2
    plan = _plan("qbmm_fwd", a.shape[-2], a.shape[-1], b.shape[-1], cfg,
                 policy, a.device)
    if plan.path == kd.JNP:
        aq = quantize(a, cfg, ka)
        bq = quantize(_t(b), cfg, kb_)
        return _contract_q(aq, bq, nbatch, policy.accum_chunk)
    y, _, _ = kd.contract_qq(a, _t(b), cfg, ka, kb_, plan, nbatch=nbatch)
    return y


# ---------------------------------------------------------------------------
# qembed: integer embedding gather
# ---------------------------------------------------------------------------

def qembed(tokens: torch.Tensor, table, key: Optional[prng.Key] = None,
           policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Integer embedding lookup: an int8 row gather scaled by 2^E.  A
    per-tensor BFP table (``_qembed_p_fwd``) needs no quantization."""
    if isinstance(table, BFP) and table.cfg.block != PER_TENSOR:
        table = dequantize(table)
    if not (policy.enabled and policy.quantize_embed):
        tf = dequantize(table) if isinstance(table, BFP) else table
        return tf[tokens]
    if key is None:
        raise ValueError("qembed with an enabled integer policy needs a PRNG key")
    if isinstance(table, BFP):
        rows = table.m[tokens]
        return rows.to(torch.float32) * pow2(scale_exponent(table.e, table.cfg))
    cfg = _cfg_for_dim(policy.fwd_cfg(), table.shape[-1])
    kt, _ = prng.split(key)
    tq = quantize_weight(table, cfg, kt)
    rows = tq.m[tokens]
    scale = pow2(scale_exponent(tq.e, cfg))
    if cfg.block == PER_TENSOR:
        return rows.to(torch.float32) * scale
    erows = scale[tokens]
    return (rows.reshape(*rows.shape[:-1], -1, cfg.block).to(torch.float32)
            * erows[..., None]).reshape(rows.shape)


def qdq_st(x: torch.Tensor, key: prng.Key, cfg: QuantConfig) -> torch.Tensor:
    """Stochastic quantize-dequantize (forward of the straight-through op)."""
    return dequantize(quantize(x, cfg, key))


# ---------------------------------------------------------------------------
# qcache: quantized KV caches, one exponent per row, nearest rounding
# ---------------------------------------------------------------------------

def qcache_quantize(x: torch.Tensor, policy: NumericPolicy,
                    cfg: Optional[QuantConfig] = None) -> BFP:
    cfg = cfg or policy.cache_cfg(x.shape[-1])
    return quantize_cache(x, cfg)


def qcache_prefill(x: torch.Tensor, pad: int, policy: NumericPolicy) -> BFP:
    """Quantize prefill rows once and pad the time axis (-2) to the cache
    length with the qcache zero (mantissa 0, exponent 1)."""
    q = qcache_quantize(x, policy)
    if pad:
        m = torch.nn.functional.pad(q.m, (0, 0, 0, pad))
        e = torch.nn.functional.pad(q.e, (0, 0, 0, pad), value=1)
        return BFP(m, e, q.cfg)
    return q


def qcache_append(cache: BFP, x: torch.Tensor, pos: int, axis: int) -> BFP:
    """Quantize a fresh row block and write it at ``pos`` along ``axis``.
    The cache is updated in place (it is never read at the old value)."""
    row = quantize_cache(x, cache.cfg)
    n = row.m.shape[axis]
    pos = max(0, min(int(pos), cache.m.shape[axis] - n))
    cache.m.narrow(axis, pos, n).copy_(row.m)
    cache.e.narrow(axis, pos, n).copy_(row.e)
    return cache


def _unit_view(m: torch.Tensor, bits: int, rng: str) -> BFP:
    """Per-tensor view of raw mantissas under a unit reference scale."""
    ucfg = QuantConfig(bits, PER_TENSOR, False, rng)
    e = torch.tensor(biased_exponent(0, ucfg), dtype=torch.int32,
                     device=m.device)
    return BFP(m, e, ucfg)


def _row_scales(q: BFP) -> torch.Tensor:
    """(*B, 1, T) float scale of each cache row."""
    return pow2(scale_exponent(q.e, q.cfg)).transpose(-1, -2)


def qcache_qk(a: torch.Tensor, kq: BFP, key: Optional[prng.Key],
              policy: NumericPolicy) -> torch.Tensor:
    """Decode scores a (*B, M, D) f32 against cache mantissas (*B, T, D)
    with the row exponents applied per output column -> (*B, M, T)."""
    nbatch = kq.m.ndim - 2
    t, d = kq.m.shape[-2], kq.m.shape[-1]
    bq = _unit_view(kq.m, kq.cfg.bits, kq.cfg.rng)
    cfg = policy.fwd_cfg()
    plan = _plan("qdecode_qk", a.shape[-2], d, t, cfg, policy, a.device,
                 kind="qi", cfg2=bq.cfg)
    if plan.path == kd.JNP:
        y = _contract_q(quantize(a, cfg, key), bq, nbatch, policy.accum_chunk)
    else:
        y, _ = kd.contract_qi(a, bq, cfg, key, plan, nbatch=nbatch)
    return y * _row_scales(kq)


def qcache_pv(p: torch.Tensor, vq: BFP, key: Optional[prng.Key],
              policy: NumericPolicy) -> torch.Tensor:
    """Decode mix p (*B, M, T) against cache mantissas (*B, T, D): the row
    exponents fold into p before its single quantization -> (*B, M, D)."""
    nbatch = vq.m.ndim - 2
    t, d = vq.m.shape[-2], vq.m.shape[-1]
    p2 = p * _row_scales(vq)
    bq = _unit_view(_t(vq.m), vq.cfg.bits, vq.cfg.rng)
    cfg = policy.fwd_cfg()
    plan = _plan("qdecode_pv", p.shape[-2], t, d, cfg, policy, p.device,
                 kind="qi", cfg2=bq.cfg)
    if plan.path == kd.JNP:
        return _contract_q(quantize(p2, cfg, key), bq, nbatch,
                           policy.accum_chunk)
    y, _ = kd.contract_qi(p2, bq, cfg, key, plan, nbatch=nbatch)
    return y


def qcache_attention(q: torch.Tensor, kq: BFP, vq: BFP, q_off: int,
                     kv_len: int, key: Optional[prng.Key],
                     policy: NumericPolicy, *, s: int, causal: bool,
                     window: int) -> torch.Tensor:
    """Fused decode attention straight off the int8 cache rows (a FUSED
    ``attn_decode`` plan): q (*B, GS, D) f32 is quantized per tensor once
    here, p is quantized inside the kernel."""
    lead = kq.m.shape[:-2]
    t, d = kq.m.shape[-2], kq.m.shape[-1]
    cfg_q = QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                        policy.rng)
    qq = quantize(q, cfg_q, None if key is None else prng.fold_in(key, 0))
    gs = qq.m.shape[-2]
    q3 = qq.m.reshape(-1, gs, d)
    sr = policy.stochastic and key is not None
    rp = (rounding_bits(prng.fold_in(key, 1), (q3.shape[0], gs, t),
                        policy.rng, q.device) if sr else None)
    y3 = kd.attn_decode(
        q3, kq.m.reshape(-1, t, d), vq.m.reshape(-1, t, d),
        kq.e.reshape(-1, t, 1), vq.e.reshape(-1, t, 1), rp, qq.e, q_off,
        kv_len, p=policy.fwd_bits - 1, s=s, causal=causal, window=window,
        stochastic=sr)
    return y3.reshape(*lead, gs, d)
