"""Integer GEMM-shaped ops with integer forward and integer backward.

The port of ``repro.core.qops``: every op quantizes its float32 operands
to BFP, contracts the integer mantissas with exact int32 accumulation and
applies the exponent-add scale once.  ``qmatmul``, ``qbmm``, ``qembed``
and ``qdq_st`` are ``torch.autograd.Function``s whose forward keeps the
int8 mantissas as residuals and whose backward is Appendix A.2: the
upstream gradient is quantized once and both dX = Ĝ Ŵᵀ and dW = X̂ᵀ Ĝ are
integer contractions (the embedding's dTable an int32 scatter-add).  Each
contraction asks ``kernels.dispatch`` for a path: the hand-written kernel
(``fused``: ``qq`` forward, ``qi`` dX, ``ii`` dW) or the plain oracle path
below (``jnp``).  Keys are split and folded exactly as in the JAX package,
so the same key gives the same rounding bits and results compare with
``==``.  The per-block (MX-style) scales have their forward here; their
backward needs the per-block kernel and raises.

Also here: the load-time-quantized weight path (``_qmatmul_pw_fwd``,
serving only), ``qdq_st`` and the qcache ops (cache rows quantized once at
append time, one exponent per row, nearest rounding).
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


def _tq(q: BFP) -> BFP:
    """Transpose the last two axes of a per-tensor BFP (a view)."""
    return BFP(_t(q.m), q.e, q.cfg)


def _per_block_bwd(op: str):
    raise NotImplementedError(
        f"{op} backward with per-block scales needs the per-block kernel "
        "(fused_qq_blk_pallas), which is not ported yet")


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
                 policy: NumericPolicy):
    """Per-call weights: both operands quantized in the op (kind qq).
    -> (y, residuals (xq, wq, kb, lead))."""
    cfg = _cfg_for_dim(policy.fwd_cfg(), x.shape[-1])
    kx, kw, kb = prng.split(key, 3)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    plan = _plan("qmatmul_fwd", x2.shape[0], x2.shape[1], w.shape[-1], cfg,
                 policy, x.device)
    if plan.path == kd.JNP:
        xq = quantize(x2, cfg, kx)
        wq = quantize_weight(_t(w), cfg, kw)
        y = _contract_q(xq, wq, 0, policy.accum_chunk)
    else:
        y, xq, wq = kd.contract_qq(x2, _t(w), cfg, kx, kw, plan)
    return y.reshape(*lead, w.shape[-1]), (xq, wq, kb, lead)


def _qmatmul_bwd(policy: NumericPolicy, res, gy: torch.Tensor):
    """A.2: Ĝ quantized once; dX = Ĝ Ŵᵀ (kind qi), dW = X̂ᵀ Ĝ (kind ii)
    on the stored mantissas.  -> (dx, dw)."""
    xq, wq, kb, lead = res
    if policy.block != PER_TENSOR:
        _per_block_bwd("qmatmul")
    cfg_b = policy.bwd_cfg()
    kg, _, _, _ = prng.split(kb, 4)
    g2 = gy.reshape(-1, gy.shape[-1])
    m, n = g2.shape
    k = xq.m.shape[-1]
    plan_dx = _plan("qmatmul_dx", m, n, k, cfg_b, policy, gy.device,
                    kind="qi", cfg2=wq.cfg)
    if plan_dx.path == kd.JNP:
        gqn = quantize(g2, cfg_b, kg)
        dx = _contract_q(gqn, _tq(wq), 0, policy.accum_chunk)
    else:
        dx, gqn = kd.contract_qi(g2, _tq(wq), cfg_b, kg, plan_dx)
    gqm = _tq(gqn)                       # (N, M): the same mantissas
    plan_dw = _plan("qmatmul_dw", k, m, n, gqm.cfg, policy, gy.device,
                    kind="ii", cfg2=xq.cfg)
    if plan_dw.path == kd.JNP:
        dw = _contract_q(_tq(xq), gqm, 0, policy.accum_chunk)
    else:
        dw = kd.contract_ii(_tq(xq), gqm, plan_dw)
    return dx.reshape(*lead, dx.shape[-1]), dw


class _QMatmul(torch.autograd.Function):
    """x (..., K) @ w (K, N), both quantized in the op (``_qmatmul``)."""

    @staticmethod
    def forward(ctx, x, w, key, policy):
        y, ctx.res = _qmatmul_fwd(x, w, key, policy)
        ctx.policy = policy
        return y

    @staticmethod
    def backward(ctx, gy):
        dx, dw = _qmatmul_bwd(ctx.policy, ctx.res, gy)
        return dx, dw, None, None


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
    """Quantized linear contraction x (..., K) @ w (K, N) with the A.2
    integer backward; ``w`` may be a per-tensor BFP (a load-time-quantized
    serving weight: forward only)."""
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
    return _QMatmul.apply(x, w, key, policy)


# ---------------------------------------------------------------------------
# qbmm: a (*B, M, K) @ b (*B, K, N)
# ---------------------------------------------------------------------------

def _qbmm_fwd(a: torch.Tensor, b: torch.Tensor, key: prng.Key,
              policy: NumericPolicy):
    """-> (y, residuals (aq, bq, kres))."""
    cfg = _cfg_for_dim(policy.fwd_cfg(), a.shape[-1])
    ka, kb_, kres = prng.split(key, 3)
    nbatch = a.ndim - 2
    plan = _plan("qbmm_fwd", a.shape[-2], a.shape[-1], b.shape[-1], cfg,
                 policy, a.device)
    if plan.path == kd.JNP:
        aq = quantize(a, cfg, ka)
        bq = quantize(_t(b), cfg, kb_)
        y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
    else:
        y, aq, bq = kd.contract_qq(a, _t(b), cfg, ka, kb_, plan,
                                   nbatch=nbatch)
    return y, (aq, bq, kres)


def _qbmm_bwd(policy: NumericPolicy, res, gy: torch.Tensor):
    """A.2 for the batched product: da = Ĝ B̂ᵀ (qi), db = Âᵀ Ĝ (ii)."""
    aq, bq, kres = res
    if policy.block != PER_TENSOR:
        _per_block_bwd("qbmm")
    cfg_b = policy.bwd_cfg()
    kg, _, _, _ = prng.split(kres, 4)
    nbatch = gy.ndim - 2
    m, n = gy.shape[-2], gy.shape[-1]
    k = aq.m.shape[-1]
    plan_da = _plan("qbmm_dx", m, n, k, cfg_b, policy, gy.device, kind="qi",
                    cfg2=bq.cfg)
    if plan_da.path == kd.JNP:
        gq = quantize(gy, cfg_b, kg)
        da = _contract_q(gq, _tq(bq), nbatch, policy.accum_chunk)
    else:
        da, gq = kd.contract_qi(gy, _tq(bq), cfg_b, kg, plan_da,
                                nbatch=nbatch)
    plan_db = _plan("qbmm_dw", k, m, n, gq.cfg, policy, gy.device, kind="ii",
                    cfg2=aq.cfg)
    if plan_db.path == kd.JNP:
        db = _contract_q(_tq(aq), _tq(gq), nbatch, policy.accum_chunk)
    else:
        db = kd.contract_ii(_tq(aq), _tq(gq), plan_db, nbatch=nbatch)
    return da, db


class _QBmm(torch.autograd.Function):
    """a (*B, M, K) @ b (*B, K, N), both quantized in the op (``_qbmm``)."""

    @staticmethod
    def forward(ctx, a, b, key, policy):
        y, ctx.res = _qbmm_fwd(a, b, key, policy)
        ctx.policy = policy
        return y

    @staticmethod
    def backward(ctx, gy):
        da, db = _qbmm_bwd(ctx.policy, ctx.res, gy)
        return da, db, None, None


def qbmm(a: torch.Tensor, b: torch.Tensor, key: Optional[prng.Key] = None,
         policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Quantized batched matmul (both operands quantized in the op) with
    the A.2 integer backward."""
    if not policy.enabled:
        return a @ b
    if key is None:
        raise ValueError("qbmm with an enabled integer policy needs a PRNG key")
    return _QBmm.apply(a, b, key, policy)


# ---------------------------------------------------------------------------
# qembed: integer embedding gather
# ---------------------------------------------------------------------------

def _qembed_fwd(tokens: torch.Tensor, table: torch.Tensor, key: prng.Key,
                policy: NumericPolicy):
    cfg = _cfg_for_dim(policy.fwd_cfg(), table.shape[-1])
    kt, kb = prng.split(key)
    tq = quantize_weight(table, cfg, kt)
    rows = tq.m[tokens]
    scale = pow2(scale_exponent(tq.e, cfg))
    if cfg.block == PER_TENSOR:
        y = rows.to(torch.float32) * scale
    else:
        erows = scale[tokens]
        y = (rows.reshape(*rows.shape[:-1], -1, cfg.block).to(torch.float32)
             * erows[..., None]).reshape(rows.shape)
    return y, kb


def _qembed_bwd(policy: NumericPolicy, tokens: torch.Tensor, vocab: int,
                kb: prng.Key, gy: torch.Tensor) -> torch.Tensor:
    """dTable: the upstream gradient quantized once per tensor, its int8
    mantissas scatter-added into int32 rows, one rescale."""
    if policy.block != PER_TENSOR:
        _per_block_bwd("qembed")
    cfg_b = policy.bwd_cfg()
    g2 = gy.reshape(-1, gy.shape[-1])
    gq = quantize(g2, QuantConfig(cfg_b.bits, PER_TENSOR, cfg_b.stochastic,
                                  cfg_b.rng), kb)
    acc = torch.zeros((vocab, g2.shape[-1]), dtype=torch.int32,
                      device=g2.device)
    acc.index_add_(0, tokens.reshape(-1).long(), gq.m.to(torch.int32))
    return acc.to(torch.float32) * pow2(scale_exponent(gq.e, gq.cfg))


class _QEmbed(torch.autograd.Function):
    """Integer gather forward, integer scatter-add backward (``_qembed``)."""

    @staticmethod
    def forward(ctx, tokens, table, key, policy):
        y, kb = _qembed_fwd(tokens, table, key, policy)
        ctx.res = (tokens, table.shape[0], kb)
        ctx.policy = policy
        return y

    @staticmethod
    def backward(ctx, gy):
        tokens, vocab, kb = ctx.res
        return None, _qembed_bwd(ctx.policy, tokens, vocab, kb, gy), None, None


def qembed(tokens: torch.Tensor, table, key: Optional[prng.Key] = None,
           policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Integer embedding lookup: an int8 row gather scaled by 2^E, with the
    int32 scatter-add backward.  A per-tensor BFP table
    (``_qembed_p_fwd``, serving) needs no quantization."""
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
    return _QEmbed.apply(tokens, table, key, policy)


class _QdqST(torch.autograd.Function):
    """Stochastic quantize-dequantize, straight-through gradient."""

    @staticmethod
    def forward(ctx, x, key, cfg):
        return dequantize(quantize(x, cfg, key))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def qdq_st(x: torch.Tensor, key: prng.Key, cfg: QuantConfig) -> torch.Tensor:
    """Stochastic quantize-dequantize with a straight-through gradient: the
    values land on the int8 grid, so later per-tensor requantizations at
    the same scale are exact under nearest rounding."""
    return _QdqST.apply(x, key, cfg)


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
