"""Quantized attention: chunked online softmax (prefill and training) and
decode off the int8 cache.

The port of ``repro.models.attention`` for the dense path.  QKᵀ and PV are
integer contractions (``qbmm``, differentiable with the A.2 backward); the
softmax stays float32 (paper §5) and is rounded as the reference rounds it
(``core.fmath``), so ``chunked_attention`` is held against the reference's
values and gradients.  Under qflow, Q, K and V are quantized once, per
tensor, and either go through the fused attention kernels (``attn_fwd`` /
``attn_bwd``, when ``plan_attention`` plans them) or through the chunk
scan as BFP operands of ``qbmm``; their float32 carriers take the
gradients.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..core import fmath, prng
from ..core.bfp import BFP, PER_TENSOR, QuantConfig, quantize
from ..core.policy import NumericPolicy
from ..core.qops import (_cfg_for_dim, qattention, qbmm, qcache_attention,
                         qcache_pv, qcache_qk, qdq_st)
from ..kernels import dispatch as kd

__all__ = ["chunked_attention", "local_attention", "cache_decode_attention",
           "decode_attention"]

_NEG = -1e30


def _group_q(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, g*S, D): queries grouped under their KV
    head."""
    b, hq, s, d = q.shape
    return q.reshape(b, n_kv, (hq // n_kv) * s, d)


def _ungroup(o: torch.Tensor, hq: int) -> torch.Tensor:
    b, n_kv, gs, d = o.shape
    return o.reshape(b, hq, gs // (hq // n_kv), d)


def _qpos(s: int, g: int, offset: int, device) -> torch.Tensor:
    """Positions of grouped queries (g-major flattening)."""
    return torch.arange(s, dtype=torch.int32, device=device).repeat(g) + offset


def _fold(key: Optional[prng.Key], data: int) -> Optional[prng.Key]:
    return None if key is None else prng.fold_in(key, data)


class _Normalize(torch.autograd.Function):
    """acc / l over the rows, with the reference's backward:
    d acc = g / l, d l = sum_D((-g * acc) * (1 / (l * l)))."""

    @staticmethod
    def forward(ctx, acc, l):
        ctx.save_for_backward(acc, l)
        return acc / l[..., None]

    @staticmethod
    def backward(ctx, g):
        acc, l = ctx.saved_tensors
        lc = l[..., None]
        dl = fmath.sum_windows((-g * acc) * (1.0 / (lc * lc)), (-1,))
        return g / lc, dl


def _fused_attn_eligible(policy: NumericPolicy, key) -> bool:
    """Whether the call may ask for the fused attention kernels: Q/K/V
    arrive quantized once (qflow) and both directions are int8."""
    return (policy.enabled and policy.qflow and key is not None
            and policy.fwd_bits == 8 and policy.bwd_bits == 8)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key: Optional[prng.Key], policy: NumericPolicy, *,
                      causal: bool = True, q_offset: int = 0, window: int = 0,
                      chunk: int = 1024, scale: float = 0.0,
                      kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, S, D); k, v (B, Hkv, T, D) -> (B, Hq, S, D)."""
    b, hq, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    g = hq // n_kv
    sc = scale or 1.0 / math.sqrt(d)
    chunk = min(chunk, t)
    while t % chunk:
        chunk -= 1
    n_chunks = t // chunk

    qg = _group_q(q, n_kv) * sc
    qpos = _qpos(s, g, q_offset, q.device)
    qk_policy = policy
    qg_b = kq = vq = None
    if policy.enabled and policy.qflow and key is not None:
        # qflow: Q, K and V quantized once; the carriers are the floats
        # before quantization (straight-through)
        cfg_d = _cfg_for_dim(policy.fwd_cfg(), d)
        qgq = quantize(qg.detach(), cfg_d, prng.fold_in(key, 0x71))
        qg_b = BFP(qgq.m, qgq.e, qgq.cfg, qg)
        if cfg_d.block == PER_TENSOR:
            kq = quantize(k.detach(), cfg_d, prng.fold_in(key, 0x72))
            vq = quantize(v.detach(), cfg_d, prng.fold_in(key, 0x73))
            if _fused_attn_eligible(policy, key):
                plan = kd.plan_attention("attn_fwd", g * s, t, d, cfg_d, s=s,
                                         kind="pp",
                                         kernel_mode=policy.kernel_mode,
                                         device=q.device.type)
                if plan.path == kd.FUSED:
                    o = qattention(qg_b, BFP(kq.m, kq.e, cfg_d, k),
                                   BFP(vq.m, vq.e, cfg_d, v), q_offset,
                                   t if kv_len is None else kv_len,
                                   prng.fold_in(key, 0x74), policy, s=s,
                                   causal=causal, window=window, plan=plan)
                    return _ungroup(o, hq)
    elif policy.enabled and policy.stochastic and n_chunks > 1 and key is not None:
        # one stochastic QDQ of Q and K puts them on the int8 grid, so the
        # per-chunk QKᵀ requantizes them exactly with nearest rounding
        cfgf = policy.fwd_cfg()
        qg = qdq_st(qg, prng.fold_in(key, 0x71), cfgf)
        k = qdq_st(k, prng.fold_in(key, 0x72), cfgf)
        qk_policy = dataclasses.replace(policy, stochastic=False,
                                        stochastic_bwd=True)

    m = torch.full((b, n_kv, g * s), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g * s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g * s, d), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        cs = slice(ci * chunk, (ci + 1) * chunk)
        kb, vb = k[:, :, cs], v[:, :, cs]
        ckey = _fold(key, ci)
        kb_in = kb.transpose(-1, -2)                        # logical (D, C)
        if kq is not None:
            kb_in = BFP(kq.m[:, :, cs].transpose(-1, -2), kq.e, kq.cfg, kb_in)
            vb = BFP(vq.m[:, :, cs], vq.e, vq.cfg, vb)
        sck = qbmm(qg if qg_b is None else qg_b, kb_in, _fold(ckey, 0),
                   qk_policy)
        kpos = ci * chunk + torch.arange(chunk, dtype=torch.int32,
                                         device=q.device)
        mask = torch.ones((qpos.shape[0], chunk), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        sck = torch.where(mask, sck, torch.full_like(sck, _NEG))
        m_new = torch.maximum(m, sck.amax(dim=-1))
        p = torch.where(mask, fmath.exp(sck - m_new[..., None]),
                        torch.zeros_like(sck))
        alpha = fmath.exp(m - m_new)
        pv = qbmm(p, vb, _fold(ckey, 1), policy)
        m, l, acc = (m_new, fmath.fma(l, alpha, fmath.sum_windows(p, (-1,))),
                     fmath.fma(acc, alpha[..., None], pv))
    out = _Normalize.apply(acc, torch.clamp(l, min=1e-30))
    return _ungroup(out, hq)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key: Optional[prng.Key], policy: NumericPolicy, *,
                    window: int, scale: float = 0.0) -> torch.Tensor:
    """Banded causal attention (training and prefill of a local-window
    layer): each block of ``window`` queries attends to its own and the
    previous block of keys under the causal band mask, O(S * window).
    Needs S == T and S % window == 0; otherwise, and wherever the fused
    forward kernel is planned (its band mask is the chunked one), the
    chunked path."""
    b, hq, s, d = q.shape
    n_kv, t = k.shape[1], k.shape[2]
    if s != t or s % window:
        return chunked_attention(q, k, v, key, policy, causal=True,
                                 window=window, scale=scale)
    if _fused_attn_eligible(policy, key):
        cfg_d = _cfg_for_dim(policy.fwd_cfg(), d)
        if cfg_d.block == PER_TENSOR:
            plan = kd.plan_attention("attn_fwd", (hq // n_kv) * s, t, d,
                                     cfg_d, s=s, kind="pp",
                                     kernel_mode=policy.kernel_mode,
                                     device=q.device.type)
            if plan.path == kd.FUSED:
                return chunked_attention(q, k, v, key, policy, causal=True,
                                         window=window, scale=scale)
    w, g = window, hq // n_kv
    nb = s // w
    sc = scale or 1.0 / math.sqrt(d)
    # blocks of queries under their KV head: (B, Hkv, nb, g*W, D)
    qb = (q.reshape(b, n_kv, g, nb, w, d).permute(0, 1, 3, 2, 4, 5)
          .reshape(b, n_kv, nb, g * w, d)) * sc
    kb = k.reshape(b, n_kv, nb, w, d)
    vb = v.reshape(b, n_kv, nb, w, d)
    # each block's keys after the previous block's (zeros before block 0)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :, :1]),
                               kb[:, :, :-1]], dim=2), kb], dim=3)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :, :1]),
                               vb[:, :, :-1]], dim=2), vb], dim=3)
    sck = qbmm(qb, k2.transpose(-1, -2), _fold(key, 0), policy)
    qpos = torch.arange(w, device=q.device).repeat(g)     # in-block position
    kpos = torch.arange(2 * w, device=q.device) - w       # from block start
    mask = (kpos[None, :] <= qpos[:, None]) & \
        ((qpos[:, None] - kpos[None, :]) < w)
    valid = mask[None].repeat(nb, 1, 1)
    valid[0] &= (kpos >= 0)[None, :]
    sck = torch.where(valid, sck, torch.full_like(sck, _NEG))
    o = qbmm(_softmax(sck), v2, _fold(key, 1), policy)
    return (o.reshape(b, n_kv, nb, g, w, d).permute(0, 1, 3, 2, 4, 5)
            .reshape(b, hq, s, d))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def cache_decode_attention(q: torch.Tensor, kq: BFP, vq: BFP, pos: int,
                           key: Optional[prng.Key], policy: NumericPolicy, *,
                           causal: bool = True, window: int = 0,
                           scale: float = 0.0) -> torch.Tensor:
    """Decode attention straight off a quantized cache: q (B, Hq, S, D)
    float, kq/vq BFP caches with mantissas (B, Hkv, T, D) and one exponent
    per row (B, Hkv, T, 1).  Takes the fused decode kernel when
    ``plan_attention`` plans it, else the scan of the two cache GEMMs."""
    b, hq, s, d = q.shape
    n_kv, t = kq.m.shape[1], kq.m.shape[2]
    g = hq // n_kv
    sc = scale or 1.0 / math.sqrt(d)
    if window:
        w = min(window, t)
        start = max(0, min(pos - (w - 1), t - w))
        kq = BFP(kq.m[:, :, start:start + w], kq.e[:, :, start:start + w],
                 kq.cfg)
        vq = BFP(vq.m[:, :, start:start + w], vq.e[:, :, start:start + w],
                 vq.cfg)
        q_offset = pos - start
        t = w
    else:
        q_offset = pos

    qg = _group_q(q, n_kv) * sc
    qpos = _qpos(s, g, q_offset, q.device)
    if policy.qflow and key is not None:
        # qflow: Q quantized once, per tensor; QKᵀ then contracts it as it
        # is (kind pp), as the chunk path does
        qg = quantize(qg, _cfg_for_dim(policy.fwd_cfg(), d),
                      prng.fold_in(key, 0x71))
    if policy.enabled and policy.fwd_bits == 8 \
            and policy.block == PER_TENSOR and (
                not isinstance(qg, BFP) or qg.cfg.block == PER_TENSOR):
        cfg_q = QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                            policy.rng)
        plan = kd.plan_attention("attn_decode", g * s, t, d, cfg_q, s=s,
                                 kind="pp" if isinstance(qg, BFP) else "qi",
                                 kernel_mode=policy.kernel_mode,
                                 device=q.device.type)
        if plan.path == kd.FUSED:
            o = qcache_attention(qg, kq, vq, q_offset, t, key, policy, s=s,
                                 causal=causal, window=window)
            return _ungroup(o, hq)
    sck = qcache_qk(qg, kq, _fold(key, 0), policy)
    kpos = torch.arange(t, dtype=torch.int32, device=q.device)
    mask = torch.ones((qpos.shape[0], t), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    sck = torch.where(mask, sck, torch.full_like(sck, _NEG))
    p = torch.where(mask, _softmax(sck), torch.zeros_like(sck))
    o = qcache_pv(p, vq, _fold(key, 1), policy)
    return _ungroup(o, hq)


def decode_attention(q: torch.Tensor, k_cache, v_cache, pos: int,
                     key: Optional[prng.Key], policy: NumericPolicy, *,
                     window: int = 0, chunk: int = 0,
                     scale: float = 0.0) -> torch.Tensor:
    """One-token decode: a quantized (BFP) cache routes to
    :func:`cache_decode_attention`; float caches run the chunked path."""
    if isinstance(k_cache, BFP):
        return cache_decode_attention(q, k_cache, v_cache, pos, key, policy,
                                      window=window, scale=scale)
    if window:
        t = k_cache.shape[2]
        w = min(window, t)
        start = max(0, min(pos - (w - 1), t - w))
        return chunked_attention(q, k_cache[:, :, start:start + w],
                                 v_cache[:, :, start:start + w], key, policy,
                                 causal=True, q_offset=pos - start, chunk=w,
                                 scale=scale)
    return chunked_attention(q, k_cache, v_cache, key, policy, causal=True,
                             q_offset=pos, chunk=chunk or k_cache.shape[2],
                             scale=scale)
