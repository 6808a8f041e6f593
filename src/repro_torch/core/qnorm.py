"""Integer layer-norm, RMSNorm and batch-norm: integer forward and integer
backward.

The port of ``repro.core.qnorm``'s ``_qln`` and ``_qbn``: the input is
quantized to int8 fixed point, the mean, centering, variance, fixed-point
rsqrt and both normalization products run in int32 (``core.fixed_point``),
and the result is mapped back to float32 once.  The qflow seams: a
per-tensor BFP input enters the fixed-point datapath as it is (q-in: its
mantissas are the Fx value, no quantize), and ``out_q=True`` emits a
per-tensor BFP (q-out: unify the per-row exponents, narrow to int8, no
float32 round trip) with a float32 gradient carrier through which the
backward receives its gradient.
The backward is the paper's integer norm backward

    dx = (1/sigma) * [ gamma*g  -  mean(gamma*g)  -  xhat * mean(gamma*g*xhat) ]

in the same calculus, from residuals kept narrow (int8 centered mantissas,
the per-row rsqrt and the quantized gain).  Batch-norm normalizes each
channel over all leading axes: the same calculus with per-channel
statistics, whose column sums over the N*H*W rows are int32 sums (exact
on any device).  The same key gives the same output and gradients as the
JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng
from .bfp import (BFP, PER_TENSOR, QuantConfig, bfp_from_fx, bfp_value,
                  dequantize, pow2, scale_exponent)
from .fixed_point import (Fx, KeyGen, fx_add, fx_const, fx_div_n, fx_mul,
                          fx_narrow, fx_quantize, fx_rsqrt, fx_sub, fx_sum,
                          fx_to_f32, fx_unify)
from .policy import NumericPolicy

__all__ = ["qlayernorm", "qrmsnorm", "qbatchnorm", "norm_gain_fx"]


def norm_gain_fx(g: torch.Tensor, bits: int = 15):
    """A norm gain or shift vector as ``(1, K)`` int32 fixed-point
    mantissas and one int32 scale exponent (the fused norm -> GEMM chain's
    affine operands): ``g ~= m * 2^se``, ``m`` rounded to nearest (ties to
    even) at ``bits`` magnitude bits of the exponent of ``max|g|``, read
    from its bits.  An all-zero vector maps to zero mantissas."""
    g2 = g.reshape(1, -1).to(torch.float32)
    amax = torch.clamp(g2.abs().amax(), min=2.0 ** -30)
    eb = (amax.view(torch.int32) >> 23) & 0xFF
    se = (eb - 127 - (bits - 1)).to(torch.int32)
    m = torch.round(g2 * pow2(-se)).to(torch.int32)
    return m, se


def _row(v: Fx) -> Fx:
    """Broadcast a per-row Fx (...,) to column shape (..., 1)."""
    e = v.e if v.e.ndim == 0 else v.e[..., None]
    return Fx(v.m[..., None], e, v.bits)


def _norm_out_cfg(policy: NumericPolicy) -> QuantConfig:
    return QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                       policy.rng)


def _emit_bfp(o: Fx, policy: NumericPolicy, kg: KeyGen):
    """q-out: per-row Fx -> per-tensor int8 (m, e, carrier value)."""
    ocfg = _norm_out_cfg(policy)
    o8 = fx_narrow(fx_unify(o, kg), ocfg.p, kg)
    q = bfp_from_fx(o8.m, o8.e, ocfg)
    return q.m, q.e, dequantize(q)


def _qln_fwd(x: torch.Tensor, xe: Optional[torch.Tensor],
             xcfg: Optional[QuantConfig], gamma: torch.Tensor,
             beta: Optional[torch.Tensor], key: prng.Key,
             policy: NumericPolicy, eps: float, rms: bool, out_q: bool):
    """-> (y, or (m, e, carrier) when ``out_q``; residuals of the
    backward).  ``xcfg`` given: ``x`` holds per-tensor BFP mantissas with
    exponent ``xe`` (q-in)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    kg = KeyGen(key)
    pb = policy.fwd_bits
    dev = x.device
    if xcfg is None:
        xf = fx_quantize(x2, pb, kg(), rng=policy.rng)
    else:
        xf = Fx(x2.to(torch.int32), scale_exponent(xe, xcfg), xcfg.p)
    if rms:
        c7 = fx_narrow(xf, 7, kg)
    else:
        mu = fx_div_n(fx_sum(xf, n, kg), n, kg)
        c7 = fx_narrow(fx_sub(xf, _row(mu), kg), 7, kg)
    var = fx_div_n(fx_sum(fx_mul(c7, c7, kg), n, kg), n, kg)
    var = fx_add(var, fx_const(eps, device=dev), kg)
    rs = fx_rsqrt(var, kg)
    gf = fx_quantize(gamma, pb, kg())
    xhat = fx_mul(c7, _row(rs), kg)
    o = fx_mul(xhat, gf, kg)
    res = (Fx(c7.m.to(torch.int8), c7.e, c7.bits), rs, gf,
           prng.fold_in(key, 0xBACC))
    if beta is not None:
        o = fx_add(o, fx_quantize(beta, pb, kg()), kg)
    if out_q:
        m, e, carrier = _emit_bfp(o, policy, kg)
        return (m.reshape(*lead, n), e, carrier.reshape(*lead, n)), res
    return fx_to_f32(o).reshape(*lead, n), res


def _qln_bwd(policy: NumericPolicy, rms: bool, res, gy: torch.Tensor):
    """-> (dx, dgamma, dbeta or None for RMSNorm)."""
    c7s, rs, gf, kb = res
    n = gy.shape[-1]
    g2 = gy.reshape(-1, n)
    c7 = Fx(c7s.m.to(torch.int32), c7s.e, c7s.bits)
    kg = KeyGen(kb)
    gq = fx_quantize(g2, policy.bwd_bits, kg(), rng=policy.rng)
    t = fx_mul(gf, gq, kg)                                   # gamma * g
    xhat = fx_narrow(fx_mul(c7, _row(rs), kg), 7, kg)        # normalized x
    u = fx_mul(t, xhat, kg)
    m2 = fx_div_n(fx_sum(u, n, kg), n, kg)                   # mean(gamma g xhat)
    if rms:
        diff = fx_sub(t, fx_mul(xhat, _row(m2), kg), kg)
    else:
        m1 = fx_div_n(fx_sum(t, n, kg), n, kg)               # mean(gamma g)
        diff = fx_sub(fx_sub(t, _row(m1), kg), fx_mul(xhat, _row(m2), kg),
                      kg)
    dx = fx_to_f32(fx_mul(diff, _row(rs), kg)).reshape(gy.shape)
    rows = g2.shape[0]
    dgamma = fx_to_f32(fx_sum(fx_unify(fx_mul(gq, xhat, kg), kg), rows, kg,
                              axis=0))
    dbeta = None if rms else fx_to_f32(fx_sum(gq, rows, kg, axis=0))
    return dx, dgamma, dbeta


class _QLN(torch.autograd.Function):
    """The integer norm with its integer backward (``_qln`` of the JAX
    package).  With a BFP input, ``x`` holds its mantissas and ``xg`` its
    carrier, which the forward never reads and which receives dx.  With
    ``out_q`` the outputs are (m, e, carrier): the backward's gradient
    arrives on the carrier."""

    @staticmethod
    def forward(ctx, x, xg, gamma, beta, xe, xcfg, key, policy, eps, rms,
                out_q):
        out, ctx.res = _qln_fwd(x, xe, xcfg, gamma, beta, key, policy, eps,
                                rms, out_q)
        ctx.policy, ctx.rms, ctx.out_q = policy, rms, out_q
        ctx.q_in, ctx.has_g = xcfg is not None, xg is not None
        if out_q:
            ctx.mark_non_differentiable(out[0], out[1])
        return out

    @staticmethod
    def backward(ctx, *cts):
        gy = cts[2] if ctx.out_q else cts[0]
        dx, dgamma, dbeta = _qln_bwd(ctx.policy, ctx.rms, ctx.res, gy)
        if ctx.q_in:
            dx_in = (None, dx if ctx.has_g else None)
        else:
            dx_in = (dx, None)
        return (*dx_in, dgamma, dbeta) + (None,) * 7


def _norm_call(x, gamma, beta, key, policy, eps, rms, out_q):
    """q-in / q-out entry: unpack a BFP input, wrap a BFP output."""
    if isinstance(x, BFP) and x.cfg.block != PER_TENSOR:
        x = bfp_value(x)       # a per-block scale varies along the norm axis
    if isinstance(x, BFP):
        out = _QLN.apply(x.m, x.g, gamma, beta, x.e, x.cfg, key, policy, eps,
                         rms, out_q)
    else:
        out = _QLN.apply(x, None, gamma, beta, None, None, key, policy, eps,
                         rms, out_q)
    if out_q:
        m, e, g = out
        return BFP(m, e, _norm_out_cfg(policy), g)
    return out


def qlayernorm(x, gamma: torch.Tensor, beta: Optional[torch.Tensor],
               key: Optional[prng.Key] = None,
               policy: NumericPolicy = NumericPolicy(), eps: float = 1e-5,
               *, out_q: bool = False):
    """Integer layer-norm over the last axis (float path when the policy
    keeps norms in float).  ``x`` may be a per-tensor BFP (q-in);
    ``out_q=True`` returns a per-tensor BFP with its carrier (q-out); the
    float path ignores ``out_q``."""
    if not (policy.enabled and policy.quantize_norms):
        x = bfp_value(x)
        mu = x.mean(-1, keepdim=True)
        v = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(v + eps) * gamma
        return y if beta is None else y + beta
    if key is None:
        raise ValueError("qlayernorm with an integer policy needs a PRNG key")
    return _norm_call(x, gamma, beta, key, policy, eps, False, out_q)


def qrmsnorm(x, gamma: torch.Tensor, key: Optional[prng.Key] = None,
             policy: NumericPolicy = NumericPolicy(), eps: float = 1e-6,
             *, out_q: bool = False):
    """Integer RMSNorm (the LM-zoo norm): no centering; BFP in and out as
    :func:`qlayernorm`."""
    if not (policy.enabled and policy.quantize_norms):
        x = bfp_value(x)
        v = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(v + eps) * gamma
    if key is None:
        raise ValueError("qrmsnorm with an integer policy needs a PRNG key")
    return _norm_call(x, gamma, None, key, policy, eps, True, out_q)


# ---------------------------------------------------------------------------
# batch-norm over all leading axes (channels-last)
# ---------------------------------------------------------------------------

def _col(v: Fx) -> Fx:
    """Broadcast a per-channel Fx (C,) across rows -> (1, C)."""
    e = v.e if v.e.ndim == 0 else v.e[None, :]
    return Fx(v.m[None, :], e, v.bits)


def _qbn_fwd(x: torch.Tensor, xe: Optional[torch.Tensor],
             xcfg: Optional[QuantConfig], gamma: torch.Tensor,
             beta: torch.Tensor, key: prng.Key, policy: NumericPolicy,
             eps: float, out_q: bool):
    """-> ((y, or (m, e, carrier) when ``out_q``), batch mean, batch var;
    residuals of the backward).  ``xcfg`` given: ``x`` holds per-tensor
    BFP mantissas with exponent ``xe`` (q-in)."""
    c = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, c)
    rows = x2.shape[0]
    kg = KeyGen(key)
    if xcfg is None:
        xf = fx_quantize(x2, policy.fwd_bits, kg(), rng=policy.rng)
    else:
        xf = Fx(x2.to(torch.int32), scale_exponent(xe, xcfg), xcfg.p)
    mu = fx_div_n(fx_sum(xf, rows, kg, axis=0), rows, kg)           # (C,)
    c7 = fx_narrow(fx_sub(xf, _col(mu), kg), 7, kg)
    var = fx_div_n(fx_sum(fx_mul(c7, c7, kg), rows, kg, axis=0), rows, kg)
    var = fx_add(var, fx_const(eps, device=x.device), kg)
    rs = fx_rsqrt(var, kg)                                          # (C,)
    gf = fx_quantize(gamma, policy.fwd_bits, kg())
    bf = fx_quantize(beta, policy.fwd_bits, kg())
    xhat = fx_mul(c7, _col(rs), kg)
    o = fx_add(fx_mul(xhat, _col(gf), kg), _col(bf), kg)
    stats = (fx_to_f32(mu), fx_to_f32(var))
    res = (Fx(c7.m.to(torch.int8), c7.e, c7.bits), rs, gf,
           prng.fold_in(key, 0xBACC))
    if out_q:
        m, e, carrier = _emit_bfp(o, policy, kg)
        return ((m.reshape(*lead, c), e, carrier.reshape(*lead, c)),
                *stats), res
    return (fx_to_f32(o).reshape(*lead, c), *stats), res


def _qbn_bwd(policy: NumericPolicy, res, gy: torch.Tensor):
    """-> (dx, dgamma, dbeta); no gradient flows through the batch
    statistics."""
    c7s, rs, gf, kb = res
    c = gy.shape[-1]
    g2 = gy.reshape(-1, c)
    rows = g2.shape[0]
    c7 = Fx(c7s.m.to(torch.int32), c7s.e, c7s.bits)
    kg = KeyGen(kb)
    gq = fx_quantize(g2, policy.bwd_bits, kg(), rng=policy.rng)
    t = fx_mul(_col(gf), gq, kg)                             # gamma * g
    xhat = fx_narrow(fx_mul(c7, _col(rs), kg), 7, kg)
    m1 = fx_div_n(fx_sum(t, rows, kg, axis=0), rows, kg)     # mean(gamma g)
    u = fx_mul(t, xhat, kg)
    m2 = fx_div_n(fx_sum(u, rows, kg, axis=0), rows, kg)     # mean(.. xhat)
    diff = fx_sub(fx_sub(t, _col(m1), kg), fx_mul(xhat, _col(m2), kg), kg)
    dx = fx_to_f32(fx_mul(diff, _col(rs), kg)).reshape(gy.shape)
    dgamma = fx_to_f32(fx_sum(fx_unify(fx_mul(gq, xhat, kg), kg), rows, kg,
                              axis=0))
    dbeta = fx_to_f32(fx_sum(gq, rows, kg, axis=0))
    return dx, dgamma, dbeta


class _QBN(torch.autograd.Function):
    """The integer batch-norm with its integer backward (``_qbn`` of the
    JAX package); inputs and outputs as ``_QLN``'s, plus the batch mean
    and variance, which take no gradient."""

    @staticmethod
    def forward(ctx, x, xg, gamma, beta, xe, xcfg, key, policy, eps, out_q):
        (y, mean, var), ctx.res = _qbn_fwd(x, xe, xcfg, gamma, beta, key,
                                           policy, eps, out_q)
        ctx.policy, ctx.out_q = policy, out_q
        ctx.q_in, ctx.has_g = xcfg is not None, xg is not None
        if out_q:
            ctx.mark_non_differentiable(y[0], y[1], mean, var)
            return (*y, mean, var)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, *cts):
        gy = cts[2] if ctx.out_q else cts[0]
        dx, dgamma, dbeta = _qbn_bwd(ctx.policy, ctx.res, gy)
        if ctx.q_in:
            dx_in = (None, dx if ctx.has_g else None)
        else:
            dx_in = (dx, None)
        return (*dx_in, dgamma, dbeta) + (None,) * 6


def qbatchnorm(x, gamma: torch.Tensor, beta: torch.Tensor,
               key: Optional[prng.Key] = None,
               policy: NumericPolicy = NumericPolicy(), eps: float = 1e-5,
               *, running=None, training: bool = True, out_q: bool = False):
    """Integer batch-norm over all leading axes (channels-last) ->
    ``(y, batch_mean, batch_var)``.  ``training=False`` (frozen) normalizes
    in float32 with the ``running`` (mean, var) and returns them; the float
    policy normalizes with the batch's float statistics.  ``x`` may be a
    per-tensor BFP (q-in) and ``out_q=True`` returns ``y`` as a per-tensor
    BFP with its carrier (q-out)."""
    if not training:
        rm, rv = running
        x = bfp_value(x)
        return (x - rm) * torch.rsqrt(rv + eps) * gamma + beta, rm, rv
    if not (policy.enabled and policy.quantize_norms):
        x = bfp_value(x)
        axes = tuple(range(x.ndim - 1))
        mu = x.mean(dim=axes)
        var = (x - mu).square().mean(dim=axes)
        return (x - mu) * torch.rsqrt(var + eps) * gamma + beta, mu, var
    if key is None:
        raise ValueError("qbatchnorm with an integer policy needs a PRNG key")
    if isinstance(x, BFP) and x.cfg.block != PER_TENSOR:
        x = bfp_value(x)
    if isinstance(x, BFP):
        out = _QBN.apply(x.m, x.g, gamma, beta, x.e, x.cfg, key, policy, eps,
                         out_q)
    else:
        out = _QBN.apply(x, None, gamma, beta, None, None, key, policy, eps,
                         out_q)
    if out_q:
        m, e, g, mean, var = out
        return BFP(m, e, _norm_out_cfg(policy), g), mean, var
    return out
