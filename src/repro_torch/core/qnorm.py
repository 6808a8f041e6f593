"""Integer layer-norm and RMSNorm: integer forward and integer backward.

The port of ``repro.core.qnorm``'s ``_qln`` (without the q-in/q-out
seams): the input is quantized to int8 fixed point, the mean, centering,
variance, fixed-point rsqrt and both normalization products run in int32
(``core.fixed_point``), and the result is mapped back to float32 once.
The backward is the paper's integer norm backward

    dx = (1/sigma) * [ gamma*g  -  mean(gamma*g)  -  xhat * mean(gamma*g*xhat) ]

in the same calculus, from residuals kept narrow (int8 centered mantissas,
the per-row rsqrt and the quantized gain).  The same key gives the same
output and gradients as the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng
from .fixed_point import (Fx, KeyGen, fx_add, fx_const, fx_div_n, fx_mul,
                          fx_narrow, fx_quantize, fx_rsqrt, fx_sub, fx_sum,
                          fx_to_f32, fx_unify)
from .policy import NumericPolicy

__all__ = ["qlayernorm", "qrmsnorm"]


def _row(v: Fx) -> Fx:
    """Broadcast a per-row Fx (...,) to column shape (..., 1)."""
    e = v.e if v.e.ndim == 0 else v.e[..., None]
    return Fx(v.m[..., None], e, v.bits)


def _qln_fwd(x: torch.Tensor, gamma: torch.Tensor,
             beta: Optional[torch.Tensor], key: prng.Key,
             policy: NumericPolicy, eps: float, rms: bool):
    """-> (y, residuals of the backward)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, n)
    kg = KeyGen(key)
    pb = policy.fwd_bits
    dev = x.device
    xf = fx_quantize(x2, pb, kg(), rng=policy.rng)
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
    if beta is None:
        y = fx_to_f32(o)
    else:
        bf = fx_quantize(beta, pb, kg())
        y = fx_to_f32(fx_add(o, bf, kg))
    return y.reshape(*lead, n), res


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
    package)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, key, policy, eps, rms):
        y, ctx.res = _qln_fwd(x, gamma, beta, key, policy, eps, rms)
        ctx.policy, ctx.rms = policy, rms
        return y

    @staticmethod
    def backward(ctx, gy):
        dx, dgamma, dbeta = _qln_bwd(ctx.policy, ctx.rms, ctx.res, gy)
        return dx, dgamma, dbeta, None, None, None, None


def qlayernorm(x: torch.Tensor, gamma: torch.Tensor,
               beta: Optional[torch.Tensor], key: Optional[prng.Key] = None,
               policy: NumericPolicy = NumericPolicy(),
               eps: float = 1e-5) -> torch.Tensor:
    """Integer layer-norm over the last axis (float path when the policy
    keeps norms in float)."""
    if not (policy.enabled and policy.quantize_norms):
        mu = x.mean(-1, keepdim=True)
        v = (x - mu).square().mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(v + eps) * gamma
        return y if beta is None else y + beta
    if key is None:
        raise ValueError("qlayernorm with an integer policy needs a PRNG key")
    return _QLN.apply(x, gamma, beta, key, policy, eps, False)


def qrmsnorm(x: torch.Tensor, gamma: torch.Tensor,
             key: Optional[prng.Key] = None,
             policy: NumericPolicy = NumericPolicy(),
             eps: float = 1e-6) -> torch.Tensor:
    """Integer RMSNorm (the LM-zoo norm): no centering."""
    if not (policy.enabled and policy.quantize_norms):
        v = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(v + eps) * gamma
    if key is None:
        raise ValueError("qrmsnorm with an integer policy needs a PRNG key")
    return _QLN.apply(x, gamma, None, key, policy, eps, True)
