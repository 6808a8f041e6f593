"""Integer layer-norm and RMSNorm forward (serving is gradient-free).

The port of the forward half of ``repro.core.qnorm`` (``_qln_fwd`` without
the q-in/q-out seams): the input is quantized to int8 fixed point, the
mean, centering, variance, fixed-point rsqrt and both normalization
products run in int32 (``core.fixed_point``), and the result is mapped
back to float32 once.  The same key gives the same output as the JAX
package, bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng
from .fixed_point import (Fx, KeyGen, fx_add, fx_const, fx_div_n, fx_mul,
                          fx_narrow, fx_quantize, fx_rsqrt, fx_sub, fx_sum,
                          fx_to_f32)
from .policy import NumericPolicy

__all__ = ["qlayernorm", "qrmsnorm"]


def _row(v: Fx) -> Fx:
    """Broadcast a per-row Fx (...,) to column shape (..., 1)."""
    e = v.e if v.e.ndim == 0 else v.e[..., None]
    return Fx(v.m[..., None], e, v.bits)


def _qln_fwd(x: torch.Tensor, gamma: torch.Tensor,
             beta: Optional[torch.Tensor], key: prng.Key,
             policy: NumericPolicy, eps: float, rms: bool) -> torch.Tensor:
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
    if beta is None:
        y = fx_to_f32(o)
    else:
        bf = fx_quantize(beta, pb, kg())
        y = fx_to_f32(fx_add(o, bf, kg))
    return y.reshape(*lead, n)


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
    return _qln_fwd(x, gamma, beta, key, policy, eps, False)


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
    return _qln_fwd(x, gamma, None, key, policy, eps, True)
