"""Plain torch oracles for the kernels (the port of ``repro.kernels.ref``).

They restate the kernel semantics independently of ``core.bfp`` so that a
kernel can be held against a ground truth that shares no code with it.
Unsigned 32-bit values (IEEE bit patterns, rounding bits) live in int64.
"""

from __future__ import annotations

import torch

__all__ = ["bfp_quantize_ref", "max_biased_exp_ref", "int8_matmul_ref"]

_BASE_SHIFT = 17  # 24-bit mantissa -> 7 magnitude bits (int8)
_M32 = 0xFFFFFFFF


def _unpack(x: torch.Tensor):
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    sign = b >> 31
    bexp = (b >> 23) & 0xFF
    frac = b & 0x7FFFFF
    mant24 = torch.where(bexp > 0, frac | (1 << 23), frac)
    return sign, bexp.clamp(min=1), mant24


def bfp_quantize_ref(x: torch.Tensor, rand: torch.Tensor,
                     e_shared: torch.Tensor) -> torch.Tensor:
    """int8 mantissas of ``x`` against a given shared exponent (scalar or
    per-row (M, 1)), threshold-compare stochastic rounding against
    ``rand`` (uint32 values in int64)."""
    sign, eff, mant24 = _unpack(x)
    s = (e_shared.to(torch.int64) - eff) + _BASE_SHIFT
    s31 = s.clamp(max=31)
    base = torch.where(s < 32, mant24 >> s31, torch.zeros_like(mant24))
    m_lo = mant24 & ((1 << s31) - 1)
    left = (32 - s).clamp(0, 31)
    over = (s - 32).clamp(0, 31)
    thr = torch.where(s <= 31, (m_lo << left) & _M32,
                      torch.where(s == 32, mant24, mant24 >> over))
    up = (rand < thr) & (s > 0)
    mag = (base + up.to(torch.int64)).clamp(max=127)
    return torch.where(sign == 1, -mag, mag).to(torch.int8)


def max_biased_exp_ref(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Max effective biased exponent (int32) over ``axis`` (None = all)."""
    eff = ((x.to(torch.float32).contiguous().view(torch.int32) >> 23)
           & 0xFF).clamp(min=1)
    return eff.amax() if axis is None else eff.amax(dim=axis)


def int8_matmul_ref(a_m: torch.Tensor, b_m: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) x int8 (K, N) -> f32 (M, N): exact integer accumulate
    (float64 holds every int8 dot of K < 2^17 terms exactly), one scale."""
    acc = a_m.to(torch.float64) @ b_m.to(torch.float64)
    return acc.to(torch.float32) * scale
