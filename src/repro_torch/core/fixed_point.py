"""Integer fixed-point arithmetic with static bit budgeting.

The port of the ``Fx`` calculus of ``repro.core.fixed_point`` that the
integer norms (forward and backward) and the int16 SGD update use.  An ``Fx`` is an int32 mantissa tensor, a
(possibly per-row) power-of-two scale exponent and a static bound on the
mantissa bit length; every op inserts rounded shifts so no int32 can
overflow.  Key consumption (``KeyGen``) follows the JAX package call for
call, so the same key gives the same mantissas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from . import prng
from .bfp import (QuantConfig, bit_length, pow2, quantize, scale_exponent,
                  sr_shift_signed)

__all__ = ["Fx", "KeyGen", "fx_quantize", "fx_const", "fx_mul", "fx_add",
           "fx_sub", "fx_sum", "fx_narrow", "fx_div_n", "fx_rsqrt",
           "fx_unify", "fx_to_f32", "fx_neg"]

_MAX_BITS = 30


class KeyGen:
    """Deterministic stream of keys: ``fold_in(key, 1)``, ``(key, 2)``, ..."""

    def __init__(self, key: Optional[prng.Key]):
        self._key = key
        self._n = 0

    def __call__(self) -> Optional[prng.Key]:
        if self._key is None:
            return None
        self._n += 1
        return prng.fold_in(self._key, self._n)


@dataclasses.dataclass
class Fx:
    """value = m * 2^e; |m| < 2^bits (bits is static)."""

    m: torch.Tensor   # int32 mantissa
    e: torch.Tensor   # int32 scale exponent; scalar or broadcastable to m
    bits: int


def _i32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=device)


def _clog2(n: int) -> int:
    return max(int(math.ceil(math.log2(n))), 0) if n > 1 else 0


def _shift_to(m: torch.Tensor, s, key, stochastic=True) -> torch.Tensor:
    """m * 2^s: left shift where s >= 0, rounded right shift where s < 0."""
    s = _i32(s, m.device)
    shape = torch.broadcast_shapes(m.shape, s.shape)
    m = m.expand(shape)
    s = s.expand(shape)
    up = m << s.clamp(min=0)
    dn = sr_shift_signed(m, (-s).clamp(min=0), key, stochastic)
    return torch.where(s >= 0, up, dn)


def _pre_narrow(a: Fx, target_bits: int, key, stochastic=True) -> Fx:
    d = a.bits - target_bits
    if d <= 0:
        return a
    return Fx(sr_shift_signed(a.m, d, key, stochastic), a.e + d, target_bits)


def fx_quantize(x: torch.Tensor, bits: int, key, stochastic=True,
                rng: str = "threefry") -> Fx:
    """Linear fixed-point mapping of a float tensor -> Fx (per tensor)."""
    q = quantize(x, QuantConfig(bits, 0, stochastic, rng), key)
    return Fx(q.m.to(torch.int32), scale_exponent(q.e, q.cfg), bits - 1)


def fx_const(c: float, bits: int = 15, device=None) -> Fx:
    """Static scalar constant as fixed point."""
    if c == 0:
        return Fx(_i32(0, device), _i32(0, device), 1)
    e = math.floor(math.log2(abs(c))) - (bits - 1)
    m = int(round(c / (2.0 ** e)))
    if abs(m) >= (1 << bits):
        m >>= 1
        e += 1
    return Fx(_i32(m, device), _i32(e, device), bits)


def fx_neg(a: Fx) -> Fx:
    return Fx(-a.m, a.e, a.bits)


def fx_mul(a: Fx, b: Fx, kg: KeyGen, stochastic=True) -> Fx:
    total = a.bits + b.bits
    if total > _MAX_BITS:
        excess = total - _MAX_BITS
        if a.bits >= b.bits:
            cut_a = min(excess, a.bits - 2)
            a = _pre_narrow(a, a.bits - cut_a, kg(), stochastic)
            excess -= cut_a
        if excess > 0:
            b = _pre_narrow(b, b.bits - excess, kg(), stochastic)
    return Fx(a.m * b.m, a.e + b.e, a.bits + b.bits)


def fx_add(a: Fx, b: Fx, kg: KeyGen, stochastic=True) -> Fx:
    la = _MAX_BITS - 1 - a.bits
    lb = _MAX_BITS - 1 - b.bits
    e_common = torch.maximum(a.e - la, b.e - lb)
    ma = _shift_to(a.m, a.e - e_common, kg(), stochastic)
    mb = _shift_to(b.m, b.e - e_common, kg(), stochastic)
    return Fx(ma + mb, e_common, _MAX_BITS)


def fx_sub(a: Fx, b: Fx, kg: KeyGen, stochastic=True) -> Fx:
    return fx_add(a, fx_neg(b), kg, stochastic)


def fx_sum(a: Fx, n: int, kg: KeyGen, axis=-1, stochastic=True) -> Fx:
    grow = _clog2(n)
    a = _pre_narrow(a, min(a.bits, 31 - grow), kg(), stochastic)
    e = a.e
    if e.ndim != 0:
        if e.shape[axis] != 1:
            raise ValueError(f"fx_sum: scale exponent varies along axis {axis}")
        e = e.squeeze(axis)
    return Fx(a.m.sum(dim=axis, dtype=torch.int32), e, a.bits + grow)


def fx_div_n(a: Fx, n: int, kg: KeyGen, stochastic=True) -> Fx:
    j = int(math.floor(math.log2(n)))
    q = n / (1 << j)
    inv = fx_const(1.0 / q, 15, a.m.device)
    out = fx_mul(a, inv, kg, stochastic)
    return Fx(out.m, out.e - j, out.bits)


def fx_narrow(a: Fx, bits: int, kg: KeyGen, stochastic=True) -> Fx:
    nb = bit_length(a.m.abs().amax())
    sh = (nb - bits).clamp(min=0)
    m = sr_shift_signed(a.m, sh.expand(a.m.shape), kg(), stochastic)
    return Fx(m, a.e + sh, bits)


def fx_unify(a: Fx, kg: KeyGen, stochastic=True) -> Fx:
    """Collapse a per-row scale exponent to one tensor-wide scalar."""
    e_max = a.e.amax()
    m = sr_shift_signed(a.m, (e_max - a.e).expand(a.m.shape), kg(), stochastic)
    return Fx(m, e_max, a.bits)


def fx_to_f32(a: Fx) -> torch.Tensor:
    return a.m.to(torch.float32) * pow2(a.e)


def fx_rsqrt(a: Fx, kg: KeyGen, stochastic=True) -> Fx:
    """Fixed-point Newton-Raphson 1/sqrt, all in int32 (4 steps)."""
    v = a.m.clamp(min=1)
    b = bit_length(v)
    d = b - 16
    vn = _shift_to(v, -d, kg(), stochastic=False)
    e2 = a.e + d
    odd = (e2 & 1) == 1
    vn = torch.where(odd, vn << 1, vn)
    e2 = torch.where(odd, e2 - 1, e2)
    r = torch.where(vn >= (1 << 16), _i32(11585, v.device),
                    _i32(16384, v.device))
    for _ in range(4):
        t = (r * r) >> 16
        u = vn * t
        w = (3 << 28) - u
        r = (r * (w >> 14)) >> 15
    return Fx(r, -22 - (e2 >> 1), 15)
