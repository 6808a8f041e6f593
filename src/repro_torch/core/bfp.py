"""Dynamic fixed-point (block floating-point) mapping, on torch tensors.

The port of ``repro.core.bfp``: the linear fixed-point mapping from float32
to a shared-scale integer mantissa tensor, executed on the IEEE-754 bit
pattern (unpack -> shift -> stochastic or half-up round), and its inverse.

A ``BFP`` with ``p`` magnitude bits stores ``x_i ~= m_i * 2^(e - 127 - 23 +
(24 - p))`` with ``e`` the IEEE-biased maximum exponent over the scale
group (the whole tensor, or one trailing-axis block).  Given the same
rounding bits (``core.prng``) every mantissa and exponent equals the JAX
package's.  Unsigned 32-bit arithmetic runs in int64 and is masked.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import prng

__all__ = ["BFP", "QuantConfig", "PER_TENSOR", "quantize", "quantize_weight",
           "quantize_cache", "dequantize", "pow2", "rounding_bits",
           "bfp_from_fx", "bfp_value",
           "storage_dtype", "scale_exponent", "biased_exponent", "bit_length",
           "sr_shift_signed"]

PER_TENSOR = 0

_F32_EXP_BIAS = 127
_F32_MANT_BITS = 23
_F32_MANT24 = _F32_MANT_BITS + 1
_M32 = 0xFFFFFFFF


def storage_dtype(bits: int) -> torch.dtype:
    """Smallest signed integer container for a sign + (bits-1) magnitude."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of a representation mapping (see
    ``repro.core.bfp.QuantConfig``): total ``bits`` incl. sign, scale-group
    ``block`` along the trailing axis (0 = per tensor), stochastic or
    half-up rounding, and the rounding-bit stream ``rng``."""

    bits: int = 8
    block: int = PER_TENSOR
    stochastic: bool = True
    rng: str = "threefry"

    @property
    def p(self) -> int:
        return self.bits - 1

    @property
    def base_shift(self) -> int:
        return _F32_MANT24 - self.p

    def __post_init__(self):
        if not (2 <= self.bits <= 16):
            raise ValueError(f"bits must be in [2, 16], got {self.bits}")
        if self.block < 0:
            raise ValueError(f"block must be >= 0, got {self.block}")


@dataclasses.dataclass
class BFP:
    """Integer mantissas ``m`` (logical shape) + IEEE-biased shared
    exponent(s) ``e`` (int32: shape ``()`` per tensor, or one per group).

    ``g`` is the optional float32 gradient carrier of the qflow currency:
    a float tensor on the autograd graph whose value no op reads; a
    consumer takes it as an input and returns its input gradient as the
    carrier's gradient, so the gradient crosses the integer seam."""

    m: torch.Tensor
    e: torch.Tensor
    cfg: QuantConfig
    g: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.m.shape

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


def scale_exponent(e_biased, cfg: QuantConfig):
    """Unbiased exponent E of the scale: x = m * 2^E."""
    return e_biased - _F32_EXP_BIAS - _F32_MANT_BITS + cfg.base_shift


def biased_exponent(e_unbiased, cfg: QuantConfig):
    """Inverse of :func:`scale_exponent`."""
    return e_unbiased + _F32_EXP_BIAS + _F32_MANT_BITS - cfg.base_shift


def bfp_from_fx(m: torch.Tensor, e_unbiased, cfg: QuantConfig,
                g: Optional[torch.Tensor] = None) -> BFP:
    """Wrap a fixed-point mantissa (already within ``cfg.p`` magnitude
    bits) and its unbiased power-of-two exponent as a BFP; no rounding."""
    e = torch.as_tensor(biased_exponent(e_unbiased, cfg), device=m.device)
    return BFP(m.to(storage_dtype(cfg.bits)), e.to(torch.int32), cfg, g)


def bfp_value(x):
    """Float32 view of ``f32 | BFP``: the carrier when there is one (it
    keeps the autograd edge), else the dequantized value."""
    if isinstance(x, BFP):
        return x.g if x.g is not None else dequantize(x)
    return x


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 2^e for integer e, built from the exponent bits.

    Scales below 2^-126 are defined as 0: the JAX package runs where XLA
    flushes sub-normals, torch does not, so the flush is explicit here."""
    e = torch.as_tensor(e).to(torch.int32)
    e1 = e.clamp(-126, 127)
    f = ((e1 + _F32_EXP_BIAS) << _F32_MANT_BITS).view(torch.float32)
    return torch.where(e < -126, torch.zeros_like(f), f)


def _unpack_f32(x: torch.Tensor):
    """(sign, effective biased exponent, 24-bit mantissa) as int64."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    sign = b >> 31
    bexp = (b >> _F32_MANT_BITS) & 0xFF
    frac = b & 0x7FFFFF
    mant24 = torch.where(bexp > 0, frac | (1 << _F32_MANT_BITS), frac)
    return sign, bexp.clamp(min=1), mant24


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    if x.shape[-1] % block != 0:
        raise ValueError(
            f"trailing dim {x.shape[-1]} not divisible by block {block}")
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def rounding_bits(key: prng.Key, shape, rng: str = "threefry",
                  device=None) -> torch.Tensor:
    """The uniform u32 draw of stochastic rounding (int64 tensor): the
    single source of rounding bits, shared by the plain mappings here and
    by the kernels' callers, as ``repro.core.bfp.rounding_bits``."""
    if rng == "hash":
        return prng.hash_bits(key, shape, device)
    return prng.bits(key, shape, device)


def _shift_round(mag: torch.Tensor, shift: torch.Tensor,
                 key: Optional[prng.Key], stochastic: bool,
                 rng: str = "threefry") -> torch.Tensor:
    """mag / 2^shift with stochastic (threshold compare against a 32-bit
    draw) or half-up rounding; ``mag`` holds uint32 values in int64."""
    s = shift.to(torch.int64)
    s31 = s.clamp(max=31)
    base = torch.where(s < 32, mag >> s31, torch.zeros_like(mag))
    if stochastic:
        if key is None:
            raise ValueError("stochastic rounding requires a PRNG key")
        r = rounding_bits(key, mag.shape, rng, mag.device)
        m_lo = mag & ((1 << s31) - 1)
        left = (32 - s).clamp(0, 31)
        over = (s - 32).clamp(0, 31)
        thr = torch.where(s <= 31, (m_lo << left) & _M32,
                          torch.where(s == 32, mag, mag >> over))
        up = (r < thr) & (s > 0)
        return base + up.to(torch.int64)
    half = torch.where(s > 0, 1 << (s31.clamp(min=1) - 1),
                       torch.zeros_like(s))
    return torch.where(s < 32, ((mag + half) & _M32) >> s31,
                       torch.zeros_like(mag))


def quantize(x: torch.Tensor, cfg: QuantConfig = QuantConfig(),
             key: Optional[prng.Key] = None) -> BFP:
    """Linear fixed-point mapping float32 -> BFP (paper §3.1)."""
    sign, eff, mant24 = _unpack_f32(x)
    if cfg.block == PER_TENSOR:
        e_shared = eff.amax()
        e_bcast = e_shared
    else:
        e_shared = _blocked(eff, cfg.block).amax(-1)
        e_bcast = torch.repeat_interleave(e_shared, cfg.block, dim=-1)
    shift = (e_bcast - eff) + cfg.base_shift
    mag = _shift_round(mant24, shift, key, cfg.stochastic, cfg.rng)
    mag = mag.clamp(max=(1 << cfg.p) - 1)
    m = torch.where(sign == 1, -mag, mag).to(storage_dtype(cfg.bits))
    return BFP(m, e_shared.to(torch.int32), cfg)


def dequantize(q: BFP) -> torch.Tensor:
    """Inverse mapping BFP -> float32 (paper §3.2)."""
    scale = pow2(scale_exponent(q.e, q.cfg))
    f = q.m.to(torch.float32)
    if q.cfg.block == PER_TENSOR:
        return f * scale
    return (_blocked(f, q.cfg.block) * scale[..., None]).reshape(q.m.shape)


def quantize_weight(w: torch.Tensor, cfg: QuantConfig = QuantConfig(),
                    key: Optional[prng.Key] = None) -> BFP:
    """The weight-operand mapping; bit-identical to :func:`quantize`."""
    return quantize(w, cfg, key)


def quantize_cache(x: torch.Tensor, cfg: QuantConfig = QuantConfig(),
                   key: Optional[prng.Key] = None) -> BFP:
    """The cache-row mapping (per-row blocks, nearest rounding in every
    caller): bit-identical to :func:`quantize`."""
    return quantize(x, cfg, key)


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bits needed for non-negative int32 ``v`` (0 -> 0), as int32."""
    v = v.clamp(min=0).to(torch.float64)
    return torch.frexp(v).exponent.to(torch.int32)


def sr_shift_signed(v: torch.Tensor, shift, key: Optional[prng.Key],
                    stochastic: bool = True,
                    rng: str = "threefry") -> torch.Tensor:
    """Signed right shift with stochastic or half-up rounding (int32)."""
    mag = v.to(torch.int64).abs() & _M32
    sh = torch.as_tensor(shift, device=v.device).expand(v.shape)
    out = _shift_round(mag, sh, key, stochastic, rng)
    out = out.to(torch.int32)
    return torch.where(v < 0, -out, out)
