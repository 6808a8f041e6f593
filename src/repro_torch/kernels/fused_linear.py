"""Fused quantize -> int8 GEMM -> exponent-add rescale: CUDA kernels + plain.

Ports of two TPU kernels of ``repro.kernels.fused_linear``:

  ``fused_qq_pt``  <- ``fused_qq_pt_pallas``: both operands f32, quantized
                   in the kernel (per-tensor exponents ``ea``/``eb``,
                   stochastic against ``ra``/``rb`` or half up), int8 x int8
                   -> int32, x 2^(sa + sb); also returns both mantissas.
  ``fused_qi_pt``  <- ``fused_qi_pt_pallas``: ``a`` quantized in the kernel
                   against pre-quantized int8 ``b``; returns y and a's
                   mantissas.

Layout is contraction-last with a leading batch: a (B, M, K), b (B, N, K)
-> y (B, M, N).  The CUDA source is ``csrc/fused_linear.cu``; its note
says what bounds it.  Each wrapper runs the kernel for CUDA tensors and
the plain version (same file, below) for CPU tensors, and nothing else:
a CUDA tensor never reaches the plain version through a wrapper.
Exponents are int32 device scalars (no host synchronisation); rounding
bits are uint32 values held in int64 (``core.prng``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

__all__ = ["quantize_tile", "int8_dot", "pow2_f32", "scale_exp",
           "fused_qq_pt", "fused_qi_pt", "fused_qq_pt_plain",
           "fused_qi_pt_plain", "as_u32"]

_F32_EXP_BIAS = 127
_F32_MANT_BITS = 23
_M32 = 0xFFFFFFFF


def scale_exp(e_biased, p: int):
    """Unbiased exponent of a p-magnitude-bit BFP scale."""
    return e_biased - _F32_EXP_BIAS - _F32_MANT_BITS + (24 - p)


def pow2_f32(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e in float32, e < -126 flushed to 0 (as core.bfp.pow2)."""
    e = torch.as_tensor(e).to(torch.int32)
    f = ((e.clamp(-126, 127) + _F32_EXP_BIAS) << _F32_MANT_BITS).view(torch.float32)
    return torch.where(e < -126, torch.zeros_like(f), f)


def quantize_tile(x: torch.Tensor, rand: Optional[torch.Tensor],
                  e_shared: torch.Tensor, p: int,
                  stochastic: bool) -> torch.Tensor:
    """Plain version of the kernels' quantizer (``_quantize_tile``): int8
    mantissas of f32 ``x`` against ``e_shared`` (broadcastable), stochastic
    against ``rand`` or half up (then ``rand`` may be None)."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
    sign = b >> 31
    bexp = (b >> 23) & 0xFF
    frac = b & 0x7FFFFF
    mant24 = torch.where(bexp > 0, frac | (1 << 23), frac)
    eff = bexp.clamp(min=1)
    s = (e_shared.to(torch.int64) - eff) + (24 - p)
    s31 = s.clamp(max=31)
    base = torch.where(s < 32, mant24 >> s31, torch.zeros_like(mant24))
    m_lo = mant24 & ((1 << s31) - 1)
    left = (32 - s).clamp(0, 31)
    over = (s - 32).clamp(0, 31)
    thr = torch.where(s <= 31, (m_lo << left) & _M32,
                      torch.where(s == 32, mant24, mant24 >> over))
    if stochastic:
        up = (rand < thr) & (s > 0)
    else:
        up = (thr >= 0x80000000) & (s > 0)
    mag = (base + up.to(torch.int64)).clamp(max=(1 << p) - 1)
    return torch.where(sign == 1, -mag, mag).to(torch.int8)


def int8_dot(am: torch.Tensor, bm: torch.Tensor) -> torch.Tensor:
    """(..., M, K) int8 x (..., N, K) int8 -> (..., M, N) exact integer
    sums as float64 (every partial sum of int8 products with K < 2^17 is an
    integer below 2^53, so any summation order is exact)."""
    return torch.matmul(am.to(torch.float64), bm.to(torch.float64).transpose(-1, -2))


def fused_qq_pt_plain(a, ra, b, rb, ea, eb, *, p=7, stochastic=True,
                      emit_residuals=True):
    """Plain version of ``fused_qq_pt``: (y, a mantissas, b mantissas),
    the mantissas None when ``emit_residuals`` is False."""
    am = quantize_tile(a, ra, ea, p, stochastic)
    bm = quantize_tile(b, rb, eb, p, stochastic)
    y = int8_dot(am, bm).to(torch.float32) * pow2_f32(
        scale_exp(ea, p) + scale_exp(eb, p))
    return (y, am, bm) if emit_residuals else (y, None, None)


def fused_qi_pt_plain(a, ra, b_m, ea, eb, *, pa=7, pb=7, stochastic=True):
    """Plain version of ``fused_qi_pt``: (y, a mantissas)."""
    am = quantize_tile(a, ra, ea, pa, stochastic)
    y = int8_dot(am, b_m).to(torch.float32) * pow2_f32(
        scale_exp(ea, pa) + scale_exp(eb, pb))
    return y, am


def as_u32(r: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 tensor with the same bits (an
    int32 tensor is taken as already converted)."""
    if r.dtype == torch.int32:
        return r
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)


def _ptr(t: Optional[torch.Tensor]) -> Optional[ctypes.c_void_p]:
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous={t.is_contiguous()})")


def _scalar_i32(name: str, e: torch.Tensor, device):
    if e.dtype != torch.int32 or e.numel() != 1 or e.device != device:
        raise ValueError(f"{name}: expected one int32 exponent on {device}")
    return e.contiguous()


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _lib_linear() -> ctypes.CDLL:
    lib = build.load("fused_linear")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_fused_qq.argtypes = [vp] * 9 + [i] * 6 + [vp]
        lib.repro_fused_qq.restype = i
        lib.repro_fused_qi.argtypes = [vp] * 7 + [i] * 7 + [vp]
        lib.repro_fused_qi.restype = i
        lib._typed = True
    return lib


def fused_qq_pt(a: torch.Tensor, ra: Optional[torch.Tensor], b: torch.Tensor,
                rb: Optional[torch.Tensor], ea: torch.Tensor,
                eb: torch.Tensor, *, p: int = 7, stochastic: bool = True,
                emit_residuals: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[torch.Tensor]]:
    """a (B, M, K) f32, b (B, N, K) f32, ra/rb their bits (None for half
    up), ea/eb int32 biased exponents -> (y (B, M, N) f32, a and b int8
    mantissas); without residuals the kernel writes no mantissa and both
    come back None."""
    if not a.is_cuda:
        return fused_qq_pt_plain(a, ra, b, rb, ea, eb, p=p,
                                 stochastic=stochastic,
                                 emit_residuals=emit_residuals)
    nb, m, k = a.shape
    n = b.shape[1]
    dev = a.device
    _check("a", a, torch.float32, (nb, m, k), dev)
    _check("b", b, torch.float32, (nb, n, k), dev)
    if stochastic:
        ra, rb = as_u32(ra), as_u32(rb)
        _check("ra", ra, torch.int32, (nb, m, k), dev)
        _check("rb", rb, torch.int32, (nb, n, k), dev)
    ea, eb = _scalar_i32("ea", ea, dev), _scalar_i32("eb", eb, dev)
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    am = bm = None
    if emit_residuals:
        am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
        bm = torch.empty((nb, n, k), dtype=torch.int8, device=dev)
    err = _lib_linear().repro_fused_qq(
        _ptr(a), _ptr(ra if stochastic else None), _ptr(b),
        _ptr(rb if stochastic else None), _ptr(ea), _ptr(eb), _ptr(y),
        _ptr(am), _ptr(bm), nb, m, n, k, p, int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "fused_qq_pt")
    fused_qq_pt.launches += 1
    return y, am, bm


def fused_qi_pt(a: torch.Tensor, ra: Optional[torch.Tensor],
                b_m: torch.Tensor, ea: torch.Tensor, eb: torch.Tensor, *,
                pa: int = 7, pb: int = 7, stochastic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a (B, M, K) f32 (+ bits ra), b_m (B, N, K) int8 mantissas, int32
    biased exponents -> (y (B, M, N) f32, a's int8 mantissas)."""
    if not a.is_cuda:
        return fused_qi_pt_plain(a, ra, b_m, ea, eb, pa=pa, pb=pb,
                                 stochastic=stochastic)
    nb, m, k = a.shape
    n = b_m.shape[1]
    dev = a.device
    _check("a", a, torch.float32, (nb, m, k), dev)
    _check("b_m", b_m, torch.int8, (nb, n, k), dev)
    if stochastic:
        ra = as_u32(ra)
        _check("ra", ra, torch.int32, (nb, m, k), dev)
    ea, eb = _scalar_i32("ea", ea, dev), _scalar_i32("eb", eb, dev)
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
    err = _lib_linear().repro_fused_qi(
        _ptr(a), _ptr(ra if stochastic else None), _ptr(b_m), _ptr(ea),
        _ptr(eb), _ptr(y), _ptr(am), nb, m, n, k, pa, pb, int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "fused_qi_pt")
    fused_qi_pt.launches += 1
    return y, am


# Launches of each kernel since the count was last set to 0.
fused_qq_pt.launches = 0
fused_qi_pt.launches = 0
