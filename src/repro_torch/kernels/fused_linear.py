"""Fused quantize -> int8 GEMM -> exponent-add rescale: CUDA kernels + plain.

Ports of four TPU kernels of ``repro.kernels.fused_linear``:

  ``fused_qq_pt``  <- ``fused_qq_pt_pallas``: both operands f32, quantized
                   in the kernel (per-tensor exponents ``ea``/``eb``,
                   stochastic against ``ra``/``rb`` or half up), int8 x int8
                   -> int32, x 2^(sa + sb); also returns both mantissas.
  ``fused_qi_pt``  <- ``fused_qi_pt_pallas``: ``a`` quantized in the kernel
                   against pre-quantized int8 ``b``; returns y and a's
                   mantissas.
  ``fused_ii_pt``  <- ``fused_ii_pt_pallas``: both operands int8 mantissas
                   (the backward's dW on stored residuals), int8 x int8 ->
                   int32 x 2^(sa + sb); no quantize stage, no rounding bits.
  ``fused_qq_blk`` <- ``fused_qq_blk_pallas``: both operands f32, quantized
                   in the kernel with one exponent per ``blk`` elements of
                   the contraction axis (``ea`` (B, M, K/blk), ``eb`` (B, N,
                   K/blk)); each block's exact int32 partial times
                   2^(sa + sb) is added to a float32 accumulator in block
                   order; also returns both mantissas.
  ``fused_gemm_epi`` <- ``fused_gemm_epi_pallas``: the qq GEMM with its f32
                   epilogue (bias, then relu, GELU, or the SiLU- or
                   GELU-GLU that gates the left half of the columns against
                   the right half) applied to each output tile; also
                   returns both mantissas and the pre-activation ``ylin``.  Its plain version also covers
                   the variants with no kernel (kinds qi / ii, the
                   per-tensor out-quantize), which run on the CPU only.

Layout is contraction-last with a leading batch: a (B, M, K), b (B, N, K)
-> y (B, M, N).  The CUDA source is ``csrc/fused_linear.cu``; its note
says what bounds it.  Each wrapper runs the kernel for CUDA tensors and
the plain version (same file, below) for CPU tensors, and nothing else:
a CUDA tensor never reaches the plain version through a wrapper.
Exponents are int32 device tensors, a scalar per tensor or one per row
and block (no host synchronisation); rounding bits are uint32 values held
in int64 (``core.prng``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core import fmath
from . import build

__all__ = ["eff_exp", "quantize_tile", "int8_dot", "pow2_f32", "scale_exp",
           "fused_qq_pt", "fused_qi_pt", "fused_ii_pt", "fused_qq_blk",
           "fused_qq_pt_plain", "fused_qi_pt_plain", "fused_ii_pt_plain",
           "fused_qq_blk_plain", "blk_combine", "as_u32", "EPI_ACTS",
           "epi_apply", "epi_pullback", "fused_gemm_epi",
           "fused_gemm_epi_plain"]

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


def eff_exp(x: torch.Tensor) -> torch.Tensor:
    """Effective biased exponent of float32 x (sub-normals count as 1)."""
    return ((x.to(torch.float32).contiguous().view(torch.int32) >> 23)
            & 0xFF).clamp(min=1)


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


def fused_ii_pt_plain(a_m, b_m, ea, eb, *, pa=7, pb=7):
    """Plain version of ``fused_ii_pt``: y."""
    return int8_dot(a_m, b_m).to(torch.float32) * pow2_f32(
        scale_exp(ea, pa) + scale_exp(eb, pb))


def _bcast_blk(e: torch.Tensor, blk: int) -> torch.Tensor:
    """Per-block exponents (..., nb) -> per-element (..., nb * blk)."""
    return torch.repeat_interleave(e, blk, dim=-1)


def blk_combine(am: torch.Tensor, bm: torch.Tensor, sea: torch.Tensor,
                seb: torch.Tensor, blk: int) -> torch.Tensor:
    """Per-block contraction of mantissas (..., M, K) x (..., N, K) with
    unbiased scale exponents (..., M, K/blk), (..., N, K/blk): each block's
    exact integer partial times 2^(sa + sb) (0 below 2^-126) added to a
    float32 accumulator from a zero start, in block order (the product is
    exact, so the order of the adds is the only float choice)."""
    acc = torch.zeros((*am.shape[:-1], bm.shape[-2]), dtype=torch.float32,
                      device=am.device)
    for i in range(am.shape[-1] // blk):
        part = int8_dot(am[..., i * blk:(i + 1) * blk],
                        bm[..., i * blk:(i + 1) * blk]).to(torch.float32)
        acc = acc + part * pow2_f32(sea[..., :, i, None]
                                    + seb[..., None, :, i])
    return acc


def fused_qq_blk_plain(a, ra, ea, b, rb, eb, *, p=7, blk=32,
                       stochastic=True, emit_residuals=True):
    """Plain version of ``fused_qq_blk``: (y, a mantissas, b mantissas),
    the mantissas None when ``emit_residuals`` is False."""
    am = quantize_tile(a, ra, _bcast_blk(ea, blk), p, stochastic)
    bm = quantize_tile(b, rb, _bcast_blk(eb, blk), p, stochastic)
    y = blk_combine(am, bm, scale_exp(ea, p), scale_exp(eb, p), blk)
    return (y, am, bm) if emit_residuals else (y, None, None)


# ---------------------------------------------------------------------------
# GEMM -> bias / activation (-> per-tensor out-quantize) epilogue
# ---------------------------------------------------------------------------

# The epilogue's activations; the CUDA kernel's act code is the index here.
EPI_ACTS = (None, "relu", "gelu", "silu_glu", "gelu_glu")
_EPI_META_LANES = 128


def epi_apply(y: torch.Tensor, act: Optional[str],
              n_out: int) -> torch.Tensor:
    """The f32 activation of the epilogue (``epi_apply`` of the reference,
    after its bias add): the ``_glu`` acts gate the left ``n_out`` columns
    against the right ones, ``act(g) * u``, with the reference's logistic
    and tanh-form GELU (``core.fmath``)."""
    if act not in EPI_ACTS:
        raise ValueError(f"unknown epilogue act {act!r}")
    if act == "relu":
        y = torch.maximum(y, torch.zeros_like(y))
    elif act == "gelu":
        y = fmath.gelu(y)
    elif act == "silu_glu":
        g, u = y[..., :n_out], y[..., n_out:]
        y = (g * fmath.logistic(g)) * u
    elif act == "gelu_glu":
        y = fmath.gelu(y[..., :n_out]) * y[..., n_out:]
    return y


def epi_pullback(ylin: torch.Tensor, g: torch.Tensor, act: Optional[str],
                 n_out: int) -> torch.Tensor:
    """The VJP of ``epi_apply(ylin, act, n_out)`` at cotangent ``g``,
    as the reference's ``jax.vjp`` computes it: relu passes half the
    gradient where ``ylin == 0`` (``lax.max``'s balanced tie), the GLUs
    pull back through ``act(g) * u`` with XLA's contraction."""
    if act is None:
        return g
    if act == "relu":
        w = torch.where(ylin > 0, 1.0, torch.where(ylin == 0, 0.5, 0.0))
        return g * w.to(g.dtype)
    if act == "gelu":
        return fmath.gelu_pullback(ylin, g)
    gate, up = ylin[..., :n_out], ylin[..., n_out:]
    if act == "gelu_glu":
        return torch.cat([fmath.gelu_pullback(gate, g * up),
                          fmath.gelu(gate) * g], dim=-1)
    s = fmath.logistic(gate)
    g_act = g * up
    d_gate = fmath._fma(g_act, s, (g_act * gate) * (s * (1.0 - s)))
    return torch.cat([d_gate, g * (gate * s)], dim=-1)


def fused_gemm_epi_plain(a, ra, b, rb, bias, rq, ea, eb, *, kind="qq", p=7,
                         stochastic=True, act=None, out_q=False, qp=7,
                         m_true=None):
    """Plain version of ``fused_gemm_epi`` (the reference's
    ``gemm_epi_ref``): a (M, K), b (N, K) contraction-last; ``kind`` qq
    (both f32, quantized here), qi (b int8) or ii (both int8); ``bias``
    (1, N) or None; ``out_q`` quantizes the output with one exponent (the
    largest over rows below ``m_true``) against ``rq``.  Returns a tuple:
    (y | ym, emeta) [+ am][+ bm if qq][+ ylin if act]."""
    n = b.shape[0]
    n_out = n // 2 if (act or "").endswith("_glu") else n
    ea = torch.as_tensor(ea).to(torch.int32)
    eb = torch.as_tensor(eb).to(torch.int32)
    bmant = (quantize_tile(b, rb if stochastic else None, eb, p, stochastic)
             if kind == "qq" else b)
    am = (a if kind == "ii" else
          quantize_tile(a, ra if stochastic else None, ea, p, stochastic))
    ylin = int8_dot(am, bmant).to(torch.float32) * pow2_f32(
        scale_exp(ea, p) + scale_exp(eb, p))
    if bias is not None:
        ylin = ylin + bias
    y = epi_apply(ylin, act, n_out)
    if out_q:
        av = y.abs()
        if m_true is not None:
            rows = torch.arange(a.shape[0], device=a.device)[:, None]
            av = torch.where(rows < m_true, av, torch.zeros_like(av))
        e_out = eff_exp(av.amax())
        ym = quantize_tile(y, rq if stochastic else None, e_out, qp,
                           stochastic)
        out = [ym, torch.full((1, _EPI_META_LANES), int(e_out),
                              dtype=torch.int32, device=a.device)]
    else:
        out = [y]
    if kind != "ii":
        out.append(am)
    if kind == "qq":
        out.append(bmant)
    if act is not None:
        out.append(ylin)
    return tuple(out)


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
        lib.repro_fused_ii.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.repro_fused_ii.restype = i
        lib.repro_fused_qq_blk.argtypes = [vp] * 9 + [i] * 7 + [vp]
        lib.repro_fused_qq_blk.restype = i
        lib.repro_gemm_epi.argtypes = [vp] * 11 + [i] * 6 + [vp]
        lib.repro_gemm_epi.restype = i
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


def fused_ii_pt(a_m: torch.Tensor, b_m: torch.Tensor, ea: torch.Tensor,
                eb: torch.Tensor, *, pa: int = 7, pb: int = 7) -> torch.Tensor:
    """a_m (B, M, K) int8, b_m (B, N, K) int8 mantissas, int32 biased
    exponents -> y (B, M, N) f32."""
    if not a_m.is_cuda:
        return fused_ii_pt_plain(a_m, b_m, ea, eb, pa=pa, pb=pb)
    nb, m, k = a_m.shape
    n = b_m.shape[1]
    dev = a_m.device
    _check("a_m", a_m, torch.int8, (nb, m, k), dev)
    _check("b_m", b_m, torch.int8, (nb, n, k), dev)
    ea, eb = _scalar_i32("ea", ea, dev), _scalar_i32("eb", eb, dev)
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    err = _lib_linear().repro_fused_ii(
        _ptr(a_m), _ptr(b_m), _ptr(ea), _ptr(eb), _ptr(y), nb, m, n, k, pa,
        pb, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "fused_ii_pt")
    fused_ii_pt.launches += 1
    return y


def fused_qq_blk(a: torch.Tensor, ra: Optional[torch.Tensor],
                 ea: torch.Tensor, b: torch.Tensor,
                 rb: Optional[torch.Tensor], eb: torch.Tensor, *, p: int = 7,
                 blk: int = 32, stochastic: bool = True,
                 emit_residuals: bool = True
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                            Optional[torch.Tensor]]:
    """a (B, M, K) f32, b (B, N, K) f32, ra/rb their bits (None for half
    up), ea (B, M, K/blk) / eb (B, N, K/blk) int32 biased exponents of
    each block -> (y (B, M, N) f32, a and b int8 mantissas); without
    residuals the kernel writes no mantissa and both come back None."""
    if not a.is_cuda:
        return fused_qq_blk_plain(a, ra, ea, b, rb, eb, p=p, blk=blk,
                                  stochastic=stochastic,
                                  emit_residuals=emit_residuals)
    nb, m, k = a.shape
    n = b.shape[1]
    dev = a.device
    if blk < 1 or k % blk:
        raise ValueError(f"K={k} is not a multiple of the block {blk}")
    _check("a", a, torch.float32, (nb, m, k), dev)
    _check("b", b, torch.float32, (nb, n, k), dev)
    _check("ea", ea, torch.int32, (nb, m, k // blk), dev)
    _check("eb", eb, torch.int32, (nb, n, k // blk), dev)
    if stochastic:
        ra, rb = as_u32(ra), as_u32(rb)
        _check("ra", ra, torch.int32, (nb, m, k), dev)
        _check("rb", rb, torch.int32, (nb, n, k), dev)
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    am = bm = None
    if emit_residuals:
        am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
        bm = torch.empty((nb, n, k), dtype=torch.int8, device=dev)
    err = _lib_linear().repro_fused_qq_blk(
        _ptr(a), _ptr(ra if stochastic else None), _ptr(ea), _ptr(b),
        _ptr(rb if stochastic else None), _ptr(eb), _ptr(y), _ptr(am),
        _ptr(bm), nb, m, n, k, blk, p, int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "fused_qq_blk")
    fused_qq_blk.launches += 1
    return y, am, bm


def fused_gemm_epi(a: torch.Tensor, ra: Optional[torch.Tensor],
                   b: torch.Tensor, rb: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], rq: Optional[torch.Tensor],
                   ea: torch.Tensor, eb: torch.Tensor, *, kind: str = "qq",
                   p: int = 7, stochastic: bool = True,
                   act: Optional[str] = None, out_q: bool = False,
                   qp: int = 7, m_true: Optional[int] = None):
    """GEMM with its fused epilogue (arguments and results of
    ``fused_gemm_epi_plain``).  On the card kind qq with any act and no
    out-quantize has a kernel: a (M, K) f32, b (N, K) f32 with their bits,
    bias (1, N) f32 or None -> (y, am, bm[, ylin]); the out-quantize and
    kinds qi / ii raise there (ROADMAP queue 2 item 1)."""
    if not a.is_cuda:
        return fused_gemm_epi_plain(
            a, ra, b, rb, bias, rq, ea, eb, kind=kind, p=p,
            stochastic=stochastic, act=act, out_q=out_q, qp=qp,
            m_true=m_true)
    if kind != "qq" or out_q:
        raise NotImplementedError(
            f"gemm_epi has a kernel for kind qq with no out-quantize, not "
            f"kind={kind} out_q={out_q}: that variant's plain version runs "
            "only on the CPU (ROADMAP queue 2 item 1)")
    m, k = a.shape
    n = b.shape[0]
    glu = (act or "").endswith("_glu")
    if glu and n % 2:
        raise ValueError(f"{act} needs an even N, got {n}")
    dev = a.device
    _check("a", a, torch.float32, (m, k), dev)
    _check("b", b, torch.float32, (n, k), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (1, n), dev)
    if stochastic:
        ra, rb = as_u32(ra), as_u32(rb)
        _check("ra", ra, torch.int32, (m, k), dev)
        _check("rb", rb, torch.int32, (n, k), dev)
    ea, eb = _scalar_i32("ea", ea, dev), _scalar_i32("eb", eb, dev)
    y = torch.empty((m, n // 2 if glu else n), dtype=torch.float32,
                    device=dev)
    am = torch.empty((m, k), dtype=torch.int8, device=dev)
    bm = torch.empty((n, k), dtype=torch.int8, device=dev)
    ylin = (torch.empty((m, n), dtype=torch.float32, device=dev)
            if act is not None else None)
    err = _lib_linear().repro_gemm_epi(
        _ptr(a), _ptr(ra if stochastic else None), _ptr(b),
        _ptr(rb if stochastic else None), _ptr(bias), _ptr(ea), _ptr(eb),
        _ptr(y), _ptr(ylin), _ptr(am), _ptr(bm), m, n, k, p,
        EPI_ACTS.index(act), int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "gemm_epi")
    fused_gemm_epi.launches += 1
    return (y, am, bm) + ((ylin,) if act is not None else ())


# Launches of each kernel since the count was last set to 0.
fused_qq_pt.launches = 0
fused_qi_pt.launches = 0
fused_ii_pt.launches = 0
fused_qq_blk.launches = 0
fused_gemm_epi.launches = 0
