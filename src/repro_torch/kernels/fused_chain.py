"""Cross-op chains: the fused norm -> GEMM and the whole-layer decode block.

Ports of two TPU kernels of ``repro.kernels.fused_chain``:

  ``fused_norm_gemm``    <- ``fused_norm_gemm_pallas``: per row, the fx-lite
                         integer RMS/LayerNorm (``_norm_rows_core``: a 7-bit
                         per-row input quantize, exact integer sums, an
                         integer Newton rsqrt, the gain product and one
                         per-row quantize to int8), then the int8 GEMM
                         against contraction-last weight mantissas with one
                         exponent per output column.  Returns y and the
                         backward's residuals: xq, the per-row scale
                         columns ``meta`` [se_row, e_c, r, e_r] and c.
  ``fused_decode_block`` <- ``fused_decode_block_pallas``: one decoder layer
                         for one token: norm -> merged QKV GEMV -> rope ->
                         the fresh K/V rows quantized per row (the qcache
                         rule) -> decode attention over the int8 cache ->
                         out-projection + residual -> norm -> gate|up GEMV
                         with SiLU-GLU -> down GEMV + residual.  Every
                         rounding is deterministic (serving).

The CUDA source is ``csrc/fused_chain.cu``; its note says what bounds each
kernel and how it is laid out on the card.  Each wrapper runs its kernel
for CUDA tensors and its plain version (below, the reference's block cores
restated in torch) for CPU tensors.  Integer steps run in int32 with the
reference's wrap-around; float steps round as XLA's CPU build rounds them
(``core.fmath``), so the plain versions equal the JAX mirrors bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..core import fmath
from ..core.bfp import bit_length
from . import build
from . import fused_attention as kfa
from .fused_linear import (_check, _ptr, _raise_on, _scalar_i32, as_u32,
                           eff_exp, int8_dot, pow2_f32, quantize_tile,
                           scale_exp)

__all__ = ["div_n_consts", "eps_consts", "norm_gemm_plain",
           "fused_norm_gemm", "decode_block_plain", "fused_decode_block",
           "norm_gemm_smem_bytes", "decode_block_smem_bytes",
           "decode_block_unsupported", "DECODE_BLOCK_MAX_B",
           "DECODE_BLOCK_MAX_T"]

_META_LANES = 128
_M32 = 0xFFFFFFFF
# The decode block kernel keeps the batch's accumulators in registers
# (at most this many rows) and sums a softmax row in at most 32 windows
# of 32 (T <= 1024, one level of the reference's windowed sum).
DECODE_BLOCK_MAX_B = 8
DECODE_BLOCK_MAX_T = 1024


# ---------------------------------------------------------------------------
# integer helpers (int32 with the reference's wrap-around)
# ---------------------------------------------------------------------------

def div_n_consts(n: int):
    """x / n ~= (x * inv_q) * 2^(-14-j) with n = 2^j * q, q odd."""
    j = (n & -n).bit_length() - 1
    q = n >> j
    return j, round((1 << 14) / q)


def eps_consts(eps: float):
    """15-bit fixed-point mantissa / exponent pair of the norm's eps."""
    fr, ex = math.frexp(eps)
    return round(fr * (1 << 15)), ex - 15


def _i32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int32, device=like.device)


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    v = v & _M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _sr_shift(v: torch.Tensor, s, rand: Optional[torch.Tensor]):
    """round(v / 2^s) on int32 v (s >= 0): stochastic against ``rand``
    (uint32 in int64), else half up; the sign is re-applied after."""
    s = _i32(s, v).to(torch.int64)
    mag = v.to(torch.int64).abs() & _M32
    s31 = s.clamp(max=31)
    base = torch.where(s < 32, mag >> s31, torch.zeros_like(mag))
    m_lo = mag & ((1 << s31) - 1)
    left = (32 - s).clamp(0, 31)
    over = (s - 32).clamp(0, 31)
    thr = torch.where(s <= 31, (m_lo << left) & _M32,
                      torch.where(s == 32, mag, mag >> over))
    up = (thr >= 1 << 31) if rand is None else (rand < thr)
    out = _wrap32(base + (up & (s > 0)).to(torch.int64))
    return torch.where(v < 0, -out, out)


def _shr(v: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic right shift of int32 v by s clamped to [0, 31]."""
    return v >> _i32(s, v).clamp(0, 31)


def _shl(v: torch.Tensor, s) -> torch.Tensor:
    """Left shift of int32 v with wrap-around (s in [0, 31])."""
    return _wrap32(v.to(torch.int64) << _i32(s, v).to(torch.int64))


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """int32 product with wrap-around."""
    return _wrap32(a.to(torch.int64) * torch.as_tensor(b).to(torch.int64))


def _int_rsqrt(vm: torch.Tensor, ev: torch.Tensor):
    """Integer Newton 1/sqrt of vm * 2^ev -> (r 15-bit, e_r)."""
    v = vm.clamp(min=1)
    d = bit_length(v) - 16
    vn = torch.where(d >= 0, _shr(v, d), _shl(v, (-d).clamp(0, 31)))
    e2 = ev + d
    odd = (e2 & 1) == 1
    vn = torch.where(odd, _shl(vn, 1), vn)
    e2 = torch.where(odd, e2 - 1, e2)
    r = torch.where(vn >= 1 << 16, _i32(11585, vn), _i32(16384, vn))
    for _ in range(4):
        t = _mul(r, r) >> 16
        r = _mul(r, (_i32(3 << 28, vn) - _mul(vn, t)) >> 14) >> 15
    return r, -22 - (e2 >> 1)


def _row_quantize(x: torch.Tensor, rand: Optional[torch.Tensor], p: int,
                  mask: Optional[torch.Tensor] = None):
    """One shared exponent per row (the largest effective exponent of the
    row's unmasked elements): (int8 mantissas, (R, 1) int32 exponents)."""
    e = eff_exp(x)
    if mask is not None:
        e = torch.where(mask, e, torch.ones_like(e))
    e_row = e.amax(dim=-1, keepdim=True)
    return quantize_tile(x, rand, e_row, p, rand is not None), e_row


def _bitlen_max_abs(v: torch.Tensor) -> torch.Tensor:
    return bit_length(v.abs().amax(dim=-1, keepdim=True))


def _norm_rows_core(x, rand_in, rand_out, gm, se_g, bm_, se_b, *, n, p,
                    eps_m, eps_e, center):
    """The reference's per-row integer norm -> quantize datapath (x (R, Kp)
    f32, true width ``n``).  Returns (xq int8, se_row, c int8, e_c, r,
    e_r), the four per-row int32 columns shaped (R, 1)."""
    j, inv_q = div_n_consts(n)
    mask = torch.arange(x.shape[-1], device=x.device) < n
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    c, e_in = _row_quantize(x, rand_in, 7, mask)
    sc = scale_exp(e_in, 7)
    ci = c.to(torch.int32)
    if center:
        s1 = torch.where(mask, ci, zero).sum(-1, keepdim=True).to(torch.int32)
        sh1 = (bit_length(s1.abs()) - 15).clamp(min=0)
        mu = _mul(_sr_shift(s1, sh1, None), inv_q)
        cm = _shl(ci, 8) - _sr_shift(mu, 6 + j - sh1, None)
        cm = torch.where(mask, cm, zero)
        shc = (_bitlen_max_abs(cm) - 7).clamp(min=0)
        ci = _sr_shift(cm, shc, None)
        c = ci.to(torch.int8)
        sc = sc - 8 + shc
    s2 = _mul(ci, ci).sum(-1, keepdim=True).to(torch.int32)
    sh2 = (bit_length(s2) - 15).clamp(min=0)
    vm = _mul(_shr(s2, sh2), inv_q)
    e_v = 2 * sc + sh2 - 14 - j
    sh3 = (bit_length(vm) - 15).clamp(min=0)
    vm = _shr(vm, sh3)
    e_v = e_v + sh3
    e_cm = torch.maximum(e_v, _i32(eps_e, x))
    vs = _shr(vm, e_cm - e_v) + _shr(_i32(eps_m, x), e_cm - eps_e)
    r, e_r = _int_rsqrt(vs, e_cm)
    t = _sr_shift(_mul(ci, r), 8, None)
    o = _mul(t, gm)
    e_o = sc + e_r + 8 + se_g
    if bm_ is not None:
        sho = (_bitlen_max_abs(o) - 15).clamp(min=0)
        o = _sr_shift(o, sho, None)
        e_o = e_o + sho
        e_ob = torch.maximum(e_o, _i32(se_b, x))
        o = _sr_shift(o, e_ob - e_o, None) + torch.where(
            mask, _sr_shift(bm_, e_ob - se_b, None), zero)
        e_o = e_ob
    shq = (_bitlen_max_abs(o) - p).clamp(min=0)
    lim = (1 << p) - 1
    xq = _sr_shift(o, shq, rand_out).clamp(-lim, lim).to(torch.int8)
    return xq, e_o + shq, c, sc, r, e_r


def _pack_meta(se_row, sc, r, e_r) -> torch.Tensor:
    """The per-row scale columns as one (R, 128) int32 block."""
    pad = torch.zeros((se_row.shape[0], _META_LANES - 4), dtype=torch.int32,
                      device=se_row.device)
    return torch.cat([se_row, sc, r, e_r, pad], dim=-1)


# ---------------------------------------------------------------------------
# norm -> quantize -> GEMM
# ---------------------------------------------------------------------------

def norm_gemm_plain(x, rand_in, rand_out, gm, se_g, beta_m, se_b, w_m, se_w,
                    *, n, p=7, eps_m=1, eps_e=-32, center=False):
    """x (M, Kp) f32 (true width ``n``), rand_in / rand_out (M, Kp) uint32
    in int64 or None (half up), gm / beta_m (1, Kp) int32 gain and shift
    mantissas at 2^se_g / 2^se_b (beta_m None: RMS), w_m (N, Kp) int8,
    se_w (1, N) int32 -> (y (M, N) f32, xq (M, Kp) int8, meta (M, 128)
    int32, c (M, Kp) int8)."""
    xq, se_row, c, sc, r, e_r = _norm_rows_core(
        x, rand_in, rand_out, gm, _i32(se_g, x), beta_m,
        None if beta_m is None else _i32(se_b, x), n=n, p=p, eps_m=eps_m, eps_e=eps_e, center=center)
    y = int8_dot(xq, w_m).to(torch.float32) * pow2_f32(se_row + se_w)
    return y, xq, _pack_meta(se_row, sc, r, e_r), c


def norm_gemm_smem_bytes(bm: int, k: int) -> int:
    """Shared memory of one norm_gemm block of ``bm`` rows: the strip's
    packed xq words (whole 32-wide slices, an odd stride), one int16 row
    of c per warp, the per-row scales, and the 64 x 9-word weight tile."""
    return 4 * bm * (-(-k // 32) * 8 + 1) + 2 * 8 * k + 4 * bm + 4 * 64 * 9


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_chain")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_norm_gemm.argtypes = [vp] * 13 + [i] * 11 + [vp]
        lib.repro_norm_gemm.restype = i
        lib.repro_decode_block.argtypes = [vp] * 25 + [i] * 17 + [vp]
        lib.repro_decode_block.restype = i
        lib._typed = True
    return lib


def fused_norm_gemm(x: torch.Tensor, rand_in: Optional[torch.Tensor],
                    rand_out: Optional[torch.Tensor], gm: torch.Tensor,
                    se_g, beta_m: Optional[torch.Tensor], se_b,
                    w_m: torch.Tensor, se_w: torch.Tensor, *, n: int,
                    p: int = 7, eps_m: int = 1, eps_e: int = -32,
                    center: bool = False):
    """The fused norm -> GEMM (arguments and results of
    ``norm_gemm_plain``): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  The kernel takes x at its true width (K ==
    ``n``) and se_g / se_b as int32 device scalars."""
    if not x.is_cuda:
        return norm_gemm_plain(x, rand_in, rand_out, gm, se_g, beta_m, se_b,
                               w_m, se_w, n=n, p=p, eps_m=eps_m, eps_e=eps_e,
                               center=center)
    m, k = x.shape
    nn = w_m.shape[0]
    dev = x.device
    if k != n:
        raise ValueError(f"norm_gemm kernel takes x at its true width, got "
                         f"K={k} for n={n}")
    bm = next((b for b in (64, 32, 16)
               if norm_gemm_smem_bytes(b, k) <= kfa.SMEM_LIMIT), 0)
    if not bm:
        raise ValueError(f"norm_gemm kernel: K={k} needs more shared memory "
                         f"than {kfa.SMEM_LIMIT} B")
    stochastic = rand_out is not None
    _check("x", x, torch.float32, (m, k), dev)
    _check("gm", gm, torch.int32, (1, k), dev)
    _check("w_m", w_m, torch.int8, (nn, k), dev)
    _check("se_w", se_w, torch.int32, (1, nn), dev)
    if beta_m is not None:
        _check("beta_m", beta_m, torch.int32, (1, k), dev)
        se_b = _scalar_i32("se_b", se_b, dev)
    if stochastic:
        rand_in, rand_out = as_u32(rand_in), as_u32(rand_out)
        _check("rand_in", rand_in, torch.int32, (m, k), dev)
        _check("rand_out", rand_out, torch.int32, (m, k), dev)
    se_g = _scalar_i32("se_g", se_g, dev)
    j, inv_q = div_n_consts(n)
    y = torch.empty((m, nn), dtype=torch.float32, device=dev)
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    meta = torch.empty((m, _META_LANES), dtype=torch.int32, device=dev)
    c = torch.empty((m, k), dtype=torch.int8, device=dev)
    err = _lib().repro_norm_gemm(
        _ptr(x), _ptr(rand_in if stochastic else None),
        _ptr(rand_out if stochastic else None), _ptr(gm), _ptr(se_g),
        _ptr(beta_m), _ptr(se_b if beta_m is not None else None), _ptr(w_m),
        _ptr(se_w), _ptr(y), _ptr(xq), _ptr(meta), _ptr(c), m, nn, k, p,
        eps_m, eps_e, int(center), j, inv_q, bm, int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "norm_gemm")
    fused_norm_gemm.launches += 1
    return y, xq, meta, c


# ---------------------------------------------------------------------------
# whole-layer decode block
# ---------------------------------------------------------------------------

def _rope_half(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x * cos + rotate_half(x) * sin on (..., dh) with cos / sin (1, dh):
    XLA contracts the first product into the add."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return fmath._fma(x, cos, rot * sin)


def decode_block_plain(x, wqkv_m, se_qkv, wo_m, se_o, wgu_m, se_gu, wd_m,
                       se_d, g1m, g2m, km, ke, vm, ve, cossin, pos: int, *,
                       n_d: int, n_ff: int, hq: int, hkv: int, dh: int,
                       p: int = 7, window: int = 0, eps_m: int = 1,
                       eps_e: int = -32, se_g1: int = 0, se_g2: int = 0):
    """One decoder layer for one token (the reference's
    ``_decode_block_core``).  x (B, d) f32; contraction-last int8 weights
    wqkv_m ((hq + 2 hkv) dh, d), wo_m (d, hq dh), wgu_m (2 n_ff, d), wd_m
    (d, n_ff) with (1, N) int32 column exponents; g1m / g2m (1, d) int32
    gain mantissas at 2^se_g1 / 2^se_g2; the cache km / vm (B, hkv, T, dh)
    int8 with row exponents ke / ve (B, hkv, T, 1) before the append;
    cossin (1, 2 dh) the rope row [cos|cos|sin|sin] of ``pos``.  Returns
    (x_out (B, d), k_new (B hkv, dh) int8, ek_new (B hkv, 1) int32, v_new,
    ev_new)."""
    b = x.shape[0]
    gs = hq // hkv
    t = km.shape[2]
    half = cossin.shape[-1] // 2
    cos, sin = cossin[:, :half], cossin[:, half:]
    xq1, se1, *_ = _norm_rows_core(x, None, None, g1m, se_g1, None, None,
                                   n=n_d, p=p, eps_m=eps_m, eps_e=eps_e,
                                   center=False)
    qkv = int8_dot(xq1, wqkv_m).to(torch.float32) * pow2_f32(se1 + se_qkv)
    nq, nk = hq * dh, hkv * dh
    q = _rope_half(qkv[:, :nq].reshape(b, hq, dh), cos, sin)
    k = _rope_half(qkv[:, nq:nq + nk].reshape(b, hkv, dh), cos, sin)
    v = qkv[:, nq + nk:].reshape(b, hkv, dh)
    k_new, ek_new = _row_quantize(k.reshape(b * hkv, dh), None, p)
    v_new, ev_new = _row_quantize(v.reshape(b * hkv, dh), None, p)

    def with_row(cache, row, width):
        full = cache.clone()
        full[:, :, pos] = row.reshape(b, hkv, width)
        return full.reshape(b * hkv, t, width)

    qg = q.reshape(b * hkv, gs, dh)
    eq = eff_exp(qg).flatten(1).amax(-1).view(-1, 1, 1)
    qm = quantize_tile(qg, None, eq, p, False)
    y = kfa.attn_decode_plain(
        qm, with_row(km, k_new, dh), with_row(vm, v_new, dh),
        with_row(ke, ek_new, 1), with_row(ve, ev_new, 1), None, eq, pos,
        pos + 1, p=p, s=1, causal=True, window=window, stochastic=False)
    aq, ea = _row_quantize(y.reshape(b, hq * dh), None, p)
    o = int8_dot(aq, wo_m).to(torch.float32) * pow2_f32(scale_exp(ea, p)
                                                        + se_o)
    h2 = x + o
    xq2, se2, *_ = _norm_rows_core(h2, None, None, g2m, se_g2, None, None,
                                   n=n_d, p=p, eps_m=eps_m, eps_e=eps_e,
                                   center=False)
    gu = int8_dot(xq2, wgu_m).to(torch.float32) * pow2_f32(se2 + se_gu)
    gate = gu[:, :n_ff]
    act = (gate * fmath.logistic(gate)) * gu[:, n_ff:]
    mq, em = _row_quantize(act, None, p)
    dn = int8_dot(mq, wd_m).to(torch.float32) * pow2_f32(scale_exp(em, p)
                                                         + se_d)
    return h2 + dn, k_new, ek_new, v_new, ev_new


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def decode_block_smem_bytes(b: int, d: int, n_ff: int, hq: int, hkv: int,
                            dh: int, t: int) -> int:
    """Dynamic shared memory of one block of the decode block kernel
    (``dec_layout`` in the source): the int8 GEMV input of the widest
    stage, the int16 norm rows, per-row scales, and for each of the 8
    warps its attention tiles: the query group, the fresh K and V rows,
    the scores and quantized probabilities over T, the rows' exponents."""
    gs = hq // hkv
    per_warp = _align16(gs * dh + 2 * dh + 5 * gs * t) + _align16(4 * gs)
    return (_align16(b * max(d, hq * dh, n_ff)) + _align16(2 * b * d)
            + _align16(16 * b) + 8 * per_warp)


def fused_decode_block(x, wqkv_m, se_qkv, wo_m, se_o, wgu_m, se_gu, wd_m,
                       se_d, g1m, g2m, km, ke, vm, ve, cossin, pos: int, *,
                       n_d: int, n_ff: int, hq: int, hkv: int, dh: int,
                       p: int = 7, window: int = 0, eps_m: int = 1,
                       eps_e: int = -32, se_g1: int = 0, se_g2: int = 0):
    """One decoder layer for one token (arguments and results of
    ``decode_block_plain``): the CUDA kernel (one cooperative launch over
    the card) for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(n_d=n_d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=p, window=window,
              eps_m=eps_m, eps_e=eps_e, se_g1=se_g1, se_g2=se_g2)
    if not x.is_cuda:
        return decode_block_plain(x, wqkv_m, se_qkv, wo_m, se_o, wgu_m,
                                  se_gu, wd_m, se_d, g1m, g2m, km, ke, vm, ve,
                                  cossin, pos, **kw)
    b, d = x.shape
    t = km.shape[2]
    nqkv = (hq + 2 * hkv) * dh
    dev = x.device
    why = decode_block_unsupported(b, d, n_ff, hq, hkv, dh, t)
    if why:
        raise ValueError(f"decode_block kernel: {why}")
    if not 0 <= pos < t:
        raise ValueError(f"decode_block: pos={pos} outside the cache of {t}")
    for name, a, dt, shape in (
            ("x", x, torch.float32, (b, d)),
            ("wqkv_m", wqkv_m, torch.int8, (nqkv, d)),
            ("se_qkv", se_qkv, torch.int32, (1, nqkv)),
            ("wo_m", wo_m, torch.int8, (d, hq * dh)),
            ("se_o", se_o, torch.int32, (1, d)),
            ("wgu_m", wgu_m, torch.int8, (2 * n_ff, d)),
            ("se_gu", se_gu, torch.int32, (1, 2 * n_ff)),
            ("wd_m", wd_m, torch.int8, (d, n_ff)),
            ("se_d", se_d, torch.int32, (1, d)),
            ("g1m", g1m, torch.int32, (1, d)), ("g2m", g2m, torch.int32, (1, d)),
            ("km", km, torch.int8, (b, hkv, t, dh)),
            ("ke", ke, torch.int32, (b, hkv, t, 1)),
            ("vm", vm, torch.int8, (b, hkv, t, dh)),
            ("ve", ve, torch.int32, (b, hkv, t, 1)),
            ("cossin", cossin, torch.float32, (1, 2 * dh))):
        _check(name, a, dt, shape, dev)
    rows = b * hkv
    f32 = dict(dtype=torch.float32, device=dev)
    x_out = torch.empty((b, d), **f32)
    k_new = torch.empty((rows, dh), dtype=torch.int8, device=dev)
    v_new = torch.empty((rows, dh), dtype=torch.int8, device=dev)
    ek_new = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    ev_new = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    # stage outputs read by later stages of the same launch
    qkv = torch.empty((b, nqkv), **f32)
    attn = torch.empty((b, hq * dh), **f32)
    h2 = torch.empty((b, d), **f32)
    act = torch.empty((b, n_ff), **f32)
    err = _lib().repro_decode_block(
        *(_ptr(a) for a in (x, wqkv_m, se_qkv, wo_m, se_o, wgu_m, se_gu, wd_m,
                            se_d, g1m, g2m, km, ke, vm, ve, cossin, x_out,
                            k_new, ek_new, v_new, ev_new, qkv, attn, h2, act)),
        b, d, n_ff, hq, hkv, dh, t, int(pos), window, p, eps_m, eps_e, se_g1,
        se_g2, *div_n_consts(d),
        decode_block_smem_bytes(b, d, n_ff, hq, hkv, dh, t),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "decode_block")
    fused_decode_block.launches += 1
    return x_out, k_new, ek_new, v_new, ev_new


def decode_block_unsupported(b: int, d: int, n_ff: int, hq: int, hkv: int,
                             dh: int, t: int) -> str:
    """Why the decode block kernel cannot take a layer ('' when it can)."""
    if b > DECODE_BLOCK_MAX_B:
        return f"batch {b} > {DECODE_BLOCK_MAX_B} rows"
    if any(v % 16 for v in (d, hq * dh, n_ff)):
        return (f"d={d}, hq*dh={hq * dh} and n_ff={n_ff} must be multiples "
                f"of 16 (16-byte weight rows)")
    if dh % 4 or dh > 128 or hq % hkv:
        return f"head dim {dh} must be a multiple of 4 up to 128"
    if t > DECODE_BLOCK_MAX_T:
        return f"cache length {t} > {DECODE_BLOCK_MAX_T}"
    need = decode_block_smem_bytes(b, d, n_ff, hq, hkv, dh, t)
    if need > kfa.SMEM_LIMIT:
        return f"needs {need} B of shared memory > {kfa.SMEM_LIMIT}"
    return ""


# Launches of each kernel since the count was last set to 0.
fused_norm_gemm.launches = 0
fused_decode_block.launches = 0
