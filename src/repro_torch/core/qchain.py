"""Cross-op chains: the qops-layer face of ``kernels.fused_chain`` and the
GEMM epilogue of ``kernels.fused_linear``.

The port of ``repro.core.qchain``:

``qnorm_gemm``
    norm -> quantize -> GEMM as one kernel (``norm_gemm``): the per-row
    integer RMS/LayerNorm feeds the int8 GEMM directly.  The chain has its
    own per-row numerics, so it engages only where dispatch plans it
    FUSED; otherwise it returns None and the caller keeps the per-op seam
    (qnorm, then qmatmul).

``qmatmul_epi``
    GEMM -> bias / activation as one kernel (``gemm_epi``): the same f32
    ops as the per-op composition, so routing it moves cost, not results.

``qdecode_block``
    One whole decoder layer per decode step (``decode_block``), gradient
    free; the fresh K/V rows come back quantized under the cache's per-row
    rule and are written into the cache here.

Both differentiable chains are ``torch.autograd.Function``s whose backward
is the A.2 integer backward on the int8 residuals the kernels emit: dX
through ``contract_qi``, dW through ``contract_ii`` (per-row norm scales
fold into the gradient rows as exact powers of two); only the norm's
elementwise backward and the activation's pullback run in float32, rounded
as the reference rounds them (``core.fmath``).  Keys are split and folded
as in the JAX package, so the same key gives the same results.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import dispatch as kd
from ..kernels.fused_linear import epi_pullback
from . import fmath, prng
from .bfp import (BFP, PER_TENSOR, QuantConfig, pow2, quantize,
                  quantize_weight, rounding_bits, scale_exponent)
from .policy import NumericPolicy
from .qnorm import norm_gain_fx
from .qops import _cfg_for_dim, _contract_q, _plan, _t, _tq, _unit_view

__all__ = ["qmatmul_epi", "qnorm_gemm", "qdecode_block"]

_LANE = 128


def _round_up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


# ---------------------------------------------------------------------------
# GEMM -> bias / activation epilogue
# ---------------------------------------------------------------------------

class _QMatmulEpi(torch.autograd.Function):
    """``_qmatmul_epi``: x (..., K) @ w (K, N), both quantized in the
    kernel (kind qq), then bias and the activation; the backward pulls the
    gradient back through the activation, then A.2 as ``_qmatmul_bwd``."""

    @staticmethod
    def forward(ctx, x, w, bias, key, policy, act, dec):
        kx, kw, kb = prng.split(key, 3)
        lead = x.shape[:-1]
        k, n = x.shape[-1], w.shape[-1]
        n_out = n // 2 if (act or "").endswith("_glu") else n
        cfg = _cfg_for_dim(policy.fwd_cfg(), k)
        out, xq, wq, ylin = kd.contract_epi(
            x.reshape(-1, k), _t(w), dec, cfg=cfg, ka=kx, kb=kw,
            bias=None if bias is None else bias.reshape(1, -1), act=act)
        ctx.res = (xq, wq, ylin, bias is not None, kb, lead, n_out)
        ctx.policy, ctx.act = policy, act
        return out.reshape(*lead, n_out)

    @staticmethod
    def backward(ctx, gy):
        xq, wq, ylin, has_bias, kb, lead, n_out = ctx.res
        policy = ctx.policy
        g2 = gy.reshape(-1, n_out).to(torch.float32)
        gl = g2 if ctx.act is None else epi_pullback(ylin, g2, ctx.act, n_out)
        dbias = (fmath._sum_windows(gl.reshape(*lead, gl.shape[-1]),
                                    range(len(lead))) if has_bias else None)
        cfg_b = policy.bwd_cfg()
        kg = prng.split(kb, 4)[0]              # _qmatmul_bwd's split
        m, n = gl.shape
        k = xq.m.shape[-1]
        plan_dx = _plan("qmatmul_epi_dx", m, n, k, cfg_b, policy, gy.device,
                        kind="qi", cfg2=wq.cfg)
        if plan_dx.path == kd.JNP:
            gqn = quantize(gl, cfg_b, kg)
            dx = _contract_q(gqn, _tq(wq), 0, policy.accum_chunk)
        else:
            dx, gqn = kd.contract_qi(gl, _tq(wq), cfg_b, kg, plan_dx)
        gqm = _tq(gqn)
        plan_dw = _plan("qmatmul_epi_dw", k, m, n, gqm.cfg, policy, gy.device,
                        kind="ii", cfg2=xq.cfg)
        if plan_dw.path == kd.JNP:
            dw = _contract_q(_tq(xq), gqm, 0, policy.accum_chunk)
        else:
            dw = kd.contract_ii(_tq(xq), gqm, plan_dw)
        return dx.reshape(*lead, k), dw, dbias, None, None, None, None


def qmatmul_epi(x, w, key: prng.Key, policy: NumericPolicy, *,
                bias: Optional[torch.Tensor] = None, act: Optional[str] = None,
                out_q: bool = False):
    """Maybe-fused ``qmatmul`` + bias / activation epilogue: x (..., K) @
    w (K, N) f32 -> (..., N) f32 (N/2 for a ``*_glu`` act), or **None**
    when dispatch does not plan the chain and the caller keeps its per-op
    composition.  The same ``(kx, kw, kb)`` key split as ``qmatmul``."""
    if not policy.enabled or isinstance(x, BFP) or isinstance(w, BFP):
        return None
    if out_q:
        # the chain's autograd Function emits f32 only (the BFP output with
        # its carrier is not ported); no model path asks: under qflow seams
        # the norm before it hands it a BFP
        return None
    k, n = x.shape[-1], w.shape[-1]
    cfg = _cfg_for_dim(policy.fwd_cfg(), k)
    if cfg.block != PER_TENSOR:
        return None
    dec = kd.plan_epilogue(
        "qmatmul_epi", math.prod(x.shape[:-1]), k, n, cfg, kind="qq",
        act=act, bias=bias is not None, out_q=out_q,
        kernel_mode=policy.kernel_mode, accum_chunk=policy.accum_chunk,
        device=x.device.type)
    if dec.path != kd.FUSED:
        return None
    return _QMatmulEpi.apply(x, w, bias, key, policy, act, dec)


# ---------------------------------------------------------------------------
# norm -> quantize -> GEMM
# ---------------------------------------------------------------------------

class _QNormGemm(torch.autograd.Function):
    """``_qnorm_gemm``: the kernel's forward keeps xq, the per-row scales
    and c; the backward is dA = Ĝ Ŵᵀ (qi), dW = Âᵀ Ĝ (ii, the per-row
    scales folded into the gradient rows) and the f32 norm backward from
    the int8 residuals."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, key, policy, rms, dec):
        lead = x.shape[:-1]
        k, n = x.shape[-1], w.shape[-1]
        cfg = _cfg_for_dim(policy.fwd_cfg(), k)
        kw_, kr1, kr2, kb = prng.split(key, 4)
        x2 = x.reshape(-1, k)
        m = x2.shape[0]
        kp = _round_up(k, _LANE)
        dev = x.device
        wq = quantize_weight(_t(w), cfg, kw_)              # (n, k) per tensor
        se_w = scale_exponent(wq.e, cfg).to(torch.int32).reshape(1, 1) \
            .expand(1, n).contiguous()
        gm, se_g = norm_gain_fx(gamma)
        bm, se_b = (None, 0) if beta is None else norm_gain_fx(beta)
        sr = cfg.stochastic
        # drawn at the reference's lane-padded width, as it draws them
        rin = rounding_bits(kr1, (m, kp), cfg.rng, dev) if sr else None
        rout = rounding_bits(kr2, (m, kp), cfg.rng, dev) if sr else None
        y, xq_m, meta, c = kd.run_norm_gemm(
            x2, rin, rout, gm, se_g, bm, se_b, wq.m, se_w, dec, n=k, p=cfg.p,
            center=not rms)
        ctx.save_for_backward(xq_m, meta[:, :4], c, gamma)
        ctx.res = (wq, kb, lead, beta is not None)
        ctx.policy, ctx.rms = policy, rms
        return y.reshape(*lead, n)

    @staticmethod
    def backward(ctx, gy):
        xq_m, meta, c, gamma = ctx.saved_tensors
        wq, kb, lead, has_beta = ctx.res
        policy = ctx.policy
        cfg_b = policy.bwd_cfg()
        kg, kg2 = prng.split(kb)
        g2 = gy.reshape(-1, gy.shape[-1]).to(torch.float32)
        m, n = g2.shape
        k = xq_m.shape[-1]
        plan_dx = _plan("qnorm_gemm_dx", m, n, k, cfg_b, policy, gy.device,
                        kind="qi", cfg2=wq.cfg)
        if plan_dx.path == kd.JNP:
            gqn = quantize(g2, cfg_b, kg)
            da = _contract_q(gqn, _tq(wq), 0, policy.accum_chunk)
        else:
            da, gqn = kd.contract_qi(g2, _tq(wq), cfg_b, kg, plan_dx)
        # Â = xq * 2^se_row per row: the scales fold into the gradient rows
        gq2 = quantize(g2 * pow2(meta[:, 0:1]), cfg_b, kg2)
        xq_u = _unit_view(xq_m, 8, cfg_b.rng)
        plan_dw = _plan("qnorm_gemm_dw", k, m, n, gq2.cfg, policy, gy.device,
                        kind="ii", cfg2=xq_u.cfg)
        if plan_dw.path == kd.JNP:
            dw = _contract_q(_tq(xq_u), _tq(gq2), 0, policy.accum_chunk)
        else:
            dw = kd.contract_ii(_tq(xq_u), _tq(gq2), plan_dw)
        # the elementwise norm backward in f32 from the int8 residuals
        r_f = meta[:, 2:3].to(torch.float32) * pow2(meta[:, 3:4])
        xhat = (c.to(torch.float32) * pow2(meta[:, 1:2])
                * meta[:, 2:3].to(torch.float32) * pow2(meta[:, 3:4]))
        g_row = gamma.reshape(1, -1).to(torch.float32)
        inv_k = fmath._f(1.0 / k)          # XLA's mean: sum * f32(1 / k)
        m2 = fmath._sum_products(da * g_row, xhat, -1)[:, None] * inv_k
        # XLA recomputes t = da * gamma inside the last fusion and
        # contracts it: (da * gamma - xhat * m2) with the first product
        # fused, and with centring (da * gamma - m1) - xhat * m2 as two
        if ctx.rms:
            dx = r_f * fmath._fma(da, g_row, -(xhat * m2))
        else:
            m1 = fmath._sum_products(da, g_row, -1)[:, None] * inv_k
            dx = r_f * fmath._fma(-xhat, m2, fmath._fma(da, g_row, -m1))
        # XLA reduces this column sum of products with an fma chain below
        # 16 rows and in a vectorised order from 16 to 32 rows
        dgamma = fmath.sum_products_cols(da, xhat).reshape(gamma.shape)
        dbeta = fmath._sum_windows(da, (0,)) if has_beta else None
        return (dx.reshape(*lead, k), dgamma, dbeta, dw, None, None, None,
                None)


def qnorm_gemm(x, gamma, beta, w, key: prng.Key, policy: NumericPolicy, *,
               rms: bool = True):
    """Maybe-fused norm -> quantize -> GEMM: x (..., K) f32 pre-norm rows,
    ``gamma`` / ``beta`` the norm's affine, w (K, N) a float32 weight ->
    (..., N) f32, or **None** where dispatch keeps the per-op seam."""
    if (not policy.enabled or not policy.quantize_norms
            or isinstance(x, BFP) or isinstance(w, BFP)
            or isinstance(gamma, BFP)):
        return None
    k, n = x.shape[-1], w.shape[-1]
    cfg = _cfg_for_dim(policy.fwd_cfg(), k)
    if cfg.block != PER_TENSOR or cfg.bits != 8:
        return None
    dec = kd.plan_norm_gemm("qnorm_gemm", math.prod(x.shape[:-1]), k, n, cfg,
                            kernel_mode=policy.kernel_mode,
                            device=x.device.type)
    if dec.path != kd.FUSED:
        return None
    return _QNormGemm.apply(x, gamma, beta, w, key, policy, rms, dec)


# ---------------------------------------------------------------------------
# whole-layer decode block
# ---------------------------------------------------------------------------

_GAIN_SE = -14   # the static fx scale of the decode block's norm gains


def _gain_static(g: torch.Tensor) -> torch.Tensor:
    """(1, K) int32 norm-gain mantissas at the static 2^_GAIN_SE scale."""
    return torch.round(g.reshape(1, -1).to(torch.float32)
                       * float(2 ** -_GAIN_SE)).to(torch.int32)


def _cat_cols(ws, cfg: QuantConfig, key: prng.Key):
    """Stack projection weights into one contraction-last int8 block: each
    ``w (k, n_i)`` (float32, quantized per tensor to nearest, or a
    per-tensor BFP) gives ``n_i`` mantissa rows and a stripe of its own
    scale exponent, so split projections share one GEMV without sharing a
    scale."""
    det = QuantConfig(cfg.bits, PER_TENSOR, False, cfg.rng)
    ms, ses = [], []
    for i, w in enumerate(ws):
        if isinstance(w, BFP):
            q, mt = w, _t(w.m)
        else:
            q = quantize_weight(_t(w), det, prng.fold_in(key, i))
            mt = q.m
        se = scale_exponent(q.e, q.cfg).to(torch.int32).reshape(1, 1)
        ms.append(mt)
        ses.append(se.expand(1, mt.shape[0]))
    return torch.cat(ms, dim=0), torch.cat(ses, dim=1)


def qdecode_block(x, g1, g2, wq, wk, wv, wo, wg, wu, wd, kc: BFP, vc: BFP,
                  cossin: torch.Tensor, pos: int, key: prng.Key,
                  policy: NumericPolicy, *, hq: int, hkv: int, dh: int,
                  window: int = 0):
    """Maybe-fused whole decoder layer for one token (serving only): x
    (B, d) f32, the RMS gains, the projections (f32 or per-tensor BFP),
    the layer's quantized cache ``kc`` / ``vc`` (B, hkv, T, dh), ``cossin``
    (1, 2 dh) the rope row [cos|cos|sin|sin] of ``pos``.  Returns (x_out,
    kc, vc) with the fresh rows written at ``pos`` (in place), or **None**
    where dispatch keeps the per-op decode path."""
    if not policy.enabled or isinstance(x, BFP):
        return None
    if not (isinstance(kc, BFP) and isinstance(vc, BFP)):
        return None
    b, d = x.shape
    n_ff = (wg.m if isinstance(wg, BFP) else wg).shape[-1]
    t = kc.m.shape[2]
    cfg = _cfg_for_dim(policy.fwd_cfg(), d)
    if cfg.bits != 8 or kc.cfg.bits != 8:
        return None
    dec = kd.plan_decode_block("qdecode_block", b, d, n_ff, t, hq, hkv, dh,
                               cfg, kernel_mode=policy.kernel_mode,
                               device=x.device.type)
    if dec.path != kd.FUSED:
        return None
    wqkv_m, se_qkv = _cat_cols([wq, wk, wv], cfg, prng.fold_in(key, 0))
    wo_m, se_o = _cat_cols([wo], cfg, prng.fold_in(key, 1))
    wgu_m, se_gu = _cat_cols([wg, wu], cfg, prng.fold_in(key, 2))
    wd_m, se_d = _cat_cols([wd], cfg, prng.fold_in(key, 3))
    x_out, k_new, ek_new, v_new, ev_new = kd.run_decode_block(
        x.detach(), wqkv_m.contiguous(), se_qkv.contiguous(),
        wo_m.contiguous(), se_o.contiguous(), wgu_m.contiguous(),
        se_gu.contiguous(), wd_m.contiguous(), se_d.contiguous(),
        _gain_static(g1), _gain_static(g2), kc.m, kc.e, vc.m, vc.e,
        cossin.contiguous(), pos, dec, n_d=d, n_ff=n_ff, hq=hq, hkv=hkv,
        dh=dh, p=cfg.p, window=window, se_g1=_GAIN_SE, se_g2=_GAIN_SE)
    kc.m[:, :, pos] = k_new.reshape(b, hkv, dh)
    kc.e[:, :, pos] = ek_new.reshape(b, hkv, 1)
    vc.m[:, :, pos] = v_new.reshape(b, hkv, dh)
    vc.e[:, :, pos] = ev_new.reshape(b, hkv, 1)
    return x_out, kc, vc
