"""Integer GEMM-shaped ops with integer forward and integer backward.

The port of ``repro.core.qops``: every op quantizes its float32 operands
to BFP, contracts the integer mantissas with exact int32 accumulation and
applies the exponent-add scale once.  ``qmatmul``, ``qbmm``, ``qembed``
and ``qdq_st`` are ``torch.autograd.Function``s whose forward keeps the
int8 mantissas as residuals and whose backward is Appendix A.2: the
upstream gradient is quantized once and both dX = Ĝ Ŵᵀ and dW = X̂ᵀ Ĝ are
integer contractions (the embedding's dTable an int32 scatter-add).  Each
contraction asks ``kernels.dispatch`` for a path: the hand-written kernel
(``fused``: ``qq`` forward, ``qi`` dX, ``ii`` dW) or the plain oracle path
below (``jnp``).  Keys are split and folded exactly as in the JAX package,
so the same key gives the same rounding bits and results compare with
``==``.

Per-block (MX-style) scales, one exponent per ``policy.block`` elements of
each contraction axis that the block divides (per tensor otherwise): the
forward quantizes both operands along K (the ``qq_blk`` kernel), and each
backward contraction re-blocks its stored residual along its own axis
(dequantize, transpose, quantize again with a fresh key) and quantizes
the gradient along that axis too, so dX and dW are kind ``qq`` as well.
The plain path sums the per-block partials in the reference's jnp order
(``_blk_dot``), the kernel in block order (the reference's Pallas order).
The embedding's per-block backward scatters the float gradient.

The qflow currency: ``qmatmul`` and ``qbmm`` also take per-tensor BFP
operands (q-in: the mantissas are contracted as they are, kinds ``iq``,
``qi`` and ``pp``) and ``qmatmul(out_q=True)`` returns a BFP (q-out).  A
BFP operand's float32 carrier ``g`` is an input of the op's
``autograd.Function`` that its forward never reads; the backward returns
the operand's A.2 gradient there.  ``qattention`` is fused integer flash
attention over pre-quantized Q/K/V (the ``attn_fwd`` / ``attn_bwd``
kernels), its gradients on the carriers too.

The qweights currency: ``qmatmul`` takes a per-tensor BFP weight (a
forward weight narrowed from the int16 masters, or a load-time-quantized
serving weight) and ``qembed`` a per-tensor BFP table, contracted and
gathered as they are; dW and dTable go to the weight's carrier.

``qconv`` is the CNN family's convolution: im2col patches (of float32
values, or of a BFP's int8 mantissas) contracted with the reshuffled
filter by ``qmatmul``; ``qrelu`` acts on BFP mantissas exactly.  Also
here: ``qdq_st`` and the qcache ops (cache rows quantized once at append
time, one exponent per row, nearest rounding).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import dispatch as kd
from ..kernels import fused_attention as kfa
from ..kernels.fused_linear import int8_dot
from . import fmath, prng
from .bfp import (BFP, PER_TENSOR, QuantConfig, bfp_value, biased_exponent,
                  dequantize, pow2, quantize, quantize_cache, quantize_weight,
                  rounding_bits, scale_exponent)
from .policy import NumericPolicy

__all__ = ["qmatmul", "qconv", "qrelu", "qbmm", "qattention", "qembed",
           "qdq_st", "qcache_quantize", "qcache_prefill", "qcache_append",
           "qcache_qk", "qcache_pv", "qcache_attention"]


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _chunk_count(k: int, chunk: int) -> int:
    if chunk <= 0 or k <= chunk:
        return 1
    return -(-k // chunk)


def _pt_dot(am: torch.Tensor, bm: torch.Tensor, nbatch: int,
            nchunk: int) -> torch.Tensor:
    """Integer dot, per-tensor scale: (*B, M, K) x (*B, N, K) -> f32.
    ``nchunk`` > 1 splits K (zero-padded) into int32 accumulators whose
    partials are combined in f32 (the accumulator-flush emulation)."""
    k = am.shape[-1]
    if nchunk == 1:
        return int8_dot(am, bm).to(torch.float32)
    kc = -(-k // nchunk)
    pad = nchunk * kc - k
    if pad:
        am = torch.nn.functional.pad(am, (0, pad))
        bm = torch.nn.functional.pad(bm, (0, pad))
    a4 = am.reshape(*am.shape[:-1], nchunk, kc).movedim(-2, nbatch)
    b4 = bm.reshape(*bm.shape[:-1], nchunk, kc).movedim(-2, nbatch)
    return int8_dot(a4, b4).to(torch.float32).sum(dim=nbatch)


def _blk_dot(aq: BFP, bq: BFP, nbatch: int) -> torch.Tensor:
    """Integer dot with per-block scales along the contraction axis: the
    exact per-block partials, each times its exact block scale, summed
    over the block axis in the reference's jnp order (XLA CPU's windows
    of 32).  The ``qq_blk`` kernel sums in block order instead, as the
    reference's Pallas kernel does."""
    blk = aq.cfg.block
    nb = aq.m.shape[-1] // blk
    a4 = aq.m.reshape(*aq.m.shape[:-1], nb, blk).movedim(-2, nbatch)
    b4 = bq.m.reshape(*bq.m.shape[:-1], nb, blk).movedim(-2, nbatch)
    acc = int8_dot(a4, b4).to(torch.float32)
    ea = scale_exponent(aq.e, aq.cfg).movedim(-1, nbatch)[..., :, None]
    eb = scale_exponent(bq.e, bq.cfg).movedim(-1, nbatch)[..., None, :]
    return fmath.sum_windows(acc * pow2(ea + eb), (nbatch,))


def _contract_q(aq: BFP, bq: BFP, nbatch: int, chunk: int) -> torch.Tensor:
    """Contraction of two pre-quantized contraction-last BFP operands."""
    if aq.cfg.block == PER_TENSOR:
        nchunk = _chunk_count(aq.m.shape[-1], chunk)
        acc = _pt_dot(aq.m, bq.m, nbatch, nchunk)
        return acc * pow2(scale_exponent(aq.e, aq.cfg)
                          + scale_exponent(bq.e, bq.cfg))
    return _blk_dot(aq, bq, nbatch)


def _cfg_for_dim(cfg: QuantConfig, dim: int) -> QuantConfig:
    if cfg.block and dim % cfg.block != 0:
        return QuantConfig(cfg.bits, PER_TENSOR, cfg.stochastic, cfg.rng)
    return cfg


def _tq(q: BFP) -> BFP:
    """Transpose the last two axes of a per-tensor BFP (a view)."""
    return BFP(_t(q.m), q.e, q.cfg)


def _wcfg_for(xcfg: QuantConfig, policy: NumericPolicy) -> QuantConfig:
    return QuantConfig(policy.fwd_bits, xcfg.block, policy.stochastic,
                       policy.rng)


def _plan(op: str, m: int, k: int, n: int, cfg: QuantConfig,
          policy: NumericPolicy, device: torch.device, kind: str = "qq",
          cfg2: Optional[QuantConfig] = None) -> kd.Decision:
    return kd.plan_contract(op, m, k, n, cfg, kind=kind, cfg2=cfg2,
                            kernel_mode=policy.kernel_mode,
                            accum_chunk=policy.accum_chunk,
                            device=device.type)


def _requant_contract(op: str, a: torch.Tensor, b: torch.Tensor,
                      cfg: QuantConfig, ka: prng.Key, kb: prng.Key,
                      nbatch: int, policy: NumericPolicy) -> torch.Tensor:
    """One backward contraction under a per-block policy: a (*B, M, K) and
    b (*B, N, K) f32, both quantized along K with ``cfg`` (per block when
    the block divides K), kind qq.  One operand is the upstream gradient,
    the other a dequantized residual: the reference's ``_requant_t`` on the
    plain path, its in-kernel requantization on the kernel path (no
    mantissa written)."""
    plan = _plan(op, a.shape[-2], a.shape[-1], b.shape[-2], cfg, policy,
                 a.device)
    if plan.path == kd.JNP:
        return _contract_q(quantize(a, cfg, ka), quantize(b, cfg, kb), nbatch,
                           policy.accum_chunk)
    return kd.contract_qq(a, b, cfg, ka, kb, plan, nbatch=nbatch,
                          want_residuals=False)[0]


# ---------------------------------------------------------------------------
# qmatmul: x (..., K) @ w (K, N)
# ---------------------------------------------------------------------------

def _qmatmul_fwd(x: torch.Tensor, w: torch.Tensor, key: prng.Key,
                 policy: NumericPolicy):
    """Per-call weights: both operands quantized in the op (kind qq).
    -> (y, residuals (xq, wq, kb, lead))."""
    cfg = _cfg_for_dim(policy.fwd_cfg(), x.shape[-1])
    kx, kw, kb = prng.split(key, 3)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    plan = _plan("qmatmul_fwd", x2.shape[0], x2.shape[1], w.shape[-1], cfg,
                 policy, x.device)
    if plan.path == kd.JNP:
        xq = quantize(x2, cfg, kx)
        wq = quantize_weight(_t(w), cfg, kw)
        y = _contract_q(xq, wq, 0, policy.accum_chunk)
    else:
        y, xq, wq = kd.contract_qq(x2, _t(w), cfg, kx, kw, plan)
    return y.reshape(*lead, w.shape[-1]), (xq, wq, kb, lead)


def _qmatmul_bwd(policy: NumericPolicy, res, gy: torch.Tensor,
                 need_dx: bool = True):
    """A.2: Ĝ quantized once; dX = Ĝ Ŵᵀ (kind qi), dW = X̂ᵀ Ĝ (kind ii)
    on the stored mantissas; under per-block scales both are kind qq on
    re-blocked residuals (``_requant_contract``).  -> (dx, dw).  Without
    ``need_dx`` (an input that takes no gradient: the CNN's images) Ĝ is
    quantized alone and dx is None, as the reference's compiled step keeps
    no unused dX."""
    xq, wq, kb, lead = res
    cfg_b = policy.bwd_cfg()
    kg, kg2, kx2, kw2 = prng.split(kb, 4)
    g2 = gy.reshape(-1, gy.shape[-1])
    m, n = g2.shape
    k = xq.m.shape[-1]
    if policy.block != PER_TENSOR:
        # dX = G W^T contracts N, dW = X^T G contracts M
        dx = _requant_contract("qmatmul_dx", g2, _t(dequantize(wq)),
                               _cfg_for_dim(cfg_b, n), kg, kw2, 0, policy)
        dw = _requant_contract("qmatmul_dw", _t(dequantize(xq)), _t(g2),
                               _cfg_for_dim(cfg_b, m), kx2, kg2, 0, policy)
        return dx.reshape(*lead, k), dw
    plan_dx = _plan("qmatmul_dx", m, n, k, cfg_b, policy, gy.device,
                    kind="qi", cfg2=wq.cfg) if need_dx else None
    if plan_dx is None or plan_dx.path == kd.JNP:
        gqn = quantize(g2, cfg_b, kg)
        dx = (None if plan_dx is None
              else _contract_q(gqn, _tq(wq), 0, policy.accum_chunk))
    else:
        dx, gqn = kd.contract_qi(g2, _tq(wq), cfg_b, kg, plan_dx)
    gqm = _tq(gqn)                       # (N, M): the same mantissas
    plan_dw = _plan("qmatmul_dw", k, m, n, gqm.cfg, policy, gy.device,
                    kind="ii", cfg2=xq.cfg)
    if plan_dw.path == kd.JNP:
        dw = _contract_q(_tq(xq), gqm, 0, policy.accum_chunk)
    else:
        dw = kd.contract_ii(_tq(xq), gqm, plan_dw)
    return (None if dx is None else dx.reshape(*lead, k)), dw


def _carrier_grads(q_in: bool, has_g: bool, grad):
    """(gradient of the float input, gradient of the carrier) of one
    operand: a BFP operand's gradient goes to its carrier."""
    if not q_in:
        return grad, None
    return None, grad if has_g else None


def _quantize_out(y: torch.Tensor, n: int, policy: NumericPolicy,
                  kq: prng.Key):
    """q-out: quantize the f32 output once -> (m, e, carrier value)."""
    yq = quantize(y, _cfg_for_dim(policy.fwd_cfg(), n), kq)
    return yq.m, yq.e, dequantize(yq)


class _QMatmulFlex(torch.autograd.Function):
    """``_qmatmul_flex``, every enabled ``qmatmul`` on a float weight: x
    (..., K) f32 (``xcfg`` None: both operands quantized in the op), or
    per-tensor BFP mantissas with exponent ``xe`` and carrier ``xg`` (kind
    iq: only the weight is quantized in the op), @ w (K, N); ``out_q``
    returns (m, e, carrier)."""

    @staticmethod
    def forward(ctx, x, xg, w, xe, key, policy, xcfg, out_q):
        lead = x.shape[:-1]
        k, n = x.shape[-1], w.shape[-1]
        if xcfg is None:
            y, res = _qmatmul_fwd(x, w, key, policy)
        else:
            _, kw, kb = prng.split(key, 3)
            xq = BFP(x.reshape(-1, k), xe, xcfg)
            wcfg = _wcfg_for(xcfg, policy)
            plan = _plan("qmatmul_fwd", xq.m.shape[0], k, n, wcfg, policy,
                         x.device, kind="iq", cfg2=xcfg)
            if plan.path == kd.JNP:
                wq = quantize_weight(_t(w), wcfg, kw)
                y = _contract_q(xq, wq, 0, policy.accum_chunk)
            else:
                y, wq = kd.contract_iq(xq, _t(w), wcfg, kw, plan)
            y, res = y.reshape(*lead, n), (xq, wq, kb, lead)
        ctx.res, ctx.policy, ctx.out_q = res, policy, out_q
        ctx.q_in, ctx.has_g = xcfg is not None, xg is not None
        if not out_q:
            return y
        out = _quantize_out(y, n, policy, prng.fold_in(key, 0xD0))
        ctx.mark_non_differentiable(out[0], out[1])
        return out

    @staticmethod
    def backward(ctx, *cts):
        gy = cts[2] if ctx.out_q else cts[0]
        dx, dw = _qmatmul_bwd(ctx.policy, ctx.res, gy,
                              any(ctx.needs_input_grad[:2]))
        return (*_carrier_grads(ctx.q_in, ctx.has_g, dx), dw) + (None,) * 5


class _QMatmulPW(torch.autograd.Function):
    """``_qmatmul_pw``, a persistent weight: x (..., K) f32 (kind qi: only
    x is quantized in the op) or per-tensor BFP mantissas with exponent
    ``xe`` and carrier ``xg`` (kind pp: nothing is quantized) @ the
    per-tensor BFP weight ``wm`` (K, N) with exponent ``we``, whose
    carrier ``wg`` takes dW; ``out_q`` returns (m, e, carrier).  The
    backward is ``_qmatmul_bwd`` on the stored weight mantissas."""

    @staticmethod
    def forward(ctx, x, xg, wm, wg, xe, we, key, policy, xcfg, wcfg, out_q):
        # the (kx, kw, kb) split of the float-weight path; kw goes unused
        kx, _, kb = prng.split(key, 3)
        lead = x.shape[:-1]
        k, n = x.shape[-1], wm.shape[-1]
        x2 = x.reshape(-1, k)
        wq = BFP(_t(wm), we, wcfg)                           # (N, K)
        if xcfg is None:
            cfg = _wcfg_for(wcfg, policy)
            plan = _plan("qmatmul_fwd", x2.shape[0], k, n, cfg, policy,
                         x.device, kind="qi", cfg2=wcfg)
            if plan.path == kd.JNP:
                xq = quantize(x2, cfg, kx)
                y = _contract_q(xq, wq, 0, policy.accum_chunk)
            else:
                y, xq = kd.contract_qi(x2, wq, cfg, kx, plan)
        else:
            xq = BFP(x2, xe, xcfg)
            plan = _plan("qmatmul_fwd", x2.shape[0], k, n, xcfg, policy,
                         x.device, kind="pp", cfg2=wcfg)
            if plan.path == kd.JNP:
                y = _contract_q(xq, wq, 0, policy.accum_chunk)
            else:
                y = kd.contract_ii(xq, wq, plan)
        y = y.reshape(*lead, n)
        ctx.res, ctx.policy, ctx.out_q = (xq, wq, kb, lead), policy, out_q
        ctx.q_in, ctx.has_g = xcfg is not None, (xg is not None,
                                                 wg is not None)
        if not out_q:
            return y
        out = _quantize_out(y, n, policy, prng.fold_in(key, 0xD0))
        ctx.mark_non_differentiable(out[0], out[1])
        return out

    @staticmethod
    def backward(ctx, *cts):
        gy = cts[2] if ctx.out_q else cts[0]
        dx, dw = _qmatmul_bwd(ctx.policy, ctx.res, gy,
                              any(ctx.needs_input_grad[:2]))
        x_g, w_g = ctx.has_g
        return (*_carrier_grads(ctx.q_in, x_g, dx), None,
                dw if w_g else None) + (None,) * 7


def qmatmul(x, w, key: Optional[prng.Key] = None,
            policy: NumericPolicy = NumericPolicy(), *, out_q: bool = False):
    """Quantized linear contraction x (..., K) @ w (K, N) with the A.2
    integer backward.  ``x`` may be a per-tensor BFP (q-in: no activation
    quantize, kind iq; its gradient goes to the carrier) and ``out_q=True``
    returns a BFP with carrier.  ``w`` may be a per-tensor BFP (a forward
    weight derived from the int16 masters, or a load-time-quantized
    serving weight): no weight quantize runs in the op (kind qi, or pp
    against a BFP x) and dW goes to the weight's carrier.  A per-block
    weight or policy takes the weight's float32 view."""
    if not policy.enabled:
        return bfp_value(x) @ bfp_value(w)
    if key is None:
        raise ValueError("qmatmul with an enabled integer policy needs a PRNG key")
    if isinstance(x, BFP) and x.cfg.block != PER_TENSOR \
            and policy.block == PER_TENSOR:
        x = bfp_value(x)       # residuals follow the policy's blocking
    if isinstance(w, BFP) and (w.cfg.block != PER_TENSOR
                               or policy.block != PER_TENSOR):
        w = bfp_value(w)
    if isinstance(w, BFP):
        xm, xg, xe, xcfg = ((x.m, x.g, x.e, x.cfg) if isinstance(x, BFP)
                            else (x, None, None, None))
        out = _QMatmulPW.apply(xm, xg, w.m, w.g, xe, w.e, key, policy, xcfg,
                               w.cfg, out_q)
    elif isinstance(x, BFP):
        out = _QMatmulFlex.apply(x.m, x.g, w, x.e, key, policy, x.cfg, out_q)
    else:
        out = _QMatmulFlex.apply(x, None, w, None, key, policy, None, out_q)
    if not out_q:
        return out
    m, e, g = out
    return BFP(m, e, _cfg_for_dim(policy.fwd_cfg(), w.shape[-1]), g)


# ---------------------------------------------------------------------------
# qconv: 2-D convolution as im2col + qmatmul; qrelu
# ---------------------------------------------------------------------------

def _conv_geometry(h: int, w: int, kh: int, kw: int, stride, padding: str):
    """(Ho, Wo, (top, bottom), (left, right)) of an NHWC convolution,
    XLA's SAME (the odd pad after) or VALID."""
    sh, sw = stride
    if padding == "SAME":
        ho, wo = -(-h // sh), -(-w // sw)
        ph = max((ho - 1) * sh + kh - h, 0)
        pw = max((wo - 1) * sw + kw - w, 0)
        return ho, wo, (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
    if padding == "VALID":
        return (h - kh) // sh + 1, (w - kw) // sw + 1, (0, 0), (0, 0)
    raise ValueError(f"unsupported padding {padding!r}")


def _int_patches(m: torch.Tensor, kh: int, kw: int, stride,
                 padding: str) -> torch.Tensor:
    """im2col (N, H, W, C) -> (N, Ho, Wo, C*kh*kw) in the reference's
    (cin, kh, kw) feature order: zero padding and strided slices, pure data
    movement (int8 mantissas or float32 values alike)."""
    n, h, w, c = m.shape
    sh, sw = stride
    ho, wo, ph, pw = _conv_geometry(h, w, kh, kw, stride, padding)
    mp = torch.nn.functional.pad(m, (0, 0, *pw, *ph))
    cols = [mp[:, dy:dy + (ho - 1) * sh + 1:sh, dx:dx + (wo - 1) * sw + 1:sw]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(cols, dim=-1).reshape(n, ho, wo, c * kh * kw)


def _fold_patches(g: torch.Tensor, shape, kh: int, kw: int, stride,
                  padding: str) -> torch.Tensor:
    """The gradient of ``_int_patches``: each patch gradient added back
    into its input element, the taps in descending (dy, dx) order from
    zero, the order of XLA's transposed patch convolution (so an element's
    sum of up to kh*kw taps is the reference's, bit for bit)."""
    n, h, w, c = shape
    sh, sw = stride
    ho, wo, ph, pw = _conv_geometry(h, w, kh, kw, stride, padding)
    g5 = g.reshape(n, ho, wo, c, kh * kw)
    acc = torch.zeros((n, h + sum(ph), w + sum(pw), c), dtype=g.dtype,
                      device=g.device)
    for t in reversed(range(kh * kw)):
        dy, dx = divmod(t, kw)
        acc[:, dy:dy + (ho - 1) * sh + 1:sh,
            dx:dx + (wo - 1) * sw + 1:sw] += g5[..., t]
    return acc[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w]


class _Patches(torch.autograd.Function):
    """Float32 im2col with the reference's fold-back as its gradient."""

    @staticmethod
    def forward(ctx, x, kh, kw, stride, padding):
        ctx.args = (x.shape, kh, kw, stride, padding)
        return _int_patches(x, kh, kw, stride, padding)

    @staticmethod
    def backward(ctx, g):
        return (_fold_patches(g, *ctx.args),) + (None,) * 4


def _filter_rows(w: torch.Tensor) -> torch.Tensor:
    """HWIO filter (kh, kw, cin, cout) -> the (cin*kh*kw, cout) GEMM
    operand in the patches' feature order, stored K-innermost (its
    transpose is the contiguous (N, K) operand of the kernels)."""
    kh, kw, cin, cout = w.shape
    return w.permute(3, 2, 0, 1).reshape(cout, cin * kh * kw).t()


def _conv_float(x: torch.Tensor, w: torch.Tensor, stride,
                padding: str) -> torch.Tensor:
    """The float policy's convolution (NHWC x HWIO, XLA's padding)."""
    _, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    _, _, ph, pw = _conv_geometry(h, wd, kh, kw, stride, padding)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2), (*pw, *ph))
    y = torch.nn.functional.conv2d(xp, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def qconv(x, w, key: Optional[prng.Key] = None,
          policy: NumericPolicy = NumericPolicy(), *, stride=(1, 1),
          padding: str = "SAME", out_q: bool = False):
    """2-D convolution NHWC x HWIO -> NHWC as an integer GEMM: im2col
    patches (data movement: the forward's slices and the backward's
    fold-back) contracted with the reshuffled filter by ``qmatmul``, so
    every multiply of the forward and the backward is inside it.

    ``x`` may be a per-tensor BFP (q-in: the patches are sliced from its
    int8 mantissas, its carrier's patches take the gradient) and
    ``out_q=True`` returns a BFP (q-out).  ``w`` may be a per-tensor BFP
    filter (the reshuffle moves mantissas; its carrier takes dW).  A
    per-block operand takes its float32 view; the float policy convolves
    in float32."""
    kh, kw, cin, cout = w.shape
    stride = tuple(stride)
    if not policy.enabled:
        return _conv_float(bfp_value(x), bfp_value(w), stride, padding)
    if isinstance(w, BFP) and w.cfg.block != PER_TENSOR:
        w = bfp_value(w)
    if isinstance(x, BFP) and x.cfg.block != PER_TENSOR:
        x = bfp_value(x)
    if isinstance(x, BFP):
        pg = None if x.g is None else _Patches.apply(x.g, kh, kw, stride,
                                                      padding)
        patches = BFP(_int_patches(x.m, kh, kw, stride, padding), x.e,
                      x.cfg, pg)
    else:
        patches = _Patches.apply(x, kh, kw, stride, padding)
    if isinstance(w, BFP):
        w2 = BFP(_filter_rows(w.m), w.e, w.cfg,
                 None if w.g is None else _filter_rows(w.g))
    else:
        w2 = _filter_rows(w)
    return qmatmul(patches, w2, key, policy, out_q=out_q)


def qrelu(x):
    """ReLU on ``f32 | BFP``, exact on mantissas (the shared scale is
    positive): a BFP stays a BFP, its carrier's gradient masked where the
    mantissa is not positive."""
    if isinstance(x, BFP):
        g = None if x.g is None else torch.relu(x.g)
        return BFP(torch.clamp(x.m, min=0), x.e, x.cfg, g)
    return torch.relu(x)


# ---------------------------------------------------------------------------
# qbmm: a (*B, M, K) @ b (*B, K, N)
# ---------------------------------------------------------------------------

def _qbmm_fwd(a: torch.Tensor, b: torch.Tensor, key: prng.Key,
              policy: NumericPolicy):
    """-> (y, residuals (aq, bq, kres))."""
    cfg = _cfg_for_dim(policy.fwd_cfg(), a.shape[-1])
    ka, kb_, kres = prng.split(key, 3)
    nbatch = a.ndim - 2
    plan = _plan("qbmm_fwd", a.shape[-2], a.shape[-1], b.shape[-1], cfg,
                 policy, a.device)
    if plan.path == kd.JNP:
        aq = quantize(a, cfg, ka)
        bq = quantize(_t(b), cfg, kb_)
        y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
    else:
        y, aq, bq = kd.contract_qq(a, _t(b), cfg, ka, kb_, plan,
                                   nbatch=nbatch)
    return y, (aq, bq, kres)


def _qbmm_bwd(policy: NumericPolicy, res, gy: torch.Tensor):
    """A.2 for the batched product: da = Ĝ B̂ᵀ (qi), db = Âᵀ Ĝ (ii); per
    block both kind qq on re-blocked residuals, as in ``_qmatmul_bwd``."""
    aq, bq, kres = res
    cfg_b = policy.bwd_cfg()
    kg, kg2, ka2, kb2 = prng.split(kres, 4)
    nbatch = gy.ndim - 2
    m, n = gy.shape[-2], gy.shape[-1]
    k = aq.m.shape[-1]
    if policy.block != PER_TENSOR:
        da = _requant_contract("qbmm_dx", gy, _t(dequantize(bq)),
                               _cfg_for_dim(cfg_b, n), kg, kb2, nbatch,
                               policy)
        db = _requant_contract("qbmm_dw", _t(dequantize(aq)), _t(gy),
                               _cfg_for_dim(cfg_b, m), ka2, kg2, nbatch,
                               policy)
        return da, db
    plan_da = _plan("qbmm_dx", m, n, k, cfg_b, policy, gy.device, kind="qi",
                    cfg2=bq.cfg)
    if plan_da.path == kd.JNP:
        gq = quantize(gy, cfg_b, kg)
        da = _contract_q(gq, _tq(bq), nbatch, policy.accum_chunk)
    else:
        da, gq = kd.contract_qi(gy, _tq(bq), cfg_b, kg, plan_da,
                                nbatch=nbatch)
    plan_db = _plan("qbmm_dw", k, m, n, gq.cfg, policy, gy.device, kind="ii",
                    cfg2=aq.cfg)
    if plan_db.path == kd.JNP:
        db = _contract_q(_tq(aq), _tq(gq), nbatch, policy.accum_chunk)
    else:
        db = kd.contract_ii(_tq(aq), _tq(gq), plan_db, nbatch=nbatch)
    return da, db


class _QBmm(torch.autograd.Function):
    """a (*B, M, K) @ b (*B, K, N), both quantized in the op (``_qbmm``)."""

    @staticmethod
    def forward(ctx, a, b, key, policy):
        y, ctx.res = _qbmm_fwd(a, b, key, policy)
        ctx.policy = policy
        return y

    @staticmethod
    def backward(ctx, gy):
        da, db = _qbmm_bwd(ctx.policy, ctx.res, gy)
        return da, db, None, None


class _QBmmFlex(torch.autograd.Function):
    """``_qbmm_flex``: a (*B, M, K) @ b (*B, K, N), each f32 or per-tensor
    BFP mantissas (exponent ``ae``/``be``, carrier ``ag``/``bg``): kind pp
    (both pre-quantized), iq (a) or qi (b)."""

    @staticmethod
    def forward(ctx, a, ag, b, bg, ae, be, key, policy, acfg, bcfg):
        ka, kb_, kres = prng.split(key, 3)
        nbatch = a.ndim - 2
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        if acfg is not None and bcfg is not None:
            aq, bq = BFP(a, ae, acfg), _tq(BFP(b, be, bcfg))
            plan = _plan("qbmm_fwd", m, k, n, acfg, policy, a.device,
                         kind="pp", cfg2=bcfg)
            if plan.path == kd.JNP:
                y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
            else:
                y = kd.contract_ii(aq, bq, plan, nbatch=nbatch)
        elif acfg is not None:
            aq = BFP(a, ae, acfg)
            bcfg_f = _wcfg_for(acfg, policy)
            plan = _plan("qbmm_fwd", m, k, n, bcfg_f, policy, a.device,
                         kind="iq", cfg2=acfg)
            if plan.path == kd.JNP:
                bq = quantize(_t(b), bcfg_f, kb_)
                y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
            else:
                y, bq = kd.contract_iq(aq, _t(b), bcfg_f, kb_, plan,
                                       nbatch=nbatch)
        else:
            bq = _tq(BFP(b, be, bcfg))
            acfg_f = _wcfg_for(bcfg, policy)
            plan = _plan("qbmm_fwd", m, k, n, acfg_f, policy, a.device,
                         kind="qi", cfg2=bcfg)
            if plan.path == kd.JNP:
                aq = quantize(a, acfg_f, ka)
                y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
            else:
                y, aq = kd.contract_qi(a, bq, acfg_f, ka, plan, nbatch=nbatch)
        ctx.res, ctx.policy = (aq, bq, kres), policy
        ctx.flags = (acfg is not None, ag is not None, bcfg is not None,
                     bg is not None)
        return y

    @staticmethod
    def backward(ctx, gy):
        da, db = _qbmm_bwd(ctx.policy, ctx.res, gy)
        a_q, a_g, b_q, b_g = ctx.flags
        return (*_carrier_grads(a_q, a_g, da), *_carrier_grads(b_q, b_g, db),
                None, None, None, None, None, None)


def qbmm(a, b, key: Optional[prng.Key] = None,
         policy: NumericPolicy = NumericPolicy()) -> torch.Tensor:
    """Quantized batched matmul a (*B, M, K) @ b (*B, K, N) with the A.2
    integer backward.  Either operand may be a pre-quantized BFP (q-in;
    ``b`` only with a per-tensor scale, a pair only with matching
    blockings: otherwise its float view is taken); gradients of a BFP
    operand go to its carrier."""
    if not policy.enabled:
        return bfp_value(a) @ bfp_value(b)
    if key is None:
        raise ValueError("qbmm with an enabled integer policy needs a PRNG key")
    a_q, b_q = isinstance(a, BFP), isinstance(b, BFP)
    if a_q and a.cfg.block != PER_TENSOR and policy.block == PER_TENSOR:
        a, a_q = bfp_value(a), False
    if b_q and b.cfg.block != PER_TENSOR:
        b, b_q = bfp_value(b), False
    if b_q and a_q and a.cfg.block != PER_TENSOR:
        b, b_q = bfp_value(b), False
    if not (a_q or b_q):
        return _QBmm.apply(a, b, key, policy)
    am, ag, ae, acfg = (a.m, a.g, a.e, a.cfg) if a_q else (a, None, None, None)
    bm, bg, be, bcfg = (b.m, b.g, b.e, b.cfg) if b_q else (b, None, None, None)
    return _QBmmFlex.apply(am, ag, bm, bg, ae, be, key, policy, acfg, bcfg)


# ---------------------------------------------------------------------------
# qattention: fused integer flash attention over pre-quantized Q/K/V
# ---------------------------------------------------------------------------

class _QAttn(torch.autograd.Function):
    """``_qattn``: the forward kernel saves only the operand mantissas and
    the two per-row softmax stats; the backward quantizes dO once (per
    tensor) and recomputes the probabilities in its own kernel.  dQ, dK,
    dV go to the carriers ``qg``, ``kg``, ``vg``."""

    @staticmethod
    def forward(ctx, qm, qg, km, kg, vm, vg, qe, ke, ve, q_off, kv_len, key,
                policy, s, causal, window, plan):
        lead = qm.shape[:-2]
        gs, d = qm.shape[-2], qm.shape[-1]
        t = km.shape[-2]
        cfg = policy.fwd_cfg()
        sr = cfg.stochastic
        q3, k3, v3 = (x.reshape(-1, x.shape[-2], d) for x in (qm, km, vm))
        rp = (rounding_bits(prng.fold_in(key, 0), (q3.shape[0], gs, t),
                            cfg.rng, qm.device) if sr else None)
        y3, m3, l3 = kd.attn_fwd(q3, k3, v3, rp, qe, ke, ve, q_off, kv_len,
                                 p=cfg.p, s=s, bt=plan.bt, causal=causal,
                                 window=window, stochastic=sr)
        y = y3.reshape(*lead, gs, d)
        ctx.save_for_backward(y)
        ctx.res = (q3, qe, k3, ke, v3, ve, m3, l3, prng.fold_in(key, 1))
        ctx.args = (policy, s, causal, window, q_off, kv_len, lead)
        ctx.has_g = (qg is not None, kg is not None, vg is not None)
        return y

    @staticmethod
    def backward(ctx, gy):
        q3, qe, k3, ke, v3, ve, m3, l3, kb = ctx.res
        y, = ctx.saved_tensors
        policy, s, causal, window, q_off, kv_len, lead = ctx.args
        nbh, gs, d = q3.shape
        t = k3.shape[1]
        cb = policy.bwd_cfg()
        cfg_b = QuantConfig(cb.bits, PER_TENSOR, cb.stochastic, cb.rng)
        kg, krs, krp = prng.split(kb, 3)
        gq = quantize(gy.reshape(-1, gs, d), cfg_b, kg)
        delta = fmath.sum_windows(gy * y, (-1,)).reshape(-1, gs, 1)
        plan_b = kd.plan_attention("attn_bwd", gs, t, d, cfg_b, s=s, kind="ii",
                                   kernel_mode=policy.kernel_mode,
                                   device=gy.device.type)
        sr = cfg_b.stochastic
        rs = (rounding_bits(krs, (nbh, gs, t), cfg_b.rng, gy.device)
              if sr else None)
        rp2 = (rounding_bits(krp, (nbh, gs, t), cfg_b.rng, gy.device)
               if sr else None)
        if plan_b.path == kd.FUSED:
            run = kd.attn_bwd
        elif gy.is_cuda:
            raise NotImplementedError(
                f"the fused attention backward has no kernel for this "
                f"shape or policy ({plan_b.reason}); its plain version "
                f"runs only on the CPU")
        else:
            run = kfa.attn_bwd_plain
        dq, dk, dv = run(q3, gq.m, k3, v3, m3, l3, delta, rs, rp2, qe, ke, ve,
                         gq.e, q_off, kv_len, p=cfg_b.p, s=s,
                         bt=plan_b.bt or kd.attn_block_t(t), causal=causal,
                         window=window, stochastic=sr)
        grads = [None] * 17
        for i, g, has in ((1, dq.reshape(*lead, gs, d), ctx.has_g[0]),
                          (3, dk.reshape(*lead, t, d), ctx.has_g[1]),
                          (5, dv.reshape(*lead, t, d), ctx.has_g[2])):
            grads[i] = g if has else None
        return tuple(grads)


def qattention(qb: BFP, kb: BFP, vb: BFP, q_off: int, kv_len: int,
               key: prng.Key, policy: NumericPolicy, *, s: int, causal: bool,
               window: int, plan: kd.Decision) -> torch.Tensor:
    """Fused integer flash attention over pre-quantized per-tensor BFPs:
    qb (*B, GS, D) the grouped, pre-scaled query (g-major GQA rows, group
    length ``s``), kb/vb (*B, T, D).  ``plan`` is a FUSED ``attn_fwd``
    decision of ``kernels.dispatch.plan_attention``.  Returns f32
    (*B, GS, D); dQ/dK/dV go to the operands' carriers."""
    assert qb.cfg.block == PER_TENSOR and plan.path == kd.FUSED
    return _QAttn.apply(qb.m, qb.g, kb.m, kb.g, vb.m, vb.g, qb.e, kb.e, vb.e,
                        int(q_off), int(kv_len), key, policy, s, causal,
                        window, plan)


# ---------------------------------------------------------------------------
# qembed: integer embedding gather
# ---------------------------------------------------------------------------

def _qembed_fwd(tokens: torch.Tensor, table: torch.Tensor, key: prng.Key,
                policy: NumericPolicy):
    cfg = _cfg_for_dim(policy.fwd_cfg(), table.shape[-1])
    kt, kb = prng.split(key)
    tq = quantize_weight(table, cfg, kt)
    rows = tq.m[tokens]
    scale = pow2(scale_exponent(tq.e, cfg))
    if cfg.block == PER_TENSOR:
        y = rows.to(torch.float32) * scale
    else:
        erows = scale[tokens]
        y = (rows.reshape(*rows.shape[:-1], -1, cfg.block).to(torch.float32)
             * erows[..., None]).reshape(rows.shape)
    return y, kb


def _scatter_rows_in_order(g: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """(n, D) float sums of the rows of ``g`` (T, D) by ``idx`` (T,), each
    row 0 + g[i0] + g[i1] + ... over its indices in ascending i (the
    reference's scatter order), on any device: round r adds the r-th
    occurrence of every index, so no round writes a row twice and no
    atomics decide the order.  One host read (the rounds' count)."""
    idx = idx.long()
    order = torch.sort(idx, stable=True).indices
    sidx = idx[order]
    pos = torch.arange(idx.numel(), device=idx.device)
    start = torch.ones_like(sidx, dtype=torch.bool)
    start[1:] = sidx[1:] != sidx[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    out = torch.zeros((n, g.shape[-1]), dtype=g.dtype, device=g.device)
    for r in range(int(rank.max()) + 1 if idx.numel() else 0):
        pick = order[rank == r]
        rows = idx[pick]
        out[rows] = out[rows] + g[pick]
    return out


def _qembed_bwd(policy: NumericPolicy, tokens: torch.Tensor, vocab: int,
                kb: prng.Key, gy: torch.Tensor) -> torch.Tensor:
    """dTable: the upstream gradient quantized once per tensor, its int8
    mantissas scatter-added into int32 rows, one rescale.  Under per-block
    scales the rows' scales differ, so the float gradient is scattered."""
    g2 = gy.reshape(-1, gy.shape[-1])
    if policy.block != PER_TENSOR:
        return _scatter_rows_in_order(g2, tokens.reshape(-1), vocab)
    cfg_b = policy.bwd_cfg()
    gq = quantize(g2, QuantConfig(cfg_b.bits, PER_TENSOR, cfg_b.stochastic,
                                  cfg_b.rng), kb)
    acc = torch.zeros((vocab, g2.shape[-1]), dtype=torch.int32,
                      device=g2.device)
    acc.index_add_(0, tokens.reshape(-1).long(), gq.m.to(torch.int32))
    return acc.to(torch.float32) * pow2(scale_exponent(gq.e, gq.cfg))


class _QEmbed(torch.autograd.Function):
    """Integer gather forward, integer scatter-add backward (``_qembed``)."""

    @staticmethod
    def forward(ctx, tokens, table, key, policy):
        y, kb = _qembed_fwd(tokens, table, key, policy)
        ctx.res = (tokens, table.shape[0], kb)
        ctx.policy = policy
        return y

    @staticmethod
    def backward(ctx, gy):
        tokens, vocab, kb = ctx.res
        return None, _qembed_bwd(ctx.policy, tokens, vocab, kb, gy), None, None


class _QEmbedP(torch.autograd.Function):
    """``_qembed_p``, a per-tensor BFP table (mantissas ``tm``, exponent
    ``te``, carrier ``tg``): the gather is int8 data movement and nothing
    is quantized; ``out_q`` returns the rows as (m, e, carrier) on the
    table's scale.  dTable, the integer scatter-add of ``_qembed_bwd`` with
    the unsplit key, goes to the carrier."""

    @staticmethod
    def forward(ctx, tokens, tm, tg, te, key, policy, tcfg, out_q):
        rows = tm[tokens]
        ctx.res = (tokens, tm.shape[0], key)
        ctx.policy, ctx.out_q = policy, out_q
        if not out_q:
            return rows.to(torch.float32) * pow2(scale_exponent(te, tcfg))
        e = te.clone()
        ctx.mark_non_differentiable(rows, e)
        return rows, e, dequantize(BFP(rows, e, tcfg))

    @staticmethod
    def backward(ctx, *cts):
        gy = cts[2] if ctx.out_q else cts[0]
        tokens, vocab, key = ctx.res
        dtable = _qembed_bwd(ctx.policy, tokens, vocab, key, gy)
        return (None, None, dtable) + (None,) * 5


class _QEmbedQ(torch.autograd.Function):
    """``_qembed_q``, the q-out embedding of a float32 table: the table is
    quantized (``quantize_weight``, the first split of ``key``), and the
    gathered int8 rows with their exponents (the table's per-tensor one, or
    each row's per-block ones) are the quantized activation, returned as
    (m, e, carrier).  dTable is ``_qembed_bwd`` of the carrier's
    cotangent with the second split."""

    @staticmethod
    def forward(ctx, tokens, table, key, policy):
        cfg = _cfg_for_dim(policy.fwd_cfg(), table.shape[-1])
        kt, kb = prng.split(key)
        tq = quantize_weight(table.detach(), cfg, kt)
        rows = tq.m[tokens]
        e = tq.e if cfg.block == PER_TENSOR else tq.e[tokens]
        ctx.res = (tokens, table.shape[0], kb)
        ctx.policy = policy
        ctx.mark_non_differentiable(rows, e)
        return rows, e, dequantize(BFP(rows, e, cfg))

    @staticmethod
    def backward(ctx, *cts):
        tokens, vocab, kb = ctx.res
        return (None, _qembed_bwd(ctx.policy, tokens, vocab, kb, cts[2]),
                None, None)


def qembed(tokens: torch.Tensor, table, key: Optional[prng.Key] = None,
           policy: NumericPolicy = NumericPolicy(), *, out_q: bool = False):
    """Integer embedding lookup: an int8 row gather scaled by 2^E, with the
    int32 scatter-add backward.  A per-tensor BFP table (a forward weight
    narrowed from the masters, or a load-time-quantized serving table) is
    gathered as it is and its carrier takes dTable; ``out_q=True`` then
    returns the rows as a BFP on the table's scale, and for a float32
    table the rows of its one quantization (``_QEmbedQ``)."""
    if not (policy.enabled and policy.quantize_embed):
        return bfp_value(table)[tokens]
    if key is None:
        raise ValueError("qembed with an enabled integer policy needs a PRNG key")
    if isinstance(table, BFP) and table.cfg.block != PER_TENSOR:
        table = bfp_value(table)       # per-block rows don't survive the gather
    if isinstance(table, BFP):
        out = _QEmbedP.apply(tokens, table.m, table.g, table.e, key, policy,
                             table.cfg, out_q)
        if not out_q:
            return out
        rows, e, g = out
        return BFP(rows, e, table.cfg, g)
    if out_q:
        rows, e, g = _QEmbedQ.apply(tokens, table, key, policy)
        return BFP(rows, e, _cfg_for_dim(policy.fwd_cfg(), table.shape[-1]),
                   g)
    return _QEmbed.apply(tokens, table, key, policy)


class _QdqST(torch.autograd.Function):
    """Stochastic quantize-dequantize, straight-through gradient."""

    @staticmethod
    def forward(ctx, x, key, cfg):
        return dequantize(quantize(x, cfg, key))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def qdq_st(x: torch.Tensor, key: prng.Key, cfg: QuantConfig) -> torch.Tensor:
    """Stochastic quantize-dequantize with a straight-through gradient: the
    values land on the int8 grid, so later per-tensor requantizations at
    the same scale are exact under nearest rounding."""
    return _QdqST.apply(x, key, cfg)


# ---------------------------------------------------------------------------
# qcache: quantized KV caches, one exponent per row, nearest rounding
# ---------------------------------------------------------------------------

def qcache_quantize(x: torch.Tensor, policy: NumericPolicy,
                    cfg: Optional[QuantConfig] = None) -> BFP:
    cfg = cfg or policy.cache_cfg(x.shape[-1])
    return quantize_cache(x, cfg)


def qcache_prefill(x: torch.Tensor, pad: int, policy: NumericPolicy) -> BFP:
    """Quantize prefill rows once and pad the time axis (-2) to the cache
    length with the qcache zero (mantissa 0, exponent 1)."""
    q = qcache_quantize(x, policy)
    if pad:
        m = torch.nn.functional.pad(q.m, (0, 0, 0, pad))
        e = torch.nn.functional.pad(q.e, (0, 0, 0, pad), value=1)
        return BFP(m, e, q.cfg)
    return q


def qcache_append(cache: BFP, x: torch.Tensor, pos: int, axis: int) -> BFP:
    """Quantize a fresh row block and write it at ``pos`` along ``axis``.
    The cache is updated in place (it is never read at the old value)."""
    row = quantize_cache(x, cache.cfg)
    n = row.m.shape[axis]
    pos = max(0, min(int(pos), cache.m.shape[axis] - n))
    cache.m.narrow(axis, pos, n).copy_(row.m)
    cache.e.narrow(axis, pos, n).copy_(row.e)
    return cache


def _unit_view(m: torch.Tensor, bits: int, rng: str) -> BFP:
    """Per-tensor view of raw mantissas under a unit reference scale."""
    ucfg = QuantConfig(bits, PER_TENSOR, False, rng)
    e = torch.tensor(biased_exponent(0, ucfg), dtype=torch.int32,
                     device=m.device)
    return BFP(m, e, ucfg)


def _row_scales(q: BFP) -> torch.Tensor:
    """(*B, 1, T) float scale of each cache row."""
    return pow2(scale_exponent(q.e, q.cfg)).transpose(-1, -2)


def qcache_qk(a, kq: BFP, key: Optional[prng.Key],
              policy: NumericPolicy) -> torch.Tensor:
    """Decode scores a (*B, M, D) f32, or a per-tensor BFP quantized
    upstream (qflow: kind pp, nothing quantized here), against cache
    mantissas (*B, T, D) with the row exponents applied per output column
    -> (*B, M, T)."""
    nbatch = kq.m.ndim - 2
    t, d = kq.m.shape[-2], kq.m.shape[-1]
    bq = _unit_view(kq.m, kq.cfg.bits, kq.cfg.rng)
    if isinstance(a, BFP) and a.cfg.block != PER_TENSOR:
        a = bfp_value(a)
    if isinstance(a, BFP):
        aq = BFP(a.m, a.e, a.cfg)
        plan = _plan("qdecode_qk", aq.m.shape[-2], d, t, aq.cfg, policy,
                     aq.m.device, kind="pp", cfg2=bq.cfg)
        if plan.path == kd.JNP:
            y = _contract_q(aq, bq, nbatch, policy.accum_chunk)
        else:
            y = kd.contract_ii(aq, bq, plan, nbatch=nbatch)
        return y * _row_scales(kq)
    cfg = policy.fwd_cfg()
    plan = _plan("qdecode_qk", a.shape[-2], d, t, cfg, policy, a.device,
                 kind="qi", cfg2=bq.cfg)
    if plan.path == kd.JNP:
        y = _contract_q(quantize(a, cfg, key), bq, nbatch, policy.accum_chunk)
    else:
        y, _ = kd.contract_qi(a, bq, cfg, key, plan, nbatch=nbatch)
    return y * _row_scales(kq)


def qcache_pv(p: torch.Tensor, vq: BFP, key: Optional[prng.Key],
              policy: NumericPolicy) -> torch.Tensor:
    """Decode mix p (*B, M, T) against cache mantissas (*B, T, D): the row
    exponents fold into p before its single quantization -> (*B, M, D)."""
    nbatch = vq.m.ndim - 2
    t, d = vq.m.shape[-2], vq.m.shape[-1]
    p2 = p * _row_scales(vq)
    bq = _unit_view(_t(vq.m), vq.cfg.bits, vq.cfg.rng)
    cfg = policy.fwd_cfg()
    plan = _plan("qdecode_pv", p.shape[-2], t, d, cfg, policy, p.device,
                 kind="qi", cfg2=bq.cfg)
    if plan.path == kd.JNP:
        return _contract_q(quantize(p2, cfg, key), bq, nbatch,
                           policy.accum_chunk)
    y, _ = kd.contract_qi(p2, bq, cfg, key, plan, nbatch=nbatch)
    return y


def qcache_attention(q: torch.Tensor, kq: BFP, vq: BFP, q_off: int,
                     kv_len: int, key: Optional[prng.Key],
                     policy: NumericPolicy, *, s: int, causal: bool,
                     window: int) -> torch.Tensor:
    """Fused decode attention straight off the int8 cache rows (a FUSED
    ``attn_decode`` plan): q (*B, GS, D) f32 is quantized per tensor once
    here, or arrives as a per-tensor BFP (qflow); p is quantized inside
    the kernel."""
    lead = kq.m.shape[:-2]
    t, d = kq.m.shape[-2], kq.m.shape[-1]
    if isinstance(q, BFP):
        qq = q
    else:
        cfg_q = QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                            policy.rng)
        qq = quantize(q, cfg_q, None if key is None else prng.fold_in(key, 0))
    gs = qq.m.shape[-2]
    q3 = qq.m.reshape(-1, gs, d)
    sr = policy.stochastic and key is not None
    rp = (rounding_bits(prng.fold_in(key, 1), (q3.shape[0], gs, t),
                        policy.rng, q3.device) if sr else None)
    y3 = kd.attn_decode(
        q3, kq.m.reshape(-1, t, d), vq.m.reshape(-1, t, d),
        kq.e.reshape(-1, t, 1), vq.e.reshape(-1, t, 1), rp, qq.e, q_off,
        kv_len, p=policy.fwd_bits - 1, s=s, causal=causal, window=window,
        stochastic=sr)
    return y3.reshape(*lead, gs, d)
