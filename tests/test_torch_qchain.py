"""The port's cross-op chains (``core/qchain.py``) against ``jax.vjp`` of
the JAX package's ``qnorm_gemm`` and ``qmatmul_epi`` under
``kernel_mode="fused"`` (the kernels' plain versions here, the Pallas
kernels in interpret mode there): values and every gradient ``==`` for the
same numpy inputs, keys and cotangent.  ``qdecode_block`` (gradient free)
against the JAX op on the same weights and quantized cache: ``x_out`` and
the cache rows it appends ``==``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qchain as jqc
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import QuantConfig as JQ
from repro.core.policy import NumericPolicy as JaxPolicy
from repro_torch.core import prng
from repro_torch.core import qchain as tqc
from repro_torch.core.bfp import BFP, QuantConfig
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd

JP = JaxPolicy(kernel_mode="fused")
TP = NumericPolicy(kernel_mode="fused")


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax_vjp(fn, args, ct):
    def run(args, ct):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(ct)
    y, grads = jax.jit(run)(tuple(jnp.asarray(a) for a in args),
                            jnp.asarray(ct))
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port_vjp(fn, args, ct):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = fn(*ts)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(ct))
    return y.detach().numpy(), [g.numpy() for g in grads]


def _check(jfn, tfn, args, ct):
    jy, jg = _jax_vjp(jfn, args, ct)
    ty, tg = _port_vjp(tfn, args, ct)
    np.testing.assert_array_equal(ty, jy)
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t, j)


# (lead, K, N, rms, beta, stochastic): RMS and LayerNorm, a width off the
# lanes, nearest rounding; rows below 16 and above 32 (see the next test)
NORM_CASES = [((2, 7), 64, 96, True, False, True),
              ((3, 16), 100, 45, False, True, True),
              ((3, 5), 72, 40, False, False, False)]


def _norm_case(case):
    lead, k, n, rms, beta, sr = case
    rng = np.random.RandomState(k)
    x = _f32(rng, *lead, k, scale=2.0)
    gamma = (1.0 + 0.1 * rng.randn(k)).astype(np.float32)
    w = _f32(rng, k, n, scale=0.2)
    ct = _f32(rng, *lead, n)
    args = (x, gamma, w) + ((0.1 * rng.randn(k)).astype(np.float32),
                            ) * beta
    jp = dataclasses.replace(JP, stochastic=sr)
    tp = dataclasses.replace(TP, stochastic=sr)

    def jfn(x, g, w, *b):
        return jqc.qnorm_gemm(x, g, b[0] if b else None, w,
                              jax.random.key(3), jp, rms=rms)

    def tfn(x, g, w, *b):
        return tqc.qnorm_gemm(x, g, b[0] if b else None, w, prng.key(3), tp,
                              rms=rms)

    return jfn, tfn, args, ct


@pytest.mark.parametrize("case", NORM_CASES)
def test_qnorm_gemm_values_and_grads_equal_jax(case):
    jfn, tfn, args, ct = _norm_case(case)
    with kd.record_decisions() as log:
        _check(jfn, tfn, args, ct)
    paths = {(d.op, d.kind): d.path for d in log}
    assert paths == {("qnorm_gemm", "norm_gemm"): kd.FUSED,
                     ("qnorm_gemm_dx", "qi"): kd.FUSED,
                     ("qnorm_gemm_dw", "ii"): kd.FUSED}


@pytest.mark.parametrize("case", [((19,), 100, 45, False, True, True),
                                  ((2, 8), 64, 30, True, False, True),
                                  ((17,), 64, 30, True, False, False),
                                  ((18,), 72, 40, False, False, True),
                                  ((3, 8), 100, 45, False, True, True),
                                  ((32,), 64, 30, True, False, True)])
def test_qnorm_gemm_gain_grad_from_16_to_32_rows(case):
    """XLA's CPU build sums dgamma's column of products over 16 to 32 rows
    in the row loop LLVM vectorizes (``core.fmath.sum_products_cols``:
    8 lanes with one or two accumulators, a 2-lane epilogue at 18 and 19
    rows, fused multiply-adds); every output ``==``, dgamma included."""
    jfn, tfn, args, ct = _norm_case(case)
    jy, jg = _jax_vjp(jfn, args, ct)
    ty, tg = _port_vjp(tfn, args, ct)
    np.testing.assert_array_equal(ty, jy)
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t, j)


# (lead, K, N, act, bias); the reference plans a GLU only with halves of
# whole TPU lanes (N % 256 == 0)
EPI_CASES = [((2, 6), 40, 256, "silu_glu", True),
             ((3, 5), 72, 256, "gelu_glu", True),
             ((13,), 37, 30, "relu", False),
             ((3, 4), 24, 18, None, True)]


@pytest.mark.parametrize("case", EPI_CASES)
def test_qmatmul_epi_values_and_grads_equal_jax(case):
    lead, k, n, act, bias = case
    rng = np.random.RandomState(n)
    x = _f32(rng, *lead, k)
    w = _f32(rng, k, n, scale=0.3)
    if act == "relu":
        x[0, :] = 0.0          # a row of exact zeros: relu's tie at 0
    n_out = n // 2 if (act or "").endswith("_glu") else n
    ct = _f32(rng, *lead, n_out)
    args = (x, w) + (_f32(rng, n),) * bias

    def jfn(x, w, *b):
        return jqc.qmatmul_epi(x, w, jax.random.key(4), JP,
                               bias=b[0] if b else None, act=act)

    def tfn(x, w, *b):
        return tqc.qmatmul_epi(x, w, prng.key(4), TP,
                               bias=b[0] if b else None, act=act)

    with kd.record_decisions() as log:
        _check(jfn, tfn, args, ct)
    paths = {(d.op, d.kind): d.path for d in log}
    assert paths == {("qmatmul_epi", "qq_epi"): kd.FUSED,
                     ("qmatmul_epi_dx", "qi"): kd.FUSED,
                     ("qmatmul_epi_dw", "ii"): kd.FUSED}


def test_chains_plan_the_per_op_seam_off_the_kernels():
    """auto on the CPU keeps the per-op seams (None); every epilogue kind
    and the out-quantize have a kernel, on the card too; norm_gemm's
    tensor-core variant takes a K whose strip the __dp4a kernel could not
    hold; the decode block kernel refuses a batch of 16."""
    x, w = torch.zeros(4, 32), torch.zeros(32, 64)
    auto = NumericPolicy()
    assert tqc.qmatmul_epi(x, w, prng.key(0), auto, act="silu_glu") is None
    assert tqc.qnorm_gemm(x, torch.ones(32), None, w, prng.key(0),
                          auto) is None
    cfg = QuantConfig()
    d = kd.plan_epilogue("e", 4, 32, 64, cfg, kind="qi", kernel_mode="fused")
    assert d.path == kd.FUSED and "qi" in d.reason
    d = kd.plan_epilogue("e", 4, 32, 64, cfg, out_q=True,
                         kernel_mode="fused", device="cuda")
    assert d.path == kd.FUSED and "out_q=True" in d.reason
    d = kd.plan_norm_gemm("n", 4, 40000, 64, cfg, kernel_mode="fused",
                          device="cuda")
    assert d.path == kd.FUSED and "wgmma" in d.reason
    d = kd.plan_decode_block("b", 16, 64, 160, 16, 8, 8, 8, cfg,
                             kernel_mode="fused", device="cuda")
    assert d.path == kd.JNP and "batch 16" in d.reason


@pytest.mark.parametrize("qweights", [False, True])
def test_qdecode_block_equals_jax(qweights):
    """One layer, B = 2, GQA groups of 2, a window, pos mid-cache; f32
    weights (quantized to nearest inside the op) or per-tensor BFP
    weights (the serving currency)."""
    b, d, n_ff, hq, hkv, dh, t, pos, window = 2, 64, 96, 8, 4, 8, 24, 13, 6
    rng = np.random.RandomState(11)
    x = _f32(rng, b, d)
    g1 = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    g2 = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    shapes = [(d, hq * dh), (d, hkv * dh), (d, hkv * dh), (hq * dh, d),
              (d, n_ff), (d, n_ff), (n_ff, d)]
    ws = [_f32(rng, *s, scale=0.2) for s in shapes]
    km = rng.randint(-127, 128, (b, hkv, t, dh)).astype(np.int8)
    vm = rng.randint(-127, 128, (b, hkv, t, dh)).astype(np.int8)
    ke = rng.randint(118, 126, (b, hkv, t, 1)).astype(np.int32)
    ve = rng.randint(118, 126, (b, hkv, t, 1)).astype(np.int32)
    ang = rng.rand(dh // 2).astype(np.float32)
    cossin = np.concatenate([np.cos(ang), np.cos(ang), np.sin(ang),
                             np.sin(ang)])[None].astype(np.float32)
    ccfg = (8, dh, False, "threefry")
    if qweights:
        wms = [rng.randint(-127, 128, s).astype(np.int8) for s in shapes]
        wes = [np.int32(115 + i) for i in range(len(shapes))]
        jws = [JBFP(jnp.asarray(m), jnp.asarray(e), JQ()) for m, e in
               zip(wms, wes)]
        tws = [BFP(torch.from_numpy(np.ascontiguousarray(m.T)).t(),
                   torch.tensor(int(e), dtype=torch.int32), QuantConfig())
               for m, e in zip(wms, wes)]
    else:
        jws = [jnp.asarray(w) for w in ws]
        tws = [torch.from_numpy(w) for w in ws]
    jout = jqc.qdecode_block(
        jnp.asarray(x), jnp.asarray(g1), jnp.asarray(g2), *jws,
        JBFP(jnp.asarray(km), jnp.asarray(ke), JQ(*ccfg)),
        JBFP(jnp.asarray(vm), jnp.asarray(ve), JQ(*ccfg)),
        jnp.asarray(cossin), jnp.int32(pos), jax.random.key(5), JP, hq=hq,
        hkv=hkv, dh=dh, window=window)
    kc = BFP(torch.from_numpy(km.copy()), torch.from_numpy(ke.copy()),
             QuantConfig(*ccfg))
    vc = BFP(torch.from_numpy(vm.copy()), torch.from_numpy(ve.copy()),
             QuantConfig(*ccfg))
    with kd.record_decisions() as log:
        tout = tqc.qdecode_block(
            torch.from_numpy(x), torch.from_numpy(g1), torch.from_numpy(g2),
            *tws, kc, vc, torch.from_numpy(cossin), pos, prng.key(5), TP,
            hq=hq, hkv=hkv, dh=dh, window=window)
    assert [(e.op, e.path) for e in log] == [("qdecode_block", kd.FUSED)]
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for tc, jc in zip(tout[1:], jout[1:]):
        np.testing.assert_array_equal(tc.m.numpy(), np.asarray(jc.m))
        np.testing.assert_array_equal(tc.e.numpy(), np.asarray(jc.e))
