"""The qq / qi / ii kernels' plain versions and dispatch.contract_qq/qi/ii
against the JAX package's fused_qq_pt_pallas / fused_qi_pt_pallas /
fused_ii_pt_pallas run in interpret mode (through repro.kernels.dispatch, which pads to the TPU
tiling): y, mantissas and exponents ``==`` at prime, non-padded shapes
and with a leading batch.  The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_kernels_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.kernels import dispatch as jd
from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.core.bfp import BFP, QuantConfig
from repro_torch.core.bfp import quantize as tquantize
from repro_torch.kernels import bfp_quant as kbq
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import int8_matmul as kim
from repro_torch.kernels import ref


def _jdec(op, m, k, n):
    return jd.Decision(op, jd.FUSED, "test", m, k, n, 32, interpret=True)


def _tdec(op, m, k, n, kind="qq"):
    return kd.Decision(op, kd.FUSED, "test", m, k, n, kind)


def _f32(rng, *shape):
    return (rng.randn(*shape) * 2.0).astype(np.float32)


# (lead batch, M, K, N): prime and non-padded shapes, with and without batch
SHAPES = [((), 37, 67, 29), ((3,), 13, 41, 17), ((2, 2), 7, 64, 5)]


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("lead,m,k,n", SHAPES)
def test_contract_qq_equal_jax_interpret(lead, m, k, n, stochastic):
    rng = np.random.RandomState(m + k)
    a, b = _f32(rng, *lead, m, k), _f32(rng, *lead, n, k)
    cfg_j, cfg_t = JQ(8, 0, stochastic), QuantConfig(8, 0, stochastic)
    nb = len(lead)
    yj, aj, bj = jd.contract_qq(jnp.asarray(a), jnp.asarray(b), cfg_j,
                                jax.random.key(1), jax.random.key(2),
                                _jdec("qbmm_fwd", m, k, n), nbatch=nb)
    yt, at, bt = kd.contract_qq(torch.from_numpy(a), torch.from_numpy(b),
                                cfg_t, prng.key(1), prng.key(2),
                                _tdec("qbmm_fwd", m, k, n), nbatch=nb)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    # the variant without residuals returns the same y and no mantissas
    yn, an, bn = kd.contract_qq(torch.from_numpy(a), torch.from_numpy(b),
                                cfg_t, prng.key(1), prng.key(2),
                                _tdec("qbmm_fwd", m, k, n), nbatch=nb,
                                want_residuals=False)
    assert torch.equal(yn, yt) and an is None and bn is None
    np.testing.assert_array_equal(at.m.numpy(), np.asarray(aj.m))
    np.testing.assert_array_equal(bt.m.numpy(), np.asarray(bj.m))
    assert int(at.e) == int(aj.e) and int(bt.e) == int(bj.e)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("lead,m,k,n", SHAPES)
def test_contract_qi_equal_jax_interpret(lead, m, k, n, stochastic):
    rng = np.random.RandomState(m * k)
    a = _f32(rng, *lead, m, k)
    bm = rng.randint(-127, 128, (*lead, n, k)).astype(np.int8)
    cfg_j, cfg_t = JQ(8, 0, stochastic), QuantConfig(8, 0, stochastic)
    from repro.core.bfp import BFP as JBFP
    bq_j = JBFP(jnp.asarray(bm), jnp.int32(131), JQ(8, 0, False))
    bq_t = BFP(torch.from_numpy(bm), torch.tensor(131, dtype=torch.int32),
               QuantConfig(8, 0, False))
    yj, aj = jd.contract_qi(jnp.asarray(a), bq_j, cfg_j, jax.random.key(4),
                            _jdec("qmatmul_fwd", m, k, n), nbatch=len(lead))
    yt, at = kd.contract_qi(torch.from_numpy(a), bq_t, cfg_t, prng.key(4),
                            _tdec("qmatmul_fwd", m, k, n, "qi"),
                            nbatch=len(lead))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(at.m.numpy(), np.asarray(aj.m))
    assert int(at.e) == int(aj.e)


@pytest.mark.parametrize("lead,m,k,n", [((), 37, 67, 29), ((3,), 13, 41, 17),
                                        ((), 5, 130, 300)])
def test_contract_ii_equal_jax_interpret(lead, m, k, n):
    rng = np.random.RandomState(m + n)
    am = rng.randint(-127, 128, (*lead, m, k)).astype(np.int8)
    bm = rng.randint(-127, 128, (*lead, n, k)).astype(np.int8)
    from repro.core.bfp import BFP as JBFP
    cfg_j, cfg_t = JQ(8, 0, True), QuantConfig(8, 0, True)
    yj = jd.contract_ii(JBFP(jnp.asarray(am), jnp.int32(124), cfg_j),
                        JBFP(jnp.asarray(bm), jnp.int32(117), cfg_j),
                        _jdec("qmatmul_dw", m, k, n), nbatch=len(lead))
    aq = BFP(torch.from_numpy(am), torch.tensor(124, dtype=torch.int32), cfg_t)
    bq = BFP(torch.from_numpy(bm), torch.tensor(117, dtype=torch.int32), cfg_t)
    yt = kd.contract_ii(aq, bq, _tdec("qmatmul_dw", m, k, n, "ii"),
                        nbatch=len(lead))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    # transposed residual views (the backward's X̂ᵀ, Ĝᵀ) give the same y
    yv = kd.contract_ii(BFP(aq.m.transpose(-1, -2).contiguous()
                            .transpose(-1, -2), aq.e, cfg_t), bq,
                        _tdec("qmatmul_dw", m, k, n, "ii"), nbatch=len(lead))
    assert torch.equal(yv, yt)
    if not lead:
        yp = kfl.fused_ii_pt_plain(aq.m[None], bq.m[None], aq.e, bq.e)[0]
        assert torch.equal(yp, yt)
        assert torch.equal(yp, kd._jnp_matmul(aq.m, bq.m, aq.e, bq.e, 7, 7))


def test_plain_versions_equal_quantize_then_matmul():
    """The plain kernels = core.bfp.quantize + the exact integer GEMM."""
    rng = np.random.RandomState(3)
    a, b = torch.from_numpy(_f32(rng, 2, 9, 33)), torch.from_numpy(_f32(rng, 2, 6, 33))
    cfg = QuantConfig()
    ra, rb = prng.bits(prng.key(1), a.shape), prng.bits(prng.key(2), b.shape)
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    y, am, bm = kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb)
    aq, bq = tquantize(a, cfg, prng.key(1)), tquantize(b, cfg, prng.key(2))
    assert torch.equal(am, aq.m) and torch.equal(bm, bq.m)
    assert torch.equal(y, kd._jnp_matmul(aq.m, bq.m, aq.e, bq.e, 7, 7))
    y2, am2 = kfl.fused_qi_pt_plain(a, ra, bm, ea, eb)
    assert torch.equal(y2, y) and torch.equal(am2, am)
    want = np.asarray(jquantize(jnp.asarray(a.numpy()), JQ(),
                                jax.random.key(1)).m)
    np.testing.assert_array_equal(am.numpy(), want)


@pytest.mark.parametrize("per_row", [False, True])
def test_ref_oracles_equal_jax(per_row):
    rng = np.random.RandomState(5)
    x = _f32(rng, 11, 23)
    x[0, :4] = 0.0
    rand = np.asarray(jax.random.bits(jax.random.key(6), x.shape, jnp.uint32))
    e_j = jref.max_biased_exp_ref(jnp.asarray(x), axis=-1 if per_row else None)
    e_t = ref.max_biased_exp_ref(torch.from_numpy(x), -1 if per_row else None)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    if per_row:
        e_j, e_t = e_j[:, None], e_t[:, None]
    m_j = jref.bfp_quantize_ref(jnp.asarray(x), jnp.asarray(rand), e_j)
    m_t = ref.bfp_quantize_ref(torch.from_numpy(x),
                               torch.from_numpy(rand.astype(np.int64)), e_t)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    b = rng.randint(-127, 128, (23, 7)).astype(np.int8)
    np.testing.assert_array_equal(
        ref.int8_matmul_ref(m_t, torch.from_numpy(b),
                            torch.tensor(2.0 ** -9)).numpy(),
        np.asarray(jref.int8_matmul_ref(m_j, jnp.asarray(b),
                                        jnp.float32(2.0 ** -9))))


def test_wrappers_take_plain_versions_on_cpu_without_counting():
    kd.reset_kernel_launches()
    a = torch.randn(1, 5, 8)
    r = prng.bits(prng.key(0), a.shape)
    e = ref.max_biased_exp_ref(a)
    y, _, _ = kfl.fused_qq_pt(a, r, a, r, e, e)
    y2, _, _ = kfl.fused_qq_pt_plain(a, r, a, r, e, e)
    assert torch.equal(y, y2)
    assert torch.equal(kfl.fused_ii_pt(am_i8 := torch.ones(1, 5, 8, dtype=torch.int8),
                                       am_i8, e, e),
                       kfl.fused_ii_pt_plain(am_i8, am_i8, e, e))
    assert torch.equal(kbq.bfp_quantize(a[0], r[0], e.expand(5)),
                       kbq.bfp_quantize_plain(a[0], r[0], e.expand(5)))
    assert torch.equal(kim.int8_matmul(am_i8, am_i8, torch.tensor(0.5)),
                       kim.int8_matmul_plain(am_i8, am_i8, torch.tensor(0.5)))
    assert kd.kernel_launches() == {"qq": 0, "qi": 0, "ii": 0, "qq_blk": 0,
                                    "attn_decode": 0, "attn_fwd": 0,
                                    "attn_bwd": 0, "gemm_epi": 0,
                                    "norm_gemm": 0, "decode_block": 0,
                                    "bfp_quantize": 0, "int8_matmul": 0}


@pytest.mark.parametrize("mode,device,bits,k,want", [
    ("auto", "cpu", 8, 64, kd.JNP),
    ("auto", "cuda", 8, 64, kd.FUSED),
    ("fused", "cpu", 8, 64, kd.FUSED),
    ("jnp", "cuda", 8, 64, kd.JNP),
    ("fused", "cpu", 4, 64, kd.JNP),
    ("fused", "cpu", 8, 200000, kd.JNP),
])
def test_plan_contract_routes(mode, device, bits, k, want):
    with kd.record_decisions() as log:
        d = kd.plan_contract("qmatmul_fwd", 4, k, 8, QuantConfig(bits),
                             kind="qi", kernel_mode=mode, device=device)
    assert d.path == want and log == [d] and d.reason


@pytest.mark.parametrize("mode,device,k,want", [
    ("auto", "cpu", 512, kd.JNP), ("auto", "cuda", 512, kd.FUSED),
    ("fused", "cpu", 512, kd.FUSED), ("fused", "cuda", 140000, kd.JNP)])
def test_plan_contract_routes_dw_to_ii(mode, device, k, want):
    d = kd.plan_contract("qmatmul_dw", 896, k, 151936, QuantConfig(),
                         kind="ii", cfg2=QuantConfig(), kernel_mode=mode,
                         device=device)
    assert d.path == want and d.kind == "ii" and d.reason


def test_plan_contract_rejects_unported_unfused_mode():
    """``"unfused"``, refused until the unfused rung was ported, now plans
    it; a mode that does not exist is still refused."""
    d = kd.plan_contract("qmatmul_fwd", 4, 8, 8, QuantConfig(),
                         kernel_mode="unfused")
    assert d.path == kd.UNFUSED
    with pytest.raises(ValueError, match="unknown kernel_mode"):
        kd.plan_contract("qmatmul_fwd", 4, 8, 8, QuantConfig(),
                         kernel_mode="fastest")
