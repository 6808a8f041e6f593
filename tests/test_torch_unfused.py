"""The unfused rung (``kernel_mode="unfused"``) against the JAX package.

* ``plan_contract`` under ``"unfused"`` takes the reference's path, with a
  reason of the same class, over kinds qq/qi/iq/ii/pp x stochastic or
  nearest rounding x per tensor or per block x K inside one int32 sum,
  over ``accum_chunk``, or over the int32 accumulator
  (``tests/test_dispatch.py``'s rules).  The two plans that exist only
  under ``"unfused"`` (nearest rounding of a fresh operand, a per-block
  scale) raise when planned for the card; the shared ones do not.
* ``qmatmul`` and ``qbmm``, values and every gradient, ``==`` ``jax.vjp``
  of the JAX ops under ``"unfused"`` (the JAX side's ``bfp_quantize`` and
  ``int8_matmul`` Pallas kernels in interpret mode, the port's plain
  versions): kinds qq, iq (a BFP activation, as ``tests/test_qflow.py``),
  qi (a load-time BFP weight; ``qbmm`` with a BFP ``b``) and pp (both
  operands BFP, as ``tests/test_qweights.py``), with every contraction
  decided UNFUSED on both sides.
* The per-tensor paths are bit-identical across modes: ``"unfused"``
  equals ``"fused"`` and ``"jnp"`` in the port, as in the reference.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qops as jqops
from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.kernels import dispatch as jkd
from repro_torch.core import prng, qops
from repro_torch.core.bfp import QuantConfig, quantize
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from test_torch_qflow import _check, _f32, _jq, _tq

KINDS = ["qq", "qi", "iq", "ii", "pp"]
# K: one int32 sum; over accum_chunk (512 below); over the accumulator
# (accum_chunk lifted past it)
K_CASES = {"fits": (64, 65536), "chunk": (600, 512),
           "overflow": (140000, 200000)}


def _reason_class(reason: str) -> str:
    for key, cls in (("kernel_mode=unfused", "unfused"), ("SR-only", "sr"),
                     ("per-block", "block"), ("per-tensor scales", "block"),
                     ("accum_chunk", "chunk"), ("overflows", "overflow")):
        if key in reason:
            return cls
    raise AssertionError(f"unclassified reason {reason!r}")


@pytest.mark.parametrize("k_case", list(K_CASES))
@pytest.mark.parametrize("block", [0, 8])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_contract_equals_reference(kind, stochastic, block, k_case):
    k, chunk = K_CASES[k_case]
    cfg2 = None if kind == "qq" else (block, stochastic)
    jd = jkd.plan_contract(
        "op", 16, k, 24, JQ(8, block=block, stochastic=stochastic),
        kind=kind, cfg2=None if cfg2 is None else JQ(8, *cfg2),
        kernel_mode="unfused", accum_chunk=chunk)
    td = kd.plan_contract(
        "op", 16, k, 24, QuantConfig(8, block, stochastic), kind=kind,
        cfg2=None if cfg2 is None else QuantConfig(8, *cfg2),
        kernel_mode="unfused", accum_chunk=chunk, device="cpu")
    assert td.path == jd.path, (td.reason, jd.reason)
    assert _reason_class(td.reason) == _reason_class(jd.reason)


@pytest.mark.parametrize("cfg,kind,k,raises", [
    (QuantConfig(stochastic=False), "qq", 64, "SR-only"),
    (QuantConfig(stochastic=False), "qi", 64, "SR-only"),
    (QuantConfig(block=8), "qq", 64, "per-block"),
    (QuantConfig(block=8), "ii", 64, "per-block"),
    (QuantConfig(stochastic=False), "ii", 64, None),
    (QuantConfig(), "qq", 70000, None),
])
def test_unfused_only_plans_raise_on_the_card(cfg, kind, k, raises):
    """Planned for the card (no card needed to plan): the unfused-only JNP
    reasons raise, a reason the fused mode shares keeps the plain path."""
    kw = dict(kind=kind, cfg2=None if kind == "qq" else cfg,
              kernel_mode="unfused", device="cuda")
    if raises:
        with pytest.raises(NotImplementedError, match=raises):
            kd.plan_contract("op", 16, k, 24, cfg, **kw)
    else:
        d = kd.plan_contract("op", 16, k, 24, cfg, **kw)
        assert d.path == (kd.UNFUSED if kind == "ii" else kd.JNP)


def test_chains_and_attention_plan_jnp_under_unfused():
    cfg = QuantConfig()
    for d in (kd.plan_attention("attn_fwd", 7, 64, 64, cfg, s=1,
                                kernel_mode="unfused", device="cuda"),
              kd.plan_norm_gemm("n", 16, 64, 24, cfg, kernel_mode="unfused",
                                device="cuda"),
              kd.plan_epilogue("e", 16, 64, 24, cfg, kernel_mode="unfused",
                               device="cuda"),
              kd.plan_decode_block("b", 4, 256, 320, 40, 8, 2, 32, cfg,
                                   kernel_mode="unfused", device="cuda")):
        assert d.path == kd.JNP and "no unfused pipeline" in d.reason


def _decisions(log):
    return [(d.op, d.kind, d.path) for d in log]


@pytest.mark.parametrize("q_in", [False, True])
def test_qmatmul_unfused_equal_jax(q_in):
    rng = np.random.RandomState(21)
    x, w = _f32(rng, 2, 5, 37), _f32(rng, 37, 29, scale=0.3)
    ct = _f32(rng, 2, 5, 29)
    jpol = JaxPolicy(qflow=q_in, kernel_mode="unfused")
    tpol = NumericPolicy(qflow=q_in, kernel_mode="unfused")

    def jfn(x, w):
        xin = _jq(x, jax.random.key(8)) if q_in else x
        return jqops.qmatmul(xin, w, jax.random.key(7), jpol), ()

    def tfn(x, w):
        xin = _tq(x, prng.key(8)) if q_in else x
        return qops.qmatmul(xin, w, prng.key(7), tpol), ()

    with jkd.record_decisions() as jlog, kd.record_decisions() as log:
        _check(jfn, tfn, (x, w), ct)
    want = [("qmatmul_fwd", "iq" if q_in else "qq", kd.UNFUSED),
            ("qmatmul_dx", "qi", kd.UNFUSED), ("qmatmul_dw", "ii", kd.UNFUSED)]
    assert _decisions(log) == want
    assert [(d.op, d.kind, d.path) for d in jlog] == want


@pytest.mark.parametrize("a_q,b_q,kind", [(False, False, "qq"),
                                          (True, True, "pp"),
                                          (True, False, "iq"),
                                          (False, True, "qi")])
def test_qbmm_unfused_equal_jax(a_q, b_q, kind):
    rng = np.random.RandomState(22)
    a, b = _f32(rng, 2, 3, 7, 19), _f32(rng, 2, 3, 19, 11, scale=0.5)
    ct = _f32(rng, 2, 3, 7, 11)
    jpol = JaxPolicy(qflow=True, kernel_mode="unfused")
    tpol = NumericPolicy(qflow=True, kernel_mode="unfused")

    def jfn(a, b):
        ain = _jq(a, jax.random.key(11)) if a_q else a
        bin_ = _jq(b, jax.random.key(12)) if b_q else b
        return jqops.qbmm(ain, bin_, jax.random.key(9), jpol), ()

    def tfn(a, b):
        ain = _tq(a, prng.key(11)) if a_q else a
        bin_ = _tq(b, prng.key(12)) if b_q else b
        return qops.qbmm(ain, bin_, prng.key(9), tpol), ()

    with kd.record_decisions() as log:
        _check(jfn, tfn, (a, b), ct)
    assert _decisions(log) == [("qbmm_fwd", kind, kd.UNFUSED),
                               ("qbmm_dx", "qi", kd.UNFUSED),
                               ("qbmm_dw", "ii", kd.UNFUSED)]


def test_qmatmul_load_time_weight_unfused_equal_jax():
    """A load-time BFP weight: only the activation is quantized (kind qi),
    forward only, as serving runs it."""
    rng = np.random.RandomState(23)
    x, w = _f32(rng, 6, 40), _f32(rng, 40, 24, scale=0.2)
    jw = jquantize(jax.numpy.asarray(w), JQ(), jax.random.key(4))
    tw = quantize(torch.from_numpy(w), QuantConfig(), prng.key(4))
    want = jqops.qmatmul(jax.numpy.asarray(x), jw, jax.random.key(5),
                         JaxPolicy(kernel_mode="unfused"))
    with kd.record_decisions() as log:
        got = qops.qmatmul(torch.from_numpy(x), tw, prng.key(5),
                           NumericPolicy(kernel_mode="unfused"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _decisions(log) == [("qmatmul_fwd", "qi", kd.UNFUSED)]


def test_unfused_equals_fused_and_jnp_in_the_port():
    """The reference makes the per-tensor paths bit-identical
    (``test_unfused_path_bit_identical_to_jnp``); so does the port, values
    and gradients."""
    rng = np.random.RandomState(24)
    x, w = _f32(rng, 24, 56), _f32(rng, 56, 24)
    outs = []
    for mode in ("unfused", "fused", "jnp"):
        xt = torch.from_numpy(x).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        y = qops.qmatmul(xt, wt, prng.key(3), NumericPolicy(kernel_mode=mode))
        gx, gw = torch.autograd.grad((y * y).sum(), (xt, wt))
        outs.append((y.detach(), gx, gw))
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
