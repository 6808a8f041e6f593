"""The qflow currency of the port against the JAX package.

BFP activations with a float32 gradient carrier: the integer norms with a
BFP input (q-in) and a BFP output (q-out), ``qmatmul`` with a BFP input
(kind iq) and with ``out_q``, each held ``==`` in its values and in every
gradient to ``jax.vjp`` of the JAX op, under ``kernel_mode="auto"`` (the
plain path on the CPU; the JAX side's jnp oracle) and ``"fused"`` (the
kernels' plain versions; the JAX side's Pallas kernels in interpret
mode).  A BFP input is made
from a float by quantizing it with a key; its carrier is that float, so
the float's gradient is the gradient the op returns on the carrier.
``contract_iq``, and ``contract_ii`` under a kind-pp decision, are held
``==`` to ``contract_iq``/``contract_pp`` of ``repro.kernels.dispatch`` in
interpret mode.  ``qbmm`` with BFP operands
is in ``test_torch_qflow_qbmm.py`` (the two files run in parallel).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qnorm as jqnorm
from repro.core import qops as jqops
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.kernels import dispatch as jkd
from repro_torch.core import prng, qnorm, qops
from repro_torch.core.bfp import BFP, QuantConfig, quantize
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd

MODES = ["auto", "fused"]


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jq(x, key):
    """A JAX BFP of float ``x`` (per tensor) with ``x`` as its carrier."""
    q = jquantize(x, JQ(), key)
    return JBFP(q.m, q.e, q.cfg, x)


def _tq(x, key):
    q = quantize(x.detach(), QuantConfig(), key)
    return BFP(q.m, q.e, q.cfg, x)


def _jax_vjp(fn, args, ct):
    """(output, aux, gradients) of ``fn(*args) -> (float out, aux)``."""
    def run(args, ct):
        y, vjp, aux = jax.vjp(fn, *args, has_aux=True)
        return y, aux, vjp(ct)
    y, aux, grads = jax.jit(run)(tuple(map(jnp.asarray, args)),
                                 jnp.asarray(ct))
    return np.asarray(y), [np.asarray(a) for a in aux], [np.asarray(g)
                                                         for g in grads]


def _port_vjp(fn, args, ct):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, aux = fn(*ts)
    grads = torch.autograd.grad(y, ts, torch.from_numpy(ct),
                                allow_unused=True)
    return (y.detach().numpy(), [a.numpy() for a in aux],
            [np.zeros_like(a) if g is None else g.numpy()
             for a, g in zip(args, grads)])


def _check(jfn, tfn, args, ct):
    jy, jaux, jg = _jax_vjp(jfn, args, ct)
    ty, taux, tg = _port_vjp(tfn, args, ct)
    np.testing.assert_array_equal(ty, jy)
    for i, (t, j) in enumerate(zip(taux, jaux)):
        np.testing.assert_array_equal(t, j, err_msg=f"aux {i}")
    for i, (t, j) in enumerate(zip(tg, jg)):
        np.testing.assert_array_equal(t, j, err_msg=f"grad {i}")


def _out(y):
    """(float output, integer aux) of a float or BFP result: a BFP's
    carrier carries the cotangent, its mantissas and exponent are
    compared as they are."""
    if hasattr(y, "m"):
        return y.g, (y.m, y.e)
    return y, ()


@pytest.mark.parametrize("q_out", [False, True])
@pytest.mark.parametrize("q_in", [False, True])
@pytest.mark.parametrize("norm", ["rms", "layer"])
def test_qnorm_q_in_q_out_equal_jax(norm, q_in, q_out):
    rng = np.random.RandomState(3)
    x, gamma, beta = _f32(rng, 3, 5, 24), _f32(rng, 24), _f32(rng, 24)
    ct = _f32(rng, 3, 5, 24)
    jpol, tpol = JaxPolicy(qflow=True), NumericPolicy(qflow=True)

    def jfn(x, gamma, beta):
        xin = _jq(x, jax.random.key(5)) if q_in else x
        if norm == "rms":
            y = jqnorm.qrmsnorm(xin, gamma, jax.random.key(2), jpol,
                                out_q=q_out)
        else:
            y = jqnorm.qlayernorm(xin, gamma, beta, jax.random.key(2), jpol,
                                  out_q=q_out)
        return _out(y)

    def tfn(x, gamma, beta):
        xin = _tq(x, prng.key(5)) if q_in else x
        if norm == "rms":
            y = qnorm.qrmsnorm(xin, gamma, prng.key(2), tpol, out_q=q_out)
        else:
            y = qnorm.qlayernorm(xin, gamma, beta, prng.key(2), tpol,
                                 out_q=q_out)
        return _out(y)

    _check(jfn, tfn, (x, gamma, beta), ct)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("q_in,q_out", [(True, False), (True, True),
                                        (False, True)])
def test_qmatmul_bfp_in_out_equal_jax(mode, q_in, q_out):
    rng = np.random.RandomState(4)
    x, w = _f32(rng, 2, 5, 37), _f32(rng, 37, 29, scale=0.3)
    ct = _f32(rng, 2, 5, 29)
    jpol = JaxPolicy(qflow=True, kernel_mode=mode)
    tpol = NumericPolicy(qflow=True, kernel_mode=mode)

    def jfn(x, w):
        xin = _jq(x, jax.random.key(8)) if q_in else x
        return _out(jqops.qmatmul(xin, w, jax.random.key(7), jpol,
                                  out_q=q_out))

    def tfn(x, w):
        xin = _tq(x, prng.key(8)) if q_in else x
        return _out(qops.qmatmul(xin, w, prng.key(7), tpol, out_q=q_out))

    with kd.record_decisions() as log:
        _check(jfn, tfn, (x, w), ct)
    want = {"auto": kd.JNP, "fused": kd.FUSED}[mode]
    fwd = [d for d in log if d.op == "qmatmul_fwd"]
    assert [(d.kind, d.path) for d in fwd] == [("iq" if q_in else "qq", want)]


@pytest.mark.parametrize("nbatch,m,k,n", [(0, 5, 37, 29), (1, 7, 19, 11),
                                          (0, 33, 130, 67)])
def test_contract_iq_pp_equal_jax_dispatch(nbatch, m, k, n):
    rng = np.random.RandomState(m + k)
    lead = (3,) * nbatch
    a, b = _f32(rng, *lead, m, k), _f32(rng, *lead, n, k, scale=0.4)
    ja, jb = _jq(jnp.asarray(a), jax.random.key(1)), _jq(jnp.asarray(b),
                                                         jax.random.key(2))
    ta, tb = (_tq(torch.from_numpy(x), prng.key(i)) for i, x in ((1, a), (2, b)))
    np.testing.assert_array_equal(ta.m.numpy(), np.asarray(ja.m))
    cfg = QuantConfig()
    jdec = jkd.plan_contract("qmatmul_fwd", m, k, n, JQ(), kind="iq",
                             cfg2=JQ(), kernel_mode="fused")
    tdec = kd.plan_contract("qmatmul_fwd", m, k, n, cfg, kind="iq",
                            cfg2=cfg, kernel_mode="fused")
    assert jdec.path == jkd.FUSED and tdec.path == kd.FUSED
    jy, jbq = jkd.contract_iq(ja, jnp.asarray(b), JQ(), jax.random.key(3),
                              jdec, nbatch=nbatch)
    ty, tbq = kd.contract_iq(ta, torch.from_numpy(b), cfg, prng.key(3), tdec,
                             nbatch=nbatch)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tbq.m.numpy(), np.asarray(jbq.m))
    assert int(tbq.e) == int(jbq.e)
    jdec = jkd.plan_contract("qbmm_fwd", m, k, n, JQ(), kind="pp", cfg2=JQ(),
                             kernel_mode="fused")
    tdec = kd.plan_contract("qbmm_fwd", m, k, n, cfg, kind="pp", cfg2=cfg,
                            kernel_mode="fused")
    jy = jkd.contract_pp(ja, jb, jdec, nbatch=nbatch)
    ty = kd.contract_ii(ta, tb, tdec, nbatch=nbatch)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
