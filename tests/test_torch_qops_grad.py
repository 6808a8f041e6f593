"""The A.2 integer backward of the port's qmatmul, qbmm, qembed and qdq_st
against ``jax.vjp`` of the JAX package's ops: forward values and every
gradient ``==`` for the same inputs (made with numpy), the same keys and
the same cotangent, under ``kernel_mode="auto"`` (the plain path on the
CPU; the JAX side's jnp oracle) and ``"fused"`` (the kernels' plain
versions; the JAX side's Pallas kernels in interpret mode).  The fused
runs route dX through ``qi`` and dW through ``ii`` on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qops as jqops
from repro.core.bfp import QuantConfig as JQ
from repro.core.policy import NumericPolicy as JaxPolicy
from repro_torch.core import prng
from repro_torch.core import qops as tqops
from repro_torch.core.bfp import QuantConfig
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd


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
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_qmatmul_grads_equal_jax(mode):
    rng = np.random.RandomState(1)
    x, w = _f32(rng, 2, 5, 37), _f32(rng, 37, 29, scale=0.3)
    ct = _f32(rng, 2, 5, 29)
    jp, tp = JaxPolicy(kernel_mode=mode), NumericPolicy(kernel_mode=mode)
    with kd.record_decisions() as log:
        _check(lambda x, w: jqops.qmatmul(x, w, jax.random.key(7), jp),
               lambda x, w: tqops.qmatmul(x, w, prng.key(7), tp), (x, w), ct)
    paths = {(d.op, d.kind): d.path for d in log}
    want = kd.FUSED if mode == "fused" else kd.JNP
    assert paths == {("qmatmul_fwd", "qq"): want, ("qmatmul_dx", "qi"): want,
                     ("qmatmul_dw", "ii"): want}


@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_qbmm_grads_equal_jax(mode):
    rng = np.random.RandomState(2)
    a, b = _f32(rng, 2, 3, 13, 24), _f32(rng, 2, 3, 24, 11)
    ct = _f32(rng, 2, 3, 13, 11)
    jp, tp = JaxPolicy(kernel_mode=mode), NumericPolicy(kernel_mode=mode)
    _check(lambda a, b: jqops.qbmm(a, b, jax.random.key(8), jp),
           lambda a, b: tqops.qbmm(a, b, prng.key(8), tp), (a, b), ct)


def test_qembed_grads_equal_jax():
    """The table gradient is an int32 scatter-add of the int8 gradient
    mantissas (repeated tokens included), then one rescale."""
    rng = np.random.RandomState(3)
    table = _f32(rng, 50, 24, scale=0.05)
    tokens = rng.randint(0, 50, (2, 9)).astype(np.int32)
    tokens[1, :3] = tokens[0, 0]
    ct = _f32(rng, 2, 9, 24)
    jy, (jg,) = _jax_vjp(lambda t: jqops.qembed(jnp.asarray(tokens), t,
                                                jax.random.key(9),
                                                JaxPolicy()), (table,), ct)
    ty, (tg,) = _port_vjp(lambda t: tqops.qembed(torch.from_numpy(tokens), t,
                                                 prng.key(9), NumericPolicy()),
                          (table,), ct)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


def test_qdq_st_is_straight_through():
    rng = np.random.RandomState(4)
    x, ct = _f32(rng, 6, 10), _f32(rng, 6, 10)
    _check(lambda x: jqops.qdq_st(x, jax.random.key(5), JQ()),
           lambda x: tqops.qdq_st(x, prng.key(5), QuantConfig()), (x,), ct)

