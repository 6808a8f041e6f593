"""repro_torch.core.qnorm against repro.core.qnorm: the integer RMSNorm and
LayerNorm outputs and their integer backward (dx, dgamma, dbeta) are
``==`` for the same key (every shift, rsqrt step and rounding bit is
integer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fixed_point as jfx
from repro.core import policy as jpol
from repro.core import qnorm as jq
from repro_torch.core import fixed_point as tfx
from repro_torch.core import policy as tpol
from repro_torch.core import prng
from repro_torch.core import qnorm as tq


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    g = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
    b = (0.1 * rng.randn(shape[-1])).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("shape", [(3, 5, 56), (2, 896)])
def test_qrmsnorm_equal_jax(shape):
    x, g, _ = _inputs(len(shape), shape)
    want = jax.jit(lambda x, g, k: jq.qrmsnorm(x, g, k, jpol.NumericPolicy()))(
        jnp.asarray(x), jnp.asarray(g), jax.random.key(5))
    got = tq.qrmsnorm(torch.from_numpy(x), torch.from_numpy(g), prng.key(5),
                      tpol.NumericPolicy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(4, 31)])
def test_qlayernorm_equal_jax(shape):
    x, g, b = _inputs(7, shape)
    want = jax.jit(lambda x, g, b, k: jq.qlayernorm(
        x, g, b, k, jpol.NumericPolicy()))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jax.random.key(9))
    got = tq.qlayernorm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), prng.key(9),
                        tpol.NumericPolicy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _port_vjp(fn, args, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = fn(*ts)
    return y.detach().numpy(), [d.numpy() for d in
                                torch.autograd.grad(y, ts, torch.from_numpy(g))]


@pytest.mark.parametrize("shape", [(3, 5, 56), (7, 33)])
def test_qrmsnorm_backward_equal_jax(shape):
    x, g, _ = _inputs(11, shape)
    gy = np.random.RandomState(12).randn(*shape).astype(np.float32)

    def jfn(x, g, gy):
        y, vjp = jax.vjp(lambda x, g: jq.qrmsnorm(x, g, jax.random.key(3),
                                                  jpol.NumericPolicy()), x, g)
        return y, vjp(gy)

    jy, (jdx, jdg) = jax.jit(jfn)(x, g, gy)
    ty, (tdx, tdg) = _port_vjp(lambda x, g: tq.qrmsnorm(
        x, g, prng.key(3), tpol.NumericPolicy()), (x, g), gy)
    np.testing.assert_array_equal(ty, np.asarray(jy))
    np.testing.assert_array_equal(tdx, np.asarray(jdx))
    np.testing.assert_array_equal(tdg, np.asarray(jdg))


def test_qlayernorm_backward_equal_jax():
    x, g, b = _inputs(13, (6, 40))
    gy = np.random.RandomState(14).randn(6, 40).astype(np.float32)

    def jfn(x, g, b, gy):
        y, vjp = jax.vjp(lambda x, g, b: jq.qlayernorm(
            x, g, b, jax.random.key(4), jpol.NumericPolicy()), x, g, b)
        return y, vjp(gy)

    jy, jd = jax.jit(jfn)(x, g, b, gy)
    ty, td = _port_vjp(lambda x, g, b: tq.qlayernorm(
        x, g, b, prng.key(4), tpol.NumericPolicy()), (x, g, b), gy)
    np.testing.assert_array_equal(ty, np.asarray(jy))
    for t, j in zip(td, jd):
        np.testing.assert_array_equal(t, np.asarray(j))


def test_fx_rsqrt_equal_jax():
    m = np.random.RandomState(0).randint(1, 2 ** 29, 97).astype(np.int32)
    e = np.int32(-20)
    jr = jfx.fx_rsqrt(jfx.Fx(jnp.asarray(m), jnp.asarray(e), 30),
                      jfx.KeyGen(jax.random.key(1)))
    tr = tfx.fx_rsqrt(tfx.Fx(torch.from_numpy(m), torch.tensor(e), 30),
                      tfx.KeyGen(prng.key(1)))
    np.testing.assert_array_equal(tr.m.numpy(), np.asarray(jr.m))
    np.testing.assert_array_equal(tr.e.numpy(), np.asarray(jr.e))


def test_float_policy_norm_is_float():
    x, g, _ = _inputs(2, (4, 16))
    got = tq.qrmsnorm(torch.from_numpy(x), torch.from_numpy(g), None,
                      tpol.FLOAT32)
    want = jq.qrmsnorm(jnp.asarray(x), jnp.asarray(g), None, jpol.FLOAT32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
