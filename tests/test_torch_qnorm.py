"""repro_torch.core.qnorm forward against repro.core.qnorm: the integer
RMSNorm and LayerNorm outputs are ``==`` for the same key (every shift,
rsqrt step and rounding bit is integer)."""

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
