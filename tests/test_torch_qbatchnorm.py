"""``qbatchnorm`` of the port against ``repro.core.qnorm.qbatchnorm``.

The integer batch-norm normalizes each channel over all leading axes in
fixed point (``core.fixed_point``), forward and backward, with int32
column sums over the N*H*W rows: for the same key its output, the batch
mean and variance and the gradients of x, gamma and beta are ``==``
``jax.vjp`` of the reference, for a 2-D and an NHWC input, a float and a
per-tensor BFP input (q-in, its gradient on the carrier), a float and a
BFP output (``out_q``, the cotangent into its carrier).  The frozen mode
(``training=False`` with running statistics) and the float policy are
float32: the reference's rsqrt is XLA's (the CPU's rsqrtss estimate and
two Newton steps) where the port's is correctly rounded, and the float
policy's batch mean and variance sum in another order, so they are held
to ``FLOAT_ATOL`` (measured: at most 1.9e-6 over five seeds at |y| < 5,
|var| < 16; PERF.md §6).  Without a key the integer policy raises, as the
reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qnorm as jqnorm
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.core.policy import NumericPolicy as JaxPolicy
from repro_torch.core import prng, qnorm
from repro_torch.core.bfp import BFP, QuantConfig, quantize
from repro_torch.core.policy import FLOAT32, NumericPolicy

# The float paths' bound (module note).
FLOAT_ATOL = 4e-6


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 3 + rng.randn(c)).astype(np.float32)
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    return x, g, b, ct


def _jq(x, key):
    q = jquantize(x, JQ(), key)
    return JBFP(q.m, q.e, q.cfg, x)


def _tq(x, key):
    q = quantize(x.detach(), QuantConfig(), key)
    return BFP(q.m, q.e, q.cfg, x)


def _split(out):
    y, mean, var = out
    if hasattr(y, "m"):
        return y.g, (y.m, y.e, mean, var)
    return y, (mean, var)


@pytest.mark.parametrize("q_in,q_out", [(False, False), (True, False),
                                        (False, True), (True, True)])
@pytest.mark.parametrize("shape", [(2, 5, 6, 12), (37, 20)])
def test_qbatchnorm_equal_jax(shape, q_in, q_out):
    x, g, b, ct = _inputs(len(shape) + 3 * q_in + q_out, shape)
    jpol, tpol = JaxPolicy(qflow=True), NumericPolicy(qflow=True)

    def jfn(x, g, b):
        xin = _jq(x, jax.random.key(5)) if q_in else x
        return _split(jqnorm.qbatchnorm(xin, g, b, jax.random.key(2), jpol,
                                        out_q=q_out))

    def run(args, ct):
        y, vjp, aux = jax.vjp(jfn, *args, has_aux=True)
        return y, aux, vjp(ct)

    jy, jaux, jg = jax.jit(run)(tuple(map(jnp.asarray, (x, g, b))),
                                jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    xin = _tq(ts[0], prng.key(5)) if q_in else ts[0]
    ty, taux = _split(qnorm.qbatchnorm(xin, ts[1], ts[2], prng.key(2), tpol,
                                       out_q=q_out))
    tg = torch.autograd.grad(ty, ts, torch.from_numpy(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    for i, (t, j) in enumerate(zip(taux, jaux)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"aux {i}")
    for i, (t, j) in enumerate(zip(tg, jg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"grad {i}")


def test_qbatchnorm_frozen_close_to_jax():
    x, g, b, _ = _inputs(8, (3, 4, 4, 8))
    rng = np.random.RandomState(9)
    rm = rng.randn(8).astype(np.float32)
    rv = (1 + rng.rand(8)).astype(np.float32)
    want = jax.jit(lambda x, g, b, rm, rv: jqnorm.qbatchnorm(
        x, g, b, None, JaxPolicy(), running=(rm, rv), training=False))(
        x, g, b, rm, rv)
    got = qnorm.qbatchnorm(*map(torch.from_numpy, (x, g, b)), None,
                           NumericPolicy(),
                           running=(torch.from_numpy(rm), torch.from_numpy(rv)),
                           training=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=FLOAT_ATOL)
    for t, j in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_qbatchnorm_float_policy_close_to_jax():
    x, g, b, _ = _inputs(10, (4, 4, 4, 8))
    want = jax.jit(lambda x, g, b: jqnorm.qbatchnorm(
        x, g, b, None, JaxPolicy(enabled=False)))(x, g, b)
    got = qnorm.qbatchnorm(*map(torch.from_numpy, (x, g, b)), None, FLOAT32)
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=FLOAT_ATOL)


def test_qbatchnorm_needs_a_key():
    x, g, b, _ = _inputs(1, (4, 8))
    with pytest.raises(ValueError, match="PRNG key"):
        qnorm.qbatchnorm(*map(torch.from_numpy, (x, g, b)), None,
                         NumericPolicy())
