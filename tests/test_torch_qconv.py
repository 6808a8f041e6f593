"""``qconv`` and ``qrelu`` of the port against the JAX package.

The convolution is im2col patches contracted by ``qmatmul``: the patch
extraction on int8 mantissas (``_int_patches``) is ``==`` the reference's;
the fold-back of the patches' gradient adds each element's taps in
descending (dy, dx) order, which is ``==`` ``jax.vjp`` of
``lax.conv_general_dilated_patches`` for arbitrary float32 gradients.  Then
``qconv``'s values and the gradients of x and the filter are ``==``
``jax.vjp`` of ``repro.core.qops.qconv`` for 1 x 1 and 3 x 3 filters,
strides 1 and 2, ``SAME`` and ``VALID``, a float x, a per-tensor BFP x
(its gradient on the carrier), a per-tensor BFP filter (dW on its
carrier), per-block operands (their float32 view) and ``out_q``, under ``kernel_mode="auto"`` (the plain path; the
JAX side's jnp oracle) and ``"fused"`` (the kernels' plain versions; the
JAX side's Pallas kernels in interpret mode).  ``qrelu`` on float32 and on
a BFP is ``==`` too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qops as jqops
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.core.policy import NumericPolicy as JaxPolicy
from repro_torch.core import prng, qops
from repro_torch.core.bfp import BFP, QuantConfig, quantize
from repro_torch.core.policy import NumericPolicy

GEOMETRIES = [(3, (1, 1), "SAME"), (3, (2, 2), "SAME"), (3, (1, 1), "VALID"),
              (1, (2, 2), "SAME"), (1, (1, 1), "VALID")]


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jq(x, key):
    q = jquantize(x, JQ(), key)
    return JBFP(q.m, q.e, q.cfg, x)


def _tq(x, key):
    q = quantize(x.detach(), QuantConfig(), key)
    return BFP(q.m, q.e, q.cfg, x)


def _out(y):
    if hasattr(y, "m"):
        return y.g, (y.m, y.e)
    return y, ()


def _check(jfn, tfn, args, ct):
    def run(args, ct):
        y, vjp, aux = jax.vjp(jfn, *args, has_aux=True)
        return y, aux, vjp(ct)
    jy, jaux, jg = jax.jit(run)(tuple(map(jnp.asarray, args)),
                                jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    ty, taux = tfn(*ts)
    tg = torch.autograd.grad(ty, ts, torch.from_numpy(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    for t, j in zip(taux, jaux):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for i, (t, j) in enumerate(zip(tg, jg)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"grad {i}")


@pytest.mark.parametrize("kh,stride,padding", GEOMETRIES)
def test_int_patches_equal_jax(kh, stride, padding):
    m = np.random.RandomState(kh).randint(-127, 128, (2, 9, 7, 5)
                                          ).astype(np.int8)
    want = jqops._int_patches(jnp.asarray(m), kh, kh, stride, padding)
    got = qops._int_patches(torch.from_numpy(m), kh, kh, stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kh,stride,padding", GEOMETRIES)
def test_patch_fold_equal_jax(kh, stride, padding):
    """Float patches and their fold-back against the reference's patch
    convolution and its transpose, with gradients of every magnitude."""
    rng = np.random.RandomState(7)
    x = _f32(rng, 2, 8, 9, 6)

    def jfn(x):
        return lax.conv_general_dilated_patches(
            x, (kh, kh), stride, padding,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    jy, vjp = jax.vjp(jfn, jnp.asarray(x))
    ct = (_f32(rng, *jy.shape)
          * np.exp(3 * rng.randn(*jy.shape))).astype(np.float32)
    jdx = jax.jit(vjp)(jnp.asarray(ct))[0]
    xt = torch.from_numpy(x).requires_grad_(True)
    ty = qops._Patches.apply(xt, kh, kh, stride, padding)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jdx))


@pytest.mark.parametrize("kh,stride,padding,mode",
                         [g + ("auto",) for g in GEOMETRIES]
                         + [g + ("fused",) for g in GEOMETRIES[:4]])
def test_qconv_float_equal_jax(kh, stride, padding, mode):
    rng = np.random.RandomState(kh + stride[0])
    x, w = _f32(rng, 2, 8, 8, 5), _f32(rng, kh, kh, 5, 6, scale=0.3)
    ho = {"SAME": -(-8 // stride[0]),
          "VALID": (8 - kh) // stride[0] + 1}[padding]
    ct = _f32(rng, 2, ho, ho, 6)
    jpol, tpol = JaxPolicy(kernel_mode=mode), NumericPolicy(kernel_mode=mode)
    _check(lambda x, w: (jqops.qconv(x, w, jax.random.key(3), jpol,
                                     stride=stride, padding=padding), ()),
           lambda x, w: (qops.qconv(x, w, prng.key(3), tpol, stride=stride,
                                    padding=padding), ()),
           (x, w), ct)


@pytest.mark.parametrize("mode", ["auto", "fused"])
@pytest.mark.parametrize("x_q,w_q,out_q", [
    (True, False, False), (True, False, True), (False, False, True),
    (False, True, False), (True, True, True)])
def test_qconv_bfp_equal_jax(x_q, w_q, out_q, mode):
    """A BFP x (kind iq; with a BFP filter pp) and a BFP filter (qi), each
    made from a float with a key and carrying that float, so the float's
    gradient is the one the op returns on the carrier; ``out_q`` compares
    the output's mantissas and exponent and sends the cotangent into its
    carrier."""
    rng = np.random.RandomState(11)
    x, w = _f32(rng, 2, 8, 8, 5), _f32(rng, 3, 3, 5, 6, scale=0.3)
    ct = _f32(rng, 2, 4, 4, 6)
    jpol = JaxPolicy(qflow=True, kernel_mode=mode)
    tpol = NumericPolicy(qflow=True, kernel_mode=mode)

    def jfn(x, w):
        xin = _jq(x, jax.random.key(5)) if x_q else x
        win = _jq(w, jax.random.key(6)) if w_q else w
        return _out(jqops.qconv(xin, win, jax.random.key(3), jpol,
                                stride=(2, 2), out_q=out_q))

    def tfn(x, w):
        xin = _tq(x, prng.key(5)) if x_q else x
        win = _tq(w, prng.key(6)) if w_q else w
        return _out(qops.qconv(xin, win, prng.key(3), tpol, stride=(2, 2),
                               out_q=out_q))

    _check(jfn, tfn, (x, w), ct)


def test_qconv_per_block_operands_demote_equal_jax():
    """Per-block BFP operands (one exponent per 4 channels) do not survive
    the reshuffle: both take their float32 view (the carrier), as in the
    reference."""
    rng = np.random.RandomState(13)
    x, w = _f32(rng, 2, 6, 6, 8), _f32(rng, 3, 3, 8, 4, scale=0.3)
    ct = _f32(rng, 2, 6, 6, 4)

    def jblk(v, key):
        q = jquantize(v, JQ(block=4), key)
        return JBFP(q.m, q.e, q.cfg, v)

    def tblk(v, key):
        q = quantize(v.detach(), QuantConfig(block=4), key)
        return BFP(q.m, q.e, q.cfg, v)

    _check(lambda x, w: (jqops.qconv(jblk(x, jax.random.key(5)),
                                     jblk(w, jax.random.key(6)),
                                     jax.random.key(3), JaxPolicy()), ()),
           lambda x, w: (qops.qconv(tblk(x, prng.key(5)), tblk(w, prng.key(6)),
                                    prng.key(3), NumericPolicy()), ()),
           (x, w), ct)


def test_qconv_float_policy_close_to_jax():
    """The float policy convolves in float32 (``F.conv2d`` against XLA's
    convolution: the same sums in another order)."""
    rng = np.random.RandomState(2)
    x, w = _f32(rng, 2, 8, 8, 5), _f32(rng, 3, 3, 5, 6)
    pol_j, pol_t = JaxPolicy(enabled=False), NumericPolicy(enabled=False)
    for stride in ((1, 1), (2, 2)):
        want = jqops.qconv(jnp.asarray(x), jnp.asarray(w), None, pol_j,
                           stride=stride)
        got = qops.qconv(torch.from_numpy(x), torch.from_numpy(w), None,
                         pol_t, stride=stride)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_qrelu_equal_jax():
    rng = np.random.RandomState(4)
    x, ct = _f32(rng, 3, 7), _f32(rng, 3, 7)

    def jfn(x):
        q = jqops.qrelu(_jq(x, jax.random.key(1)))
        return jqops.qrelu(x) + q.g, (q.m, q.e)

    def tfn(x):
        q = qops.qrelu(_tq(x, prng.key(1)))
        return qops.qrelu(x) + q.g, (q.m, q.e)

    _check(jfn, tfn, (x,), ct)
