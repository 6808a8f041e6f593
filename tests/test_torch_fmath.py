"""core.fmath against the reference's float32 ops as its XLA CPU build
runs them under ``jax.jit``: the contracted multiply-add, exp, the
logistic, tanh, the tanh-form GELU and the GELU(-GLU) pullback, sums in
the reference's order and the loss mean's fused sum ``==`` on random
inputs and edge values; log
within one ulp (its Cephes evaluation order is reproduced up to a rare
last-bit difference, about 3 in 10^4 inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import rope as jax_rope
from repro_torch.core import fmath
from repro_torch.models.common import rope


def _f32(rng, n, scale):
    return (rng.randn(n) * scale).astype(np.float32)


def test_elementwise_equal_jax():
    rng = np.random.RandomState(0)
    x = _f32(rng, 20000, 10)
    a, b, c = (_f32(rng, 20000, 3) for _ in range(3))
    T = torch.from_numpy
    np.testing.assert_array_equal(fmath.exp(T(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))
    np.testing.assert_array_equal(fmath.logistic(T(x)).numpy(),
                                  np.asarray(jax.jit(jax.nn.sigmoid)(x)))
    np.testing.assert_array_equal(
        fmath.fma(T(a), T(b), T(c)).numpy(),
        np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c)))
    pos = np.exp(_f32(rng, 20000, 4)).astype(np.float32)
    got = fmath.log(T(pos)).numpy().view(np.int32).astype(np.int64)
    want = np.asarray(jax.jit(jnp.log)(pos)).view(np.int32).astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert (got != want).mean() < 1e-3


def _gelu_inputs(seed):
    """About 10^5 values of N(0, 3^2) and the edges of XLA's tanh: 0, the
    threshold 4e-4 below which it returns x (either side, both signs), the
    clamp 7.9988, 20 where it returns +-1, the infinities, NaN, sub-normals
    and the largest floats."""
    rng = np.random.RandomState(seed)
    tiny = np.float32(4e-4)             # XLA's threshold, 0x1.a36e2ep-12
    edges = [0.0, -0.0, tiny, np.nextafter(tiny, np.float32(0)),
             np.nextafter(tiny, np.float32(1)), 7.905, 7.9988117,
             8.0, 19.999998, 20.0, 1e3, np.inf, np.nan, 1e-40, 1.4e-45,
             1.2e-38, 3.4e38]
    e = np.array(edges, dtype=np.float32)
    return np.concatenate([_f32(rng, 100000, 3), e, -e]).astype(np.float32)


def _bits_equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).view(np.int32),
                                  np.asarray(want).view(np.int32))


def test_tanh_and_gelu_equal_jax():
    x = _gelu_inputs(1)
    T = torch.from_numpy
    _bits_equal(fmath.tanh(T(x)).numpy(), jax.jit(jnp.tanh)(x))
    _bits_equal(fmath.gelu(T(x)).numpy(), jax.jit(jax.nn.gelu)(x))


def test_gelu_pullbacks_equal_jax_vjp():
    """``gelu_pullback`` against the jitted VJP of ``gelu(g) * u`` (both
    cotangents) and of ``gelu(g)``."""
    g = _gelu_inputs(2)
    rng = np.random.RandomState(3)
    u, ct = _f32(rng, g.size, 1), _f32(rng, g.size, 1)

    def glu(g, u, ct):
        return jax.vjp(lambda g, u: jax.nn.gelu(g) * u, g, u)[1](ct)

    def gelu(g, ct):
        return jax.vjp(jax.nn.gelu, g)[1](ct)[0]

    T = torch.from_numpy
    d_gate, d_up = jax.jit(glu)(g, u, ct)
    _bits_equal(fmath.gelu_pullback(T(g), T(ct) * T(u)).numpy(), d_gate)
    _bits_equal((fmath.gelu(T(g)) * T(ct)).numpy(), d_up)
    _bits_equal(fmath.gelu_pullback(T(g), T(ct)).numpy(),
                jax.jit(gelu)(g, ct))


@pytest.mark.parametrize("shape,dims", [((33,), (0,)), ((151936,), (0,)),
                                        ((2, 16, 56), (0, 1)),
                                        ((4, 128, 96), (0, 1)),
                                        ((112, 16), (1,)), ((40, 3, 50), (0, 2))])
def test_sum_order_equal_jax(shape, dims):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape) * 2)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=dims))(x))
    np.testing.assert_array_equal(
        fmath.sum_windows(torch.from_numpy(x), dims).numpy(), want)


# (B, S, V) of softmax_xent's mean where the port follows the reference's
# fused loop: index order (2x12, 2x4, 1x16, and past 32 positions with no
# dim over 32 at 2x32, 3x20 and 2x16 where LLVM keeps the loop scalar),
# windows over both dims (2x64, 4x128, 1x40, 40x4, 3x33).  The lanes LLVM
# vectorizes the loop into at the smoke vocabularies are not followed
# (PERF.md §6).
MEAN_SHAPES = [(2, 12, 512), (2, 4, 512), (1, 16, 512), (2, 32, 1024),
               (3, 20, 1024), (2, 16, 1024), (2, 64, 64), (4, 128, 512),
               (1, 40, 509), (40, 4, 256), (3, 33, 300)]


@pytest.mark.parametrize("shape", MEAN_SHAPES)
def test_softmax_xent_mean_order_equal_jax(shape):
    """The loss mean in the order of the reference's fused loop
    (``fmath.sum_fused_2d``), ``==`` ``jax.jit`` of its softmax_xent where
    that loop is not vectorized."""
    from repro.models.common import softmax_xent as jax_xent
    from repro_torch.models.common import softmax_xent

    b, s, v = shape
    rng = np.random.RandomState(b * s + v)
    for _ in range(4):
        logits = (rng.randn(b, s, v) * 3).astype(np.float32)
        labels = rng.randint(0, v, (b, s)).astype(np.int32)
        want = np.asarray(jax.jit(jax_xent)(logits, labels))
        got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
        assert got.numpy() == want


@pytest.mark.parametrize("start,length", [(0, 128), (37, 5), (1500, 1)])
def test_rope_tables_equal_jax_runtime_tables(start, length):
    """The reference computes its rope tables inside the jitted step (the
    C library's sinf/cosf); the port's host tables equal them, for a
    prefill's positions and for a decode step's slice."""
    pos = np.arange(start, start + length, dtype=np.int32)
    want = jax.jit(lambda p: jax_rope(p, 64, 1_000_000.0))(pos)
    got = rope(start, length, 64, 1_000_000.0, "cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rope_tables_cached_under_inference_mode_serve_training():
    """Tables first made while serving (inference mode) are ordinary
    tensors: a later training pass saves them for its backward."""
    from repro_torch.models.common import _rope_tables, apply_rope
    _rope_tables.cache_clear()
    with torch.inference_mode():
        rope(0, 8, 16, 10000.0, "cpu")
    x = torch.randn(1, 8, 16, requires_grad=True)
    apply_rope(x, *rope(0, 8, 16, 10000.0, "cpu")).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape
