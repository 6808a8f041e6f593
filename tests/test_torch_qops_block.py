"""Per-block (MX-style) scales in the port's qmatmul, qbmm and qembed
against the JAX package's ops.

* The forward contraction sums its per-block partials in the reference's
  own order: the jnp path (``_blk_dot``) in XLA CPU's windows of 32 over
  the block axis.  Inputs ``x * exp(4 * randn)`` spread the partials over
  many binades, so a sum in another order differs in many entries once
  there are more than 32 blocks.
* Forward values and every gradient ``==`` ``jax.vjp`` of the JAX ops,
  under ``kernel_mode="auto"`` (both sides' plain paths: windowed sums)
  and ``"fused"`` (the port's ``qq_blk`` plain version, the JAX package's
  Pallas kernel in interpret mode: sums in block order), with shapes
  where a contraction length does not divide by the block (per-tensor
  fallback on the ``qq`` kernel).  Every per-block contraction, forward
  and A.2 backward, is kind ``qq``.
* The embedding's per-block backward scatters the float gradient rows in
  token order (repeated tokens included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qops as jqops
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.kernels import dispatch as jd
from repro_torch.core import prng
from repro_torch.core import qops as tqops
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd


def _wide(rng, *shape):
    """x * exp(4 * randn): values over many binades."""
    return (rng.randn(*shape) * np.exp(4.0 * rng.randn(*shape))
            ).astype(np.float32)


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


# (blocks, block): under 32 blocks the sum runs in index order; 38 blocks
# of 128 is d_ff's contraction in qwen2-0.5b; 40 and 300 take windows.
SUM_CASES = [(4, 32), (40, 32), (300, 32), (38, 128)]


@pytest.mark.parametrize("nb,blk", SUM_CASES)
def test_blk_dot_sums_qmatmul_in_reference_order(nb, blk):
    rng = np.random.RandomState(nb + blk)
    x, w = _wide(rng, 16, nb * blk), _wide(rng, nb * blk, 24)
    jp, tp = JaxPolicy(block=blk), NumericPolicy(block=blk)
    want = jax.jit(lambda x, w: jqops.qmatmul(x, w, jax.random.key(3), jp))(
        jnp.asarray(x), jnp.asarray(w))
    got = tqops.qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                        prng.key(3), tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,blk", SUM_CASES)
def test_blk_dot_sums_qbmm_in_reference_order(nb, blk):
    rng = np.random.RandomState(2 * nb + blk)
    a, b = _wide(rng, 2, 8, nb * blk), _wide(rng, 2, nb * blk, 12)
    jp, tp = JaxPolicy(block=blk), NumericPolicy(block=blk)
    want = jax.jit(lambda a, b: jqops.qbmm(a, b, jax.random.key(4), jp))(
        jnp.asarray(a), jnp.asarray(b))
    got = tqops.qbmm(torch.from_numpy(a), torch.from_numpy(b), prng.key(4),
                     tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def _check(jfn, tfn, args, ct, mode):
    """Values and gradients ``==``; under ``fused`` every contraction the
    JAX side plans is FUSED (Pallas interpret) and so is the port's."""
    with jd.record_decisions() as jlog:
        jy, jg = _jax_vjp(jfn, args, ct)
    with kd.record_decisions() as tlog:
        ty, tg = _port_vjp(tfn, args, ct)
    np.testing.assert_array_equal(ty, jy)
    for t, j in zip(tg, jg):
        np.testing.assert_array_equal(t, j)
    want = kd.FUSED if mode == "fused" else kd.JNP
    assert jlog and {d.path for d in jlog} == {want}
    assert {(d.op, d.kind, d.path) for d in tlog} == {
        (d.op, d.kind, d.path) for d in jlog}
    assert {d.kind for d in tlog} == {"qq"}
    return tlog


# (x lead, K, N) at block 8: K, N and the token count M each divide by
# the block or not, so forward, dX (contracts N) and dW (contracts M) each
# take the per-block kernel or fall back to the per-tensor one.
QMATMUL_SHAPES = [((2, 4), 32, 24), ((3, 5), 40, 20), ((2, 4), 36, 16),
                  ((7,), 64, 30)]


@pytest.mark.parametrize("mode", ["auto", "fused"])
@pytest.mark.parametrize("lead,k,n", QMATMUL_SHAPES)
def test_qmatmul_per_block_grads_equal_jax(lead, k, n, mode):
    rng = np.random.RandomState(k + n)
    x, w = _wide(rng, *lead, k), _f32(rng, k, n, scale=0.3)
    ct = _wide(rng, *lead, n)
    jp = JaxPolicy(block=8, kernel_mode=mode)
    tp = NumericPolicy(block=8, kernel_mode=mode)
    log = _check(lambda x, w: jqops.qmatmul(x, w, jax.random.key(7), jp),
                 lambda x, w: tqops.qmatmul(x, w, prng.key(7), tp), (x, w),
                 ct, mode)
    assert {d.op for d in log} == {"qmatmul_fwd", "qmatmul_dx", "qmatmul_dw"}


# (batch, M, K, N): QKᵀ- and PV-like products with K, N, M on and off the
# block.
QBMM_SHAPES = [((2,), 16, 8, 16), ((2, 3), 12, 16, 9), ((3,), 13, 24, 16)]


@pytest.mark.parametrize("mode", ["auto", "fused"])
@pytest.mark.parametrize("lead,m,k,n", QBMM_SHAPES)
def test_qbmm_per_block_grads_equal_jax(lead, m, k, n, mode):
    rng = np.random.RandomState(m * k + n)
    a, b = _wide(rng, *lead, m, k), _f32(rng, *lead, k, n)
    ct = _f32(rng, *lead, m, n)
    jp = JaxPolicy(block=8, kernel_mode=mode)
    tp = NumericPolicy(block=8, kernel_mode=mode)
    _check(lambda a, b: jqops.qbmm(a, b, jax.random.key(8), jp),
           lambda a, b: tqops.qbmm(a, b, prng.key(8), tp), (a, b), ct, mode)


@pytest.mark.parametrize("d", [24, 20])
def test_qembed_per_block_grads_equal_jax(d):
    """Forward per block over d_model (per tensor when it does not divide);
    the per-block backward scatters the float gradient, token order."""
    rng = np.random.RandomState(d)
    table = _f32(rng, 50, d, scale=0.05)
    tokens = rng.randint(0, 50, (3, 11)).astype(np.int32)
    tokens[1, :5] = tokens[0, 2]
    tokens[2, 4:] = tokens[0, 7]
    ct = _wide(rng, 3, 11, d)
    jy, (jg,) = _jax_vjp(lambda t: jqops.qembed(
        jnp.asarray(tokens), t, jax.random.key(9), JaxPolicy(block=8)),
        (table,), ct)
    ty, (tg,) = _port_vjp(lambda t: tqops.qembed(
        torch.from_numpy(tokens), t, prng.key(9), NumericPolicy(block=8)),
        (table,), ct)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tg, jg)


def test_float_scatter_adds_rows_in_token_order():
    """Row r of the scatter is 0 + g_first + g_second + ... over the
    tokens equal to r, in token order: the reference's order."""
    rng = np.random.RandomState(11)
    g = torch.from_numpy(_wide(rng, 40, 6))
    tokens = torch.from_numpy(rng.randint(0, 5, 40))
    got = tqops._scatter_rows_in_order(g, tokens, 7)
    want = torch.zeros((7, 6))
    for i in range(40):
        want[tokens[i]] = want[tokens[i]] + g[i]
    assert torch.equal(got, want)
