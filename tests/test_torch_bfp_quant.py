"""The standalone quantizer of the unfused rung against the JAX package.

``bfp_quantize_plain`` (what the ``bfp_quantize`` wrapper runs on the CPU)
is ``==`` the Pallas kernel ``bfp_quantize_pallas`` in interpret mode, at
odd shapes (the reference pads rows to 8 and lanes to 128; the port pads
nothing) and at the edge values: zeros, sub-normals, values that round
past 127 and clamp, and elements 32 and more binades below their row's
exponent.  ``ops.quantize_op`` per tensor and per row block is ``==`` the
reference's ``quantize_op(use_pallas=True)`` from the same key (the port
draws the bits with ``core.prng``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bfp_quant import bfp_quantize_pallas
from repro_torch.core import prng
from repro_torch.kernels import bfp_quant as kbq
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _edge_values(seed, m, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, n).astype(np.float32)
    x[0, : n // 2] = 0.0
    x[0, n // 2] = -0.0
    x[1 % m] *= np.float32(2.0 ** -140)                 # sub-normal row
    x[2 % m] = np.clip(x[2 % m], -0.5, 0.5)
    x[2 % m, 0] = np.float32(1.0 - 2.0 ** -24)          # rounds to 128 -> 127
    x[3 % m, 0] = np.float32(2.0 ** 40)                 # the rest: s >= 32
    return x


def _pad(a, rows, cols, value=0):
    return np.pad(a, ((0, -a.shape[0] % rows), (0, -a.shape[1] % cols)),
                  constant_values=value)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("shape", [(13, 100), (37, 67), (5, 3), (16, 256)])
def test_plain_equals_pallas_kernel(shape, per_row):
    m, n = shape
    x = _edge_values(m + n, m, n)
    rand = np.array(jax.random.bits(jax.random.key(m * n), (m, n),
                                    jnp.uint32))
    eff = np.asarray(jref.max_biased_exp_ref(jnp.asarray(x),
                                             axis=1 if per_row else None))
    e_rows = np.broadcast_to(eff, (m,)).astype(np.int32)
    # the reference's own padding: exponent-1 rows, zero lanes
    want = np.asarray(bfp_quantize_pallas(
        jnp.asarray(_pad(x, 8, 128)), jnp.asarray(_pad(rand, 8, 128)),
        jnp.asarray(_pad(e_rows[:, None], 8, 1, value=1)), block_rows=8,
        interpret=True))[:m, :n]
    got = kbq.bfp_quantize(torch.from_numpy(x),
                           torch.from_numpy(rand.astype(np.int64)),
                           torch.from_numpy(e_rows.copy()))
    np.testing.assert_array_equal(got.numpy(), want)
    # bits handed over as int32 (as the kernel wrappers pass them)
    got32 = kbq.bfp_quantize_plain(torch.from_numpy(x),
                                   torch.from_numpy(rand.view(np.int32)),
                                   torch.from_numpy(e_rows.copy()))
    np.testing.assert_array_equal(got32.numpy(), want)
    if per_row and m > 2:                # row 2's largest clamps at 127
        assert want[2, 0] == 127
    # the port's oracle agrees too
    np.testing.assert_array_equal(
        tref.bfp_quantize_ref(torch.from_numpy(x),
                              torch.from_numpy(rand.astype(np.int64)),
                              torch.from_numpy(e_rows.copy())[:, None]).numpy(),
        want)


@pytest.mark.parametrize("per_tensor,block_rows,shape", [
    (True, 8, (13, 100)), (True, 8, (64, 128)), (False, 8, (64, 128)),
    (False, 16, (64, 128)), (False, 8, (13, 100))])
def test_quantize_op_equals_reference(per_tensor, block_rows, shape):
    m, n = shape
    rng = np.random.RandomState(m)
    x = (rng.randn(m, n) * np.repeat(2.0 ** np.arange(-(-m // 8)), 8)[:m, None]
         ).astype(np.float32)
    want_m, want_e = jops.quantize_op(jnp.asarray(x), jax.random.key(3),
                                      per_tensor=per_tensor, use_pallas=True,
                                      interpret=True, block_rows=block_rows)
    for use_kernel in (True, False):
        got_m, got_e = tops.quantize_op(torch.from_numpy(x), prng.key(3),
                                        per_tensor=per_tensor,
                                        use_kernel=use_kernel,
                                        block_rows=block_rows)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))


def test_per_row_block_needs_a_whole_block():
    with pytest.raises(ValueError, match="block_rows"):
        tops.quantize_op(torch.zeros((5, 4)), prng.key(0), per_tensor=False)
