"""The int8 GEMM of the unfused rung against the JAX package.

``int8_matmul_plain`` (what the ``int8_matmul`` wrapper runs on the CPU)
is ``==`` the Pallas kernel ``int8_matmul_pallas`` in interpret mode (the
reference's padding to 128 tiles; the port pads nothing), batched too,
with scales that are exact, tiny and flushed to 0; ``ops.int8_matmul_op``
is ``==`` the reference's, and the zero padding of the reference is exact
through the rescale (``tests/test_kernels.py``), per slice of a batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core.bfp import pow2 as jpow2
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul_pallas
from repro_torch.core.bfp import pow2
from repro_torch.kernels import int8_matmul as kim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _i8(rng, *shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


def _pallas(a, b_kn, scale):
    """The reference kernel on zero-padded 128 tiles, sliced back."""
    m, n = a.shape[0], b_kn.shape[1]
    ap = np.pad(a, ((0, -m % 128), (0, -a.shape[1] % 128)))
    bp = np.pad(b_kn, ((0, -b_kn.shape[0] % 128), (0, -n % 128)))
    return np.asarray(int8_matmul_pallas(jnp.asarray(ap), jnp.asarray(bp),
                                         jnp.float32(scale), bm=128, bn=128,
                                         bk=128, interpret=True))[:m, :n]


@pytest.mark.parametrize("e", [-12, -140, -127])
@pytest.mark.parametrize("nb,m,k,n", [(1, 100, 70, 30), (3, 13, 257, 9),
                                      (2, 130, 128, 129)])
def test_plain_equals_pallas_kernel(nb, m, k, n, e):
    rng = np.random.RandomState(m + k + n)
    a, b = _i8(rng, nb, m, k), _i8(rng, nb, n, k)
    scale = np.asarray(jpow2(jnp.int32(e)))
    want = np.stack([_pallas(a[i], b[i].T, scale) for i in range(nb)])
    got = kim.int8_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          pow2(torch.tensor(e)))
    np.testing.assert_array_equal(got.numpy(), want)
    # the port's oracle (b as (K, N)) agrees slice by slice
    for i in range(nb):
        np.testing.assert_array_equal(
            tref.int8_matmul_ref(torch.from_numpy(a[i]),
                                 torch.from_numpy(b[i].T.copy()),
                                 pow2(torch.tensor(e))).numpy(),
            np.asarray(jref.int8_matmul_ref(jnp.asarray(a[i]),
                                            jnp.asarray(b[i].T),
                                            jnp.float32(scale))))


@pytest.mark.parametrize("m,k,n", [(100, 70, 30), (13, 257, 9)])
def test_op_equals_reference_and_padding_exact(m, k, n):
    rng = np.random.RandomState(m + k + n)
    a, b = _i8(rng, m, k), _i8(rng, k, n)
    want = np.asarray(jops.int8_matmul_op(jnp.asarray(a), jnp.asarray(b),
                                          jnp.int32(141), jnp.int32(118),
                                          use_pallas=True))
    exact = (a.astype(np.int32) @ b.astype(np.int32)).astype(np.float32) \
        * np.float32(2.0 ** (141 - 133) * 2.0 ** (118 - 133))
    np.testing.assert_array_equal(want, exact)
    for use_kernel in (True, False):
        got = tops.int8_matmul_op(torch.from_numpy(a), torch.from_numpy(b),
                                  141, 118, use_kernel=use_kernel)
        assert got.shape == (m, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_batched_zero_padding_exact():
    """Zero rows and columns appended to every slice of a batch leave the
    valid region bit-identical (zeros add nothing to an integer sum)."""
    rng = np.random.RandomState(5)
    a, b = _i8(rng, 3, 13, 67), _i8(rng, 3, 9, 67)
    scale = pow2(torch.tensor(-9))
    y = kim.int8_matmul(torch.from_numpy(a), torch.from_numpy(b), scale)
    ap = np.pad(a, ((0, 0), (0, 3), (0, 61)))
    bp = np.pad(b, ((0, 0), (0, 7), (0, 61)))
    yp = kim.int8_matmul(torch.from_numpy(ap), torch.from_numpy(bp), scale)
    np.testing.assert_array_equal(yp[:, :13, :9].numpy(), y.numpy())
    exact = np.einsum("bmk,bnk->bmn", a.astype(np.int64),
                      b.astype(np.int64)).astype(np.float32) * 2.0 ** -9
    np.testing.assert_array_equal(y.numpy(), exact.astype(np.float32))
