"""The CNN's two fused float sums against ``jax.jit`` of the reference's
expressions: the global average pool (``fmath.mean_hw``, the fused
``relu(h + sc).mean(axis=(1, 2))``) at pool sizes 16, 32, 48 and 64, where
XLA vectorizes the loop over H into 8 lanes (16), keeps it scalar (32) or
sums windows of 32 x 32 whose 2 x 2 grid it adds as 2 lanes (48, 64); and
the loss mean (``fmath.sum_rows_1d`` inside ``log_softmax_nll``) at batch
20-23, where a 4-lane epilogue follows the 8-lane loop.  Several seeds a
size: one draw can hide an order that differs.  Each ``==``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import fmath
from repro_torch.models.common import log_softmax_nll

POOL_SEEDS = 4
LOSS_SEEDS = 20


@jax.jit
def _jax_pool(a, b):
    return jax.nn.relu(a + b).mean(axis=(1, 2))


@pytest.mark.parametrize("h", [16, 32, 48, 64])
def test_mean_hw_equal_xla(h):
    for seed in range(POOL_SEEDS):
        rng = np.random.RandomState(1000 * seed + h)
        a, b = (rng.randn(8, h, h, 16).astype(np.float32) for _ in range(2))
        ct = rng.randn(8, 16).astype(np.float32)
        jy = np.asarray(_jax_pool(a, b))
        jg = np.asarray(jax.vjp(lambda a: _jax_pool(a, b), a)[1](ct)[0])
        at = torch.from_numpy(a).requires_grad_(True)
        ty = fmath.mean_hw(torch.relu(at + torch.from_numpy(b)))
        ty.backward(torch.from_numpy(ct))
        np.testing.assert_array_equal(ty.detach().numpy(), jy)
        np.testing.assert_array_equal(at.grad.numpy(), jg)


@pytest.mark.parametrize("batch", [20, 21, 22, 23])
def test_loss_mean_equal_xla(batch):
    for seed in range(LOSS_SEEDS):
        rng = np.random.RandomState(1000 * seed + batch)
        x = (3 * rng.randn(batch, 10)).astype(np.float32)
        labels = rng.randint(0, 10, batch).astype(np.int32)

        def jloss(x):
            logp = jax.nn.log_softmax(x)
            return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                        axis=1).mean()

        want = float(jax.jit(jloss)(x))
        got = float(log_softmax_nll(torch.from_numpy(x),
                                    torch.from_numpy(labels)))
        assert got == want, (seed, got, want)
