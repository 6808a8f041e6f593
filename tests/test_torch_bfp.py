"""repro_torch.core.bfp against repro.core.bfp: mantissas and exponents
``==`` for stochastic and nearest rounding, per tensor and per row, with
sub-normals and zeros; the inverse mapping and pow2 ``==``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfp as jb
from repro_torch.core import bfp as tb
from repro_torch.core import prng


def _data(seed=0, shape=(37, 64)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * np.exp2(rng.randint(-140, 20, shape))
         ).astype(np.float32)
    x[0, :5] = 0.0
    x[1, :3] = np.float32(1e-42)            # sub-normal
    x[2, 0] = -0.0
    x[3, :] = np.float32(-3e-39)            # a row of sub-normals
    return x


CONFIGS = [(bits, block, stochastic, "threefry") for bits in (4, 8, 16)
           for block in (0, 16) for stochastic in (True, False)] + \
    [(8, 0, True, "hash"), (8, 16, True, "hash")]


@pytest.mark.parametrize("bits,block,stochastic,rng_name", CONFIGS)
def test_quantize_equal_jax(bits, block, stochastic, rng_name):
    x = _data(bits + block)
    cj = jb.QuantConfig(bits, block, stochastic, rng_name)
    ct = tb.QuantConfig(bits, block, stochastic, rng_name)
    qj = jb.quantize(jnp.asarray(x), cj, jax.random.key(3))
    qt = tb.quantize(torch.from_numpy(x), ct, prng.key(3))
    np.testing.assert_array_equal(qt.m.numpy(), np.asarray(qj.m))
    np.testing.assert_array_equal(qt.e.numpy(), np.asarray(qj.e))
    assert qt.m.numpy().dtype == np.asarray(qj.m).dtype
    np.testing.assert_array_equal(tb.dequantize(qt).numpy(),
                                  np.asarray(jb.dequantize(qj)))


def test_pow2_flushes_below_min_normal():
    e = np.arange(-140, 130, dtype=np.int32)
    np.testing.assert_array_equal(tb.pow2(torch.from_numpy(e)).numpy(),
                                  np.asarray(jb.pow2(jnp.asarray(e))))
    assert tb.pow2(torch.tensor(-127)).item() == 0.0


@pytest.mark.parametrize("shift", [0, 17, 32, 40])
@pytest.mark.parametrize("stochastic", [True, False])
def test_sr_shift_signed_equal_jax(shift, stochastic):
    v = np.random.RandomState(1).randint(-2 ** 30, 2 ** 30, 301).astype(np.int32)
    want = jb.sr_shift_signed(jnp.asarray(v), shift, jax.random.key(2),
                              stochastic)
    got = tb.sr_shift_signed(torch.from_numpy(v), shift, prng.key(2),
                             stochastic)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bit_length_equal_jax():
    v = np.array([0, 1, 2, 3, 255, 256, 2 ** 30, 2 ** 31 - 1], np.int32)
    np.testing.assert_array_equal(tb.bit_length(torch.from_numpy(v)).numpy(),
                                  np.asarray(jb.bit_length(jnp.asarray(v))))


def test_stochastic_rounding_needs_a_key():
    with pytest.raises(ValueError):
        tb.quantize(torch.ones(4), tb.QuantConfig(), None)
