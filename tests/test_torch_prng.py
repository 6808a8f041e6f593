"""repro_torch.core.prng against jax.random: bits, split and fold_in chains
must be bit-equal (uint32 ==), in both threefry modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.bfp import _hash_bits
from repro_torch.core import prng

SHAPES = [(), (1,), (7,), (3, 5, 17), (257, 129)]


def _kd(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _tk(k: prng.Key):
    return (k.k0, k.k1)


def _pair(seed, partitionable):
    return jax.random.key(seed), prng.key(seed, partitionable=partitionable)


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_equal_jax(shape, partitionable):
    with jax.threefry_partitionable(partitionable):
        jk, tk = _pair(7, partitionable)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.bits(tk, shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("partitionable", [True, False])
def test_split_fold_in_chains_equal_jax(partitionable):
    with jax.threefry_partitionable(partitionable):
        jk, tk = _pair(3, partitionable)
        for n in (1, 2, 3, 4, 5):
            assert [_kd(k) for k in jax.random.split(jk, n)] == \
                [_tk(k) for k in prng.split(tk, n)]
        for d in (0, 1, 0x71, 0x9E, 0xF3, 2 ** 32 - 1):
            assert _kd(jax.random.fold_in(jk, d)) == _tk(prng.fold_in(tk, d))
        # a nested chain as the model walks it: split -> fold_in -> split
        j = jax.random.fold_in(jax.random.split(jk, 4)[2], 11)
        t = prng.fold_in(prng.split(tk, 4)[2], 11)
        j = jax.random.split(jax.random.fold_in(j, 0xE0), 3)[1]
        t = prng.split(prng.fold_in(t, 0xE0), 3)[1]
        assert _kd(j) == _tk(t)
        want = np.asarray(jax.random.bits(j, (5, 9), jnp.uint32))
    np.testing.assert_array_equal(prng.bits(t, (5, 9)).numpy(),
                                  want.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (1,), (33, 7)])
def test_hash_stream_equal_jax(shape):
    jk, tk = _pair(5, True)
    want = np.asarray(_hash_bits(jk, shape)).astype(np.int64)
    np.testing.assert_array_equal(prng.hash_bits(tk, shape).numpy(), want)


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        prng.key(-1)
    with pytest.raises(ValueError):
        prng.key(2 ** 32)
