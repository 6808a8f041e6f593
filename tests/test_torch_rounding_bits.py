"""The rounding-bit draw of the port: where it runs, and its plain version.

``core.bfp.rounding_bits`` is the single source of stochastic-rounding
words.  On the CPU, and inside ``dispatch.plain_kernels()``, it is
``prng.bits`` / ``prng.hash_bits``; on a CUDA device it is the
``rounding_bits`` kernel (``csrc/rounding_bits.cu``), whose build or
launch failure raises and never falls back.  The kernel against its plain
version is in ``test_torch_kernels_cuda.py`` (on the card); here the route
rule, the failure, and the plain draw across a chunk boundary ``==``
``jax.random.bits`` in both key modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bfp import _hash_bits
from repro_torch.core import bfp, prng
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import rounding_bits as krb


@pytest.fixture
def recorders(monkeypatch):
    """Stand-ins for the kernel and its plain version that record each
    call (this machine has no card)."""
    calls = []

    def fake(name):
        def draw(key, shape, rng="threefry", device=None):
            calls.append((name, tuple(shape), rng, str(device)))
            return torch.zeros(shape, dtype=torch.int64)
        return draw

    monkeypatch.setattr(krb, "rounding_bits", fake("kernel"))
    monkeypatch.setattr(krb, "rounding_bits_plain", fake("plain"))
    return calls


def test_cpu_draw_is_the_plain_version(recorders):
    k = prng.fold_in(prng.key(5), 2)
    assert torch.equal(bfp.rounding_bits(k, (3, 7)), prng.bits(k, (3, 7)))
    assert torch.equal(bfp.rounding_bits(k, (3, 7), "hash", "cpu"),
                       prng.hash_bits(k, (3, 7)))
    assert recorders == []


def test_card_draw_is_the_kernel_but_inside_plain_kernels(recorders):
    k = prng.key(1)
    bfp.rounding_bits(k, (4, 5), "threefry", "cuda")
    bfp.rounding_bits(k, (9,), "hash", torch.device("cuda", 0))
    with kd.plain_kernels():
        bfp.rounding_bits(k, (4, 5), "threefry", "cuda")
    assert recorders == [("kernel", (4, 5), "threefry", "cuda"),
                         ("kernel", (9,), "hash", "cuda:0"),
                         ("plain", (4, 5), "threefry", "cuda")]


def test_failed_build_raises_and_counts_nothing(monkeypatch):
    def broken(name):
        raise RuntimeError(f"kernel build failed: {name}")

    monkeypatch.setattr(krb.build, "load", broken)
    before = kd.kernel_launches()["rounding_bits"]
    with pytest.raises(RuntimeError, match="rounding_bits"):
        krb.rounding_bits(prng.key(0), (8,), device="cuda")
    with pytest.raises(RuntimeError, match="build failed"):
        bfp.rounding_bits(prng.key(0), (8,), device="cuda")
    assert kd.kernel_launches()["rounding_bits"] == before


def test_wrapper_on_cpu_is_the_plain_version():
    k = prng.fold_in(prng.key(9), 4)
    for kk in (k, prng.Key(k.k0, k.k1, False)):
        for rng in ("threefry", "hash"):
            assert torch.equal(krb.rounding_bits(kk, (5, 3), rng, "cpu"),
                               krb.rounding_bits_plain(kk, (5, 3), rng))
    assert kd.kernel_launches()["rounding_bits"] == 0


@pytest.mark.parametrize("partitionable", [True, False])
def test_plain_bits_across_chunks_equal_jax(monkeypatch, partitionable):
    """``prng.bits`` cut into chunks of 64 words (its ``_CHUNK``, 2^24
    otherwise) against ``jax.random.bits``; ``prng.word`` against a scalar
    draw."""
    monkeypatch.setattr(prng, "_CHUNK", 64)
    for seed, shape in ((3, (5, 37)), (11, (64,)), (12, (129,))):
        with jax.threefry_partitionable(partitionable):
            jk = jax.random.fold_in(jax.random.key(seed), 6)
            want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
            word = int(np.asarray(jax.random.bits(jk, (), jnp.uint32)))
            hashed = np.asarray(_hash_bits(jk, shape))
        tk = prng.fold_in(prng.key(seed, partitionable=partitionable), 6)
        np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                      want.astype(np.int64))
        np.testing.assert_array_equal(prng.hash_bits(tk, shape).numpy(),
                                      hashed.astype(np.int64))
        assert prng.word(tk) == word
