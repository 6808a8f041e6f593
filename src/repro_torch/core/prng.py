"""Counter-based threefry2x32 keys, bit-equal to ``jax.random``.

Every stochastic-rounding bit of the integer pipeline comes from
``bits(key, shape)`` below, and every op derives its key by ``split`` /
``fold_in`` chains.  The functions reproduce ``jax.random`` under its
defaults (``jax_threefry_partitionable=True``): a key is two uint32 words,
``fold_in(k, d)`` hashes the counter pair ``(0, d)``, ``split(k, n)`` hashes
``(hi(i), lo(i))`` for ``i < n`` and ``bits(k, shape)`` is the XOR of the
two output words of the hash of each element's flat row-major index.  So a
port op fed the same key as its JAX counterpart rounds with the same bits,
and results can be compared with ``==``.

Keys are plain host objects (two Python ints): the chains are walked on
the host, and only ``bits`` touches a device.  torch has little uint32
arithmetic, so the vectorised hash runs in int64 and masks to 32 bits.

A key made with ``partitionable=False`` (and every key derived from it)
follows ``jax_threefry_partitionable=False`` instead, the default of JAX
before 0.5: ``split`` hashes the counters ``(i, n + i)`` and ``bits`` hashes
the halves of ``iota(size)``.  That is how ``tests/goldens`` were drawn.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch

__all__ = ["Key", "key", "split", "fold_in", "bits", "word", "hash_bits"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements hashed per vectorised pass: bounds the int64 temporaries.
_CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class Key:
    """A threefry2x32 key: two uint32 words, as ``jax.random.key_data``."""

    k0: int
    k1: int
    partitionable: bool = True


def key(seed: int, partitionable: bool = True) -> Key:
    """``jax.random.key(seed)`` for a seed in [0, 2^32)."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must be in [0, 2^32), got {seed}")
    return Key(0, seed, partitionable)


def _hash_int(k0: int, k1: int, x0: int, x1: int):
    """threefry2x32 of one counter pair, in Python integers."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _hash_tensor(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 over int64 tensors holding uint32 counter words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0, x1


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for data in [0, 2^32)."""
    return Key(*_hash_int(k.k0, k.k1, 0, int(data) & _M32), k.partitionable)


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)`` as a list of keys."""
    if k.partitionable:
        return [Key(*_hash_int(k.k0, k.k1, i >> 32, i & _M32))
                for i in range(num)]
    words = [_hash_int(k.k0, k.k1, i, num + i) for i in range(num)]
    flat = [w[0] for w in words] + [w[1] for w in words]
    return [Key(flat[2 * i], flat[2 * i + 1], False) for i in range(num)]


def bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as an int64 tensor of uint32
    values on ``device``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    if not k.partitionable:
        # threefry_2x32(k, iota(n)): the first half of the counters against
        # the second (zero-padded to even length), outputs concatenated
        h = (n + 1) // 2
        x0 = torch.arange(h, dtype=torch.int64, device=device)
        x1 = x0 + h
        x1 = torch.where(x1 < n, x1, torch.zeros_like(x1))
        y0, y1 = _hash_tensor(k.k0, k.k1, x0, x1)
        return torch.cat([y0, y1])[:n].reshape(shape)
    for lo in range(0, n, _CHUNK):
        idx = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64,
                           device=device)
        y0, y1 = _hash_tensor(k.k0, k.k1, idx >> 32, idx & _M32)
        out[lo:lo + idx.numel()] = y0 ^ y1
    return out.reshape(shape)


def word(k: Key) -> int:
    """``bits(k, ())`` as a Python int, drawn on the host: the hash of the
    counters (0, 0), its two words XORed (partitionable) or the first."""
    y0, y1 = _hash_int(k.k0, k.k1, 0, 0)
    return y0 ^ y1 if k.partitionable else y0


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """uint32 product ``h * c mod 2^32`` without leaving int64's range."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_bits(k: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """The ``"hash"`` rounding-bit stream of ``repro.core.bfp._hash_bits``:
    one threefry word seeds a multiply-xorshift avalanche over the flat
    element index."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    seed = int(bits(k, (), device="cpu"))
    h = torch.arange(max(n, 1), dtype=torch.int64, device=device) & _M32
    h = _mul32(h, 0x9E3779B1) ^ seed
    h = _mul32(h ^ (h >> 15), 0x85EBCA77)
    h = _mul32(h ^ (h >> 13), 0xC2B2AE3D)
    h = h ^ (h >> 16)
    return h[:n].reshape(shape)
