"""The rounding bits: CUDA kernel + plain version.

Replaces no Pallas kernel: the reference draws its stochastic-rounding
words with ``jax.random.bits`` (``repro.core.bfp.rounding_bits``), which
XLA fuses into the consumer.  ``csrc/rounding_bits.cu`` draws the same
words in one launch: threefry2x32 in either key mode of ``core.prng`` and
the ``"hash"`` stream of ``prng.hash_bits``, as int64 holding uint32
values (``prng.bits``' contract).  The key chains stay on the host; the
key words, and the hash stream's seed word, are kernel arguments.  The
wrapper runs the kernel for a CUDA device and the plain version
(``prng.bits`` / ``prng.hash_bits``) for the CPU, and nothing else: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence

import torch

from ..core import prng
from . import build
from .fused_linear import _raise_on

__all__ = ["rounding_bits", "rounding_bits_plain", "MODES"]

# The kernel's streams, in the order of its C codes.
MODES = ("partitionable", "iota_halves", "hash")


def rounding_bits_plain(key: prng.Key, shape: Sequence[int],
                        rng: str = "threefry", device=None) -> torch.Tensor:
    """Plain version: ``prng.hash_bits`` for ``rng="hash"``, else
    ``prng.bits`` (the key's own mode)."""
    if rng == "hash":
        return prng.hash_bits(key, shape, device)
    return prng.bits(key, shape, device)


def _mode(key: prng.Key, rng: str) -> int:
    if rng == "hash":
        return 2
    return 0 if key.partitionable else 1


def _lib() -> ctypes.CDLL:
    lib = build.load("rounding_bits")
    if not getattr(lib, "_typed", False):
        u = ctypes.c_uint32
        lib.repro_rounding_bits.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, u, u, ctypes.c_int, u,
            ctypes.c_void_p]
        lib.repro_rounding_bits.restype = ctypes.c_int
        lib._typed = True
    return lib


def rounding_bits(key: prng.Key, shape: Sequence[int], rng: str = "threefry",
                  device=None) -> torch.Tensor:
    """``rng``'s uint32 words for ``key`` and ``shape``, as an int64 tensor
    on ``device``: the kernel on a CUDA device, the plain version
    elsewhere."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type != "cuda":
        return rounding_bits_plain(key, shape, rng, device)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    mode = _mode(key, rng)
    if mode == 1 and n >= (1 << 32) - 1:
        raise ValueError(f"rounding_bits: {n} words exceed one iota of the "
                         "non-partitionable key mode")
    seed = prng.word(key) if mode == 2 else 0
    lib = _lib()
    out = torch.empty(shape, dtype=torch.int64, device=device)
    if n == 0:
        return out
    err = lib.repro_rounding_bits(
        ctypes.c_void_p(out.data_ptr()), n, key.k0, key.k1, mode, seed,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _raise_on(err, "rounding_bits")
    rounding_bits.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
rounding_bits.launches = 0
