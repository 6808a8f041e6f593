"""Deterministic synthetic data: every token from (seed, step, host).

A copy of ``repro.data.pipeline``'s generators (numpy's Philox with the
same counters), so a step's batch is the same array in both packages and a
restarted job resumes by passing the step.

  * ``SyntheticLM``: a noisy affine bigram walk, x_{t+1} = (a x_t + b + eps)
    mod V: learnable structure, so loss curves measure learning.
  * ``UniformLM``: i.i.d. tokens for throughput runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "UniformLM"]


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    """Noisy affine bigram stream: x_{t+1} = (a*x_t + b + eps) mod V."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    a: int = 31
    b: int = 7
    noise: int = 3          # eps in [0, noise)
    n_hosts: int = 1
    host: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of n_hosts {self.n_hosts}")
        return self.global_batch // self.n_hosts

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.host, 0, 0]))
        b, s, v = self.host_batch, self.seq_len, self.vocab
        x0 = rng.integers(0, v, size=(b,), dtype=np.int64)
        eps = rng.integers(0, max(self.noise, 1), size=(b, s), dtype=np.int64)
        toks = np.empty((b, s + 1), np.int64)
        toks[:, 0] = x0
        for t in range(s):
            toks[:, t + 1] = (self.a * toks[:, t] + self.b + eps[:, t]) % v
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class UniformLM:
    """i.i.d. tokens (throughput runs; nothing to learn)."""

    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host: int = 0

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[step, self.host, 0, 1]))
        b, s = self.host_batch, self.seq_len
        toks = rng.integers(0, self.vocab, size=(b, s + 1), dtype=np.int64)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
