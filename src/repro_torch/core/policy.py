"""Numeric policy: one switch selecting float / paper-faithful int / variants.

The port of ``repro.core.policy``; fields, defaults and derived configs
are the same, so a policy means the same arithmetic in both packages.
``kernel_mode`` keeps its meaning: ``"auto"`` takes the hand-written CUDA
kernels for CUDA tensors and the plain mirror of the JAX package's off-TPU
path for CPU tensors; ``"fused"`` takes the kernels' numerics everywhere
(their plain versions on the CPU); ``"jnp"`` forces the plain oracle path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .bfp import PER_TENSOR, QuantConfig

__all__ = ["NumericPolicy", "FLOAT32", "PAPER_INT8", "int_policy",
           "QW_NONE", "QW_TENSOR", "QW_STACKED", "QW_STACKED2",
           "QC_ROWS", "QC_STATE"]

# Weight-mask leaf markers (models/<family>.weight_mask): how a parameter
# leaf takes part in the load-time quantized weight currency.
#   QW_NONE     consumed as float32 (norm gains, biases).
#   QW_TENSOR   GEMM weight with one shared scale for the whole leaf.
#   QW_STACKED  GEMM weight stacked along a leading layer axis: one scale
#               per slice of axis 0.
#   QW_STACKED2 two leading stack axes: one scale per (axis0, axis1) slice.
QW_NONE = 0
QW_TENSOR = 1
QW_STACKED = 2
QW_STACKED2 = 3

# Cache-layout leaf markers (models/<family>.cache_layout).
#   QC_ROWS   append-only rows quantized once when written (KV rows).
#   QC_STATE  accumulator state rewritten every step (master-width rows).
QC_ROWS = "rows"
QC_STATE = "state"


@dataclasses.dataclass(frozen=True)
class NumericPolicy:
    """Static numeric configuration; see ``repro.core.policy`` for the
    meaning of every field."""

    enabled: bool = True
    fwd_bits: int = 8
    bwd_bits: int = 8
    block: int = PER_TENSOR
    stochastic: bool = True
    quantize_norms: bool = True
    quantize_embed: bool = True
    master_bits: int = 16
    accum_chunk: int = 65536
    fused_proj: bool = False
    qflow: bool = False
    qweights: bool = False
    qcache: bool = False
    rng: str = "threefry"
    stochastic_bwd: Optional[bool] = None
    kernel_mode: str = "auto"
    kernel_autotune: bool = False
    health: bool = False

    @property
    def qweights_on(self) -> bool:
        return self.enabled and self.qweights and self.block == PER_TENSOR

    @property
    def qcache_on(self) -> bool:
        return self.enabled and self.qcache and self.block == PER_TENSOR

    def cache_cfg(self, row: int, bits: Optional[int] = None) -> QuantConfig:
        """One shared exponent per cache row, nearest rounding."""
        return QuantConfig(bits or self.fwd_bits, row, False, self.rng)

    def cache_cfg_for(self, kind: str, row: int) -> QuantConfig:
        return self.cache_cfg(row,
                              self.master_bits if kind == QC_STATE else None)

    @property
    def qflow_seams(self) -> bool:
        return self.enabled and self.qflow and self.quantize_norms

    def fwd_cfg(self) -> QuantConfig:
        return QuantConfig(self.fwd_bits, self.block, self.stochastic, self.rng)

    def bwd_cfg(self) -> QuantConfig:
        sb = self.stochastic if self.stochastic_bwd is None else self.stochastic_bwd
        return QuantConfig(self.bwd_bits, self.block, sb, self.rng)

    def master_cfg(self) -> QuantConfig:
        return QuantConfig(self.master_bits, PER_TENSOR, self.stochastic, self.rng)


FLOAT32 = NumericPolicy(enabled=False)
PAPER_INT8 = NumericPolicy()


def int_policy(bits: int = 8, block: int = PER_TENSOR, **kw) -> NumericPolicy:
    """Shorthand used by the bit-width ablation (Table 5)."""
    return NumericPolicy(fwd_bits=bits, bwd_bits=bits, block=block, **kw)
