"""Shared model infrastructure: arch config, init, RoPE, cache paging spec.

The port of the parts of ``repro.models.common`` that the dense serving
path uses.  Models are plain functions over a parameter dict whose layer
weights are stacked along a leading ``(L, ...)`` axis, as in the JAX
package; a Python loop over layer slices takes the place of ``lax.scan``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..core.bfp import BFP

__all__ = ["ArchConfig", "CachePageSpec", "dense_init", "rope", "apply_rope",
           "weight_t"]


@dataclasses.dataclass(frozen=True)
class CachePageSpec:
    """How one decode-cache leaf maps onto a block-paged pool: its qcache
    currency, the axis indexing sequences and the axis that grows with
    decoded positions (None for whole-state leaves)."""

    kind: str
    batch_axis: int
    seq_axis: Optional[int] = None


def weight_t(w):
    """Transpose the last two axes of a float32 or per-tensor BFP weight
    (the tied LM head): for a BFP a view of the int8 mantissas."""
    if isinstance(w, BFP):
        return BFP(w.m.transpose(-1, -2), w.e, w.cfg)
    return w.transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One config describes any architecture (fields of
    ``repro.models.common.ArchConfig``)."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    qkv_bias: bool = False
    attn_out_bias: bool = False
    norm: str = "rmsnorm"
    act: str = "silu"
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_shared: bool = False
    capacity_factor: float = 1.25
    block_period: int = 0
    attn_offset: int = 0
    local_window: int = 0
    conv_width: int = 4
    lora_rank: int = 64
    enc_layers: int = 0
    patch_positions: int = 0
    logit_scale: float = 0.0
    attn_chunk: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads


def dense_init(shape: Tuple[int, ...], generator: torch.Generator,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init in [-2, 2] sigma, the JAX package's
    sigma (``1/sqrt(shape[0])`` unless ``scale``).  A leading layer axis
    is the caller's: pass the per-layer shape's fan-in through ``scale``."""
    sigma = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * sigma


def rope(positions: torch.Tensor, dim: int,
         theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions: (..., dim/2) each."""
    freqs = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                    device=positions.device) / dim
                      * math.log(theta))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, D): rotate the two halves; cos/sin (S, D/2) broadcast."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
