"""Shared model infrastructure: arch config, init, RoPE, activations, the
loss, cache paging spec.

The port of the parts of ``repro.models.common`` that the dense serving
and training paths use.  Models are plain functions over a parameter dict whose layer
weights are stacked along a leading ``(L, ...)`` axis, as in the JAX
package; a Python loop over layer slices takes the place of ``lax.scan``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import fmath
from ..core.bfp import BFP

__all__ = ["ArchConfig", "CachePageSpec", "dense_init", "rope", "apply_rope",
           "weight_t", "add_bias", "glu_act", "softmax_xent"]


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


@functools.lru_cache(maxsize=1)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("expf", "sinf", "cosf"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return lib


def _libm_map(name: str, x: np.ndarray) -> np.ndarray:
    fn = getattr(_libm(), name)
    return np.array([fn(float(v)) for v in x.ravel()],
                    dtype=np.float32).reshape(x.shape)


@functools.lru_cache(maxsize=16)
def _rope_tables(n: int, dim: int, theta: float, device: torch.device):
    """cos/sin for positions 0..n-1, made on the host, kept on ``device``
    as ordinary tensors (not inference tensors, even when first asked for
    under ``torch.inference_mode``: training saves them for backward)."""
    freqs = _libm_map("expf", (-np.arange(0, dim, 2, dtype=np.float32)
                               / np.float32(dim))
                      * np.float32(math.log(theta)))
    ang = np.arange(n, dtype=np.float32)[:, None] * freqs
    with torch.inference_mode(False):
        return (torch.from_numpy(_libm_map("cosf", ang)).to(device),
                torch.from_numpy(_libm_map("sinf", ang)).to(device))


def rope(start: int, length: int, dim: int, theta: float,
         device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for positions ``start .. start+length-1``: (length,
    dim/2) each.  The tables are the C library's float32 expf, cosf and
    sinf, as the reference's CPU build evaluates them (torch's kernels
    differ by an ulp at some angles).  Each position's row depends on that
    position alone, so one table per device, grown by powers of two,
    serves every call as a slice: no host sync and no copy per call."""
    n = max(1024, 1 << (start + length - 1).bit_length())
    cos, sin = _rope_tables(n, dim, float(theta), torch.device(device))
    return cos[start:start + length], sin[start:start + length]


class _Rope(torch.autograd.Function):
    """The rotation with the reference's fused multiply-adds, forward and
    backward (``core.fmath``)."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        x1, x2 = x.chunk(2, dim=-1)
        ctx.save_for_backward(cos, sin)
        return torch.cat([fmath.fma(x1, cos, -(x2 * sin)),
                          fmath.fma(x2, cos, x1 * sin)], dim=-1)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        g1, g2 = g.chunk(2, dim=-1)
        d1 = fmath.fma(g2, sin, g1 * cos)
        d2 = fmath.fma(g2, cos, -(g1 * sin))
        return torch.cat([d1, d2], dim=-1), None, None


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, D): rotate the two halves; cos/sin (S, D/2) broadcast."""
    return _Rope.apply(x, cos, sin)


class _AddBias(torch.autograd.Function):
    """x (..., N) + b (N,); db sums the leading axes in the reference's
    order."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.lead = x.ndim - 1
        return x + b

    @staticmethod
    def backward(ctx, g):
        return g, fmath.sum_windows(g, range(ctx.lead))


def add_bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _AddBias.apply(x, b)


class _SiluGlu(torch.autograd.Function):
    """silu(gate) * up, silu = gate * logistic(gate), with the reference's
    rounding (``core.fmath``) forward and backward."""

    @staticmethod
    def forward(ctx, up, gate):
        s = fmath.logistic(gate)
        act = gate * s
        ctx.save_for_backward(up, gate, s, act)
        return act * up

    @staticmethod
    def backward(ctx, g):
        up, gate, s, act = ctx.saved_tensors
        g_act = g * up
        d_gate = fmath.fma(g_act, s, (g_act * gate) * (s * (1.0 - s)))
        return g * act, d_gate


class _GeluGlu(torch.autograd.Function):
    """gelu(gate) * up with ``jax.nn.gelu``'s tanh form and the reference's
    rounding (``core.fmath``) forward and backward."""

    @staticmethod
    def forward(ctx, up, gate):
        act = fmath.gelu(gate)
        ctx.save_for_backward(up, gate, act)
        return act * up

    @staticmethod
    def backward(ctx, g):
        up, gate, act = ctx.saved_tensors
        return g * act, fmath.gelu_pullback(gate, g * up)


def glu_act(up: torch.Tensor, gate: torch.Tensor, act: str) -> torch.Tensor:
    """act(gate) * up."""
    if act == "silu":
        return _SiluGlu.apply(up, gate)
    if act == "gelu":
        return _GeluGlu.apply(up, gate)
    if act == "relu":
        return torch.relu(gate) * up
    raise ValueError(act)


class _SoftmaxXent(torch.autograd.Function):
    """Mean next-token cross entropy over all positions, float32, with the
    reference's exp, log and sum order (``core.fmath``)."""

    @staticmethod
    def forward(ctx, logits, labels):
        m = logits.amax(dim=-1, keepdim=True)
        e = fmath.exp(logits - m)
        s = fmath.sum_windows(e, (-1,))
        lse = fmath.log(s) + m[..., 0]
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        nll = lse - gold
        n = nll.numel()
        ctx.save_for_backward(e, s, labels)
        ctx.n = n
        # XLA's mean: the fused sum times the float32 reciprocal of n
        rows = nll.reshape(-1, nll.shape[-1])
        return fmath.sum_fused_2d(rows) * float(np.float32(1.0 / n))

    @staticmethod
    def backward(ctx, g):
        e, s, labels = ctx.saved_tensors
        gn = (g / ctx.n).expand(s.shape)
        d_sum = gn / s
        onehot = torch.zeros_like(e).scatter_(-1, labels[..., None].long(),
                                              (-gn)[..., None])
        return fmath.fma(d_sum[..., None], e, onehot), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE over every position; stays float (the paper
    keeps softmax in float)."""
    return _SoftmaxXent.apply(logits.to(torch.float32), labels)
