"""Load-time weight quantization for serving (from ``repro.core.integer_sgd``).

Only ``quantize_weights_once`` and its stacking rule are ported so far; the
int16 SGD update belongs to the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import prng
from .bfp import BFP, PER_TENSOR, QuantConfig, quantize_weight
from .policy import QW_NONE, QW_STACKED, QW_STACKED2, QW_TENSOR, NumericPolicy

__all__ = ["quantize_weights_once", "tree_items"]

# Leading axes that each get their own scale, per weight-mask marker.
_STACK_AXES = {QW_TENSOR: 0, QW_STACKED: 1, QW_STACKED2: 2}


def tree_items(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
               ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict in ``jax.tree_util`` leaf order
    (keys sorted at every level), so leaf ``i`` here is leaf ``i`` there."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_items(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _k_contiguous(m: torch.Tensor) -> torch.Tensor:
    """Same values, with the contraction (second-to-last, K) axis
    innermost in memory: ``m[..., :, :].transpose(-1, -2)`` is then the
    contiguous (N, K) operand the GEMM kernels read, with no copy."""
    return m.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_weights_once(params: Dict[str, Any], policy: NumericPolicy,
                          key: prng.Key, mask: Dict[str, Any]):
    """Map each masked float32 leaf to a per-tensor (``QW_TENSOR``) or
    per-layer-slice (``QW_STACKED``) BFP exactly once, with the JAX
    package's keys: leaf ``i`` takes ``fold_in(key, i)``, split once more
    per slice of a stack.  Stacked GEMM weights are stored K-innermost
    (see ``_k_contiguous``); the tied embedding keeps its row layout for
    the gather (its transpose is the LM head's (N, K) operand)."""
    if not policy.qweights_on:
        return params
    cfg = QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                      policy.rng)
    out = _copy_tree(params)
    mask_items = dict(tree_items(mask))
    for i, (path, leaf) in enumerate(tree_items(params)):
        mk = mask_items[path]
        if mk == QW_NONE:
            continue
        ki = prng.fold_in(key, i)
        nstack = _STACK_AXES[mk]
        if nstack == 0:
            _set(out, path, quantize_weight(leaf, cfg, ki))
            continue
        lead = leaf.shape[:nstack]
        flat = leaf.reshape((-1,) + tuple(leaf.shape[nstack:]))
        keys = prng.split(ki, flat.shape[0])
        qs = [quantize_weight(flat[j], cfg, keys[j]) for j in range(flat.shape[0])]
        m = torch.stack([q.m for q in qs]).reshape(leaf.shape)
        e = torch.stack([q.e for q in qs]).reshape(lead)
        _set(out, path, BFP(_k_contiguous(m), e, cfg))
    return out


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}
