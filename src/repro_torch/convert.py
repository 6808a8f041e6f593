"""Carry JAX-package parameters and training state, given as numpy
arrays, to the port and back.

Float leaves become float32 tensors; a quantized (BFP) leaf is given as an
``(m, e)`` pair of numpy arrays and becomes a ``core.bfp.BFP`` with the
given config.  Stacked (3-D) mantissas are stored K-innermost, as
``core.integer_sgd.quantize_weights_once`` stores them.  A training state
(``IntSGDState``) travels as the flat list of ``jax.tree_util.tree_leaves``:
every master's int16 mantissas and int32 exponent in parameter-tree order,
then the momentum's, then the step.  This module reads numpy only: the
caller does the ``np.asarray`` on the JAX side.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .core.bfp import BFP, QuantConfig
from .core.integer_sgd import (IntSGDState, _k_contiguous, tree_items,
                               tree_unflatten)
from .core.policy import NumericPolicy
from .device import resolve_device

__all__ = ["params_from_numpy", "state_from_numpy", "state_leaves_numpy"]


def _leaf(x, device, qcfg: QuantConfig):
    if isinstance(x, tuple):
        m, e = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in x)
        if m.ndim == 3:
            m = _k_contiguous(m)
        return BFP(m, e.to(torch.int32), qcfg)
    return torch.from_numpy(np.asarray(x, dtype=np.float32)).to(device)


def params_from_numpy(tree: Dict[str, Any], device=None,
                      qcfg: QuantConfig = QuantConfig()) -> Dict[str, Any]:
    """Map a nested dict of numpy leaves (or ``(m, e)`` pairs) onto
    ``device`` (None: the card)."""
    dev = resolve_device(device)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else _leaf(v, dev, qcfg)
                for k, v in t.items()}

    return walk(tree)


def state_from_numpy(leaves: List[np.ndarray], like: Dict[str, Any],
                     device=None, policy: NumericPolicy = NumericPolicy()
                     ) -> IntSGDState:
    """A JAX ``IntSGDState``'s ``tree_leaves`` -> the port's state on
    ``device`` (None: the card).  ``like`` is any tree with the parameter
    tree's structure (for example the parameters)."""
    dev = resolve_device(device)
    cfg = policy.master_cfg()
    n = len(tree_items(like))
    if len(leaves) != 4 * n + 1:
        raise ValueError(f"expected {4 * n + 1} leaves for {n} parameters, "
                         f"got {len(leaves)}")
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in leaves]

    def bfps(lo):
        return tree_unflatten(like, [BFP(t[lo + 2 * i], t[lo + 2 * i + 1], cfg)
                                     for i in range(n)])

    return IntSGDState(bfps(0), bfps(2 * n), t[4 * n].to(torch.int32))


def state_leaves_numpy(state: IntSGDState) -> List[np.ndarray]:
    """The port's state -> the flat leaf list of ``jax.tree_util.tree_leaves``
    of the same JAX state."""
    out = []
    for tree in (state.masters, state.momentum):
        for _, q in tree_items(tree):
            out += [q.m.cpu().numpy(), q.e.cpu().numpy()]
    return out + [state.step.cpu().numpy()]
