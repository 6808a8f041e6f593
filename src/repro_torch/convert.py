"""Convert a JAX-package parameter tree, given as numpy arrays, to the port.

Float leaves become float32 tensors; a quantized (BFP) leaf is given as an
``(m, e)`` pair of numpy arrays and becomes a ``core.bfp.BFP`` with the
given config.  Stacked (3-D) mantissas are stored K-innermost, as
``core.integer_sgd.quantize_weights_once`` stores them.  This module reads
numpy only: the caller does the ``np.asarray`` on the JAX side.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.bfp import BFP, QuantConfig
from .core.integer_sgd import _k_contiguous
from .device import resolve_device

__all__ = ["params_from_numpy"]


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
