"""Float32 SGD with momentum (the paper's float baseline) and the WSD
learning-rate schedule.

The port of the parts of ``repro.optim.optimizers`` that the trainer
uses: the float twin of ``core.integer_sgd``, over nested dicts of
tensors, and ``wsd_schedule``.  Both round as the reference's XLA CPU
build does (``core.fmath``): float32 throughout, a multiply feeding an add
contracted into one fused multiply-add.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..core import fmath
from ..core.integer_sgd import tree_items, tree_map, tree_unflatten

__all__ = ["SGDState", "sgd_init", "sgd_step", "wsd_schedule"]


class SGDState(NamedTuple):
    momentum: Any
    step: int


def sgd_init(params: Dict[str, Any]) -> SGDState:
    return SGDState(tree_map(torch.zeros_like, params), 0)


def sgd_step(state: SGDState, params: Dict[str, Any], grads: Dict[str, Any],
             lr: float, momentum: float = 0.9, weight_decay: float = 0.0):
    """v' = mu v + g + wd w, w' = w - lr v'.  -> (state', params')."""
    ws = [w for _, w in tree_items(params)]
    gs = [g for _, g in tree_items(grads)]
    vs = [fmath.fma(weight_decay, w, fmath.fma(momentum, v, g))
          for (_, v), g, w in zip(tree_items(state.momentum), gs, ws)]
    new_p = [fmath.fma(-lr, v, w) for w, v in zip(ws, vs)]
    return (SGDState(tree_unflatten(state.momentum, vs), state.step + 1),
            tree_unflatten(params, new_p))


def wsd_schedule(step: int, base_lr: float, warmup_steps: int,
                 stable_steps: int, decay_steps: int,
                 final_frac: float = 0.1) -> float:
    """MiniCPM warmup-stable-decay, evaluated in float32 as the reference's
    compiled schedule evaluates it on its int32 step: its XLA build turns
    a division by a constant c into a multiply by the float32 ``1 / c``,
    folds ``base_lr * (1 / warmup)`` into one constant, and contracts ``1 - (1 - final_frac) * frac`` into
    one fused multiply-add.  Returns that float32 value."""
    f = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    s = f(step)
    if step < warmup_steps:
        return float(s * (f(base_lr) * (f(1.0) / f(max(warmup_steps, 1)))))
    frac = ((s - f(warmup_steps + stable_steps))
            * (f(1.0) / f(max(decay_steps, 1)))).clamp(0.0, 1.0)
    return float(fmath.fma(-(1.0 - final_frac), frac, 1.0) * f(base_lr))
