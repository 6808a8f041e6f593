"""Step builders: the integer train step, its float32 twin, and the
serving steps.

The port of ``repro.launch.steps``.  ``make_train_step`` is the paper's
full integer pipeline: dequantize the int16 masters -> integer forward ->
A.2 integer backward (``torch.autograd``) -> optionally microbatched
gradients -> int16 SGD update.  ``make_float_train_step`` is the float32
baseline.  A step is a plain function over (state, inputs, key); there is
nothing to compile.  Keys fold as in the JAX package: ``fold_in(key, 1)``
for the loss, ``fold_in(key, 2)`` for the SGD update.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..core import prng
from ..core.integer_sgd import (IntSGDState, integer_sgd_step,
                                master_params_f32, quantize_weights_once,
                                tree_items, tree_map, tree_unflatten)
from ..core.policy import FLOAT32, NumericPolicy
from ..device import resolve_device
from ..models.common import ArchConfig
from ..models.registry import get_model, get_weight_mask
from ..optim import sgd_step

__all__ = ["TrainHyper", "make_train_step", "make_float_train_step",
           "make_prefill_step", "make_decode_step", "quantize_serving_params"]


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    lr: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 0.0
    microbatch: int = 1          # gradient-accumulation splits of the batch
    schedule: Optional[Callable[[int], float]] = None   # step -> lr
    # "threefry2x32" only: the JAX package's other choice, "unsafe_rbg",
    # is the TPU's hardware generator and has no counterpart here.
    rng_impl: str = "threefry2x32"


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _grad_fn(mod, cfg: ArchConfig, policy: NumericPolicy):
    """``vg(params, batch, key) -> (loss, grads)``: the loss and the
    gradient of every parameter leaf (zeros for a leaf the loss does not
    reach, as ``jax.value_and_grad`` gives)."""
    if policy.qweights_on:
        raise NotImplementedError(
            "qweights training (derive_qweights, qweight_grads) is not "
            "ported yet: ROADMAP queue 1, qweights training")

    def vg(params, batch, key):
        leaves = [p.detach().requires_grad_(True)
                  for _, p in tree_items(params)]
        loss = mod.loss_fn(tree_unflatten(params, leaves), batch, key,
                           policy, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)

    return vg


def _accum_grads(vg, params, batch: Dict[str, torch.Tensor], key: prng.Key,
                 n_micro: int):
    """Microbatches in order; loss and grads averaged in float32."""
    loss_acc = torch.zeros((), dtype=torch.float32)
    g_acc = None
    for i in range(n_micro):
        mb = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
              for k, v in batch.items()}
        loss, g = vg(params, mb, prng.fold_in(key, i))
        loss_acc = loss_acc.to(loss.device) + loss
        if g_acc is None:
            g_acc = tree_map(torch.zeros_like, g)
        g_acc = tree_unflatten(g_acc, [a + b for (_, a), (_, b) in
                                       zip(tree_items(g_acc), tree_items(g))])
    scale = 1.0 / n_micro
    return loss_acc * scale, tree_map(lambda x: x * scale, g_acc)


def _to_device(batch, dev: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _lr(hyper: TrainHyper, step: torch.Tensor) -> float:
    return hyper.schedule(int(step)) if hyper.schedule else hyper.lr


def _check_hyper(hyper: TrainHyper):
    if hyper.rng_impl != "threefry2x32":
        raise ValueError(f"rng_impl={hyper.rng_impl!r} is the TPU's hardware "
                         "generator; the port draws threefry2x32 bits only")


def make_train_step(cfg: ArchConfig, policy: NumericPolicy,
                    hyper: TrainHyper = TrainHyper(), device=None):
    """Integer pipeline train step on ``device`` (None: the card):
    ``(IntSGDState, batch, key) -> (state, loss)``."""
    _check_hyper(hyper)
    if policy.health:
        raise NotImplementedError(
            "the numeric-health report and supervisor are not ported yet: "
            "ROADMAP queue 1, robustness")
    mod = get_model(cfg)
    vg = _grad_fn(mod, cfg, policy)
    dev = resolve_device(device)

    def train_step(state: IntSGDState, batch, key: prng.Key):
        batch = _to_device(batch, dev)
        params = master_params_f32(state)
        kf = prng.fold_in(key, 1)
        if hyper.microbatch > 1:
            loss, grads = _accum_grads(vg, params, batch, kf, hyper.microbatch)
        else:
            loss, grads = vg(params, batch, kf)
        state = integer_sgd_step(state, grads, _lr(hyper, state.step),
                                 prng.fold_in(key, 2), policy,
                                 momentum=hyper.momentum,
                                 weight_decay=hyper.weight_decay)
        return state, loss

    return train_step


def make_float_train_step(cfg: ArchConfig, hyper: TrainHyper = TrainHyper(),
                          device=None):
    """Float32 baseline twin: ``((params, SGDState), batch, key) ->
    ((params, SGDState), loss)``."""
    _check_hyper(hyper)
    mod = get_model(cfg)
    vg = _grad_fn(mod, cfg, FLOAT32)
    dev = resolve_device(device)

    def train_step(carry, batch, key: prng.Key):
        params, opt = carry
        batch = _to_device(batch, dev)
        if hyper.microbatch > 1:
            loss, grads = _accum_grads(vg, params, batch, key, hyper.microbatch)
        else:
            loss, grads = vg(params, batch, key)
        opt, params = sgd_step(opt, params, grads, _lr(hyper, opt.step),
                               hyper.momentum, hyper.weight_decay)
        return (params, opt), loss

    return train_step


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig, policy: NumericPolicy, max_len: int,
                      device=None):
    """``prefill_step(params, {"tokens": (B, S)}, key) -> (cache, logits)``
    on ``device`` (None: the card)."""
    mod = get_model(cfg)
    dev = resolve_device(device)

    def prefill_step(params, batch, key: prng.Key):
        tokens = batch["tokens"].to(dev)
        return mod.prefill(params, tokens, key, policy, cfg, max_len)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: NumericPolicy, device=None):
    """``decode_step(params, cache, token (B,), pos, key) -> (logits,
    cache)`` on ``device`` (None: the card); the cache is updated in
    place."""
    mod = get_model(cfg)
    dev = resolve_device(device)

    def decode_step(params, cache, token, pos: int, key: prng.Key):
        return mod.decode_step(params, cache, token.to(dev), int(pos), key,
                               policy, cfg)

    return decode_step


def quantize_serving_params(params, cfg: ArchConfig, policy: NumericPolicy,
                            key: prng.Key):
    """Quantize a float32 parameter tree once at model load: every GEMM
    weight the arch declares becomes a persistent BFP leaf."""
    return quantize_weights_once(params, policy, key, get_weight_mask(cfg))
