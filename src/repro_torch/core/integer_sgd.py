"""Integer SGD (int16 masters and momentum) and load-time weight
quantization.

The port of ``repro.core.integer_sgd`` (paper §5 "int16 SGD", Appendix
A.4): master weights and momentum are dynamic fixed-point int16 tensors,
one ``BFP`` (int16 mantissas + a scalar shared exponent) per parameter
leaf, and the update

    v' = mu * v + g + wd * w
    w' = w  - lr * v'

runs entirely in int32 fixed point (``core.fixed_point``) with stochastic
rounding at every rescaling point.  Leaves are walked in ``tree_items``
order (the JAX package's ``tree_flatten`` order), because leaf ``i`` draws
its rounding bits from ``fold_in(key, i)``.  ``quantize_weights_once`` is
the serving path's load-time weight quantization; ``derive_qweights`` and
``qweight_grads`` are the qweights training currency: int8 forward weights
narrowed from the int16 masters once a step in integer arithmetic, each
with a float32 gradient carrier that takes the weight's dW.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from . import prng
from .bfp import (BFP, PER_TENSOR, QuantConfig, biased_exponent, bit_length,
                  dequantize, pow2, quantize, quantize_weight, scale_exponent,
                  sr_shift_signed, storage_dtype)
from .fixed_point import (Fx, KeyGen, fx_add, fx_const, fx_mul, fx_narrow,
                          fx_quantize, fx_sub)
from .policy import QW_NONE, QW_STACKED, QW_STACKED2, QW_TENSOR, NumericPolicy

__all__ = ["IntSGDState", "integer_sgd_init", "integer_sgd_step",
           "master_params_f32", "derive_qweights", "qweight_grads",
           "quantize_weights_once", "tree_items", "tree_map",
           "tree_unflatten"]

# Leading axes that each get their own scale, per weight-mask marker.
_STACK_AXES = {QW_TENSOR: 0, QW_STACKED: 1, QW_STACKED2: 2}


def tree_items(tree, prefix: Tuple[Any, ...] = ()
               ) -> List[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) pairs of nested dicts and lists in ``jax.tree_util``
    leaf order (dict keys sorted, list items by index at every level), so
    leaf ``i`` here is leaf ``i`` there.  A path holds dict keys and list
    indices; any other value is a leaf (a BFP too)."""
    if isinstance(tree, dict):
        kids = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        kids = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    return [item for k, v in kids for item in tree_items(v, prefix + (k,))]


def tree_map(fn, tree):
    """``fn`` on every leaf of nested dicts and lists (a BFP is one leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def _set(tree, path: Tuple[Any, ...], value) -> None:
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
    out = tree_map(lambda v: v, params)
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


# ---------------------------------------------------------------------------
# int16 SGD
# ---------------------------------------------------------------------------

class IntSGDState(NamedTuple):
    masters: Any          # nested dict of BFP (int16)
    momentum: Any         # nested dict of BFP (int16)
    step: torch.Tensor    # int32 scalar


def _fx_from_bfp(q: BFP) -> Fx:
    return Fx(q.m.to(torch.int32), scale_exponent(q.e, q.cfg), q.cfg.bits - 1)


def _fx_to_bfp(a: Fx, cfg: QuantConfig, kg: KeyGen) -> BFP:
    """Narrow an Fx to the master bit width and store it as a BFP."""
    a = fx_narrow(a, cfg.bits - 1, kg)
    e_biased = a.e + 127 + 23 - cfg.base_shift
    return BFP(a.m.to(storage_dtype(cfg.bits)), e_biased.to(torch.int32), cfg)


def tree_unflatten(like, leaves: List[Any]):
    """Nested dicts and lists shaped like ``like`` with ``leaves`` in
    ``tree_items`` order."""
    out = tree_map(lambda v: v, like)
    for (path, _), leaf in zip(tree_items(like), leaves):
        _set(out, path, leaf)
    return out


def integer_sgd_init(params: Dict[str, Any],
                     policy: NumericPolicy = NumericPolicy(),
                     key: Optional[prng.Key] = None) -> IntSGDState:
    """Quantize float32 params to int16 masters (leaf ``i`` with
    ``fold_in(key, 2i)``) and zero momentum (``fold_in(key, 2i + 1)``)."""
    cfg = policy.master_cfg()
    key = prng.key(0) if key is None else key
    masters, moms = [], []
    for i, (_, p) in enumerate(tree_items(params)):
        masters.append(quantize(p, cfg, prng.fold_in(key, 2 * i)))
        moms.append(quantize(torch.zeros_like(p), cfg,
                             prng.fold_in(key, 2 * i + 1)))
    dev = masters[0].m.device
    return IntSGDState(tree_unflatten(params, masters),
                       tree_unflatten(params, moms),
                       torch.zeros((), dtype=torch.int32, device=dev))


def master_params_f32(state: IntSGDState) -> Dict[str, Any]:
    """The float32 compute view of the masters."""
    return tree_map(dequantize, state.masters)


def _narrow_leaf(master: BFP, cfg: QuantConfig, key: prng.Key,
                 nstack: int) -> BFP:
    """Narrow one int16 master to a ``cfg.p``-magnitude-bit BFP in integer
    arithmetic: the bit length of the largest |mantissa| of each slice of
    the ``nstack`` leading axes, one rounded right shift over the whole
    leaf with the leaf's one key, a clip, and the shift added to the
    exponent.  The float32 carrier ``g`` is the result's value, made from
    the narrowed mantissas; a stacked leaf's mantissas are stored
    K-innermost (``_k_contiguous``)."""
    m32 = master.m.to(torch.int32)
    e_master = scale_exponent(master.e, master.cfg)       # scalar, unbiased
    lead = tuple(m32.shape[:nstack])
    bcast = lead + (1,) * (m32.ndim - nstack)
    nb = bit_length(m32.abs().amax(dim=tuple(range(nstack, m32.ndim))))
    shift = (nb - cfg.p).clamp(min=0)                     # shape = lead
    m = sr_shift_signed(m32, shift.reshape(bcast), key, cfg.stochastic,
                        cfg.rng)
    lim = (1 << cfg.p) - 1
    m = m.clamp(-lim, lim).to(storage_dtype(cfg.bits))
    e_new = e_master + shift
    g = m.to(torch.float32) * pow2(e_new).reshape(bcast)
    if nstack:
        m = _k_contiguous(m)
    return BFP(m, biased_exponent(e_new, cfg).to(torch.int32), cfg, g)


def derive_qweights(state: IntSGDState, policy: NumericPolicy,
                    key: prng.Key, mask: Dict[str, Any]) -> Dict[str, Any]:
    """The forward weights of one optimizer step under ``policy.qweights``:
    leaf ``i`` (``tree_items`` order) narrowed from its int16 master with
    ``fold_in(key, i)`` to a per-tensor (``QW_TENSOR``) or per-layer-slice
    (``QW_STACKED``) BFP with a float32 gradient carrier, no float32 value
    on the way; ``QW_NONE`` leaves (norm gains, biases) keep the masters'
    float32 view.  Off (``not policy.qweights_on``): the float32 view of
    every master."""
    if not policy.qweights_on:
        return master_params_f32(state)
    cfg = QuantConfig(policy.fwd_bits, PER_TENSOR, policy.stochastic,
                      policy.rng)
    mask_items = dict(tree_items(mask))
    out = []
    for i, (path, master) in enumerate(tree_items(state.masters)):
        mk = mask_items[path]
        if mk == QW_NONE:
            out.append(dequantize(master))
        else:
            out.append(_narrow_leaf(master, cfg, prng.fold_in(key, i),
                                    _STACK_AXES[mk]))
    return tree_unflatten(state.masters, out)


def qweight_grads(grads: Dict[str, Any]) -> Dict[str, Any]:
    """The float32 gradient tree ``integer_sgd_step`` takes, from a
    qweights gradient tree whose BFP leaves hold their carrier's gradient
    in ``g``."""
    return tree_map(lambda l: l.g if isinstance(l, BFP) else l, grads)


def _update_leaf(master: BFP, mom: BFP, g: torch.Tensor, lr_fx: Fx,
                 mu_fx: Fx, wd_fx: Optional[Fx], key: prng.Key,
                 policy: NumericPolicy):
    cfg = policy.master_cfg()
    kg = KeyGen(key)
    wf = _fx_from_bfp(master)
    vf = _fx_from_bfp(mom)
    gf = fx_quantize(g, cfg.bits, kg())
    v_new = fx_add(fx_mul(mu_fx, vf, kg), gf, kg)
    if wd_fx is not None:
        v_new = fx_add(v_new, fx_mul(wd_fx, wf, kg), kg)
    w_new = fx_sub(wf, fx_mul(lr_fx, v_new, kg), kg)
    return _fx_to_bfp(w_new, cfg, kg), _fx_to_bfp(v_new, cfg, kg)


def integer_sgd_step(state: IntSGDState, grads: Dict[str, Any], lr,
                     key: prng.Key, policy: NumericPolicy = NumericPolicy(),
                     momentum: float = 0.9,
                     weight_decay: float = 0.0) -> IntSGDState:
    """One integer SGD step over a nested dict of float32 gradients.
    ``lr`` (a float or scalar tensor) is quantized to 16-bit fixed point;
    ``momentum`` and ``weight_decay`` are exact 15-bit constants."""
    dev = state.step.device
    kg0 = KeyGen(key)
    lr_fx = fx_quantize(torch.as_tensor(lr, dtype=torch.float32, device=dev),
                        16, kg0())
    mu_fx = fx_const(momentum if momentum else 0.0, device=dev)
    wd_fx = fx_const(weight_decay, device=dev) if weight_decay else None
    grad_leaves = dict(tree_items(grads))
    new_m, new_v = [], []
    for i, ((path, ml), (_, vl)) in enumerate(
            zip(tree_items(state.masters), tree_items(state.momentum))):
        nm, nv = _update_leaf(ml, vl, grad_leaves[path], lr_fx, mu_fx,
                              wd_fx, prng.fold_in(key, i), policy)
        new_m.append(nm)
        new_v.append(nv)
    return IntSGDState(tree_unflatten(state.masters, new_m),
                       tree_unflatten(state.momentum, new_v), state.step + 1)
