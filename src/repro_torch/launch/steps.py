"""Serving steps: prefill and decode closures, load-time weight quantization.

The port of the serving half of ``repro.launch.steps``.  A step is a plain
function over (params, inputs, key); there is nothing to compile.
"""

from __future__ import annotations

from ..core import prng
from ..core.integer_sgd import quantize_weights_once
from ..core.policy import NumericPolicy
from ..device import resolve_device
from ..models.common import ArchConfig
from ..models.registry import get_model, get_weight_mask

__all__ = ["make_prefill_step", "make_decode_step", "quantize_serving_params"]


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
