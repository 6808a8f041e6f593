"""Decoder-only transformer, dense family: serving forward passes.

The port of the dense path of ``repro.models.transformer``: integer
embedding, integer RMS/LayerNorm, quantized Q/K/V/O and gated-MLP
projections, chunked attention at prefill and decode attention over the
(int8) KV cache.  Softmax, SiLU and RoPE stay float32 (paper §5).  Layer
weights are stacked along a leading ``(L, ...)`` axis; a Python loop over
layer slices replaces ``lax.scan``.  Keys follow the JAX package's
``split``/``fold_in`` chain, so with the same parameters and key the two
packages compute on the same rounding bits.  MoE, the qflow seams and the
whole-layer decode kernel are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..core import prng
from ..core.bfp import BFP, storage_dtype
from ..core.policy import (QC_ROWS, QW_NONE, QW_STACKED, QW_TENSOR,
                           NumericPolicy)
from ..core.qnorm import qlayernorm, qrmsnorm
from ..core.qops import qcache_append, qcache_prefill, qembed, qmatmul
from .attention import chunked_attention, decode_attention
from .common import (ArchConfig, CachePageSpec, apply_rope, dense_init, rope,
                     weight_t)

__all__ = ["init_params", "weight_mask", "cache_layout", "cache_page_spec",
           "init_cache", "forward_hidden", "prefill", "decode_step"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _check_family(cfg: ArchConfig):
    if cfg.family != "dense" or cfg.moe_experts:
        raise NotImplementedError(f"family {cfg.family!r} is not ported")


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` (truncated
    normal with the JAX package's sigmas; the draws differ from
    ``jax.random``).  Layer weights are stacked on a leading L axis."""
    _check_family(cfg)
    d, hd, hq, hkv, ff, L = (cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_ff, cfg.n_layers)

    def w(fan_in, *shape):
        return dense_init((L, *shape), generator, 1.0 / math.sqrt(fan_in),
                          device)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    layers = {
        "ln1_g": full((L, d), 1.0), "ln2_g": full((L, d), 1.0),
        "wq": w(d, d, hq * hd), "wk": w(d, d, hkv * hd),
        "wv": w(d, d, hkv * hd), "wo": w(hq * hd, hq * hd, d),
        "w_gate": w(d, d, ff), "w_up": w(d, d, ff), "w_down": w(ff, ff, d),
    }
    if cfg.norm == "layernorm":
        layers["ln1_b"] = full((L, d), 0.0)
        layers["ln2_b"] = full((L, d), 0.0)
    if cfg.qkv_bias:
        layers["bq"] = full((L, hq * hd), 0.0)
        layers["bk"] = full((L, hkv * hd), 0.0)
        layers["bv"] = full((L, hkv * hd), 0.0)
    params = {
        "layers": layers,
        "embed": dense_init((cfg.vocab, d), generator, 0.02, device),
        "fn_g": full((d,), 1.0),
    }
    if cfg.norm == "layernorm":
        params["fn_b"] = full((d,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init((d, cfg.vocab), generator, None, device)
    return params


def weight_mask(cfg: ArchConfig) -> Dict[str, Any]:
    """Which leaves become load-time-quantized BFP weights: GEMM weights
    (one scale per layer slice for the stacks); gains and biases stay
    float32."""
    layers = {"ln1_g": QW_NONE, "ln2_g": QW_NONE, "wq": QW_STACKED,
              "wk": QW_STACKED, "wv": QW_STACKED, "wo": QW_STACKED,
              "w_gate": QW_STACKED, "w_up": QW_STACKED, "w_down": QW_STACKED}
    if cfg.norm == "layernorm":
        layers["ln1_b"] = layers["ln2_b"] = QW_NONE
    if cfg.qkv_bias:
        layers["bq"] = layers["bk"] = layers["bv"] = QW_NONE
    mask = {"layers": layers, "embed": QW_TENSOR, "fn_g": QW_NONE}
    if cfg.norm == "layernorm":
        mask["fn_b"] = QW_NONE
    if not cfg.tie_embeddings:
        mask["lm_head"] = QW_TENSOR
    return mask


def cache_layout(cfg: ArchConfig):
    """KV rows are append-only: quantized once when written."""
    return {"k": QC_ROWS, "v": QC_ROWS}


def cache_page_spec(cfg: ArchConfig):
    """K/V leaves are (L, B, Hkv, T, hd): sequences on axis 1, positions
    on axis 3."""
    spec = CachePageSpec(QC_ROWS, batch_axis=1, seq_axis=3)
    return {"k": spec, "v": spec}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               policy: Optional[NumericPolicy] = None, device=None,
               dtype=torch.bfloat16):
    """Zero cache (L, B, Hkv, T, hd); int8 rows + row exponents under
    ``policy.qcache``."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    if policy is not None and policy.qcache_on:
        ccfg = policy.cache_cfg(cfg.hd)

        def mk():
            return BFP(torch.zeros(shape, dtype=storage_dtype(ccfg.bits),
                                   device=device),
                       torch.ones(shape[:-1] + (1,), dtype=torch.int32,
                                  device=device), ccfg)
        return {"k": mk(), "v": mk()}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _layer_slice(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: (BFP(v.m[i], v.e[i], v.cfg) if isinstance(v, BFP) else v[i])
            for k, v in layers.items()}


def _norm(x, g, b, key, policy, cfg):
    if cfg.norm == "layernorm":
        return qlayernorm(x, g, b, key, policy)
    return qrmsnorm(x, g, key, policy)


def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)                # (B, H, S, D)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _attn_block(h, lp, key, policy, cfg, *, positions, kv=None, pos=None):
    """Self-attention: prefill when ``kv`` is None, else decode against the
    cache (updated in place)."""
    kq, ka, ko = prng.split(key, 3)
    q = qmatmul(h, lp["wq"], prng.fold_in(kq, 0), policy)
    k = qmatmul(h, lp["wk"], prng.fold_in(kq, 1), policy)
    v = qmatmul(h, lp["wv"], prng.fold_in(kq, 2), policy)
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = _heads(q, cfg.n_heads, cfg.hd)
    k = _heads(k, cfg.n_kv_heads, cfg.hd)
    v = _heads(v, cfg.n_kv_heads, cfg.hd)
    cos, sin = rope(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if kv is None:
        o = chunked_attention(q, k, v, ka, policy, causal=True,
                              window=cfg.local_window,
                              chunk=cfg.attn_chunk or 1024)
        new_kv = (k, v)
    else:
        kc, vc = kv
        if isinstance(kc, BFP):
            kc = qcache_append(kc, k, pos, axis=2)
            vc = qcache_append(vc, v, pos, axis=2)
            o = decode_attention(q, kc, vc, pos, ka, policy,
                                 window=cfg.local_window)
        else:
            kc[:, :, pos:pos + 1] = k.to(kc.dtype)
            vc[:, :, pos:pos + 1] = v.to(vc.dtype)
            o = decode_attention(q, kc.to(torch.float32),
                                 vc.to(torch.float32), pos, ka, policy,
                                 window=cfg.local_window)
        new_kv = (kc, vc)
    return qmatmul(_unheads(o), lp["wo"], ko, policy), new_kv


def _mlp_block(h, lp, key, policy, cfg):
    k1, k2, k3 = prng.split(key, 3)
    gate = qmatmul(h, lp["w_gate"], k1, policy)
    up = qmatmul(h, lp["w_up"], k2, policy)
    if cfg.act == "silu":
        act = gate * torch.sigmoid(gate) * up
    else:
        act = torch.nn.functional.gelu(gate, approximate="tanh") * up
    return qmatmul(act, lp["w_down"], k3, policy)


def _layer(h, lp, key, policy, cfg, *, positions, kv=None, pos=None):
    if policy.enabled and (policy.fused_proj or policy.qflow):
        raise NotImplementedError("fused_proj / qflow seams are not ported yet")
    kn1, kattn, kn2, kmlp = prng.split(key, 4)
    hn = _norm(h, lp["ln1_g"], lp.get("ln1_b"), kn1, policy, cfg)
    a, new_kv = _attn_block(hn, lp, kattn, policy, cfg, positions=positions,
                            kv=kv, pos=pos)
    h = h + a
    hn = _norm(h, lp["ln2_g"], lp.get("ln2_b"), kn2, policy, cfg)
    return h + _mlp_block(hn, lp, kmlp, policy, cfg), new_kv


# ---------------------------------------------------------------------------
# full passes
# ---------------------------------------------------------------------------

def _lm_logits(params, h, key, policy, cfg):
    head = weight_t(params["embed"]) if cfg.tie_embeddings else params["lm_head"]
    return qmatmul(h, head, key, policy)


def forward_hidden(params, tokens: torch.Tensor, key: prng.Key,
                   policy: NumericPolicy, cfg: ArchConfig,
                   collect_kv: bool = False):
    """Causal full-sequence pass -> (hidden, per-layer (k, v) or None)."""
    _check_family(cfg)
    b, s = tokens.shape
    h = qembed(tokens, params["embed"], prng.fold_in(key, 0xE0), policy)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    kvs = []
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        h, kv = _layer(h, lp, prng.fold_in(key, i), policy, cfg,
                       positions=positions)
        if collect_kv:
            kvs.append(kv)
    h = _norm(h, params["fn_g"], params.get("fn_b"), prng.fold_in(key, 0xF1),
              policy, cfg)
    return h, (kvs if collect_kv else None)


def prefill(params, tokens: torch.Tensor, key: prng.Key,
            policy: NumericPolicy, cfg: ArchConfig, max_len: int):
    """Populate the cache from a prompt -> (cache, last-token logits).
    Under ``policy.qcache`` the K/V rows are quantized exactly once here."""
    b, s = tokens.shape
    h, kvs = forward_hidden(params, tokens, key, policy, cfg, collect_kv=True)
    k = torch.stack([kv[0] for kv in kvs])                # (L, B, Hkv, S, hd)
    v = torch.stack([kv[1] for kv in kvs])
    del kvs
    pad = max_len - s
    if policy.qcache_on:
        cache = {"k": qcache_prefill(k, pad, policy),
                 "v": qcache_prefill(v, pad, policy)}
    else:
        pads = (0, 0, 0, pad)
        cache = {"k": torch.nn.functional.pad(k.to(torch.bfloat16), pads),
                 "v": torch.nn.functional.pad(v.to(torch.bfloat16), pads)}
    logits = _lm_logits(params, h[:, -1:], prng.fold_in(key, 0xF3), policy,
                        cfg)
    return cache, logits[:, 0]


def decode_step(params, cache, token: torch.Tensor, pos: int, key: prng.Key,
                policy: NumericPolicy, cfg: ArchConfig):
    """One decode step: token (B,), pos int -> (logits (B, V), cache).
    The cache is updated in place: one row per layer at ``pos``."""
    _check_family(cfg)
    h = qembed(token[:, None], params["embed"], prng.fold_in(key, 0xE0),
               policy)
    positions = torch.full((1,), pos, dtype=torch.int32, device=token.device)
    for i in range(cfg.n_layers):
        lp = _layer_slice(params["layers"], i)
        kc, vc = cache["k"], cache["v"]
        if isinstance(kc, BFP):
            kv = (BFP(kc.m[i], kc.e[i], kc.cfg), BFP(vc.m[i], vc.e[i], vc.cfg))
        else:
            kv = (kc[i], vc[i])
        h, _ = _layer(h, lp, prng.fold_in(key, i), policy, cfg,
                      positions=positions, kv=kv, pos=pos)
    h = _norm(h, params["fn_g"], params.get("fn_b"), prng.fold_in(key, 0xF1),
              policy, cfg)
    logits = _lm_logits(params, h, prng.fold_in(key, 0xF2), policy, cfg)
    return logits[:, 0], cache
