"""Batched serving driver: prefill a prompt batch, then decode greedily.

The port of ``repro.launch.serve.serve``.  With the int8 policy the GEMM
weights are quantized exactly once at load (``qweights``, the default) and
``--qcache`` keeps the KV cache as int8 rows written once at append time.
On the card every contraction runs on the hand-written kernels
(``kernels.fused_linear``) and decode attention on the fused decode kernel
(``kernels.fused_attention``); with ``--qcache`` a dense layer without
QKV bias (minicpm-2b) decodes as one ``decode_block`` launch
(``kernels.fused_chain``).  Weights are random, from a seeded
``torch.Generator``.

    PYTHONPATH=src python -m repro_torch.launch.serve --full --qcache \\
        --batch 4 --prompt-len 128 --gen 32
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core import prng
from ..core.policy import FLOAT32, PAPER_INT8, NumericPolicy
from ..device import resolve_device, synchronize
from ..models.common import ArchConfig
from ..models.registry import get_model
from .steps import make_decode_step, make_prefill_step, quantize_serving_params

__all__ = ["ServeConfigError", "POLICIES", "validate_request",
           "serving_policy", "load_params", "serve", "main"]

POLICIES = {"int8": PAPER_INT8, "float32": FLOAT32}


class ServeConfigError(ValueError):
    """A serving request that can never run; ``main`` exits cleanly."""


def validate_request(arch: str, policy_name: str, *, batch: int,
                     prompt_len: int, gen: int, qcache: bool = False) -> None:
    if arch not in ARCH_IDS:
        raise ServeConfigError(f"unknown or unported arch {arch!r}; "
                               f"ported: {ARCH_IDS}")
    if policy_name not in POLICIES:
        raise ServeConfigError(f"unknown policy {policy_name!r}; choose "
                               f"from {sorted(POLICIES)}")
    if batch < 1 or prompt_len < 1 or gen < 1:
        raise ServeConfigError(
            f"batch, prompt_len and gen must be >= 1, got batch={batch} "
            f"prompt_len={prompt_len} gen={gen}")
    if qcache and not POLICIES[policy_name].enabled:
        raise ServeConfigError(
            "--qcache quantizes decode caches, which needs an integer "
            "policy; drop --qcache or use --policy int8")


def serving_policy(policy_name: str, *, qweights: bool = True,
                   qcache: bool = False) -> NumericPolicy:
    policy = POLICIES[policy_name]
    if policy.enabled:
        policy = dataclasses.replace(policy, qweights=qweights, qcache=qcache)
    return policy


def load_params(cfg: ArchConfig, policy: NumericPolicy, seed: int,
                device: torch.device):
    """Random weights from ``torch.Generator(seed)``, quantized once at
    load under ``policy.qweights`` (key ``fold_in(key(seed), 0x9E)``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = get_model(cfg).init_params(cfg, gen, device)
    if policy.qweights_on:
        params = quantize_serving_params(params, cfg, policy,
                                         prng.fold_in(prng.key(seed), 0x9E))
    return params


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, policy_name: str = "int8",
          seed: int = 0, qweights: bool = True, qcache: bool = False,
          device=None, quiet: bool = False):
    """Prefill ``batch`` random prompts and decode ``gen`` tokens greedily
    on ``device`` (None: the card).  Returns (tokens (B, gen) int64,
    stats); ``stats["logits"]`` holds the prefill logits and each decode
    step's, on the device."""
    validate_request(arch, policy_name, batch=batch, prompt_len=prompt_len,
                     gen=gen, qcache=qcache)
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    policy = serving_policy(policy_name, qweights=qweights, qcache=qcache)
    key = prng.key(seed)
    params = load_params(cfg, policy, seed, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len),
                            generator=torch.Generator().manual_seed(seed + 1))
    max_len = prompt_len + gen
    prefill_fn = make_prefill_step(cfg, policy, max_len, dev)
    decode_fn = make_decode_step(cfg, policy, dev)

    with torch.inference_mode():
        synchronize(dev)
        t0 = time.perf_counter()
        cache, logits = prefill_fn(params, {"tokens": prompts},
                                   prng.fold_in(key, 3))
        tok = logits.argmax(dim=-1)
        synchronize(dev)
        t_prefill = time.perf_counter() - t0
        all_logits, out_tokens = [logits], [tok]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = decode_fn(params, cache, tok, prompt_len + i,
                                      prng.fold_in(key, 10 + i))
            tok = logits.argmax(dim=-1)
            all_logits.append(logits)
            out_tokens.append(tok)
        synchronize(dev)
        t_decode = time.perf_counter() - t0
    steps = max(gen - 1, 1)
    stats = {"prefill_s": t_prefill, "decode_s": t_decode,
             "decode_ms_per_step": 1e3 * t_decode / steps,
             "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
             "qweights": policy.qweights_on, "qcache": policy.qcache_on,
             "device": str(dev), "logits": all_logits}
    toks = torch.stack(out_tokens, dim=1).cpu()
    if not quiet:
        print(f"arch={cfg.name} policy={policy_name} batch={batch} "
              f"qweights={policy.qweights_on} qcache={policy.qcache_on} "
              f"device={dev}")
        print(f"prefill: {prompt_len} toks x {batch} in {t_prefill:.3f}s")
        print(f"decode: {gen - 1} steps in {t_decode:.3f}s "
              f"({stats['tok_per_s']:.1f} tok/s, "
              f"{stats['decode_ms_per_step']:.2f} ms/step)")
    return toks, stats


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_0_5b")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    default=True, help="the published config, not SMOKE")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--policy", default="int8", choices=list(POLICIES))
    ap.add_argument("--per-call-weights", dest="qweights",
                    action="store_false", default=True,
                    help="re-quantize f32 weights inside every GEMM instead "
                         "of once at model load")
    ap.add_argument("--qcache", action="store_true", default=False,
                    help="int8 KV rows written once at append time, read "
                         "directly by decode attention")
    args = ap.parse_args(argv)
    try:
        toks, _ = serve(args.arch, smoke=args.smoke, batch=args.batch,
                        prompt_len=args.prompt_len, gen=args.gen,
                        policy_name=args.policy, qweights=args.qweights,
                        qcache=args.qcache)
    except ServeConfigError as err:
        ap.exit(2, f"error: {err}\n")
    print("tokens:", np.asarray(toks).tolist())


if __name__ == "__main__":
    main()
