"""``serve("starcoder2_7b", qcache=True, device="cpu")`` against live JAX:
prefill 2 prompts x 8 tokens and 4 greedy tokens of the smoke config
(LayerNorm, QKV bias, grouped KV heads, GELU-GLU) with int8 weights
quantized once at load and an int8 KV cache.  The JAX side takes the
same float weights (the port's ``torch.Generator(0)`` init) and prompts,
and the trainer's keys; tokens and every logit ``==``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro.launch import steps as jsteps
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import get_model as torch_model

ARCH, SEED = "starcoder2_7b", 0


def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return t.numpy()


def test_serve_equals_live_jax():
    batch, prompt, gen = 2, 8, 4
    toks, stats = tserve.serve(ARCH, batch=batch, prompt_len=prompt,
                               gen=gen, qcache=True, device="cpu",
                               quiet=True)
    cfg_t = torch_smoke_config(ARCH)
    params = torch_model(cfg_t).init_params(
        cfg_t, torch.Generator().manual_seed(SEED), torch.device("cpu"))
    prompts = torch.randint(0, cfg_t.vocab, (batch, prompt),
                            generator=torch.Generator().manual_seed(SEED + 1))
    cfg = get_smoke_config(ARCH)
    jpol = dataclasses.replace(JAX_INT8, qweights=True, qcache=True)
    key = jax.random.key(SEED)
    jparams = jsteps.quantize_serving_params(
        jax.tree_util.tree_map(jnp.asarray, _tree_np(params)), cfg, jpol,
        jax.random.fold_in(key, 0x9E))
    prefill = jax.jit(jsteps.make_prefill_step(cfg, jpol, prompt + gen))
    decode = jax.jit(jsteps.make_decode_step(cfg, jpol))
    cache, lg = prefill(jparams, {"tokens": jnp.asarray(prompts.numpy())},
                        jax.random.fold_in(key, 3))
    want = [np.asarray(lg)]
    for i in range(gen - 1):
        lg, cache = decode(jparams, cache,
                           jnp.asarray(want[-1].argmax(-1), jnp.int32),
                           jnp.int32(prompt + i),
                           jax.random.fold_in(key, 10 + i))
        want.append(np.asarray(lg))
    np.testing.assert_array_equal(
        toks.numpy(), np.stack([w.argmax(-1) for w in want], axis=1))
    for got, w in zip(stats["logits"], want):
        np.testing.assert_array_equal(got.numpy(), w)
