"""Serving the minicpm smoke config through the whole-layer decode block,
against live JAX.

Prefill 2 prompts x 8 tokens, then 3 decode steps, under
``NumericPolicy(qweights=True, qcache=True, kernel_mode="fused")``: every
decode step runs each layer as one ``qdecode_block`` (the kernel's plain
version here, the Pallas kernel in interpret mode in the JAX package), on
the same weights (JAX init, quantized once at load by each package),
prompts and fed tokens.  Prefill and decode logits are ``==``.  The
port's minicpm-2b config is field for field the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.kernels import dispatch as jkd
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import quantize_serving_params as jax_quantize
from repro.models import get_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps

ARCH, BATCH, PROMPT, GEN = "minicpm_2b", 2, 8, 4


def test_config_equals_jax():
    assert ARCH in ARCH_IDS
    for get in (lambda a: (get_config(a), jax_config(a)),
                lambda a: (torch_smoke_config(a), get_smoke_config(a))):
        mine, ref = get(ARCH)
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_decode_block_serving_equals_live_jax():
    cfg = get_smoke_config(ARCH)
    key = jax.random.key(0)
    params = get_model(cfg).init_params(key, cfg)
    np_params = jax.tree_util.tree_map(np.array, params)
    prompts = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                          (BATCH, PROMPT), 0, cfg.vocab))
    jpol = JaxPolicy(qweights=True, qcache=True, kernel_mode="fused")
    jparams = jax_quantize(params, cfg, jpol, jax.random.fold_in(key, 0x9E))
    prefill = jax.jit(jax_prefill_step(cfg, jpol, PROMPT + GEN))
    decode = jax.jit(jax_decode_step(cfg, jpol))
    with jkd.record_decisions() as jlog:
        cache, lg = prefill(jparams, {"tokens": jnp.asarray(prompts)},
                            jax.random.fold_in(key, 3))
        want, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
        for i in range(GEN - 1):
            lg, cache = decode(jparams, cache,
                               jnp.asarray(toks[-1], jnp.int32),
                               jnp.int32(PROMPT + i),
                               jax.random.fold_in(key, 10 + i))
            want.append(np.asarray(lg))
            toks.append(np.asarray(jnp.argmax(lg, -1)))
    assert any(d.op == "qdecode_block" and d.path == jkd.FUSED for d in jlog)

    tcfg = torch_smoke_config(ARCH)
    policy = NumericPolicy(qweights=True, qcache=True, kernel_mode="fused")
    tkey = prng.key(0)
    tparams = tsteps.quantize_serving_params(
        params_from_numpy(np_params, "cpu"), tcfg, policy,
        prng.fold_in(tkey, 0x9E))
    tprefill = tsteps.make_prefill_step(tcfg, policy, PROMPT + GEN, "cpu")
    tdecode = tsteps.make_decode_step(tcfg, policy, "cpu")
    with kd.record_decisions() as log, torch.inference_mode():
        tcache, tlg = tprefill(tparams, {"tokens": torch.from_numpy(prompts)},
                               prng.fold_in(tkey, 3))
        got = [tlg.numpy()]
        for i in range(GEN - 1):
            tlg, tcache = tdecode(tparams, tcache, torch.tensor(toks[i]),
                                  PROMPT + i, prng.fold_in(tkey, 10 + i))
            got.append(tlg.numpy())
    blocks = [d for d in log if d.op == "qdecode_block"]
    assert len(blocks) == (GEN - 1) * cfg.n_layers
    assert all(d.path == kd.FUSED for d in blocks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
