"""qflow serving on the CPU against the JAX package.

The policy is ``PAPER_INT8`` with ``qflow``, ``qweights`` and ``qcache``:
BFP activations between layers, weights quantized once at load, an int8
KV cache.  The smoke qwen2 prefills 2 prompts x 8 tokens and decodes 4
greedy tokens through ``make_prefill_step`` / ``make_decode_step`` of both
packages on the same numpy weights carried across by ``convert``: every
logit and token ``==`` live JAX, under ``auto`` (the attention scans) and
under ``fused`` (the kernels' plain versions against Pallas in interpret
mode; the projections after a norm and the LM head of kind pp, the
attention on ``attn_fwd`` and ``attn_decode``).

The attention keys of ``tests/goldens/attention_pr4.npz`` that qflow
reaches, drawn in the old key mode: ``chunked_qflow_g{q,k,v}``,
``local_qflow`` and ``decode_qcache_qflow`` ``==`` the goldens;
``chunked_qflow`` ``==`` live JAX (jax 0.9 itself misses that golden, by
at most 2.4e-7, an older XLA's float order).  And ``qembed(out_q=True)``
of a per-block float table.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro.core import qops as jqops
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.launch import steps as jsteps
from repro.models import get_model
from repro.models.attention import chunked_attention as jchunked
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng, qops
from repro_torch.core.policy import PAPER_INT8, NumericPolicy
from repro_torch.core.qops import qcache_quantize
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from repro_torch.models.attention import (cache_decode_attention,
                                          chunked_attention, local_attention)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "tests", "goldens", "attention_pr4.npz")
ARCH, BATCH, PROMPT, GEN = "qwen2_0_5b", 2, 8, 4
QFLOW = dict(qflow=True, qweights=True, qcache=True)


def _jax_serve(mode):
    """Live JAX: init params and prompts, then prefill and GEN - 1 greedy
    decode steps.  Returns (numpy params, prompts, logits, tokens)."""
    cfg = get_smoke_config(ARCH)
    jpol = dataclasses.replace(JAX_INT8, kernel_mode=mode, **QFLOW)
    key = jax.random.key(0)
    params = get_model(cfg).init_params(key, cfg)
    np_params = jax.tree_util.tree_map(np.array, params)
    prompts = np.array(jax.random.randint(jax.random.fold_in(key, 1),
                                          (BATCH, PROMPT), 0, cfg.vocab))
    jparams = jsteps.quantize_serving_params(params, cfg, jpol,
                                             jax.random.fold_in(key, 0x9E))
    prefill = jax.jit(jsteps.make_prefill_step(cfg, jpol, PROMPT + GEN))
    decode = jax.jit(jsteps.make_decode_step(cfg, jpol))
    cache, lg = prefill(jparams, {"tokens": jnp.asarray(prompts)},
                        jax.random.fold_in(key, 3))
    logits = [np.asarray(lg)]
    for i in range(GEN - 1):
        lg, cache = decode(jparams, cache,
                           jnp.asarray(logits[-1].argmax(-1), jnp.int32),
                           jnp.int32(PROMPT + i),
                           jax.random.fold_in(key, 10 + i))
        logits.append(np.asarray(lg))
    return np_params, prompts, logits, np.stack(
        [lg.argmax(-1) for lg in logits], axis=1)


def _port_serve(np_params, prompts, mode):
    cfg = torch_smoke_config(ARCH)
    policy = dataclasses.replace(PAPER_INT8, kernel_mode=mode, **QFLOW)
    key = prng.key(0)
    params = tsteps.quantize_serving_params(
        params_from_numpy(np_params, "cpu"), cfg, policy,
        prng.fold_in(key, 0x9E))
    prefill = tsteps.make_prefill_step(cfg, policy, PROMPT + GEN, "cpu")
    decode = tsteps.make_decode_step(cfg, policy, "cpu")
    cache, lg = prefill(params, {"tokens": torch.from_numpy(prompts)},
                        prng.fold_in(key, 3))
    logits = [lg.numpy()]
    for i in range(GEN - 1):
        lg, cache = decode(params, cache,
                           torch.from_numpy(logits[-1].argmax(-1)),
                           PROMPT + i, prng.fold_in(key, 10 + i))
        logits.append(lg.numpy())
    return logits


@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_qflow_serving_equals_live_jax(mode):
    np_params, prompts, want, want_toks = _jax_serve(mode)
    with kd.record_decisions() as log:
        got = _port_serve(np_params, prompts, mode)
    np.testing.assert_array_equal(
        np.stack([g.argmax(-1) for g in got], axis=1), want_toks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fused = {(d.op, d.kind) for d in log if d.path == kd.FUSED}
    if mode == "auto":
        assert fused == set()
    else:
        assert {("qmatmul_fwd", "pp"), ("qmatmul_fwd", "qi"),
                ("attn_fwd", "pp"), ("attn_decode", "pp")} <= fused, fused


def _rand(shape, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_attention_goldens_under_qflow():
    g = np.load(GOLDENS)
    qf = dataclasses.replace(PAPER_INT8, qflow=True)
    key = prng.key(7, partitionable=False)
    qn, kn, vn = (_rand((2, 4, 24, 16), 1), _rand((2, 2, 24, 16), 2),
                  _rand((2, 2, 24, 16), 3))
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (qn, kn, vn))
    o = chunked_attention(q, k, v, key, qf, chunk=8)
    grads = torch.autograd.grad((o ** 2).sum(), [q, k, v])
    for name, got in zip(("gq", "gk", "gv"), grads):
        np.testing.assert_array_equal(got.numpy(), g[f"chunked_qflow_{name}"])
    with jax.threefry_partitionable(False):
        want = np.asarray(jchunked(jnp.asarray(qn), jnp.asarray(kn),
                                   jnp.asarray(vn), jax.random.key(7),
                                   dataclasses.replace(JAX_INT8, qflow=True),
                                   chunk=8))
    np.testing.assert_array_equal(o.detach().numpy(), want)
    assert np.abs(want - g["chunked_qflow"]).max() <= 2.4e-7
    np.testing.assert_array_equal(
        local_attention(q, k, v, key, qf, window=8).detach().numpy(),
        g["local_qflow"])
    qc = dataclasses.replace(PAPER_INT8, qcache=True)
    q1 = torch.from_numpy(_rand((2, 4, 1, 16), 4))
    kq = qcache_quantize(torch.from_numpy(_rand((2, 2, 24, 16), 5)), qc)
    vq = qcache_quantize(torch.from_numpy(_rand((2, 2, 24, 16), 6)), qc)
    np.testing.assert_array_equal(
        cache_decode_attention(q1, kq, vq, 11, key,
                               dataclasses.replace(qc, qflow=True)).numpy(),
        g["decode_qcache_qflow"])


def test_qembed_q_per_block_table_equals_jax():
    """``_qembed_q`` under a per-block policy (blocks of 8 along D = 24):
    each row's exponents are gathered with it; values, mantissas,
    exponents and dTable ``==`` ``jax.vjp`` of the reference's."""
    rng = np.random.RandomState(8)
    table = _rand((19, 24), 8, 0.02)
    ct = rng.randn(3, 7, 24).astype(np.float32)
    tokens = rng.randint(0, 19, size=(3, 7)).astype(np.int32)
    tokens[1, :2] = 5
    jpol, tpol = JaxPolicy(block=8), NumericPolicy(block=8)

    def jfn(table):
        y = jqops.qembed(jnp.asarray(tokens), table, jax.random.key(2), jpol,
                         out_q=True)
        return y.g, (y.m, y.e)

    jy, vjp, (jm, je) = jax.vjp(jfn, jnp.asarray(table), has_aux=True)
    jd, = vjp(jnp.asarray(ct))
    tt = torch.from_numpy(table).requires_grad_(True)
    y = qops.qembed(torch.from_numpy(tokens).long(), tt, prng.key(2), tpol,
                    out_q=True)
    td, = torch.autograd.grad(y.g, [tt], torch.from_numpy(ct))
    np.testing.assert_array_equal(y.g.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(y.m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(y.e.numpy(), np.asarray(je))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
