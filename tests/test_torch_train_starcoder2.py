"""starcoder2 (LayerNorm, QKV bias, GELU-GLU, grouped KV heads) against
live JAX, on the smoke config.

* Two steps (2 x 16 tokens of ``SyntheticLM(seed=0)``) under
  ``replace(PAPER_INT8, fused_proj=True,
  kernel_mode="fused")`` with ``d_ff=128`` (the reference plans its GLU
  epilogue only on halves of whole TPU lanes): the merged gate|up GEMM and
  its GELU-GLU run as one ``gemm_epi`` (its plain version here, the Pallas
  kernel in interpret mode in the JAX package); the QKV bias keeps the
  merged QKV ``qmatmul`` in place of the norm chain in both packages.
  Both start from the trainer's initial state and take its keys; every
  int16 master and momentum leaf ``==``, and the two decision logs hold
  the same (op, kind, path) triples.
* Losses within ``LOSS_ULPS`` (the order of the reference's vectorized
  loss mean, PERF.md §6).
* The port's starcoder2-7b config is field for field the JAX package's.

``test_torch_train_starcoder2_int8.py`` holds the ``int8`` trainer and
``test_torch_serve_starcoder2.py`` serving, each a file of its own (one
compiled JAX step each).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro.core import integer_sgd as jsgd
from repro.kernels import dispatch as jkd
from repro.launch import steps as jsteps
from repro.models import get_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core import prng
from repro_torch.core.policy import PAPER_INT8
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH, BATCH, SEQ, SEED, D_FF = "starcoder2_7b", 2, 16, 0, 128
# The loss mean's order is LLVM's vectorizer choice for the fused loop XLA
# builds around it, which the port does not follow (PERF.md §6).
LOSS_ULPS = 2
LEAVES = 69                 # masters and momenta, biases and LayerNorm shifts


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def _jax_steps(cfg, pol, init, steps):
    key = jax.random.key(SEED)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jsgd.integer_sgd_init(
            get_model(cfg).init_params(key, cfg), pol, key=key)))
    state = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in init])
    step = jax.jit(jsteps.make_train_step(
        cfg, pol, jsteps.TrainHyper(lr=0.05, momentum=0.9)))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    losses = []
    with jkd.record_decisions() as log:
        for i in range(steps):
            batch = {k: jnp.asarray(v)
                     for k, v in ds.batch_for_step(i).items()}
            state, loss = step(state, batch, jax.random.fold_in(key, i))
            losses.append(float(loss))
    return (losses, [np.asarray(a) for a in jax.tree_util.tree_leaves(state)],
            log)


def _assert_equal(losses, leaves, jlosses, jleaves):
    assert len(leaves) == len(jleaves) == LEAVES
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)


def test_config_equals_jax():
    assert ARCH in ARCH_IDS
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)),
                      (torch_smoke_config(ARCH), get_smoke_config(ARCH))):
        for f in dataclasses.fields(mine):
            assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_fused_proj_steps_equal_live_jax():
    cfg_t = dataclasses.replace(torch_smoke_config(ARCH), d_ff=D_FF)
    policy = dataclasses.replace(PAPER_INT8, fused_proj=True,
                                 kernel_mode="fused")
    state = ttrain._init_state(cfg_t, policy, SEED, torch.device("cpu"))
    init = state_leaves_numpy(state)
    step = tsteps.make_train_step(cfg_t, policy, ttrain.train_hyper(2),
                                  "cpu")
    ds = SyntheticLM(vocab=cfg_t.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    key = prng.key(SEED)
    losses = []
    with kd.record_decisions() as log:
        for i in range(2):
            state, loss = step(state, ds.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
    cfg_j = dataclasses.replace(get_smoke_config(ARCH), d_ff=D_FF)
    jpol = dataclasses.replace(JAX_INT8, fused_proj=True, kernel_mode="fused")
    jlosses, jleaves, jlog = _jax_steps(cfg_j, jpol, init, 2)
    _assert_equal(losses, state_leaves_numpy(state), jlosses, jleaves)

    plans = {(d.op, d.kind, d.path) for d in log}
    assert plans == {(d.op, d.kind, d.path) for d in jlog}
    assert ("qmatmul_epi", "qq_epi", kd.FUSED) in plans
    assert all(d.path == kd.FUSED for d in log)
    assert not any(d.op == "qnorm_gemm" for d in log)
    acts = {d.reason for d in log if d.op == "qmatmul_epi"}
    assert acts == {"gemm_epi kernel (act=gelu_glu, bias=False)"}
