"""``PAPER_INT8`` training under ``kernel_mode="unfused"`` against live JAX.

Three steps of the qwen2 smoke config (2 x 16 tokens of
``SyntheticLM(seed=0)``) through ``make_train_step`` with
``replace(PAPER_INT8, kernel_mode="unfused")``, the way the JAX package's
own tests reach the mode (its trainer has no flag for it): every
contraction, the forward projections, both A.2 backward contractions and
attention's ``qbmm``s, is planned UNFUSED, each fresh operand quantized by
``bfp_quantize`` and each product taken by ``int8_matmul`` (their plain
versions here; the JAX side's Pallas kernels in interpret mode).  Both
start from the trainer's initial state and take its keys; all 57 int16
master and momentum leaves must be ``==`` after the three steps, and the
losses within ``LOSS_ULPS`` of ``test_torch_train_qflow.py`` (the order of
the reference's vectorized loss mean; PERF.md §6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro.core import integer_sgd as jsgd
from repro.launch import steps as jsteps
from repro.models import get_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core import prng
from repro_torch.core.policy import PAPER_INT8
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from test_torch_train_qflow import (ARCH, BATCH, SEED, SEQ, STEPS,
                                    assert_equal_to_jax, initial_state)


def _jax_unfused(init_leaves):
    cfg = get_smoke_config(ARCH)
    pol = dataclasses.replace(JAX_INT8, kernel_mode="unfused")
    key = jax.random.key(SEED)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jsgd.integer_sgd_init(
            get_model(cfg).init_params(key, cfg), pol, key=key)))
    state = jax.tree_util.tree_unflatten(treedef,
                                         [jnp.asarray(a) for a in init_leaves])
    step = jax.jit(jsteps.make_train_step(
        cfg, pol, jsteps.TrainHyper(lr=0.05, momentum=0.9)))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    losses = []
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_for_step(i).items()}
        state, loss = step(state, batch, jax.random.fold_in(key, i))
        losses.append(float(loss))
    return losses, [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]


def test_unfused_steps_equal_live_jax():
    policy = dataclasses.replace(PAPER_INT8, kernel_mode="unfused")
    state, init = initial_state(policy)
    step = tsteps.make_train_step(torch_smoke_config(ARCH), policy,
                                  tsteps.TrainHyper(lr=0.05, momentum=0.9),
                                  "cpu")
    ds = SyntheticLM(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=SEED)
    key = prng.key(SEED)
    losses = []
    with kd.record_decisions() as log:
        for i in range(STEPS):
            state, loss = step(state, ds.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
    assert {d.path for d in log} == {kd.UNFUSED}
    assert {(d.op, d.kind) for d in log} == {
        ("qmatmul_fwd", "qq"), ("qmatmul_dx", "qi"), ("qmatmul_dw", "ii"),
        ("qbmm_fwd", "qq"), ("qbmm_dx", "qi"), ("qbmm_dw", "ii")}
    assert_equal_to_jax(losses, state_leaves_numpy(state),
                        *_jax_unfused(init))
