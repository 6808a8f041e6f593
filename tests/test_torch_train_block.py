"""Per-block (``int8_block``-style) training of the qwen2 smoke config
against live JAX.

Two steps of 2 x 16 tokens of ``SyntheticLM(seed=0)`` under
``NumericPolicy(block=8, kernel_mode="fused")``: block 8 divides every
smoke width (head dim 8 included) and the vocabulary 512 gives the LM
head's dX 64 blocks.  On the port every per-block contraction, forward
and both A.2 backward GEMMs, runs the ``qq_blk`` kernel's plain version
(block-order sums) and the per-tensor ones the ``qq`` kernel's; on the
JAX side the Pallas kernels in interpret mode.  Both start from the
trainer's own initial state (``launch.train._init_state``) with the
trainer's keys and hyperparameters; all 57 int16 master and momentum
leaves must be ``==`` after the two steps, and the losses within
``LOSS_ULPS`` (the reference's XLA build fuses the mean of
``softmax_xent`` into one vectorized loop; PERF.md §6).  The plain path
(``kernel_mode="auto"``, windowed sums) is
``test_torch_train_block_scan.py``: each JAX train step takes about 50 s
to compile, and the two files run in parallel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.core import NumericPolicy as JaxPolicy
from repro.core import integer_sgd as jsgd
from repro.launch import steps as jsteps
from repro.models import get_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core import prng
from repro_torch.core.policy import NumericPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH, STEPS, BATCH, SEQ, SEED, BLOCK = "qwen2_0_5b", 2, 2, 16, 0, 8
# The loss mean's order is LLVM's vectorizer choice for the fused loop XLA
# builds around it (8 reassociated lanes at 2 x 16 positions of the smoke
# vocabulary; the dump excerpt is in PERF.md §6), which the port does not
# follow; measured: 1 ulp.
LOSS_ULPS = 2


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def port_run(mode):
    """The port's steps from the trainer's initial state on the CPU ->
    (losses, state leaves, initial leaves, decisions)."""
    policy = NumericPolicy(block=BLOCK, kernel_mode=mode)
    cfg = torch_smoke_config(ARCH)
    state = ttrain._init_state(cfg, policy, SEED, torch.device("cpu"))
    init = state_leaves_numpy(state)
    step = tsteps.make_train_step(cfg, policy, ttrain.train_hyper(STEPS),
                                  "cpu")
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    key = prng.key(SEED)
    losses = []
    with kd.record_decisions() as log:
        for i in range(STEPS):
            state, loss = step(state, ds.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
    return losses, state_leaves_numpy(state), init, log


def jax_losses_and_leaves(mode, init_leaves):
    """Live JAX: the same steps from the same state."""
    cfg = get_smoke_config(ARCH)
    pol = JaxPolicy(block=BLOCK, kernel_mode=mode)
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


def assert_equal_to_jax(losses, leaves, jlosses, jleaves):
    assert len(jleaves) == 57
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)


def test_fused_block_steps_equal_live_jax():
    losses, leaves, init, log = port_run("fused")
    assert {(d.op, d.kind, d.path) for d in log} == {
        (op, "qq", kd.FUSED) for op in ("qmatmul_fwd", "qmatmul_dx",
                                        "qmatmul_dw", "qbmm_fwd", "qbmm_dx",
                                        "qbmm_dw")}
    assert_equal_to_jax(losses, leaves, *jax_losses_and_leaves("fused", init))
