"""``fused_proj`` training of the minicpm smoke config against live JAX.

Two steps of 2 x 32 tokens of ``SyntheticLM(seed=0)`` under
``NumericPolicy(fused_proj=True, kernel_mode="fused")`` with ``d_ff=128``
(the reference plans its GLU epilogue only on halves of whole TPU lanes):
on the port the chain kernels' plain versions (``norm_gemm`` for the
pre-attention norm and the merged QKV projection, ``gemm_epi`` for gate|up
and the SiLU-GLU) and the contraction kernels' for the rest; on the JAX
side the Pallas kernels in interpret mode.  Both start from the trainer's
own initial state and take its keys and hyperparameters; all 45 int16
master and momentum leaves must be ``==`` after the two steps, the losses
within ``LOSS_ULPS`` (the order of the loss mean in the reference's fused
loop, below).  64 rows per step; the chain's gain gradient is reproduced
at every row count (``tests/test_torch_qchain.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro.core import integer_sgd as jsgd
from repro.kernels import dispatch as jkd
from repro.launch import steps as jsteps
from repro.models import get_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core import prng
from repro_torch.core.policy import PAPER_INT8
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH, STEPS, BATCH, SEQ, SEED, D_FF = "minicpm_2b", 2, 2, 32, 0, 128
# The loss mean's order in this step is LLVM's vectorizer choice for the
# fused loop XLA builds around it (8 lanes interleaved twice: the gold
# logit is gathered from the LM head's int32 sums inside the loop), which
# the port does not follow (PERF.md §6); measured: 1 ulp on step 2.
LOSS_ULPS = 2
CHAINS = {"qnorm_gemm", "qmatmul_epi"}


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def test_fused_proj_steps_equal_live_jax():
    cfg_t = dataclasses.replace(torch_smoke_config(ARCH), d_ff=D_FF)
    policy = dataclasses.replace(PAPER_INT8, fused_proj=True,
                                 kernel_mode="fused")
    state = ttrain._init_state(cfg_t, policy, SEED, torch.device("cpu"))
    init = state_leaves_numpy(state)
    step = tsteps.make_train_step(cfg_t, policy, ttrain.train_hyper(STEPS),
                                  "cpu")
    ds = SyntheticLM(vocab=cfg_t.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    key = prng.key(SEED)
    losses = []
    with kd.record_decisions() as log:
        for i in range(STEPS):
            state, loss = step(state, ds.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
    fused = {d.op for d in log if d.path == kd.FUSED}
    assert CHAINS <= fused
    assert not {d.op for d in log if d.path == kd.JNP} & CHAINS

    cfg_j = dataclasses.replace(get_smoke_config(ARCH), d_ff=D_FF)
    jpol = dataclasses.replace(JAX_INT8, fused_proj=True, kernel_mode="fused")
    jkey = jax.random.key(SEED)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jsgd.integer_sgd_init(
            get_model(cfg_j).init_params(jkey, cfg_j), jpol, key=jkey)))
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in init])
    jstep = jax.jit(jsteps.make_train_step(
        cfg_j, jpol, jsteps.TrainHyper(lr=0.05, momentum=0.9)))
    jlosses = []
    with jkd.record_decisions() as jlog:
        for i in range(STEPS):
            batch = {k: jnp.asarray(v)
                     for k, v in ds.batch_for_step(i).items()}
            jstate, loss = jstep(jstate, batch, jax.random.fold_in(jkey, i))
            jlosses.append(float(loss))
    assert CHAINS <= {d.op for d in jlog if d.path == jkd.FUSED}
    jleaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    leaves = state_leaves_numpy(state)
    assert len(leaves) == len(jleaves) == 45
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)
