"""``int8_qfull`` training (qflow and qweights) of the qwen2 smoke config
against live JAX.

Three steps of 2 x 16 tokens of ``SyntheticLM(seed=0)`` under
``NumericPolicy(qflow=True, qweights=True, kernel_mode="fused")``: the
norms emit BFP activations, the forward weights are narrowed from the
int16 masters once a step, so the projections after a norm and the LM
head contract two pre-quantized operands (kind ``pp``, the ``ii``
kernel), ``wo`` and ``w_down`` a float activation against a BFP weight
(kind ``qi``), and attention runs through ``attn_fwd`` / ``attn_bwd``.
On the port the kernels' plain versions, on the JAX side the Pallas
kernels in interpret mode (``"fused"`` on both sides: under ``"auto"`` the
reference keeps the attention scan, which computes other numbers).  Both
start from the trainer's initial state with its keys and
hyperparameters; all 57 int16 master and momentum leaves must be ``==``,
and the losses within ``LOSS_ULPS`` (PERF.md §6 R2(a)).  No forward
contraction may quantize a weight: no ``qmatmul_fwd`` plan of kind ``qq``
or ``iq``.
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

ARCH, STEPS, BATCH, SEQ, SEED = "qwen2_0_5b", 3, 2, 16, 0
# The loss mean's order is LLVM's vectorizer choice for the fused loop XLA
# builds around it (PERF.md §6 R2(a)), which the port does not follow.
LOSS_ULPS = 2


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def jax_losses_and_leaves(init_leaves):
    """Live JAX: the same 3 steps from the same state."""
    cfg = get_smoke_config(ARCH)
    pol = JaxPolicy(qflow=True, qweights=True, kernel_mode="fused")
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


def test_fused_qfull_steps_equal_live_jax():
    policy = NumericPolicy(qflow=True, qweights=True, kernel_mode="fused")
    state = ttrain._init_state(torch_smoke_config(ARCH), policy, SEED,
                               torch.device("cpu"))
    init = state_leaves_numpy(state)
    step = tsteps.make_train_step(torch_smoke_config(ARCH), policy,
                                  ttrain.train_hyper(STEPS), "cpu")
    ds = SyntheticLM(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=SEED)
    key = prng.key(SEED)
    losses = []
    with kd.record_decisions() as log:
        for i in range(STEPS):
            state, loss = step(state, ds.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
    paths = {(d.op, d.kind, d.path) for d in log}
    assert {("attn_fwd", "pp", kd.FUSED), ("attn_bwd", "ii", kd.FUSED),
            ("qmatmul_fwd", "pp", kd.FUSED), ("qmatmul_fwd", "qi", kd.FUSED),
            ("qmatmul_dx", "qi", kd.FUSED),
            ("qmatmul_dw", "ii", kd.FUSED)} <= paths
    assert {d.kind for d in log if d.op == "qmatmul_fwd"} == {"pp", "qi"}
    assert not {d.op for d in log} & {"qbmm_fwd", "qbmm_dx", "qbmm_dw"}
    jlosses, jleaves = jax_losses_and_leaves(init)
    leaves = state_leaves_numpy(state)
    assert len(jleaves) == 57 and len(leaves) == 57
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)
