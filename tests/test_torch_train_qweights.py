"""``int8_qweights`` training of the qwen2 smoke config against live JAX.

Under ``NumericPolicy(qweights=True)`` each step narrows the int8 forward
weights from the int16 masters once (``derive_qweights``, key
``fold_in(key, 3)``), every GEMM contracts those mantissas as they are
(kind ``qi``: only the activation is quantized in the op) and dW arrives
on the weights' float32 carriers (``qweight_grads``).  Three steps of 2 x
16 tokens of ``SyntheticLM(seed=0)`` through the trainer
(``train(policy_name="int8_qweights")``), then two steps with 2
microbatches through ``make_train_step`` (the forward weights derived
once and shared by both microbatches), both from the trainer's initial
state with its keys and hyperparameters, on the plain path
(``kernel_mode="auto"`` on the CPU, both sides).  All 57 int16 master and
momentum leaves must be ``==`` live JAX ``make_train_step``.  The loss:
the reference fuses the mean of ``softmax_xent`` with the LM head's
rescale and the label gather into one loop that LLVM vectorizes (PERF.md
§6 R2(a)); the port sums in index order.  So the port's per-position
losses, summed in the order of that loop as its LLVM IR spells it
(``xla_row_order``), must give JAX's losses ``==``, and the port's own
must lie within ``LOSS_ULPS`` (the microbatched losses within
``LOSS_ULPS`` alone).  No forward contraction may quantize a weight: no
``qmatmul_fwd`` plan of kind ``qq`` or ``iq``.
"""

import dataclasses

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
from repro_torch.core import fmath, prng
from repro_torch.core.policy import NumericPolicy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH, STEPS, MICRO_STEPS, BATCH, SEQ, SEED = "qwen2_0_5b", 3, 2, 2, 16, 0
# The port's index-order mean against the reference's vectorized one:
# measured 3 ulps at step 2 (1 at steps 1 and 3), where ``xla_row_order``
# gives JAX's loss bit for bit.
LOSS_ULPS = 4


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


def xla_row_order(nll):
    """The mean of (B, 16) per-position losses in the order of the fused
    loop of the reference's XLA CPU build here: each row's 16 values as
    two 8-lane vectors, the running sum in lane 0 of the first add,
    ``(acc + row[:8]) + row[8:]``, then the 8 lanes reduced by halving
    (``llvm.vector.reduce.fadd`` with reassociation); times f32(1/n)."""
    f32 = np.float32
    carry = f32(0)
    for row in np.asarray(nll, f32).reshape(-1, 16):
        acc = np.full(8, f32(-0.0), f32)
        acc[0] = carry
        acc = (row[8:] + (acc + row[:8])).astype(f32)
        while acc.size > 1:
            acc = (acc[:acc.size // 2] + acc[acc.size // 2:]).astype(f32)
        carry = acc[0]
    return float(carry * f32(1.0 / np.asarray(nll).size))


class per_position_losses:
    """Collects the (B, S) per-position losses each port loss sums."""

    def __enter__(self):
        self.seen, self.sum = [], fmath.sum_fused_2d

        def spy(x):
            self.seen.append(x.detach().cpu().numpy().copy())
            return self.sum(x)
        fmath.sum_fused_2d = spy
        return self.seen

    def __exit__(self, *exc):
        fmath.sum_fused_2d = self.sum


def jax_run(init_leaves, steps, microbatch=1):
    """Live JAX: ``steps`` qweights steps from the port's initial state."""
    cfg = get_smoke_config(ARCH)
    pol = JaxPolicy(qweights=True)
    key = jax.random.key(SEED)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jsgd.integer_sgd_init(
            get_model(cfg).init_params(key, cfg), pol, key=key)))
    state = jax.tree_util.tree_unflatten(treedef,
                                         [jnp.asarray(a) for a in init_leaves])
    step = jax.jit(jsteps.make_train_step(
        cfg, pol, jsteps.TrainHyper(lr=0.05, momentum=0.9,
                                    microbatch=microbatch)))
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                     seed=SEED)
    losses = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in ds.batch_for_step(i).items()}
        state, loss = step(state, batch, jax.random.fold_in(key, i))
        losses.append(float(loss))
    return losses, [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]


def assert_equal_to_jax(losses, leaves, jlosses, jleaves):
    assert len(jleaves) == 57 and len(leaves) == 57
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)


def assert_no_weight_quantize(log):
    fwd = {d.kind for d in log if d.op == "qmatmul_fwd"}
    assert fwd == {"qi"}, fwd


def test_trainer_qweights_steps_equal_live_jax():
    policy = ttrain.POLICIES["int8_qweights"]
    init = state_leaves_numpy(ttrain._init_state(
        torch_smoke_config(ARCH), policy, SEED, torch.device("cpu")))
    with kd.record_decisions() as log, per_position_losses() as nlls:
        losses, state, _ = ttrain.train(ARCH, steps=STEPS, batch=BATCH,
                                        seq=SEQ, policy_name="int8_qweights",
                                        seed=SEED, device="cpu", quiet=True)
    assert_no_weight_quantize(log)
    assert {(d.op, d.kind) for d in log} >= {
        ("qmatmul_dx", "qi"), ("qmatmul_dw", "ii"), ("qbmm_fwd", "qq")}
    jlosses, jleaves = jax_run(init, STEPS)
    assert_equal_to_jax(losses, state_leaves_numpy(state), jlosses, jleaves)
    assert [xla_row_order(x) for x in nlls] == jlosses


def test_microbatched_qweights_steps_equal_live_jax():
    policy = NumericPolicy(qweights=True)
    state = ttrain._init_state(torch_smoke_config(ARCH), policy, SEED,
                               torch.device("cpu"))
    init = state_leaves_numpy(state)
    hyper = dataclasses.replace(ttrain.train_hyper(MICRO_STEPS),
                                microbatch=2)
    step = tsteps.make_train_step(torch_smoke_config(ARCH), policy, hyper,
                                  "cpu")
    ds = SyntheticLM(vocab=512, seq_len=SEQ, global_batch=BATCH, seed=SEED)
    key = prng.key(SEED)
    narrows = []
    derive = tsteps.derive_qweights
    tsteps.derive_qweights = lambda *a: narrows.append(1) or derive(*a)
    try:
        losses = []
        with kd.record_decisions() as log:
            for i in range(MICRO_STEPS):
                state, loss = step(state, ds.batch_for_step(i),
                                   prng.fold_in(key, i))
                losses.append(float(loss))
    finally:
        tsteps.derive_qweights = derive
    assert len(narrows) == MICRO_STEPS          # once a step, not a microbatch
    assert_no_weight_quantize(log)
    # each microbatch's loss mean runs inside the reference's scan body, in
    # an order the port does not follow: held to LOSS_ULPS alone
    assert_equal_to_jax(losses, state_leaves_numpy(state),
                        *jax_run(init, MICRO_STEPS, microbatch=2))
