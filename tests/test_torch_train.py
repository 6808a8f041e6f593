"""The training slice end to end on the CPU, against the JAX package.

* Three ``PAPER_INT8`` train steps of the qwen2 smoke config (int8
  forward, A.2 integer backward, int16 SGD) on the port and on live JAX,
  from the same initial state and with the same keys, end with every
  int16 master, momentum leaf and the step counter ``==``.  The losses are
  held to ``LOSS_ULPS``: the reference's XLA build sums the final mean of
  ``softmax_xent`` inside one fused loop that LLVM vectorizes, in an order
  the port does not follow (PERF.md §6); the loss feeds nothing back (its
  gradient is 1/N), so no state leaf depends on it.
* ``tests/goldens/train_decode_pr5.npz`` was drawn with an older XLA: the
  JAX package itself, under the jax installed here, reproduces its first
  loss but not steps 2 and 3 (ROADMAP §3).  The port is held to that first
  loss (``LOSS_ULPS``, as above) and to live JAX for the rest.
* ``kernel_mode="fused"`` (the kernels' plain versions on the CPU) equals
  ``auto`` bit for bit and routes every contraction to the kernels: qq
  forward, qi dX, ii dW.
* int16 SGD, the data streams and the state converters on their own.
* ``train`` refuses to run without a card unless given ``device="cpu"``,
  and refuses every option that is not ported yet.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8
from repro.core import integer_sgd as jsgd
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import UniformLM as JUniformLM
from repro.launch.steps import TrainHyper as JHyper
from repro.launch.steps import make_train_step as jax_train_step
from repro.models import get_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import (params_from_numpy, state_from_numpy,
                                 state_leaves_numpy)
from repro_torch.core import prng
from repro_torch.core import integer_sgd as tsgd
from repro_torch.core.policy import NumericPolicy
from repro_torch.data import SyntheticLM, UniformLM
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainHyper, make_train_step

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "train_decode_pr5.npz")
ARCH, STEPS, BATCH, SEQ = "qwen2_0_5b", 3, 2, 16
# The loss mean's order is LLVM's vectorizer choice for the fused loop XLA
# builds around it (8 reassociated lanes at 2 x 16 positions of the smoke
# vocabulary; the dump excerpt is in PERF.md §6), which the port does not
# follow; measured: 1 ulp.
LOSS_ULPS = 2


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(int(a.view(np.int32)) - int(b.view(np.int32)))


@pytest.fixture(scope="module")
def runs():
    """The port under auto and fused, and live JAX, from the JAX init
    params in the golden's key mode (jax_threefry_partitionable=False)."""
    cfg = get_smoke_config(ARCH)
    with jax.threefry_partitionable(False):
        params = get_model(cfg).init_params(jax.random.key(0), cfg)
    np_params = jax.tree_util.tree_map(np.array, params)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=0)
    key = prng.key(0, partitionable=False)
    out = {}
    for mode in ("auto", "fused"):
        policy = NumericPolicy(kernel_mode=mode)
        state = tsgd.integer_sgd_init(params_from_numpy(np_params, "cpu"),
                                      policy, key=key)
        if mode == "auto":
            out["init"] = state_leaves_numpy(state)
        step = make_train_step(torch_smoke_config(ARCH), policy,
                               TrainHyper(lr=0.05, momentum=0.9), "cpu")
        losses = []
        with kd.record_decisions() as log:
            for i in range(STEPS):
                state, loss = step(state, ds.batch_for_step(i),
                                   prng.fold_in(key, i))
                losses.append(float(loss))
        out[mode] = (losses, state_leaves_numpy(state), log)
    with jax.threefry_partitionable(False):
        jkey = jax.random.key(0)
        treedef = jax.tree_util.tree_structure(jax.eval_shape(
            lambda: jsgd.integer_sgd_init(params, PAPER_INT8, key=jkey)))
        jstate = jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(a) for a in out["init"]])
        step_fn = jax.jit(jax_train_step(cfg, PAPER_INT8,
                                         JHyper(lr=0.05, momentum=0.9)))
        losses = []
        for i in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in ds.batch_for_step(i).items()}
            jstate, loss = step_fn(jstate, batch, jax.random.fold_in(jkey, i))
            losses.append(float(loss))
        out["jax"] = (losses, [np.asarray(x)
                               for x in jax.tree_util.tree_leaves(jstate)])
    return out


def test_train_steps_equal_live_jax(runs):
    losses, leaves, _ = runs["auto"]
    jlosses, jleaves = runs["jax"]
    assert len(leaves) == len(jleaves) == 57
    for i, (got, want) in enumerate(zip(leaves, jleaves)):
        np.testing.assert_array_equal(got, want, err_msg=f"state leaf {i}")
    for got, want in zip(losses, jlosses):
        assert _ulps(got, want) <= LOSS_ULPS, (losses, jlosses)


def test_golden_first_loss(runs):
    golden = np.load(GOLDEN)["train_int8_losses"]
    assert _ulps(runs["auto"][0][0], golden[0]) <= LOSS_ULPS
    # the reference reproduces the golden's first loss exactly
    assert runs["jax"][0][0] == golden[0]


def test_fused_equals_auto_and_routes_to_the_kernels(runs):
    (la, sa, log_a), (lf, sf, log_f) = runs["auto"], runs["fused"]
    assert la == lf
    for a, f in zip(sa, sf):
        np.testing.assert_array_equal(a, f)
    fused = {(d.op, d.kind) for d in log_f if d.path == kd.FUSED}
    assert fused == {("qmatmul_fwd", "qq"), ("qmatmul_dx", "qi"),
                     ("qmatmul_dw", "ii"), ("qbmm_fwd", "qq"),
                     ("qbmm_dx", "qi"), ("qbmm_dw", "ii")}
    assert all(d.path == kd.FUSED for d in log_f)
    assert all(d.path == kd.JNP for d in log_a)


def test_integer_sgd_equal_jax():
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(7, 5).astype(np.float32),
            "b": {"c": rng.randn(3).astype(np.float32) * 1e-3,
                  "d": rng.randn(2, 4, 6).astype(np.float32)}}
    grads = [{"a": rng.randn(7, 5).astype(np.float32),
              "b": {"c": rng.randn(3).astype(np.float32),
                    "d": rng.randn(2, 4, 6).astype(np.float32) * 1e-2}}
             for _ in range(2)]
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jsgd.integer_sgd_init(jtree, PAPER_INT8, key=jax.random.key(1))
    ttree = tsgd.tree_map(torch.from_numpy, tree)
    tstate = tsgd.integer_sgd_init(ttree, NumericPolicy(), key=prng.key(1))
    for i, g in enumerate(grads):
        jstate = jsgd.integer_sgd_step(
            jstate, jax.tree_util.tree_map(jnp.asarray, g), 0.05 / (i + 1),
            jax.random.key(10 + i), PAPER_INT8, momentum=0.9,
            weight_decay=1e-3)
        tstate = tsgd.integer_sgd_step(
            tstate, tsgd.tree_map(torch.from_numpy, g), 0.05 / (i + 1),
            prng.key(10 + i), NumericPolicy(), momentum=0.9,
            weight_decay=1e-3)
    for got, want in zip(state_leaves_numpy(tstate),
                         jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(got, np.asarray(want))
    view = tsgd.master_params_f32(tstate)
    np.testing.assert_array_equal(
        view["b"]["d"].numpy(),
        np.asarray(jsgd.master_params_f32(jstate)["b"]["d"]))
    # the converters carry the state across in both directions
    back = state_from_numpy(state_leaves_numpy(tstate), ttree, "cpu")
    for x, y in zip(state_leaves_numpy(back), state_leaves_numpy(tstate)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("step,host", [(0, 0), (7, 1)])
def test_data_streams_equal_jax(step, host):
    for ours, theirs in ((SyntheticLM, JSyntheticLM), (UniformLM, JUniformLM)):
        got = ours(vocab=97, seq_len=11, global_batch=4, seed=3, n_hosts=2,
                   host=host).batch_for_step(step)
        want = theirs(vocab=97, seq_len=11, global_batch=4, seed=3,
                      n_hosts=2, host=host).batch_for_step(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_schedules_equal_jax():
    """WSD in float32 as the reference computes it on its int32 step,
    ``==``: one ulp of the learning rate can move its 16-bit fixed-point
    draw and with it the int16 masters."""
    from repro.optim import optimizers as jopt
    from repro_torch.optim import optimizers as topt
    steps = np.arange(64, dtype=np.int32)
    for args in ((0.05, 0, 0, 3), (0.05, 5, 20, 16), (0.3, 7, 3, 9, 0.25),
                 (1e-3, 1, 30, 33)):
        want = jax.jit(jax.vmap(lambda s: jopt.wsd_schedule(s, *args)))(steps)
        got = [topt.wsd_schedule(int(s), *args) for s in steps]
        np.testing.assert_array_equal(np.float32(got), np.asarray(want))
    # the trainer's schedule is the JAX trainer's
    for n in (3, 10, 40):
        sched = ttrain.train_hyper(n, use_wsd=True).schedule
        want = jax.jit(jax.vmap(lambda s: jopt.wsd_schedule(
            s, 0.05, n // 10, n // 2, n // 3)))(steps[:n])
        np.testing.assert_array_equal(
            np.float32([sched(int(s)) for s in steps[:n]]), np.asarray(want))


def test_train_entry_points_on_cpu(capsys):
    losses, state, stats = ttrain.train(ARCH, steps=2, batch=2, seq=8,
                                        device="cpu", quiet=True)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(state.step) == 2 and stats["device"] == "cpu"
    mlosses, _, _ = ttrain.train(ARCH, steps=2, batch=2, seq=8, microbatch=2,
                                 use_wsd=True, device="cpu", quiet=True)
    assert all(np.isfinite(mlosses))
    flosses, _, _ = ttrain.train(ARCH, steps=2, batch=2, seq=8,
                                 policy_name="float32", device="cpu",
                                 quiet=True)
    assert all(np.isfinite(flosses))
    ttrain.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                 "--seq", "8"])
    assert "final loss" in capsys.readouterr().out


def test_train_refuses_what_is_not_ported():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.train(ARCH, steps=1)
    for kw in ({"ckpt_dir": "x"}, {"health": True},
               {"qflow": True, "qweights": True},
               {"qweights": True}, {"fault_plan": object()},
               {"policy_name": "int8_qfull"}, {"policy_name": "int4"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.train(ARCH, steps=1, device="cpu", **kw)
    with pytest.raises(ValueError, match="unsafe_rbg"):
        make_train_step(torch_smoke_config(ARCH), NumericPolicy(),
                        TrainHyper(rng_impl="unsafe_rbg"), "cpu")
    with pytest.raises(NotImplementedError, match="qweights"):
        make_train_step(torch_smoke_config(ARCH),
                        NumericPolicy(qweights=True), TrainHyper(), "cpu")
