"""``train("qwen2_0_5b", qflow=True, device="cpu")`` against live JAX.

The trainer's entry point on the smoke config, 3 steps of 2 x 16 tokens:
on the CPU ``auto`` keeps the chunk scan of BFP ``qbmm`` contractions
(the JAX package's off-TPU path) on both sides.  All 57 state leaves
``==`` live JAX ``make_train_step`` with ``NumericPolicy(qflow=True)``
from the same initial state, losses within 2 ulps; the fused path is
``test_torch_train_qflow.py``, whose helpers this file uses.
"""

from repro_torch.convert import state_leaves_numpy
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import train as ttrain
from test_torch_train_qflow import (ARCH, BATCH, SEED, SEQ, STEPS,
                                    assert_equal_to_jax, initial_state,
                                    jax_losses_and_leaves)


def test_train_qflow_entry_point_equals_live_jax():
    _, init = initial_state(NumericPolicy(qflow=True))
    with kd.record_decisions() as log:
        losses, state, stats = ttrain.train(
            ARCH, steps=STEPS, batch=BATCH, seq=SEQ, seed=SEED, qflow=True,
            device="cpu", quiet=True)
    assert stats["device"] == "cpu" and int(state.step) == STEPS
    assert {(d.op, d.path) for d in log if d.op.startswith("attn")} == {
        ("attn_fwd", kd.JNP)}
    assert {(d.op, d.kind) for d in log if d.op == "qbmm_fwd"} == {
        ("qbmm_fwd", "pp"), ("qbmm_fwd", "qi")}
    assert_equal_to_jax(losses, state_leaves_numpy(state),
                        *jax_losses_and_leaves("auto", init))


def test_train_cli_takes_qflow(capsys):
    for flags in (["--qflow"], ["--policy", "int8_qflow"]):
        ttrain.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                     "--seq", "8", *flags])
        assert "final loss" in capsys.readouterr().out
