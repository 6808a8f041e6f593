"""Per-block training on the plain path, and the trainer's
``int8_block`` policy.

* Two smoke-config steps under ``NumericPolicy(block=8)`` (``auto``: on
  the CPU every contraction takes the plain path, whose per-block sums run
  in the reference's windowed jnp order) equal live JAX ``make_train_step``
  in all 57 state leaves, losses within 2 ulps; the fused path is
  ``test_torch_train_block.py``, whose helpers this file uses.
* ``train(policy_name="int8_block")`` and ``--policy int8_block`` run the
  trainer's ``NumericPolicy(block=128)``.
"""

import math

from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import train as ttrain
from test_torch_train_block import (ARCH, assert_equal_to_jax,
                                    jax_losses_and_leaves, port_run)


def test_auto_block_steps_equal_live_jax():
    losses, leaves, init, log = port_run("auto")
    assert {d.path for d in log} == {kd.JNP} and {d.kind for d in log} == {
        "qq"}
    assert_equal_to_jax(losses, leaves, *jax_losses_and_leaves("auto", init))


def test_train_runs_int8_block(capsys):
    assert ttrain.POLICIES["int8_block"] == NumericPolicy(block=128)
    losses, state, stats = ttrain.train(ARCH, steps=1, batch=2, seq=16,
                                        policy_name="int8_block",
                                        device="cpu", quiet=True)
    assert int(state.step) == 1 and math.isfinite(losses[0])
    ttrain.main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq",
                 "8", "--policy", "int8_block"])
    assert "final loss" in capsys.readouterr().out
