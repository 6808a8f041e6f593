"""3 ``int8_qflow`` steps of the smoke CNN against live JAX (see
``test_torch_convnet.py``): each block's conv -> bn -> relu -> conv chain
runs on BFP activations (kind ``iq`` forwards, BFP-input batch-norms, ReLU
on mantissas); the losses and every int16 master and momentum leaf
``==``."""

from test_torch_convnet import STEPS, jax_cnn_registry, run_both  # noqa: F401


def test_cnn_qflow_steps_equal_jax(jax_cnn_registry):  # noqa: F811
    run_both("int8_qflow", STEPS)
