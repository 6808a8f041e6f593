"""One ``int8_qweights`` step of the smoke CNN against live JAX (see
``test_torch_convnet.py``): every filter and the head narrowed from its
int16 master through ``convnet.weight_mask`` (``derive_qweights``), the
convolutions contracting the narrowed mantissas (kind ``qi``) and dW on
the filters' carriers; the loss and every master and momentum leaf
``==``."""

from test_torch_convnet import jax_cnn_registry, run_both  # noqa: F401


def test_cnn_qweights_step_equal_jax(jax_cnn_registry):  # noqa: F811
    run_both("int8_qweights", 1)
