"""Three ``int8`` steps of the starcoder2 smoke config through the trainer,
``train("starcoder2_7b", device="cpu")`` (2 x 16 tokens of
``SyntheticLM(seed=0)``), against the JAX package's ``make_train_step``
from the same initial state and keys: every int16 master and momentum
leaf ``==``, the losses within ``LOSS_ULPS``.  On the CPU ``auto`` keeps
the per-op path: LayerNorm with its shift, the QKV bias, grouped KV heads
and the MLP's unfused GELU-GLU, through ``core.fmath`` (XLA's tanh and
the order of the gelu VJP's fused loop)."""

import torch

from repro.configs import get_smoke_config
from repro.core import PAPER_INT8 as JAX_INT8
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core.policy import PAPER_INT8
from repro_torch.launch import train as ttrain
from test_torch_train_starcoder2 import (ARCH, BATCH, SEED, SEQ,
                                         _assert_equal, _jax_steps)


def test_int8_trainer_steps_equal_live_jax():
    cfg = torch_smoke_config(ARCH)
    init = state_leaves_numpy(ttrain._init_state(
        cfg, PAPER_INT8, SEED, torch.device("cpu")))
    losses, state, _ = ttrain.train(ARCH, steps=3, batch=BATCH, seq=SEQ,
                                    seed=SEED, quiet=True, device="cpu")
    jlosses, jleaves, _ = _jax_steps(get_smoke_config(ARCH), JAX_INT8, init,
                                     3)
    _assert_equal(losses, state_leaves_numpy(state), jlosses, jleaves)
