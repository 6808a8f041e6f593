"""The CNN family of the port against live JAX: the smoke configuration
``CNNConfig(img=16, width=8, n_blocks=1, n_stages=2)`` (a stride-2 block
with a 1 x 1 projection shortcut), batch 8 of ``SyntheticVision``, lr 0.02,
momentum 0.9.

The port's tree walkers take the parameter tree's ``blocks`` list in
``jax.tree_util``'s leaf order, and ``convert`` carries the reference's
initial parameters across.  Then 3 integer SGD steps under ``int8``
(``make_train_step`` of both packages, the JAX one reached through its
registry seam; the plain path on both sides): every int16 master and
momentum leaf ``==`` live JAX, and the losses ``==`` (the pool and the
loss sum in the reference's order, ``fmath.mean_hw`` and
``fmath.sum_rows_1d``); and one float32 step (``F.conv2d`` against XLA's
convolution, another summation order) within ``FLOAT_ATOL``.  The pool and the loss are held ``==``
alone too, at the smoke and full-width shapes.  ``int8_qflow`` and ``int8_qweights`` are in ``test_torch_convnet_qflow.py``
and ``test_torch_convnet_qweights.py`` (each JAX step compiles for about
50 s, so the files run in parallel).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NumericPolicy as JaxPolicy
from repro.core import integer_sgd as jsgd
from repro.data.vision import SyntheticVision as JaxVision
from repro.launch import steps as jsteps
from repro.models import convnet as jconv
from repro.optim import sgd_init as jsgd_init
from repro_torch.convert import params_from_numpy, state_leaves_numpy
from repro_torch.core import prng
from repro_torch.core.integer_sgd import integer_sgd_init, tree_items
from repro_torch.core.policy import NumericPolicy
from repro_torch.data import SyntheticVision
from repro_torch.launch import steps as tsteps
from repro_torch.core import fmath
from repro_torch.models import convnet
from repro_torch.models.common import log_softmax_nll
from repro_torch.optim import sgd_init

SMOKE = dict(img=16, width=8, n_blocks=1, n_stages=2)
STEPS, BATCH, LR, MOMENTUM, SEED = 3, 8, 0.02, 0.9, 0
# The float32 step's bound on every parameter after one step (measured at
# most 6.0e-8 from the batches of steps 0-2; the convolutions and the
# batch statistics sum in other orders, and XLA's rsqrt is its own).
FLOAT_ATOL = 1e-6

POLICIES = {"int8": {}, "int8_qflow": {"qflow": True},
            "int8_qweights": {"qweights": True}}


@pytest.fixture
def jax_cnn_registry(monkeypatch):
    """The reference's ``make_train_step`` on a CNN config: its registry
    maps transformer families only, so the CNN module stands in for it."""
    monkeypatch.setattr(jsteps, "get_model", lambda cfg: jconv)
    monkeypatch.setattr(jsteps, "get_weight_mask", jconv.weight_mask)


@functools.lru_cache(maxsize=1)
def _jax_params():
    return jconv.init_params(jax.random.key(SEED), jconv.CNNConfig(**SMOKE))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_tree_items_follow_jax_leaf_order():
    params = _jax_params()
    want = [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path),
             np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]]
    got = tree_items(params_from_numpy(_numpy_tree(params), device="cpu"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, t), (_, j) in zip(got, want):
        np.testing.assert_array_equal(t.numpy(), j)


def test_synthetic_vision_equals_reference():
    for step in (0, 5):
        want = JaxVision(img=16, batch=BATCH).batch_for_step(step)
        got = SyntheticVision(img=16, batch=BATCH).batch_for_step(step)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("shape", [(8, 8, 8, 16), (128, 4, 4, 512),
                                   (3, 4, 4, 8)])
def test_mean_hw_equal_xla(shape):
    """The global average pool as the reference's fused ``relu(h + sc)
    .mean(axis=(1, 2))`` computes it (H lanes, W in order), and its
    gradient."""
    rng = np.random.RandomState(shape[1])
    a, b = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    ct = rng.randn(shape[0], shape[3]).astype(np.float32)

    def jfn(a):
        return jax.nn.relu(a + b).mean(axis=(1, 2))

    jy = jax.jit(jfn)(a)
    jg = jax.jit(lambda a, ct: jax.vjp(jfn, a)[1](ct)[0])(a, ct)
    at = torch.from_numpy(a).requires_grad_(True)
    ty = fmath.mean_hw(torch.relu(at + torch.from_numpy(b)))
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(at.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("batch", [8, 16, 32, 128])
def test_log_softmax_nll_equal_jax(batch):
    """The loss (``-take_along_axis(log_softmax(x), labels).mean()``) and
    its gradient ``==`` the reference's, the mean's sum in its order."""
    rng = np.random.RandomState(batch)
    x = (3 * rng.randn(batch, 10)).astype(np.float32)
    labels = rng.randint(0, 10, batch).astype(np.int32)

    def jloss(x):
        logp = jax.nn.log_softmax(x)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                                    axis=1).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = log_softmax_nll(xt, torch.from_numpy(labels))
    tl.backward()
    assert float(tl.detach()) == float(jl)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def run_both(policy_name, steps):
    """``steps`` steps of both packages under ``policy_name`` from the
    reference's initial parameters and state: the losses and every state
    leaf ``==``."""
    cfg_j, cfg_t = jconv.CNNConfig(**SMOKE), convnet.CNNConfig(**SMOKE)
    jpol = JaxPolicy(**POLICIES[policy_name])
    tpol = NumericPolicy(**POLICIES[policy_name])
    params = _jax_params()
    st_j = jsgd.integer_sgd_init(params, jpol, key=jax.random.key(SEED))
    st_t = integer_sgd_init(params_from_numpy(_numpy_tree(params),
                                              device="cpu"),
                            tpol, key=prng.key(SEED))
    hyper_j = jsteps.TrainHyper(lr=LR, momentum=MOMENTUM)
    step_j = jax.jit(jsteps.make_train_step(cfg_j, jpol, hyper_j))
    step_t = tsteps.make_train_step(
        cfg_t, tpol, tsteps.TrainHyper(lr=LR, momentum=MOMENTUM), "cpu")
    data = SyntheticVision(img=16, batch=BATCH)
    for i in range(steps):
        batch = data.batch_for_step(i)
        st_j, loss_j = step_j(st_j, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                              jax.random.fold_in(jax.random.key(SEED), i))
        st_t, loss_t = step_t(st_t, batch, prng.fold_in(prng.key(SEED), i))
        assert float(loss_t) == float(loss_j), (i, float(loss_t),
                                                float(loss_j))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(st_j)]
    got = state_leaves_numpy(st_t)
    assert len(got) == len(want)
    for i, (t, j) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(t, j, err_msg=f"state leaf {i}")


def test_cnn_int8_steps_equal_jax(jax_cnn_registry):
    run_both("int8", STEPS)


def test_cnn_float_step_close_to_jax(jax_cnn_registry):
    cfg_j, cfg_t = jconv.CNNConfig(**SMOKE), convnet.CNNConfig(**SMOKE)
    params = _jax_params()
    hyper = dict(lr=LR, momentum=MOMENTUM)
    step_j = jax.jit(jsteps.make_float_train_step(
        cfg_j, jsteps.TrainHyper(**hyper)))
    step_t = tsteps.make_float_train_step(cfg_t, tsteps.TrainHyper(**hyper),
                                          "cpu")
    pt = params_from_numpy(_numpy_tree(params), device="cpu")
    batch = SyntheticVision(img=16, batch=BATCH).batch_for_step(0)
    (pj, _), loss_j = step_j((params, jsgd_init(params)),
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jax.random.key(SEED))
    (pt, _), loss_t = step_t((pt, sgd_init(pt)), batch, prng.key(SEED))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for (path, t), j in zip(tree_items(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=FLOAT_ATOL, err_msg=str(path))
