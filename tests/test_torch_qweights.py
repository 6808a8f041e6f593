"""The qweights currency of the port against the JAX package, op by op.

* ``derive_qweights`` on the trainer's initial state of the qwen2 smoke
  config (the tied embedding ``QW_TENSOR``, the layer stacks
  ``QW_STACKED``, the norm gains and biases ``QW_NONE``): every mantissa,
  exponent and carrier ``==``, under stochastic and nearest rounding; a
  stacked leaf's mantissas are stored K-innermost.
* ``qweight_grads``: the carriers' gradients pulled out of a tree.
* ``qmatmul`` with a per-tensor BFP weight: kind ``qi`` (a float x) and
  ``pp`` (a BFP x), with and without ``out_q``, under ``kernel_mode``
  ``"jnp"`` (the plain path; the JAX side's jnp oracle) and ``"fused"``
  (the kernels' plain versions; the JAX side's Pallas kernels in
  interpret mode): values and every gradient ``==`` ``jax.vjp``, dX on x
  or on x's carrier, dW on the weight's carrier, each decision's kind
  asserted.
* ``qembed`` with a BFP table, with and without ``out_q``: values and
  dTable (on the carrier) ``==``.
* ``weight_t`` of a BFP with carrier, and a tied-head loss whose
  embedding gradient (the gather's and the head's, summed) is ``==``.
* A per-block policy demoting a BFP weight to its float view.

A BFP operand is made from a float by quantizing it with a key; its
carrier is that float, so the float's gradient is the gradient the op
returns on the carrier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.configs import get_smoke_config
from repro.core import NumericPolicy as JaxPolicy
from repro.core import integer_sgd as jsgd
from repro.core import qops as jqops
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import QuantConfig as JQ
from repro.core.bfp import quantize as jquantize
from repro.models import get_model, get_weight_mask
from repro.models.common import weight_t as jweight_t
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import state_leaves_numpy
from repro_torch.core import integer_sgd as tsgd
from repro_torch.core import prng, qops
from repro_torch.core.bfp import BFP, QuantConfig, quantize
from repro_torch.core.policy import QW_NONE, QW_STACKED, QW_TENSOR
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import train as ttrain
from repro_torch.models.common import weight_t
from repro_torch.models.registry import get_weight_mask as torch_weight_mask

ARCH = "qwen2_0_5b"


def _f32(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jq(x, key):
    """A JAX per-tensor BFP of float ``x`` with ``x`` as its carrier."""
    q = jquantize(x, JQ(), key)
    return JBFP(q.m, q.e, q.cfg, x)


def _tq(x, key):
    q = quantize(x.detach(), QuantConfig(), key)
    return BFP(q.m, q.e, q.cfg, x)


def _out(y):
    """(float output, integer aux) of a float or BFP result: a BFP's
    carrier carries the cotangent, its mantissas and exponent are
    compared as they are."""
    if hasattr(y, "m"):
        return y.g, (y.m, y.e)
    return y, ()


def _check(jfn, tfn, args, ct, wrt=None):
    """``jfn`` / ``tfn`` on the same numpy ``args``: outputs, aux and the
    gradients of the float args (``wrt``: their indices; the rest are
    integer inputs) ``==``."""
    wrt = range(len(args)) if wrt is None else wrt

    def run(fargs, ct):
        def f(*fa):
            full = list(map(jnp.asarray, args))
            for i, a in zip(wrt, fa):
                full[i] = a
            return jfn(*full)
        y, vjp, aux = jax.vjp(f, *fargs, has_aux=True)
        return y, aux, vjp(ct)

    jy, jaux, jg = jax.jit(run)(tuple(jnp.asarray(args[i]) for i in wrt),
                                jnp.asarray(ct))
    ts = [torch.from_numpy(np.asarray(a)) for a in args]
    for i in wrt:
        ts[i].requires_grad_(True)
    ty, taux = tfn(*ts)
    tg = torch.autograd.grad(ty, [ts[i] for i in wrt], torch.from_numpy(ct),
                             allow_unused=True)
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    for i, (t, j) in enumerate(zip(taux, jaux)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=f"aux {i}")
    for i, (t, j) in enumerate(zip(tg, jg)):
        t = np.zeros_like(np.asarray(j)) if t is None else t.numpy()
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=f"grad {i}")


# ---------------------------------------------------------------------------
# derive_qweights, qweight_grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [True, False])
def test_derive_qweights_equals_jax(stochastic):
    kw = dict(qweights=True, stochastic=stochastic)
    tpol, jpol = NumericPolicy(**kw), JaxPolicy(**kw)
    state = ttrain._init_state(torch_smoke_config(ARCH), tpol, 0,
                               torch.device("cpu"))
    cfg = get_smoke_config(ARCH)
    key = jax.random.key(0)
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        lambda: jsgd.integer_sgd_init(
            get_model(cfg).init_params(key, cfg), jpol, key=key)))
    jstate = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(a) for a in state_leaves_numpy(state)])
    want = jax.jit(lambda s, k: jsgd.derive_qweights(
        s, jpol, k, get_weight_mask(cfg)))(jstate, jax.random.key(11))
    got = tsgd.derive_qweights(state, tpol, prng.key(11),
                               torch_weight_mask(torch_smoke_config(ARCH)))
    mask = dict(tsgd.tree_items(torch_weight_mask(torch_smoke_config(ARCH))))
    wleaves = jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, JBFP))
    seen = set()
    for (path, t), j in zip(tsgd.tree_items(got), wleaves):
        seen.add(mask[path])
        if mask[path] == QW_NONE:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=str(path))
            continue
        assert isinstance(t, BFP) and t.cfg == QuantConfig(8, 0, stochastic)
        for a, b in ((t.m, j.m), (t.e, j.e), (t.g, j.g)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=str(path))
        if mask[path] == QW_STACKED:
            assert t.e.shape == (cfg.n_layers,)
            assert t.m.transpose(-1, -2).is_contiguous(), path
    assert seen == {QW_NONE, QW_TENSOR, QW_STACKED}
    assert len(wleaves) == len(tsgd.tree_items(got))
    # off (int8): the masters' float32 view
    off = tsgd.derive_qweights(state, NumericPolicy(), prng.key(11), None)
    for (_, a), (_, b) in zip(tsgd.tree_items(off),
                              tsgd.tree_items(tsgd.master_params_f32(state))):
        assert torch.equal(a, b)


def test_qweight_grads_equals_jax():
    rng = np.random.RandomState(0)
    g1, g2, g3 = _f32(rng, 3, 4), _f32(rng, 5), _f32(rng, 2, 3, 4)
    jtree = {"a": JBFP(jnp.zeros((3, 4), jnp.int8), jnp.int32(130), JQ(),
                       jnp.asarray(g1)),
             "b": jnp.asarray(g2),
             "c": {"d": JBFP(jnp.zeros((2, 3, 4), jnp.int8),
                             jnp.zeros(2, jnp.int32), JQ(), jnp.asarray(g3))}}
    ttree = {"a": BFP(torch.zeros(3, 4, dtype=torch.int8),
                      torch.tensor(130), QuantConfig(), torch.from_numpy(g1)),
             "b": torch.from_numpy(g2),
             "c": {"d": BFP(torch.zeros(2, 3, 4, dtype=torch.int8),
                            torch.zeros(2, dtype=torch.int32), QuantConfig(),
                            torch.from_numpy(g3))}}
    want = jsgd.qweight_grads(jtree)
    got = tsgd.qweight_grads(ttree)
    for (_, t), j in zip(tsgd.tree_items(got),
                         jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# qmatmul / qembed with BFP weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["jnp", "fused"])
@pytest.mark.parametrize("q_out", [False, True])
@pytest.mark.parametrize("q_in", [False, True])
def test_qmatmul_bfp_weight_equals_jax(q_in, q_out, mode):
    rng = np.random.RandomState(4)
    x, w = _f32(rng, 2, 5, 37), _f32(rng, 37, 29, scale=0.3)
    ct = _f32(rng, 2, 5, 29)
    jpol = JaxPolicy(qweights=True, kernel_mode=mode)
    tpol = NumericPolicy(qweights=True, kernel_mode=mode)

    def jfn(x, w):
        xin = _jq(x, jax.random.key(8)) if q_in else x
        return _out(jqops.qmatmul(xin, _jq(w, jax.random.key(9)),
                                  jax.random.key(7), jpol, out_q=q_out))

    def tfn(x, w):
        xin = _tq(x, prng.key(8)) if q_in else x
        return _out(qops.qmatmul(xin, _tq(w, prng.key(9)), prng.key(7), tpol,
                                 out_q=q_out))

    with kd.record_decisions() as log:
        _check(jfn, tfn, (x, w), ct)
    want = {"jnp": kd.JNP, "fused": kd.FUSED}[mode]
    assert [(d.op, d.kind, d.path) for d in log] == [
        ("qmatmul_fwd", "pp" if q_in else "qi", want),
        ("qmatmul_dx", "qi", want), ("qmatmul_dw", "ii", want)]


def test_qmatmul_bfp_weight_without_carrier_is_forward_only():
    """A load-time-quantized serving weight (no carrier): the same values,
    dX still flows, no weight gradient."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(_f32(rng, 3, 24)).requires_grad_(True)
    w = torch.from_numpy(_f32(rng, 24, 16))
    q = quantize(w, QuantConfig(), prng.key(2))
    pol = NumericPolicy()
    y = qops.qmatmul(x, BFP(q.m, q.e, q.cfg), prng.key(3), pol)
    y2 = qops.qmatmul(x, BFP(q.m, q.e, q.cfg, w.clone()), prng.key(3), pol)
    assert torch.equal(y, y2)
    gx, = torch.autograd.grad(y.sum(), [x])
    assert torch.isfinite(gx).all()


@pytest.mark.parametrize("q_out", [False, True])
def test_qembed_bfp_table_equals_jax(q_out):
    rng = np.random.RandomState(6)
    table, ct = _f32(rng, 19, 24, scale=0.02), _f32(rng, 3, 7, 24)
    tokens = rng.randint(0, 19, size=(3, 7)).astype(np.int32)
    tokens[0, :3] = 4                       # repeated rows sum in dTable
    jpol, tpol = JaxPolicy(qweights=True), NumericPolicy(qweights=True)

    def jfn(table, tokens):
        return _out(jqops.qembed(tokens, _jq(table, jax.random.key(1)),
                                 jax.random.key(2), jpol, out_q=q_out))

    def tfn(table, tokens):
        return _out(qops.qembed(tokens.long(), _tq(table, prng.key(1)),
                                prng.key(2), tpol, out_q=q_out))

    _check(jfn, tfn, (table, tokens), ct, wrt=(0,))

    def jfloat(table, tokens):       # a float32 table: ``_qembed_q``
        return _out(jqops.qembed(tokens, table, jax.random.key(2), jpol,
                                 out_q=True))

    def tfloat(table, tokens):
        return _out(qops.qembed(tokens.long(), table, prng.key(2), tpol,
                                out_q=True))

    _check(jfloat, tfloat, (table, tokens), ct, wrt=(0,))


def test_weight_t_carrier_and_tied_head_grad_equal_jax():
    rng = np.random.RandomState(7)
    table, ct = _f32(rng, 40, 24, scale=0.3), _f32(rng, 2, 6, 40)
    tokens = rng.randint(0, 40, size=(2, 6)).astype(np.int32)
    jpol, tpol = JaxPolicy(qweights=True), NumericPolicy(qweights=True)

    tb = _tq(torch.from_numpy(table), prng.key(1))
    tt = weight_t(tb)
    assert tt.m.data_ptr() == tb.m.data_ptr() and tt.m.shape == (24, 40)
    assert torch.equal(tt.g, tb.g.T) and tt.e is tb.e
    jt = jweight_t(_jq(jnp.asarray(table), jax.random.key(1)))
    np.testing.assert_array_equal(tt.m.numpy(), np.asarray(jt.m))

    def jfn(table, tokens):
        t = _jq(table, jax.random.key(1))
        h = jqops.qembed(tokens, t, jax.random.key(2), jpol)
        return jqops.qmatmul(h, jweight_t(t), jax.random.key(3), jpol), ()

    def tfn(table, tokens):
        t = _tq(table, prng.key(1))
        h = qops.qembed(tokens.long(), t, prng.key(2), tpol)
        return qops.qmatmul(h, weight_t(t), prng.key(3), tpol), ()

    _check(jfn, tfn, (table, tokens), ct, wrt=(0,))


@pytest.mark.parametrize("mode", ["auto", "fused"])
def test_per_block_policy_demotes_bfp_weight(mode):
    rng = np.random.RandomState(8)
    x, w = _f32(rng, 6, 32), _f32(rng, 32, 16, scale=0.3)
    ct = _f32(rng, 6, 16)
    jpol = JaxPolicy(block=8, kernel_mode=mode)
    tpol = NumericPolicy(block=8, kernel_mode=mode)

    def jfn(x, w):
        return jqops.qmatmul(x, _jq(w, jax.random.key(9)), jax.random.key(7),
                             jpol), ()

    def tfn(x, w):
        return qops.qmatmul(x, _tq(w, prng.key(9)), prng.key(7), tpol), ()

    with kd.record_decisions() as log:
        _check(jfn, tfn, (x, w), ct)
    # the weight's float view (its carrier) is quantized per block in the op
    assert log[0].op == "qmatmul_fwd" and log[0].kind == "qq"
    tw = torch.from_numpy(w)
    y_view = qops.qmatmul(torch.from_numpy(x), tw, prng.key(7), tpol)
    y_bfp = qops.qmatmul(torch.from_numpy(x), _tq(tw, prng.key(9)),
                         prng.key(7), tpol)
    assert torch.equal(y_view, y_bfp)
