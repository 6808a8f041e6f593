"""The training attention kernels' plain versions against the JAX package.

``attn_fwd_plain`` / ``attn_bwd_plain`` (``kernels.fused_attention``) are
held ``==`` to the TPU kernels ``fused_attn_fwd_pallas`` /
``fused_attn_bwd_pallas`` in interpret mode and to their jnp mirrors
(``_attn_fwd_ref_slice`` / ``_attn_bwd_ref_slice``), through the JAX
package's batched entry points: causal GQA, a sliding window, no mask,
prime GS and T with kv_len < T, two to four KV blocks, stochastic and
half-up rounding.  ``qattention`` is held ``==`` in its output and in
dQ, dK, dV to ``jax.vjp`` of the JAX ``qattention`` under a FUSED
interpret plan (the delta row sum, the one fresh dO quantize and the key
splits included).  Inputs are made with numpy from a seed; rounding bits
come from ``jax.random`` and are handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core import qops as jqops
from repro.core.bfp import BFP as JBFP
from repro.core.bfp import quantize as jquantize
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.kernels import dispatch as jkd
from repro.kernels import fused_attention as jfa
from repro_torch.core import prng
from repro_torch.core import qops as tqops
from repro_torch.core.bfp import BFP, QuantConfig, quantize
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as tfa

# (BH, GS, T, D, s, q_off, kv_len, causal, window, bq): causal GQA over 3
# blocks; prime GS and T, kv_len < T, no mask; a sliding window over 4
# blocks; a strip size that does not divide s (no block skipping in the
# reference); an offset query group
CASES = [(2, 14, 300, 16, 2, 0, 300, True, 0, 8),
         (1, 21, 197, 12, 3, 0, 170, False, 0, 8),
         (2, 16, 400, 8, 16, 0, 400, True, 100, 8),
         (2, 35, 260, 8, 5, 0, 260, True, 0, 16),
         (1, 7, 131, 16, 7, 124, 131, True, 0, 8)]


def _case_operands(seed, bh, gs, t, d):
    rng = np.random.RandomState(seed)
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    bits = [np.asarray(jax.random.bits(jax.random.key(seed + i), (bh, gs, t),
                                       jnp.uint32)) for i in range(3)]
    delta = (rng.randn(bh, gs, 1) * 1e-3).astype(np.float32)
    return i8(bh, gs, d), i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d), bits, delta


def _t(x):
    return torch.from_numpy(np.array(x))


def _bits(x, stochastic):
    return torch.from_numpy(x.astype(np.int64)) if stochastic else None


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_fwd_bwd_equal_pallas_interpret_and_ref(case, stochastic):
    bh, gs, t, d, s, q_off, kv_len, causal, window, bq = case
    qm, gm, km, vm, (rp, rs, rp2), delta = _case_operands(t, bh, gs, t, d)
    eq, ek, ev, eg = 125, 124, 124, 110
    bt = kd.attn_block_t(t)
    jkw = dict(p=7, s=s, causal=causal, window=window, stochastic=stochastic,
               interpret=True)
    je = [jnp.int32(e) for e in (eq, ek, ev, eg)]
    J = jnp.asarray
    fwd_args = (J(qm), J(km), J(vm), J(rp) if stochastic else None, *je[:3],
                q_off, kv_len)
    want = [jfa.attn_fwd(*fwd_args, bq=bq, bt=bt, pallas=pallas, **jkw)
            for pallas in (True, False)]
    te = [torch.tensor(e, dtype=torch.int32) for e in (eq, ek, ev, eg)]
    tkw = dict(p=7, s=s, bt=bt, causal=causal, window=window,
               stochastic=stochastic)
    got = tfa.attn_fwd_plain(_t(qm), _t(km), _t(vm), _bits(rp, stochastic),
                             *te[:3], q_off, kv_len, **tkw)
    for name, g, w0, w1 in zip(("y", "m", "l"), got, *want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w0), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w1), err_msg=name)
    _, m, l = want[0]
    bwd_args = (J(qm), J(gm), J(km), J(vm), m, l, J(delta),
                J(rs) if stochastic else None, J(rp2) if stochastic else None,
                *je, q_off, kv_len)
    want = [jfa.attn_bwd(*bwd_args, bt=bt, pallas=pallas, **jkw)
            for pallas in (True, False)]
    got = tfa.attn_bwd_plain(_t(qm), _t(gm), _t(km), _t(vm), _t(m), _t(l),
                             _t(delta), _bits(rs, stochastic),
                             _bits(rp2, stochastic), *te, q_off, kv_len, **tkw)
    for name, g, w0, w1 in zip(("dq", "dk", "dv"), got, *want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w0), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w1), err_msg=name)


def test_wrappers_take_plain_versions_on_cpu():
    bh, gs, t, d = 1, 7, 20, 8
    qm, gm, km, vm, (rp, rs, rp2), delta = _case_operands(0, bh, gs, t, d)
    e = torch.tensor(124, dtype=torch.int32)
    kw = dict(p=7, s=7, bt=128, causal=True, window=0, stochastic=True)
    kd.reset_kernel_launches()
    fwd = (_t(qm), _t(km), _t(vm), _bits(rp, True), e, e, e, 0, t)
    y = tfa.attn_fwd(*fwd, **kw)
    for a, b in zip(y, tfa.attn_fwd_plain(*fwd, **kw)):
        assert torch.equal(a, b)
    bwd = (_t(qm), _t(gm), _t(km), _t(vm), y[1], y[2], _t(delta),
           _bits(rs, True), _bits(rp2, True), e, e, e, e, 0, t)
    for a, b in zip(tfa.attn_bwd(*bwd, **kw), tfa.attn_bwd_plain(*bwd, **kw)):
        assert torch.equal(a, b)
    assert kd.kernel_launches()["attn_fwd"] == 0
    assert kd.kernel_launches()["attn_bwd"] == 0


# (B, Hkv, g, S, T, D, causal, window, q_off, kv_len): the qwen2 smoke
# layer (7 groups, one KV head, D 8); two KV heads with D 64 (the full
# head dim: the delta sum runs in windows); a window over T > bt
QATTN_CASES = [(2, 1, 7, 16, 16, 8, True, 0, 0, None),
               (1, 2, 3, 20, 20, 64, True, 0, 0, None),
               (1, 1, 2, 150, 150, 16, True, 40, 0, 140)]


@pytest.mark.parametrize("case", QATTN_CASES)
def test_qattention_values_and_grads_equal_jax(case):
    b, hkv, g, s, t, d, causal, window, q_off, kv_len = case
    rng = np.random.RandomState(s + d)
    qg = (rng.randn(b, hkv, g * s, d) * 0.5).astype(np.float32)
    k = rng.randn(b, hkv, t, d).astype(np.float32)
    v = rng.randn(b, hkv, t, d).astype(np.float32)
    ct = rng.randn(b, hkv, g * s, d).astype(np.float32)
    kv = t if kv_len is None else kv_len
    jpol = JaxPolicy(qflow=True, kernel_mode="fused")
    tpol = NumericPolicy(qflow=True, kernel_mode="fused")
    jcfg = jpol.fwd_cfg()
    jplan = jkd.plan_attention("attn_fwd", g * s, t, d, jcfg, s=s,
                               kind="pp", kernel_mode="fused")
    assert jplan.path == jkd.FUSED

    def jfn(qg, k, v):
        key = jax.random.key(3)
        qq, kq, vq = (jquantize(x, jcfg, jax.random.fold_in(key, i))
                      for i, x in ((1, qg), (2, k), (3, v)))
        return jqops.qattention(
            JBFP(qq.m, qq.e, jcfg, qg), JBFP(kq.m, kq.e, jcfg, k),
            JBFP(vq.m, vq.e, jcfg, v), q_off, kv, jax.random.key(4), jpol,
            s=s, causal=causal, window=window, plan=jplan)

    def run(args, ct):
        y, vjp = jax.vjp(jfn, *args)
        return y, vjp(ct)

    jy, jgrads = jax.jit(run)(tuple(map(jnp.asarray, (qg, k, v))),
                              jnp.asarray(ct))
    tcfg = tpol.fwd_cfg()
    tplan = kd.plan_attention("attn_fwd", g * s, t, d, tcfg, s=s, kind="pp",
                              kernel_mode="fused")
    assert tplan.path == kd.FUSED and tplan.bt == kd.attn_block_t(t)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (qg, k, v)]
    key = prng.key(3)
    qs = [quantize(x.detach(), tcfg, prng.fold_in(key, i))
          for i, x in zip((1, 2, 3), ts)]
    with kd.record_decisions() as log:
        ty = tqops.qattention(*(BFP(q.m, q.e, tcfg, x) for q, x in zip(qs, ts)),
                              q_off, kv, prng.key(4), tpol, s=s,
                              causal=causal, window=window, plan=tplan)
        tgrads = torch.autograd.grad(ty, ts, torch.from_numpy(ct))
    assert [(x.op, x.path) for x in log] == [("attn_bwd", kd.FUSED)]
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    for name, tg, jg in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg),
                                      err_msg=name)


@pytest.mark.parametrize("op", ["attn_fwd", "attn_bwd"])
def test_plan_attention_train_ops(op):
    cfg = QuantConfig()
    for mode, device, want in (("auto", "cpu", kd.JNP),
                               ("auto", "cuda", kd.FUSED),
                               ("fused", "cpu", kd.FUSED),
                               ("jnp", "cuda", kd.JNP)):
        dec = kd.plan_attention(op, 896, 128, 64, cfg, s=128,
                                kernel_mode=mode, device=device)
        assert dec.path == want and dec.reason
        assert dec.bt == (128 if want == kd.FUSED else 0)
    assert kd.plan_attention(op, 896, 3000, 64, cfg, s=128,
                             kernel_mode="fused").bt == 256
    wide = kd.plan_attention(op, 64, 8192, 256, cfg, s=64, kernel_mode="fused")
    assert wide.path == kd.JNP and "shared memory" in wide.reason
    assert kd.plan_attention(op, 64, 64, 64, QuantConfig(4), s=64,
                             kernel_mode="fused").path == kd.JNP


@pytest.mark.parametrize("t", [1000, 3000, 5000])
def test_plan_attention_fused_forward_implies_fused_backward(t):
    """A fused forward commits the backward to the fused numerics, whose
    plain version does not run on the card: attn_fwd is FUSED only where
    the attn_bwd kernels fit too, with narrower query strips if need be."""
    cfg = QuantConfig()
    for d in range(1, 520):
        fwd, bwd = (kd.plan_attention(op, 64, t, d, cfg, s=64,
                                      kernel_mode="fused", device="cuda")
                    for op in ("attn_fwd", "attn_bwd"))
        assert fwd.path == kd.JNP or bwd.path == kd.FUSED, d
        if fwd.path == kd.JNP:
            assert "shared memory" in fwd.reason
    bt = kd.attn_block_t(t)
    assert tfa.bwd_strip(64, bt) == 32
    for d in (64, 128, 256):
        fits = tfa.train_smem_bytes("attn_fwd", d, bt) <= tfa.SMEM_LIMIT
        dec = kd.plan_attention("attn_fwd", 64, t, d, cfg, s=64,
                                kernel_mode="fused", device="cuda")
        assert (dec.path == kd.FUSED) == fits, d
    if bt == 512:
        assert tfa.bwd_strip(128, bt) == 8
        dec = kd.plan_attention("attn_fwd", 64, t, 160, cfg, s=64,
                                kernel_mode="fused", device="cuda")
        assert dec.path == kd.JNP and "attn_bwd" in dec.reason

