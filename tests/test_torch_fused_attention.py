"""The decode-attention kernel's plain version against the JAX package's
attn_decode reference (pallas=False), and the decode plan.  The integer
parts (the quantized probabilities and their row exponents) and y are
``==``: the plain version's softmax rounds as the reference's (the Cephes
exp and the windowed row sum of ``core.fmath``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.kernels import fused_attention as jfa
from repro_torch.core.bfp import QuantConfig
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as tfa

# (BH, GS, T, D, s, pos, window): odd shapes, GQA groups, a window
CASES = [(3, 7, 19, 12, 1, 18, 0), (2, 14, 40, 64, 2, 30, 0),
         (4, 7, 33, 16, 1, 20, 8)]


def _operands(seed, bh, gs, t, d):
    rng = np.random.RandomState(seed)
    i8 = lambda *s: rng.randint(-127, 128, s).astype(np.int8)
    qm, km, vm = i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    ek = rng.randint(118, 126, (bh, t, 1)).astype(np.int32)
    ev = rng.randint(118, 126, (bh, t, 1)).astype(np.int32)
    rp = np.asarray(jax.random.bits(jax.random.key(seed), (bh, gs, t),
                                    jnp.uint32))
    return qm, km, vm, ek, ev, rp


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_decode_plain_matches_jax_reference(case, stochastic):
    bh, gs, t, d, s, pos, window = case
    qm, km, vm, ek, ev, rp = _operands(t, bh, gs, t, d)
    want = np.asarray(jfa.attn_decode(
        *map(jnp.asarray, (qm, km, vm, ek, ev)),
        jnp.asarray(rp) if stochastic else None, jnp.int32(122),
        jnp.int32(pos), jnp.int32(t), p=7, s=s, causal=True, window=window,
        stochastic=stochastic, interpret=True, pallas=False))
    got = tfa.attn_decode_plain(
        *map(torch.from_numpy, (qm, km, vm, ek, ev)),
        torch.from_numpy(rp.astype(np.int64)) if stochastic else None,
        torch.tensor(122, dtype=torch.int32), pos, t, p=7, s=s, causal=True,
        window=window, stochastic=stochastic).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_decode_p(qm, km, ek, ev, rp, eq, pos, t, s, window, stochastic):
    """The first half of the JAX ``_decode_core`` (scores, masks, softmax,
    V-exponent fold, p quantization) per slice, from its own helpers."""
    gs = qm.shape[1]

    @jax.jit
    def one(q, k, e_k, e_v, r):
        qpos = jnp.arange(gs, dtype=jnp.int32)[:, None] % s + pos
        kpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (gs, t))
        mask = jfa._block_mask(qpos, kpos, t, True, window)
        sek = jfa._scale_exp(e_k, 7).reshape(1, t)
        sev = jfa._scale_exp(e_v, 7).reshape(1, t)
        sf = jfa._qk_dot(q, k).astype(jnp.float32) * jfa._pow2_f32(
            jfa._scale_exp(jnp.int32(eq), 7) + sek)
        sf = jnp.where(mask, sf, jfa._NEG)
        pe = jnp.exp(sf - sf.max(axis=-1, keepdims=True))
        pn = jnp.where(mask, pe / pe.sum(axis=-1, keepdims=True), 0.0)
        p2 = pn * jfa._pow2_f32(sev)
        e_row = jfa._eff_exp(p2).max(axis=-1, keepdims=True)
        return (jfa._quantize_tile(p2, r if stochastic else None, e_row, 7,
                                   stochastic), e_row)

    outs = [one(*map(jnp.asarray, (qm[i], km[i], ek[i], ev[i], rp[i])))
            for i in range(qm.shape[0])]
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_decode_integer_parts_equal_jax(case, stochastic):
    bh, gs, t, d, s, pos, window = case
    qm, km, vm, ek, ev, rp = _operands(t, bh, gs, t, d)
    want_ph, want_e = _jax_decode_p(qm, km, ek, ev, rp, 122, pos, t, s,
                                    window, stochastic)
    ph, e_row = tfa.decode_p_plain(
        *map(torch.from_numpy, (qm, km, ek, ev)),
        torch.from_numpy(rp.astype(np.int64)) if stochastic else None,
        torch.tensor(122, dtype=torch.int32), pos, t, p=7, s=s, causal=True,
        window=window, stochastic=stochastic)
    np.testing.assert_array_equal(ph.numpy(), want_ph)
    np.testing.assert_array_equal(e_row.numpy(), want_e)


@pytest.mark.parametrize("mode,device,t,want", [
    ("auto", "cpu", 160, kd.JNP), ("auto", "cuda", 160, kd.FUSED),
    ("fused", "cpu", 160, kd.FUSED), ("fused", "cuda", 32768, kd.FUSED),
    ("fused", "cuda", 131072, kd.JNP),
])
def test_plan_attention_decode(mode, device, t, want):
    d = kd.plan_attention("attn_decode", 7, t, 64, QuantConfig(), s=1,
                          kind="qi", kernel_mode=mode, device=device)
    assert d.path == want
    if t == 131072:
        assert "shared memory" in d.reason


def test_plan_attention_unported_ops_keep_scan_path():
    """Every attention op is ported now: a shape its kernel cannot hold
    keeps the scan path, with the reason."""
    d = kd.plan_attention("attn_fwd", 7, 64, 64, QuantConfig(), s=1,
                          kernel_mode="fused", device="cuda")
    assert d.path == kd.FUSED and d.bt == 128
    d = kd.plan_attention("attn_fwd", 7, 8192, 512, QuantConfig(), s=1,
                          kernel_mode="fused", device="cuda")
    assert d.path == kd.JNP and "shared memory" in d.reason
