"""The chains' plans under the reference's residency budget, and the decode
block kernel's alignment check (CPU, no card).

By default the port plans ``norm_gemm``, ``gemm_epi`` and ``decode_block``
by its CUDA kernels' own limits; with ``vmem_budget`` (or inside
``dispatch.chain_vmem_budget``) it also applies the reference's residency
predicates, and then every plan answers as ``repro.kernels.dispatch``'s
does with ``backend="tpu"`` and ``kernel_mode="fused"``: the same path,
and the same reason where it keeps the seam.  ``decode_block_misaligned``
names an operand that sits off the alignment the kernel's loads need; the
launcher raises on it before any launch.
"""

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.core.bfp import QuantConfig as JQ
from repro.kernels import dispatch as jkd
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.bfp import QuantConfig
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_chain as kfc

BUDGET = 12 * 1024 * 1024
TOKENS = 4 * 128


def _arch(name, smoke=False, d_ff=None):
    cfg = get_smoke_config(name) if smoke else get_config(name)
    return dict(name=f"{name}{'-smoke' if smoke else ''}", d=cfg.d_model,
                d_ff=d_ff or cfg.d_ff, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
                dh=cfg.hd, act="silu_glu" if cfg.act == "silu" else "gelu_glu")


# The full-width configurations and the smoke ones whose chains fit the
# budget (minicpm's smoke MLP at the d_ff of 128 the chain tests use: its
# own 160 makes GLU halves off the reference's 128-column tile).
ARCHS = [_arch("minicpm_2b"), _arch("qwen2_0_5b"), _arch("starcoder2_7b"),
         _arch("minicpm_2b", smoke=True), _arch("minicpm_2b", smoke=True, d_ff=128)]


def _same(port, ref):
    assert port.path == ref.path, (port, ref)
    if ref.path == jkd.JNP:
        assert port.reason == ref.reason, (port.reason, ref.reason)


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("arch", ARCHS, ids=[a["name"] for a in ARCHS])
def test_norm_gemm_plan_under_budget_equals_reference(arch, stochastic):
    """The pre-attention norm -> QKV chain at 4 x 128 tokens: minicpm-2b's
    QKV weight alone (15.9 MB) exceeds 12 MiB, so the reference keeps the
    seam; the port's default plan keeps its kernel."""
    m, k, n = TOKENS, arch["d"], (arch["hq"] + 2 * arch["hkv"]) * arch["dh"]
    port = kd.plan_norm_gemm("qnorm_gemm", m, k, n,
                             QuantConfig(stochastic=stochastic),
                             kernel_mode="fused", device="cuda",
                             vmem_budget=BUDGET)
    ref = jkd.plan_norm_gemm("qnorm_gemm", m, k, n, JQ(stochastic=stochastic),
                             kernel_mode="fused", backend="tpu")
    _same(port, ref)
    assert kd.plan_norm_gemm("qnorm_gemm", m, k, n, QuantConfig(),
                             kernel_mode="fused", device="cuda").path == kd.FUSED


@pytest.mark.parametrize("variant", ["qq", "qq_bias", "qi_out_q", "ii", "pp_relu"])
@pytest.mark.parametrize("arch", ARCHS, ids=[a["name"] for a in ARCHS])
def test_epilogue_plan_under_budget_equals_reference(arch, variant):
    """The gate|up GEMM with its GLU (kind qq, with a bias; kind qi with
    the out-quantize; kind ii; kind pp with relu on the un-gated width)."""
    kind = variant.split("_")[0]
    act = "relu" if variant == "pp_relu" else arch["act"]
    n = arch["d_ff"] * (1 if act == "relu" else 2)
    kw = dict(kind=kind, act=act, bias=variant == "qq_bias",
              out_q=variant == "qi_out_q", kernel_mode="fused")
    port = kd.plan_epilogue("qmatmul_epi", TOKENS, arch["d"], n, QuantConfig(),
                            device="cuda", vmem_budget=BUDGET, **kw)
    ref = jkd.plan_epilogue("qmatmul_epi", TOKENS, arch["d"], n, JQ(),
                            backend="tpu", **kw)
    _same(port, ref)
    assert kd.plan_epilogue("qmatmul_epi", TOKENS, arch["d"], n, QuantConfig(),
                            device="cuda", **kw).path == kd.FUSED


@pytest.mark.parametrize("b,t", [(4, 160), (1, 1024)])
@pytest.mark.parametrize("arch", ARCHS, ids=[a["name"] for a in ARCHS])
def test_decode_block_plan_under_budget_equals_reference(arch, b, t):
    """A decode layer over a 160- and a 1024-row cache: a minicpm-2b layer's
    int8 weights are 58 MiB."""
    args = (b, arch["d"], arch["d_ff"], t, arch["hq"], arch["hkv"], arch["dh"])
    port = kd.plan_decode_block("qdecode_block", *args, QuantConfig(),
                                kernel_mode="fused", device="cuda",
                                vmem_budget=BUDGET)
    ref = jkd.plan_decode_block("qdecode_block", *args, JQ(),
                                kernel_mode="fused", backend="tpu")
    _same(port, ref)


def test_budget_context_and_full_width_decisions():
    """``chain_vmem_budget`` applies the budget to plans not given one; at
    full width the reference keeps every seam, the port's default plan
    none."""
    cfg = QuantConfig()
    with kd.chain_vmem_budget():
        d = kd.plan_norm_gemm("n", TOKENS, 2304, 6912, cfg, kernel_mode="fused",
                              device="cuda")
        e = kd.plan_epilogue("e", TOKENS, 2304, 11520, cfg, act="silu_glu",
                             kernel_mode="fused", device="cuda")
        b = kd.plan_decode_block("b", 4, 2304, 5760, 160, 36, 36, 64, cfg,
                                 kernel_mode="fused", device="cuda")
    assert [x.path for x in (d, e, b)] == [kd.JNP] * 3
    assert all(f"vmem_budget={BUDGET}" in x.reason for x in (d, e, b))
    assert kd.plan_decode_block("b", 4, 2304, 5760, 160, 36, 36, 64, cfg,
                                kernel_mode="fused", device="cuda").path == kd.FUSED


def _decode_operands(dh):
    """CPU stand-ins of the decode block kernel's operands at one layer's
    small widths (b 2, d 64, n_ff 96, 8 query over 4 KV heads, T 24)."""
    b, d, n_ff, hq, hkv, t = 2, 64, 96, 8, 4, 24
    rng = np.random.RandomState(3)
    i8 = lambda *s: torch.from_numpy(rng.randint(-127, 128, s).astype(np.int8))
    i32 = lambda *s: torch.from_numpy(rng.randint(118, 126, s).astype(np.int32))
    nqkv = (hq + 2 * hkv) * dh
    args = [torch.from_numpy(rng.randn(b, d).astype(np.float32)),
            i8(nqkv, d), i32(1, nqkv), i8(d, hq * dh), i32(1, d),
            i8(2 * n_ff, d), i32(1, 2 * n_ff), i8(d, n_ff), i32(1, d),
            i32(1, d), i32(1, d), i8(b, hkv, t, dh), i32(b, hkv, t, 1),
            i8(b, hkv, t, dh), i32(b, hkv, t, 1),
            torch.from_numpy(rng.randn(1, 2 * dh).astype(np.float32))]
    kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=7, window=0,
              eps_m=1, eps_e=-32, se_g1=-14, se_g2=-14)
    return args, kw


def _offset_view(t, elems):
    """``t``'s values as a contiguous view ``elems`` elements into a larger
    storage."""
    full = torch.zeros(t.numel() + 16, dtype=t.dtype)
    view = full[elems:elems + t.numel()].view(t.shape)
    view.copy_(t)
    return view


# (operand, its index among the kernel's arguments, elements off)
OFFSETS = [("x", 0, 1), ("x", 0, 2), ("km", 11, 1), ("km", 11, 2),
           ("vm", 13, 1), ("vm", 13, 4), ("wqkv_m", 1, 8)]


@pytest.mark.parametrize("name,i,off", OFFSETS)
def test_decode_block_launcher_rejects_offset_views(name, i, off):
    """An operand as a contiguous view off the alignment its loads need:
    the launcher raises ValueError naming it, before building or launching
    anything (so here, on CPU tensors, too)."""
    args, kw = _decode_operands(64)
    args[i] = _offset_view(args[i], off)
    assert args[i].is_contiguous()
    with pytest.raises(ValueError, match=f"{name} at address"):
        kfc._launch_decode_block(tuple(args), 23, **kw)


def test_decode_block_misaligned_rule():
    """16 bytes for x, the weights and the V cache (4 where dh % 16 != 0);
    4 for the K cache, the exponents and the rope row."""
    ok = {n: 4096 for n in ("x", "wqkv_m", "wo_m", "wgu_m", "wd_m", "km",
                            "ke", "vm", "ve", "cossin")}
    assert kfc.decode_block_misaligned(ok, 64) == ""
    for name, addr, dh, bad in (("x", 4100, 64, True), ("vm", 4100, 64, True),
                                ("vm", 4100, 8, False), ("vm", 4098, 8, True),
                                ("km", 4100, 64, False), ("km", 4097, 64, True),
                                ("ke", 4098, 64, True), ("ve", 4100, 64, False),
                                ("cossin", 4098, 64, True), ("wd_m", 4104, 64, True)):
        why = kfc.decode_block_misaligned(dict(ok, **{name: addr}), dh)
        assert bool(why) == bad and (not bad or why.startswith(name)), (name, why)


def test_run_decode_block_copies_only_what_it_must():
    """``run_decode_block``'s copy of an off-alignment operand keeps its
    values; an aligned one is passed as it is."""
    t = torch.arange(64, dtype=torch.float32)
    view = _offset_view(t, 1)
    copy = kd._aligned_to(view, 16)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, t)
    assert kd._aligned_to(copy, 16) is copy


@pytest.mark.parametrize("out_q", [False, True])
@pytest.mark.parametrize("kind,act,with_bias", [
    ("qq", "silu_glu", False), ("qi", "gelu_glu", True), ("ii", "relu", True),
    ("pp", None, False)])
def test_contract_epi_kinds_equal_reference(kind, act, with_bias, out_q):
    """``contract_epi`` of every kind, with and without the out-quantize,
    runs the same keys, bits and operands as the reference's (its jnp
    mirror, bit-identical to its kernel): out (or its mantissas and
    exponent), the residuals it returns and ylin ``==``."""
    import jax
    from repro.core.bfp import BFP as JBFP
    from repro_torch.core import prng
    from repro_torch.core.bfp import BFP

    m, k, n = 24, 40, 48
    rng = np.random.RandomState(5)
    a = (rng.randn(m, k) * 3).astype(np.float32)
    b = rng.randn(n, k).astype(np.float32)
    am = rng.randint(-127, 128, (m, k)).astype(np.int8)
    bm = rng.randint(-127, 128, (n, k)).astype(np.int8)
    bias = rng.randn(1, n).astype(np.float32) if with_bias else None
    jq, tq = JQ(), QuantConfig()
    if kind in ("ii", "pp"):
        ja, ta = JBFP(am, np.int32(129), jq), BFP(torch.from_numpy(am), torch.tensor(129, dtype=torch.int32), tq)
    else:
        ja, ta = a, torch.from_numpy(a)
    if kind == "qq":
        jb, tb = b, torch.from_numpy(b)
    else:
        jb, tb = JBFP(bm, np.int32(127), jq), BFP(torch.from_numpy(bm), torch.tensor(127, dtype=torch.int32), tq)
    sr = kind in ("qq", "qi")
    kw = dict(act=act, qcfg=(jq if out_q else None))
    jdec = jkd.Decision("e", jkd.JNP, "test", m, k, n, kind=f"{kind}_epi")
    want = jkd.contract_epi(
        ja, jb, jdec, cfg=jq if sr else None, ka=jax.random.key(1),
        kb=jax.random.key(2), bias=bias, kq=jax.random.key(3), **kw)
    dec = kd.plan_epilogue("e", m, k, n, tq, kind=kind, act=act, bias=with_bias,
                           out_q=out_q, kernel_mode="fused")
    assert dec.path == kd.FUSED
    got = kd.contract_epi(
        ta, tb, dec, cfg=tq if sr else None, ka=prng.key(1), kb=prng.key(2),
        bias=None if bias is None else torch.from_numpy(bias), kq=prng.key(3),
        act=act, qcfg=tq if out_q else None)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        if isinstance(w, JBFP):
            np.testing.assert_array_equal(g.m.numpy(), np.asarray(w.m))
            assert int(g.e) == int(w.e)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
