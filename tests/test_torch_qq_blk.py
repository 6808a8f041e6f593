"""The per-block kernel's plain version (``fused_qq_blk_plain``) and
``dispatch.contract_qq``'s per-block branch against the JAX package's
``fused_qq_blk_pallas`` in interpret mode, its ``ref`` oracles and its
``dispatch.contract_qq``: y and both mantissa arrays ``==``, at blocks 8
and 32, odd shapes, a leading batch, both rounding modes, with and
without residuals, and a block whose scale 2^(sa + sb) falls below 2^-126
(flushed to 0).  The CUDA kernel itself is held against the plain version
on the card by ``tests/test_torch_kernels_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bfp import QuantConfig as JQ
from repro.kernels import dispatch as jd
from repro.kernels import ref as jref
from repro.kernels.fused_linear import fused_qq_blk_pallas
from repro_torch.core import prng
from repro_torch.core.bfp import QuantConfig
from repro_torch.core.bfp import quantize as tquantize
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import ref


def _wide(rng, *shape):
    return (rng.randn(*shape) * np.exp(2.0 * rng.randn(*shape))
            ).astype(np.float32)


def _operands(rng, m, k, n, blk, lead=()):
    a, b = _wide(rng, *lead, m, k), _wide(rng, *lead, n, k)
    # one block of tiny values in both operands: its scale flushes to 0
    a[..., 0, :blk] *= np.float32(2.0 ** -70)
    b[..., 0, :blk] *= np.float32(2.0 ** -70)
    ra = rng.randint(0, 2 ** 32, a.shape, dtype=np.uint64).astype(np.uint32)
    rb = rng.randint(0, 2 ** 32, b.shape, dtype=np.uint64).astype(np.uint32)
    return a, b, ra, rb


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(
        np.int64 if np.asarray(x).dtype == np.uint32 else np.asarray(x).dtype))


# (M, K, N, blk): odd M and N, 2 to 9 blocks
SHAPES = [(21, 64, 13, 8), (9, 96, 35, 32), (16, 72, 8, 8), (5, 288, 3, 32)]


@pytest.mark.parametrize("residuals", [True, False])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("m,k,n,blk", SHAPES)
def test_plain_equals_pallas_interpret_and_ref(m, k, n, blk, stochastic,
                                               residuals):
    rng = np.random.RandomState(m + k + n)
    a, b, ra, rb = _operands(rng, m, k, n, blk)
    ea_j = jref.max_biased_exp_blocks_ref(jnp.asarray(a), blk)
    eb_j = jref.max_biased_exp_blocks_ref(jnp.asarray(b), blk)
    ea, eb = (ref.max_biased_exp_blocks_ref(torch.from_numpy(x), blk)
              for x in (a, b))
    np.testing.assert_array_equal(ea.numpy(), np.asarray(ea_j))
    np.testing.assert_array_equal(eb.numpy(), np.asarray(eb_j))
    assert int((kfl.scale_exp(ea[0, 0], 7) + kfl.scale_exp(eb[0, 0], 7))) \
        < -126
    sr = (lambda x: x) if stochastic else (lambda x: None)
    want = fused_qq_blk_pallas(
        jnp.asarray(a), sr(jnp.asarray(ra)), ea_j, jnp.asarray(b),
        sr(jnp.asarray(rb)), eb_j, p=7, blk=blk, bm=m,
        stochastic=stochastic, interpret=True, emit_residuals=residuals)
    got = kfl.fused_qq_blk_plain(
        torch.from_numpy(a), sr(_t(ra)), ea, torch.from_numpy(b),
        sr(_t(rb)), eb, p=7, blk=blk, stochastic=stochastic,
        emit_residuals=residuals)
    if not residuals:
        want = (want,)
        assert got[1] is None and got[2] is None
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    if stochastic and residuals:
        y_ref = jref.bfp_block_matmul_ref(
            want[1], want[2], ea_j - 127 - 23 + 17, eb_j - 127 - 23 + 17, blk)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(y_ref))
        assert torch.equal(got[0], ref.bfp_block_matmul_ref(
            got[1], got[2], kfl.scale_exp(ea, 7), kfl.scale_exp(eb, 7), blk))
        assert torch.equal(got[0], kd._jnp_block_matmul(got[1], got[2], ea,
                                                        eb, 7, 7, blk))
        am_ref = jref.bfp_block_quantize_ref(jnp.asarray(a), jnp.asarray(ra),
                                             ea_j, blk)
        np.testing.assert_array_equal(np.asarray(am_ref), got[1].numpy())
        np.testing.assert_array_equal(
            ref.bfp_block_quantize_ref(torch.from_numpy(a), _t(ra), ea,
                                       blk).numpy(), got[1].numpy())


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("lead,m,k,n,blk", [((), 37, 64, 29, 8),
                                            ((3,), 13, 96, 17, 32),
                                            ((2, 2), 7, 40, 5, 8)])
def test_contract_qq_per_block_equals_jax_dispatch(lead, m, k, n, blk,
                                                   stochastic):
    """The per-block branch: exponents per row and block, rounding bits
    on the logical shapes, residual BFPs with (*B, M, K/blk) exponents
    that equal ``core.bfp.quantize``'s."""
    rng = np.random.RandomState(m * n)
    a, b, _, _ = _operands(rng, m, k, n, blk, lead)
    cfg_j, cfg_t = JQ(8, blk, stochastic), QuantConfig(8, blk, stochastic)
    nb = len(lead)
    yj, aj, bj = jd.contract_qq(
        jnp.asarray(a), jnp.asarray(b), cfg_j, jax.random.key(1),
        jax.random.key(2),
        jd.Decision("qbmm_fwd", jd.FUSED, "test", m, k, n, 8,
                    interpret=True), nbatch=nb)
    dec = kd.Decision("qbmm_fwd", kd.FUSED, "test", m, k, n, "qq")
    yt, at, bt = kd.contract_qq(torch.from_numpy(a), torch.from_numpy(b),
                                cfg_t, prng.key(1), prng.key(2), dec,
                                nbatch=nb)
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    for q, qj in ((at, aj), (bt, bj)):
        np.testing.assert_array_equal(q.m.numpy(), np.asarray(qj.m))
        np.testing.assert_array_equal(q.e.numpy(), np.asarray(qj.e))
        assert q.e.dtype == torch.int32 and q.e.shape[-1] == k // blk
    want_a = tquantize(torch.from_numpy(a), cfg_t, prng.key(1))
    assert torch.equal(at.m, want_a.m) and torch.equal(at.e, want_a.e)
    yn, an, bn = kd.contract_qq(torch.from_numpy(a), torch.from_numpy(b),
                                cfg_t, prng.key(1), prng.key(2), dec,
                                nbatch=nb, want_residuals=False)
    assert torch.equal(yn, yt) and an is None and bn is None


@pytest.mark.parametrize("mode,device,kind,want", [
    ("auto", "cpu", "qq", kd.JNP), ("auto", "cuda", "qq", kd.FUSED),
    ("fused", "cpu", "qq", kd.FUSED), ("jnp", "cuda", "qq", kd.JNP),
    ("fused", "cpu", "iq", kd.JNP), ("auto", "cpu", "qi", kd.JNP)])
def test_plan_contract_routes_per_block(mode, device, kind, want):
    """Kind qq takes the qq_blk kernel at any K (the LM head's dX over the
    vocabulary included); other per-block kinds keep the plain path."""
    cfg2 = QuantConfig(8, 128) if kind != "qq" else None
    d = kd.plan_contract("qmatmul_dx", 512, 151936, 896, QuantConfig(8, 128),
                         kind=kind, cfg2=cfg2, kernel_mode=mode,
                         device=device)
    assert d.path == want and d.reason


@pytest.mark.parametrize("kind", ["iq", "qi", "ii", "pp"])
def test_plan_contract_refuses_per_block_kinds_without_a_kernel_on_card(kind):
    with pytest.raises(NotImplementedError, match="kind qq"):
        kd.plan_contract("qmatmul_fwd", 4, 64, 8, QuantConfig(8, 32),
                         kind=kind, cfg2=QuantConfig(8, 32),
                         kernel_mode="auto", device="cuda")


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    kd.reset_kernel_launches()
    rng = np.random.RandomState(0)
    a, b, ra, rb = _operands(rng, 6, 32, 5, 8, (2,))
    ea, eb = (ref.max_biased_exp_blocks_ref(torch.from_numpy(x), 8)
              for x in (a, b))
    args = (torch.from_numpy(a), _t(ra), ea, torch.from_numpy(b), _t(rb), eb)
    for x, y in zip(kfl.fused_qq_blk(*args, blk=8),
                    kfl.fused_qq_blk_plain(*args, blk=8)):
        assert torch.equal(x, y)
    assert kd.kernel_launches()["qq_blk"] == 0
