"""The CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one.  The file imports no jax, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as kfa
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("nb,m,k,n", [(1, 4, 896, 1000), (1, 37, 67, 29),
                                      (8, 896, 64, 128), (2, 130, 96, 70)])
def test_qq_qi_kernels_equal_plain(cuda, nb, m, k, n, stochastic):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((nb, m, k), generator=g, device=cuda)
    b = torch.randn((nb, n, k), generator=g, device=cuda)
    ra = prng.bits(prng.key(1), a.shape, cuda) if stochastic else None
    rb = prng.bits(prng.key(2), b.shape, cuda) if stochastic else None
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    kd.reset_kernel_launches()
    got = kfl.fused_qq_pt(a, ra, b, rb, ea, eb, stochastic=stochastic)
    want = kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb, stochastic=stochastic)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    y_only = kfl.fused_qq_pt(a, ra, b, rb, ea, eb, stochastic=stochastic,
                             emit_residuals=False)
    assert torch.equal(y_only[0], want[0]) and y_only[1:] == (None, None)
    bm = want[2]
    got = kfl.fused_qi_pt(a, ra, bm, ea, eb, stochastic=stochastic)
    want = kfl.fused_qi_pt_plain(a, ra, bm, ea, eb, stochastic=stochastic)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert kd.kernel_launches() == {"qq": 2, "qi": 1, "attn_decode": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,gs,t,d,s,pos,window", [
    (3, 7, 19, 16, 1, 18, 0), (2, 14, 40, 64, 2, 30, 0),
    (4, 7, 33, 16, 1, 20, 8), (8, 7, 160, 64, 1, 159, 0)])
def test_decode_kernel_within_bound_of_plain(cuda, bh, gs, t, d, s, pos,
                                             window):
    g = torch.Generator(device=cuda).manual_seed(1)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=cuda,
                             dtype=torch.int8)

    qm, km, vm = i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    ek = torch.randint(118, 126, (bh, t, 1), generator=g, device=cuda,
                       dtype=torch.int32)
    ev = torch.randint(118, 126, (bh, t, 1), generator=g, device=cuda,
                       dtype=torch.int32)
    rp = prng.bits(prng.key(3), (bh, gs, t), cuda)
    eq = torch.tensor(122, dtype=torch.int32, device=cuda)
    kw = dict(p=7, s=s, causal=True, window=window, stochastic=True)
    got = kfa.attn_decode(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    want = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    err = (got - want).abs().max().item()
    assert err <= kfa.DECODE_Y_RTOL * want.abs().max().item()


@pytest.mark.cuda
def test_wrappers_reject_wrong_operands(cuda):
    a = torch.randn((1, 4, 8), device=cuda)
    e = ref.max_biased_exp_ref(a)
    with pytest.raises(ValueError):
        kfl.fused_qi_pt(a, None, torch.zeros((1, 3, 8), dtype=torch.int16,
                                             device=cuda), e, e,
                        stochastic=False)
