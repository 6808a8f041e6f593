"""The CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one.  The file imports no jax, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.core import prng
from repro_torch.core import qops
from repro_torch.kernels import bfp_quant as kbq
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as kfa
from repro_torch.kernels import fused_chain as kfc
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import int8_matmul as kim
from repro_torch.kernels import ops
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
    assert kd.kernel_launches() == {"qq": 2, "qi": 1, "ii": 0, "qq_blk": 0,
                                    "attn_decode": 0, "attn_fwd": 0,
                                    "attn_bwd": 0, "gemm_epi": 0,
                                    "norm_gemm": 0, "decode_block": 0,
                                    "bfp_quantize": 0, "int8_matmul": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("nb,m,k,n", [(1, 896, 512, 1000), (1, 37, 67, 29),
                                      (8, 64, 896, 128), (2, 13, 130, 70),
                                      (3, 5, 33, 17)])
def test_ii_kernel_equal_plain(cuda, nb, m, k, n):
    """K not a multiple of the 32-wide slice nor of 4 (the unvectorised
    load), M under and over the 16-row tile, a batch grid dimension."""
    g = torch.Generator(device=cuda).manual_seed(2)
    am = torch.randint(-127, 128, (nb, m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=cuda,
                       dtype=torch.int8)
    ea = torch.tensor(125, dtype=torch.int32, device=cuda)
    eb = torch.tensor(119, dtype=torch.int32, device=cuda)
    kd.reset_kernel_launches()
    got = kfl.fused_ii_pt(am, bm, ea, eb, pa=7, pb=7)
    want = kfl.fused_ii_pt_plain(am, bm, ea, eb, pa=7, pb=7)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert kd.kernel_launches()["ii"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("bh,gs,t,d,s,pos,window", [
    (3, 7, 19, 16, 1, 18, 0), (2, 14, 40, 64, 2, 30, 0),
    (4, 7, 33, 16, 1, 20, 8), (8, 7, 160, 64, 1, 159, 0),
    (2, 7, 1100, 64, 1, 1099, 0)])
def test_decode_kernel_within_bound_of_plain(cuda, bh, gs, t, d, s, pos,
                                             window):
    """y ==: the kernel's softmax spells the plain version's Cephes exp and
    windowed row sum (T = 1100: more than 32 windows, summed again)."""
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
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()


# (B, M, K, N, blk): the qwen2-0.5b per-block training shapes (the gate's
# forward, the LM head's forward and its dX over 1187 blocks of the
# vocabulary, the batched PV of attention) and odd ones: 40 blocks of 32
# with odd M and N and a batch, an odd dW-like shape, and a block that is
# not a multiple of 4 (the unvectorised load).
QQ_BLK_SHAPES = [(1, 512, 896, 4864, 128), (1, 512, 896, 151936, 128),
                 (1, 512, 151936, 896, 128), (8, 896, 128, 64, 128),
                 (2, 37, 1280, 29, 32), (1, 65, 512, 131, 128),
                 (1, 19, 42, 23, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", QQ_BLK_SHAPES)
def test_qq_blk_kernel_equal_plain(cuda, shape, stochastic):
    """y and both mantissa arrays ==, with and without residuals; the
    first block of row 0 of both operands is tiny, so its scale
    2^(sa + sb) falls below 2^-126 and flushes to 0."""
    nb, m, k, n, blk = shape
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn((nb, m, k), generator=g, device=cuda)
    b = torch.randn((nb, n, k), generator=g, device=cuda)
    a[:, 0, :blk] *= 2.0 ** -70
    b[:, 0, :blk] *= 2.0 ** -70
    ra = prng.bits(prng.key(8), a.shape, cuda) if stochastic else None
    rb = prng.bits(prng.key(9), b.shape, cuda) if stochastic else None
    ea = ref.max_biased_exp_blocks_ref(a, blk)
    eb = ref.max_biased_exp_blocks_ref(b, blk)
    assert int(kfl.scale_exp(ea[0, 0, 0], 7) + kfl.scale_exp(eb[0, 0, 0], 7)) < -126
    kw = dict(p=7, blk=blk, stochastic=stochastic)
    kd.reset_kernel_launches()
    got = kfl.fused_qq_blk(a, ra, ea, b, rb, eb, **kw)
    want = kfl.fused_qq_blk_plain(a, ra, ea, b, rb, eb, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("y", "am", "bm"), got, want):
        assert torch.equal(x, y), (name, (x.float() - y.float()).abs().max().item())
    y_only = kfl.fused_qq_blk(a, ra, ea, b, rb, eb, emit_residuals=False, **kw)
    assert torch.equal(y_only[0], want[0]) and y_only[1:] == (None, None)
    assert kd.kernel_launches()["qq_blk"] == 2


@pytest.mark.cuda
def test_float_scatter_on_card_equals_cpu(cuda):
    """The per-block embedding backward's float scatter: the same sums in
    the same order on the card as on the CPU (repeated tokens, under
    deterministic algorithms)."""
    g = torch.Generator().manual_seed(3)
    rows = torch.randn((512, 896), generator=g) * torch.exp(
        4 * torch.randn((512, 896), generator=g))
    tokens = torch.randint(0, 40, (512,), generator=g)
    tokens[:100] = 7
    want = qops._scatter_rows_in_order(rows, tokens, 1000)
    torch.use_deterministic_algorithms(True)
    try:
        got = qops._scatter_rows_in_order(rows.to(cuda), tokens.to(cuda), 1000)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got.cpu(), want)


# (BH, GS, T, D, s, q_off, kv_len, causal, window): the qwen2-0.5b
# training slice; odd GS, T and D with kv_len < T; T over 3 KV blocks; a
# sliding window over 4 blocks; a 1500-position band (bt = 256) behind an
# offset; the backward's narrow query strips: D = 128 over 9 blocks of
# bt = 512 (the last one ragged) and D = 256 with bt = 256, 8-row strips.
TRAIN_SHAPES = [(8, 896, 128, 64, 128, 0, 128, True, 0),
                (2, 21, 200, 12, 3, 0, 170, False, 0),
                (3, 35, 300, 16, 5, 0, 300, True, 0),
                (2, 64, 400, 64, 64, 0, 400, True, 100),
                (1, 14, 1500, 8, 2, 1498, 1500, True, 0),
                (1, 20, 4100, 128, 10, 0, 4100, False, 0),
                (1, 24, 2000, 256, 24, 1500, 1990, True, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_attn_train_kernels_equal_plain(cuda, shape, stochastic):
    """attn_fwd (y, m, l) and attn_bwd (dq, dk, dv) == their plain
    versions: the kernels reproduce the plain float order op for op."""
    bh, gs, t, d, s, q_off, kv_len, causal, window = shape
    g = torch.Generator(device=cuda).manual_seed(5)

    def i8(*shp):
        return torch.randint(-127, 128, shp, generator=g, device=cuda,
                             dtype=torch.int8)

    def e(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda)

    qm, gm, km, vm = i8(bh, gs, d), i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    rp, rs, rp2 = (prng.bits(prng.key(i), (bh, gs, t), cuda) if stochastic
                   else None for i in (4, 5, 6))
    eq, ek, ev, eg = e(125), e(125), e(124), e(110)
    kw = dict(p=7, s=s, bt=kd.attn_block_t(t), causal=causal, window=window,
              stochastic=stochastic)
    kd.reset_kernel_launches()
    got = kfa.attn_fwd(qm, km, vm, rp, eq, ek, ev, q_off, kv_len, **kw)
    want = kfa.attn_fwd_plain(qm, km, vm, rp, eq, ek, ev, q_off, kv_len, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("y", "m", "l"), got, want):
        assert torch.equal(x, y), (name, (x - y).abs().max().item())
    _, m, l = want
    delta = torch.randn((bh, gs, 1), generator=g, device=cuda) * 1e-3
    args = (qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, q_off,
            kv_len)
    got = kfa.attn_bwd(*args, **kw)
    want = kfa.attn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(x, y), (name, (x - y).abs().max().item())
    assert kd.kernel_launches()["attn_fwd"] == 1
    assert kd.kernel_launches()["attn_bwd"] == 1


@pytest.mark.cuda
def test_wrappers_reject_wrong_operands(cuda):
    a = torch.randn((1, 4, 8), device=cuda)
    e = ref.max_biased_exp_ref(a)
    with pytest.raises(ValueError):
        kfl.fused_qi_pt(a, None, torch.zeros((1, 3, 8), dtype=torch.int16,
                                             device=cuda), e, e,
                        stochastic=False)
    with pytest.raises(ValueError):
        kfl.fused_ii_pt(torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda),
                        torch.zeros((1, 3, 7), dtype=torch.int8, device=cuda),
                        e, e)
    i8 = torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):      # float keys
        kfa.attn_fwd(i8, i8.float(), i8, None, e, e, e, 0, 4, p=7, s=4,
                     bt=128, causal=True, window=0, stochastic=False)
    a3 = torch.randn((1, 4, 64), device=cuda)
    e3 = ref.max_biased_exp_blocks_ref(a3, 32)
    with pytest.raises(ValueError):      # K not a multiple of the block
        kfl.fused_qq_blk(a3, None, e3, a3, None, e3, blk=48,
                         stochastic=False)
    with pytest.raises(ValueError):      # one exponent per tensor
        kfl.fused_qq_blk(a3, None, e, a3, None, e, blk=32, stochastic=False)
    with pytest.raises(ValueError):      # bt not a multiple of 128
        kfa.attn_fwd(i8, i8, i8, None, e, e, e, 0, 4, p=7, s=4, bt=64,
                     causal=True, window=0, stochastic=False)


# (M, K, N, act, bias): the gate|up training GEMMs of minicpm-2b (512
# tokens, 2304 -> 2 x 5760) and starcoder2-7b (4608 -> 2 x 18432), and odd
# shapes: rows off the 64-row tile, K not a multiple of 32 nor of 4, N off
# the column tile (an odd GLU half), every epilogue.
EPI_SHAPES = [(512, 2304, 11520, "silu_glu", False),
              (512, 4608, 36864, "gelu_glu", False),
              (37, 67, 58, "silu_glu", True), (37, 67, 58, "gelu_glu", True),
              (130, 96, 70, "relu", True), (130, 96, 70, "gelu", True),
              (65, 40, 29, "gelu", False), (65, 40, 29, None, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", EPI_SHAPES)
def test_gemm_epi_kernel_equal_plain(cuda, shape, stochastic):
    """y, both mantissas and ylin ==; a row of gate inputs so large that
    the logistic is sub-normal (flushed in both) and the tanh saturates."""
    m, k, n, act, with_bias = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn((m, k), generator=g, device=cuda)
    b = torch.randn((n, k), generator=g, device=cuda)
    a[1] *= 300.0
    bias = (torch.randn((1, n), generator=g, device=cuda) if with_bias
            else None)
    ra = prng.bits(prng.key(12), a.shape, cuda) if stochastic else None
    rb = prng.bits(prng.key(13), b.shape, cuda) if stochastic else None
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    kw = dict(p=7, stochastic=stochastic, act=act)
    kd.reset_kernel_launches()
    got = kfl.fused_gemm_epi(a, ra, b, rb, bias, None, ea, eb, **kw)
    want = kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, None, ea, eb, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for name, x, y in zip(("y", "am", "bm", "ylin"), got, want):
        assert torch.equal(x, y), (name, (x.float() - y.float()).abs().max().item())
    assert kd.kernel_launches()["gemm_epi"] == 1


@pytest.mark.cuda
def test_gemm_epi_variants_without_a_kernel_raise(cuda):
    a = torch.randn((8, 32), device=cuda)
    e = ref.max_biased_exp_ref(a)
    m8 = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    for kw in (dict(kind="qi"), dict(out_q=True)):
        args = (a, None, m8 if kw.get("kind") else a, None, None, None, e, e)
        with pytest.raises(NotImplementedError):
            kfl.fused_gemm_epi(*args, stochastic=False, **kw)
    with pytest.raises(NotImplementedError):
        kd.plan_epilogue("e", 8, 32, 64, qops.QuantConfig(), kind="ii",
                         kernel_mode="fused", device="cuda")


# (M, K, N, center, beta): minicpm-2b's QKV training chain (512 tokens,
# 2304 -> 6912) and odd ones: rows off every strip, K off the 32-wide
# slice and of 4, N off the 64-column tile, LayerNorm with and without
# the shift.
NORM_SHAPES = [(512, 2304, 6912, False, False), (37, 100, 70, True, True),
               (130, 67, 29, False, True), (16, 4000, 130, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_norm_gemm_kernel_equal_plain(cuda, shape, stochastic):
    """y, xq, meta and c ==; a row of zeros and a tiny row."""
    m, k, n, center, with_beta = shape
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn((m, k), generator=g, device=cuda) * 3.0
    x[0] = 0.0
    x[1] *= 2.0 ** -60
    gm = torch.randint(1 << 13, 1 << 15, (1, k), generator=g, device=cuda,
                       dtype=torch.int32)
    bm = (torch.randint(-(1 << 14), 1 << 14, (1, k), generator=g,
                        device=cuda, dtype=torch.int32) if with_beta else None)
    wm = torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                       dtype=torch.int8)
    se_w = torch.randint(-12, -5, (1, n), generator=g, device=cuda,
                         dtype=torch.int32)
    rin = prng.bits(prng.key(22), (m, k), cuda) if stochastic else None
    rout = prng.bits(prng.key(23), (m, k), cuda) if stochastic else None
    se_g = torch.tensor(-15, dtype=torch.int32, device=cuda)
    se_b = torch.tensor(-20, dtype=torch.int32, device=cuda)
    kw = dict(n=k, p=7, center=center)
    kd.reset_kernel_launches()
    got = kfc.fused_norm_gemm(x, rin, rout, gm, se_g, bm, se_b, wm, se_w, **kw)
    want = kfc.norm_gemm_plain(x, rin, rout, gm, se_g, bm, se_b, wm, se_w,
                               **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "xq", "meta", "c"), got, want):
        assert torch.equal(a, b), (name, (a.float() - b.float()).abs().max().item())
    assert kd.kernel_launches()["norm_gemm"] == 1


# (B, d, n_ff, hq, hkv, dh, T, pos, window): minicpm-2b's decode layer (4
# streams, a 160-row cache, the last position) and an odd one: GQA groups
# of 4, a sliding window, a cache of 40 rows, pos mid-cache.
DECODE_BLOCK_SHAPES = [(4, 2304, 5760, 36, 36, 64, 160, 159, 0),
                       (4, 2304, 5760, 36, 36, 64, 160, 128, 0),
                       (3, 256, 320, 8, 2, 32, 40, 37, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_BLOCK_SHAPES)
def test_decode_block_kernel_equal_plain(cuda, shape):
    """x_out and the fresh K/V rows ==: the kernel spells the plain
    version's exp and its windowed softmax sum."""
    b, d, n_ff, hq, hkv, dh, t, pos, window = shape
    g = torch.Generator(device=cuda).manual_seed(31)

    def i8(*shp):
        return torch.randint(-127, 128, shp, generator=g, device=cuda,
                             dtype=torch.int8)

    def se(n):
        return torch.randint(-14, -9, (1, n), generator=g, device=cuda,
                             dtype=torch.int32)

    def rows(*shp):
        return torch.randint(118, 126, shp, generator=g, device=cuda,
                             dtype=torch.int32)

    nqkv = (hq + 2 * hkv) * dh
    ang = torch.rand(dh // 2, generator=g, device=cuda) * 3
    cossin = torch.cat([ang.cos(), ang.cos(), ang.sin(), ang.sin()])[None]
    gains = [torch.randint(1 << 13, 1 << 15, (1, d), generator=g,
                           device=cuda, dtype=torch.int32) for _ in range(2)]
    args = (torch.randn((b, d), generator=g, device=cuda), i8(nqkv, d),
            se(nqkv), i8(d, hq * dh), se(d), i8(2 * n_ff, d), se(2 * n_ff),
            i8(d, n_ff), se(d), *gains, i8(b, hkv, t, dh),
            rows(b, hkv, t, 1), i8(b, hkv, t, dh), rows(b, hkv, t, 1),
            cossin.contiguous(), pos)
    kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=7, window=window,
              se_g1=-14, se_g2=-14)
    kd.reset_kernel_launches()
    got = kfc.fused_decode_block(*args, **kw)
    want = kfc.decode_block_plain(*args, **kw)
    torch.cuda.synchronize()
    for name, x, y in zip(("x_out", "k_new", "ek_new", "v_new", "ev_new"),
                          got, want):
        assert torch.equal(x, y), (name, (x.float() - y.float()).abs().max().item())
    assert kd.kernel_launches()["decode_block"] == 1


def _edge_values(g, m, n, dev):
    """f32 (m, n) with zeros, sub-normals, values that round past 127 and a
    row whose exponent lies far above most of its elements (s >= 32)."""
    x = torch.randn((m, n), generator=g, device=dev)
    x[0, : n // 2] = 0.0
    x[1 % m] *= 2.0 ** -140                      # sub-normal
    x[2 % m, 0] = 1.0 - 2.0 ** -24               # 127.99.. -> clamps at 127
    x[3 % m, 0] = 2.0 ** 40                      # the rest shift past 32
    return x


# (M, N): qwen2's tied LM-head weight cut to 8192 of its 151936 rows
# (7 MB), a 512 x 4864 activation, and odd shapes (N not a multiple of 4,
# a tail of 1-3).
QUANT_SHAPES = [(8192, 896), (512, 4864), (37, 67), (5, 3), (130, 97)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_bfp_quantize_kernel_equal_plain(cuda, shape):
    m, n = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    x = _edge_values(g, m, n, cuda)
    rand = prng.bits(prng.key(12), (m, n), cuda)
    per_tensor = ref.max_biased_exp_ref(x).reshape(1).expand(m).contiguous()
    per_row = ref.max_biased_exp_ref(x, axis=1).to(torch.int32)
    kd.reset_kernel_launches()
    for e_rows in (per_tensor, per_row):
        got = kbq.bfp_quantize(x, rand, e_rows)
        want = kbq.bfp_quantize_plain(x, rand, e_rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(want, ref.bfp_quantize_ref(x, rand, e_rows[:, None]))
    assert kd.kernel_launches()["bfp_quantize"] == 2
    if m * n > 36:       # an unaligned (offset) operand: the scalar path
        xs = x.reshape(-1)[1:36].reshape(5, 7)
        rs = rand.reshape(-1)[1:36].reshape(5, 7)
        e5 = per_tensor[:5].contiguous()
        assert torch.equal(kbq.bfp_quantize(xs, rs, e5),
                           kbq.bfp_quantize_plain(xs, rs, e5))


# (B, M, K, N): the LM-head forward and its dW (scaled down along the
# vocabulary), a layer's gate forward, and odd shapes (M, N, K off every
# tile, K not a multiple of 16, a batch of 3).
MATMUL_SHAPES = [(1, 512, 896, 8192), (1, 896, 512, 8192),
                 (1, 512, 896, 4864), (3, 37, 67, 29), (1, 5, 33, 130),
                 (2, 130, 96, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_int8_matmul_kernel_equal_plain(cuda, shape):
    nb, m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    am = torch.randint(-127, 128, (nb, m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=cuda,
                       dtype=torch.int8)
    kd.reset_kernel_launches()
    for e in (-20, -150):                      # a scale that flushes to 0
        scale = kfl.pow2_f32(torch.tensor(e, device=cuda))
        got = kim.int8_matmul(am, bm, scale)
        want = kim.int8_matmul_plain(am, bm, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert kd.kernel_launches()["int8_matmul"] == 2


@pytest.mark.cuda
def test_unfused_ops_on_card_equal_cpu(cuda):
    """``ops.quantize_op`` (per tensor and per row block) and
    ``ops.int8_matmul_op`` give the card's kernels the CPU's answers."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn((37, 67), generator=g)
    key = prng.key(15)
    for per_tensor in (True, False):
        mc, ec = ops.quantize_op(x, key, per_tensor=per_tensor)
        mg, eg = ops.quantize_op(x.to(cuda), key, per_tensor=per_tensor)
        assert torch.equal(mg.cpu(), mc) and torch.equal(eg.cpu(), ec)
    b = torch.randint(-127, 128, (67, 29), generator=g, dtype=torch.int8)
    y = ops.int8_matmul_op(mc.to(cuda), b.to(cuda), 121, 119)
    assert torch.equal(y.cpu(), ops.int8_matmul_op(mc, b, 121, 119))


@pytest.mark.cuda
def test_unfused_only_plans_raise_on_card(cuda):
    """Nearest rounding of a fresh operand and per-block scales have no
    unfused kernel: the card raises instead of running a plain path."""
    from repro_torch.core.bfp import QuantConfig
    with pytest.raises(NotImplementedError, match="SR-only"):
        kd.plan_contract("x", 8, 64, 8, QuantConfig(stochastic=False),
                         kernel_mode="unfused", device="cuda")
    with pytest.raises(NotImplementedError, match="per-block"):
        kd.plan_contract("x", 8, 64, 8, QuantConfig(block=32),
                         kernel_mode="unfused", device="cuda")
    with pytest.raises(ValueError):
        kim.int8_matmul(torch.zeros((1, 4, 8), dtype=torch.int8, device=cuda),
                        torch.zeros((1, 3, 7), dtype=torch.int8, device=cuda),
                        torch.tensor(1.0, device=cuda))
