"""The CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one.  The file imports no jax, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.core import bfp, prng
from repro_torch.core import qops
from repro_torch.kernels import bfp_quant as kbq
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as kfa
from repro_torch.kernels import fused_chain as kfc
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import int8_matmul as kim
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import rounding_bits as krb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _variant_launches(kind, variants=kfl.QGEMM_VARIANTS):
    counts = kd.kernel_launches()
    return {f"{kind}_{v}": counts[f"{kind}_{v}"] for v in variants
            if counts[f"{kind}_{v}"]}


# qi shapes beyond the qq ones (B, M, K, N): the two timed main-path
# shapes (the decode LM head, the prefill gate), ragged M (17, 130) and N
# (70, at M = 4 too), N % 4 != 0 on the tensor cores, a batch on the
# streaming variant, and K not a multiple of 16 at M <= 16 (__dp4a).
QI_SHAPES = [(1, 4, 896, 151936), (1, 512, 896, 4864), (1, 4, 896, 70),
             (1, 17, 896, 4864), (1, 130, 896, 896), (3, 4, 128, 200),
             (1, 4, 37, 100)]


# qq's main-path shapes beyond those above (B, M, K, N): qwen2's PV of the
# prefill attention, its wq, wk / wv, w_down and tied LM head (full width);
# minicpm-2b's wq and w_down and its LM head narrowed to 4099 of 122753
# rows (N % 4 != 0 kept); starcoder2-7b's merged QKV and w_down and its LM
# head narrowed to 8192 of 49152 rows.
QQ_SHAPES = [(8, 896, 128, 64), (1, 512, 896, 896), (1, 512, 896, 128),
             (1, 512, 4864, 896), (1, 512, 896, 151936),
             (1, 512, 2304, 2304), (1, 512, 5760, 2304), (1, 512, 2304, 4099),
             (1, 512, 4608, 5632), (1, 512, 18432, 4608),
             (1, 512, 4608, 8192)]


# ResNet-18 for CIFAR at batch 128 (B, M, K, N): the stem (K = 27:
# __dp4a), a stage-1 and a stage-4 3 x 3 convolution and the 10-class head
# forward (qq); a stage-1 convolution's dX and the head's dX (K = 10:
# __dp4a) on qi.
CNN_SHAPES = [(1, 131072, 27, 64), (1, 131072, 576, 64), (1, 2048, 4608, 512),
              (1, 128, 512, 10), (1, 131072, 64, 576), (1, 128, 10, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("nb,m,k,n", [(1, 4, 896, 1000), (1, 37, 67, 29),
                                      (8, 896, 64, 128), (2, 130, 96, 70)]
                         + QI_SHAPES + QQ_SHAPES + CNN_SHAPES)
def test_qq_qi_kernels_equal_plain(cuda, nb, m, k, n, stochastic):
    """y and mantissas ``==``; the qq calls move the counter of the variant
    ``qq_variant`` names, the qi call that of ``qgemm_variant``'s (wgmma,
    stream or dp4a)."""
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
    want = {"qq": 2, "qi": 1, "ii": 0, "qq_blk": 0, "attn_decode": 0,
            "attn_fwd": 0, "attn_bwd": 0, "gemm_epi": 0, "norm_gemm": 0,
            "decode_block": 0, "bfp_quantize": 0, "int8_matmul": 0,
            "rounding_bits": 0}
    want.update({f"{kind}_{v}": 0 for kind in ("qq", "qi", "ii")
                 for v in kfl.QGEMM_VARIANTS})
    want.update({f"int8_matmul_{v}": 0 for v in kim.INT8_MATMUL_VARIANTS})
    want.update({f"qq_blk_{v}": 0 for v in kfl.QQ_BLK_VARIANTS})
    want.update({f"gemm_epi_{v}": 0 for v in kfl.GEMM_EPI_VARIANTS})
    want.update({f"norm_gemm_{v}": 0 for v in kfc.NORM_GEMM_VARIANTS})
    want.update({f"attn_decode_n{n}": 0 for n in kfa.DECODE_SPLITS})
    want.update({f"attn_fwd_{v}": 0 for v in kfa.ATTN_FWD_VARIANTS})
    want.update({f"attn_bwd_{v}": 0 for v in kfa.ATTN_BWD_VARIANTS})
    want[f"qq_{kfl.qq_variant(m, k)}"] = 2
    want[f"qi_{kfl.qgemm_variant(m, k)}"] = 1
    assert kd.kernel_launches() == want


# ii shapes beyond the first five (B, M, K, N): the two timed main-path
# shapes (the LM head's and w_down's training dW), M <= 16 with K % 16 ==
# 0 (the streaming variant, a batch too), ragged M on the tensor cores,
# two of ResNet-18's.
II_SHAPES = [(1, 896, 512, 151936), (1, 4864, 512, 896), (1, 4, 512, 896),
             (2, 4, 512, 70), (1, 17, 512, 4864),
             # ResNet-18's stage-2 3 x 3 convolution dW and its head's dW
             (1, 1152, 32768, 128), (1, 512, 128, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,m,k,n", [(1, 896, 512, 1000), (1, 37, 67, 29),
                                      (8, 64, 896, 128), (2, 13, 130, 70),
                                      (3, 5, 33, 17)] + II_SHAPES)
def test_ii_kernel_equal_plain(cuda, nb, m, k, n):
    """K not a multiple of 16 (the __dp4a variant; of 4: its unvectorised
    load), M under and over 16, a batch grid dimension; the call moves the
    counter of the variant ``qgemm_variant`` names."""
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
    assert _variant_launches("ii") == {f"ii_{kfl.qgemm_variant(m, k)}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("m,n,k", [(512, 4864, 896), (151936, 4, 896),
                                   (130, 70, 96), (29, 37, 67)])
def test_iq_and_pp_routes_equal_plain(cuda, m, n, k, stochastic):
    """Kind iq (the qi kernel with b quantized in it: its M is b's rows)
    and kind pp (the ii kernel) through dispatch, against the same calls
    on the plain versions."""
    from repro_torch.core.bfp import BFP, QuantConfig
    g = torch.Generator(device=cuda).manual_seed(8)
    cfg = QuantConfig(stochastic=stochastic)
    aq = BFP(torch.randint(-127, 128, (m, k), generator=g, device=cuda,
                           dtype=torch.int8),
             torch.tensor(119, dtype=torch.int32, device=cuda), cfg)
    bq = BFP(torch.randint(-127, 128, (n, k), generator=g, device=cuda,
                           dtype=torch.int8),
             torch.tensor(123, dtype=torch.int32, device=cuda), cfg)
    b = torch.randn((n, k), generator=g, device=cuda)
    iq = kd.Decision("iq", kd.FUSED, "test", m, k, n, "iq", "cuda")
    pp = kd.Decision("pp", kd.FUSED, "test", m, k, n, "pp", "cuda")
    kd.reset_kernel_launches()
    y, bqk = kd.contract_iq(aq, b, cfg, prng.key(9), iq)
    y2 = kd.contract_ii(aq, bq, pp)
    torch.cuda.synchronize()
    assert _variant_launches("qi") == {f"qi_{kfl.qgemm_variant(n, k)}": 1}
    assert _variant_launches("ii") == {f"ii_{kfl.qgemm_variant(m, k)}": 1}
    with kd.plain_kernels():
        yp, bqp = kd.contract_iq(aq, b, cfg, prng.key(9), iq)
        y2p = kd.contract_ii(aq, bq, pp)
    assert torch.equal(y, yp) and torch.equal(bqk.m, bqp.m)
    assert torch.equal(bqk.e, bqp.e) and torch.equal(y2, y2p)


# (BH, GS, T, D, s, pos, window): the first five (T 19 to 1100, a window)
# and the qwen2-0.5b decode slice at 4096 and at its published 32768
# positions; T 5001 (the windows' offset split lands inside a block's
# range; more than 32 windows summed again); a window across the blocks;
# the cluster sizes the split names at GS 7 (1 to 8: T up to 256, 300,
# 600, 1000, 1100, 1500, 1700, 4096; then 16 at 48000) and 15 at GS 56;
# D 12 and 48 (rows padded, copied by the threads), 32, 128 and 256.
DECODE_SHAPES = [(3, 7, 19, 16, 1, 18, 0), (2, 14, 40, 64, 2, 30, 0),
                 (4, 7, 33, 16, 1, 20, 8), (8, 7, 160, 64, 1, 159, 0),
                 (2, 7, 1100, 64, 1, 1099, 0), (8, 7, 4096, 64, 1, 4095, 0),
                 (8, 7, 32768, 64, 1, 32767, 0), (2, 7, 5001, 64, 1, 5000, 0),
                 (2, 7, 4096, 64, 1, 4000, 700), (2, 7, 1000, 64, 1, 999, 0),
                 (2, 7, 1500, 32, 1, 1499, 0), (2, 7, 1700, 128, 1, 1699, 0),
                 (1, 7, 48000, 64, 1, 47999, 0), (1, 56, 3622, 64, 8, 3600, 0),
                 (2, 9, 700, 12, 1, 650, 0), (2, 7, 600, 48, 1, 599, 0),
                 (2, 7, 300, 256, 1, 299, 0)]


def _decode_operands(g, dev, bh, gs, t, d, stochastic):
    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    qm, km, vm = i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    ek = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev,
                       dtype=torch.int32)
    ev = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev,
                       dtype=torch.int32)
    rp = prng.bits(prng.key(3), (bh, gs, t), dev) if stochastic else None
    eq = torch.tensor(122, dtype=torch.int32, device=dev)
    return qm, km, vm, ek, ev, rp, eq


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("bh,gs,t,d,s,pos,window", DECODE_SHAPES)
def test_decode_kernel_within_bound_of_plain(cuda, bh, gs, t, d, s, pos,
                                             window, stochastic):
    """y ==: the kernel's softmax spells the plain version's Cephes exp and
    windowed row sum, block by block of the cluster; the call moves the
    counter of the cluster size ``decode_split`` names."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qm, km, vm, ek, ev, rp, eq = _decode_operands(g, cuda, bh, gs, t, d,
                                                  stochastic)
    kw = dict(p=7, s=s, causal=True, window=window, stochastic=stochastic)
    kd.reset_kernel_launches()
    got = kfa.attn_decode(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    want = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max().item()
    n = kfa.decode_split(gs, t, d)
    counts = kd.kernel_launches()
    assert counts["attn_decode"] == 1 and counts[f"attn_decode_n{n}"] == 1


def _offset_view(x):
    """x as a contiguous view one element into a larger storage."""
    full = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = full[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("op,operand", [("attn_decode", "qm"),
                                        ("attn_decode", "km"),
                                        ("attn_decode", "vm"),
                                        ("attn_fwd", "qm"), ("attn_fwd", "km"),
                                        ("attn_bwd", "qm"), ("attn_bwd", "gm")])
def test_attention_offset_views_raise(cuda, op, operand):
    """An int8 operand as a contiguous view one byte into its storage: the
    wrapper raises ValueError naming it instead of faulting; the card stays
    usable (a call right after ==); the dispatch copies the operand and
    runs."""
    g = torch.Generator(device=cuda).manual_seed(44)
    if op == "attn_decode":
        qm, km, vm, ek, ev, rp, eq = _decode_operands(g, cuda, 8, 7, 160, 64,
                                                      True)
        args = [qm, km, vm, ek, ev, rp, eq, 159, 160]
        kw = dict(p=7, s=1, causal=True, window=0, stochastic=True)
        wrapper, plain, routed = kfa.attn_decode, kfa.attn_decode_plain, \
            kd.attn_decode
        i = {"qm": 0, "km": 1, "vm": 2}[operand]
    elif op == "attn_fwd":
        args, kw = _fwd_operands(g, cuda, TRAIN_SHAPES[0], True)
        wrapper, plain, routed = kfa.attn_fwd, kfa.attn_fwd_plain, kd.attn_fwd
        i = {"qm": 0, "km": 1}[operand]
    else:
        args, kw = _bwd_operands(g, cuda, TRAIN_SHAPES[0], True)
        wrapper, plain, routed = kfa.attn_bwd, kfa.attn_bwd_plain, kd.attn_bwd
        i = {"qm": 0, "gm": 1}[operand]
    bad = list(args)
    bad[i] = _offset_view(args[i])
    with pytest.raises(ValueError, match=operand):
        wrapper(*bad, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    for x, y in zip(_as_tuple(wrapper(*args, **kw)), _as_tuple(want)):
        assert torch.equal(x, y)
    for x, y in zip(_as_tuple(routed(*bad, **kw)), _as_tuple(want)):
        assert torch.equal(x, y)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# (B, M, K, N, blk): the qwen2-0.5b per-block training shapes (the gate's
# forward, the LM head's forward and its dX over 1187 blocks of the
# vocabulary, the batched PV of attention, w_down's forward, a layer's and
# the LM head's dW) and odd ones: 40 blocks of 32 with odd M and N and a
# batch, an odd dW-like shape, a block that is not a multiple of 4 (the
# unvectorised load), blocks of 64 and 256, K of 96 (three blocks of 32 in
# one 128-byte stage), M <= 16 and K % 16 != 0 (__dp4a).
QQ_BLK_SHAPES = [(1, 512, 896, 4864, 128), (1, 512, 896, 151936, 128),
                 (1, 512, 151936, 896, 128), (8, 896, 128, 64, 128),
                 (1, 512, 4864, 896, 128), (1, 4864, 512, 896, 128),
                 (1, 896, 512, 151936, 128),
                 (2, 37, 1280, 29, 32), (1, 65, 512, 131, 128),
                 (1, 19, 42, 23, 6), (1, 65, 512, 131, 64),
                 (1, 200, 1024, 300, 256), (1, 130, 96, 70, 32),
                 (1, 16, 256, 64, 128), (1, 37, 168, 29, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", QQ_BLK_SHAPES)
def test_qq_blk_kernel_equal_plain(cuda, shape, stochastic):
    """y and both mantissa arrays ==, with and without residuals, on the
    variant ``qq_blk_variant`` names (its counter moved, no other); the
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
    variant = kfl.qq_blk_variant(m, n, k, blk, True, nb)
    assert _variant_launches("qq_blk", kfl.QQ_BLK_VARIANTS) == {f"qq_blk_{variant}": 2}


def _qq_blk_tiles(a, ra, ea, b, rb, eb, blk, variant):
    """The Hopper route of qq_blk on ``variant``'s tiling, whatever the
    shape rule would pick: (y, am, bm)."""
    import ctypes
    nb, m, k = a.shape
    n = b.shape[1]
    dev = a.device
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
    bm = torch.empty((nb, n, k), dtype=torch.int8, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    sa = torch.empty((nb, k // blk, -(-m // 128) * 128), **i32)
    sb = torch.empty((nb, k // blk, -(-n // 128) * 128), **i32)
    ra, rb = (kfl.as_u32(ra), kfl.as_u32(rb)) if ra is not None else (None, None)
    p = kfl._ptr
    err = kfl._lib_sm90().repro_qq_blk_sm90(
        p(a), p(ra), p(ea), p(b), p(rb), p(eb), p(y), p(am), p(bm), p(sa), p(sb),
        nb, m, n, k, blk, 7, int(ra is not None), kfl.QQ_BLK_VARIANTS.index(variant),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    kfl._raise_on(err, f"qq_blk ({variant})")
    return y, am, bm


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wgmma", "wgmma64"])
@pytest.mark.parametrize("shape", [(1, 512, 896, 4864, 128), (8, 896, 128, 64, 128),
                                   (2, 37, 1280, 29, 32), (1, 130, 96, 70, 32),
                                   (1, 200, 1024, 300, 256)])
def test_qq_blk_both_tilings_equal_plain(cuda, shape, variant):
    """Each tiling of the Hopper route (128 x 128, two warpgroups; 64 x
    64, one, double-buffered at blocks of 128) == the plain version at
    shapes the rule gives the other one too: the block order of the sum
    does not depend on the tile."""
    nb, m, k, n, blk = shape
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randn((nb, m, k), generator=g, device=cuda)
    b = torch.randn((nb, n, k), generator=g, device=cuda)
    a[:, 0, :blk] *= 2.0 ** -70
    ra = prng.bits(prng.key(8), a.shape, cuda)
    rb = prng.bits(prng.key(9), b.shape, cuda)
    ea = ref.max_biased_exp_blocks_ref(a, blk)
    eb = ref.max_biased_exp_blocks_ref(b, blk)
    got = _qq_blk_tiles(a, ra, ea, b, rb, eb, blk, variant)
    want = kfl.fused_qq_blk_plain(a, ra, ea, b, rb, eb, p=7, blk=blk, stochastic=True)
    torch.cuda.synchronize()
    for name, x, y in zip(("y", "am", "bm"), got, want):
        assert torch.equal(x, y), (name, (x.float() - y.float()).abs().max().item())


@pytest.mark.cuda
def test_qq_blk_unaligned_view_takes_dp4a(cuda):
    """An operand off 16-byte alignment (TMA's rule) runs on __dp4a, ==."""
    g = torch.Generator(device=cuda).manual_seed(12)
    a = torch.randn((37 * 256 + 4,), generator=g, device=cuda)[1:1 + 37 * 256].view(1, 37, 256)
    b = torch.randn((1, 29, 256), generator=g, device=cuda)
    ea = ref.max_biased_exp_blocks_ref(a, 32)
    eb = ref.max_biased_exp_blocks_ref(b, 32)
    kd.reset_kernel_launches()
    got = kfl.fused_qq_blk(a, None, ea, b, None, eb, blk=32, stochastic=False)
    want = kfl.fused_qq_blk_plain(a, None, ea, b, None, eb, blk=32, stochastic=False)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert _variant_launches("qq_blk", kfl.QQ_BLK_VARIANTS) == {"qq_blk_dp4a": 1}


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
# offset; the __dp4a backward's narrow query strips: D = 128 over 9 blocks
# of bt = 512 (the last one ragged) and D = 256 with bt = 256, 8-row
# strips; on wgmma D 32 and 96 (n64 + n32) with two row tiles, T odd (the
# bits one by one) and a ragged last block; then for the wgmma forward,
# causal at D 64: query positions that wrap inside a row tile behind an
# offset (the last KV block masked for every row), and bt = 256 behind an
# offset, where the first row tile sees only the first chunk of the last
# KV block and a half of 64 positions of the others.
TRAIN_SHAPES = [(8, 896, 128, 64, 128, 0, 128, True, 0),
                (2, 21, 200, 12, 3, 0, 170, False, 0),
                (3, 35, 300, 16, 5, 0, 300, True, 0),
                (2, 64, 400, 64, 64, 0, 400, True, 100),
                (1, 14, 1500, 8, 2, 1498, 1500, True, 0),
                (1, 20, 4100, 128, 10, 0, 4100, False, 0),
                (1, 24, 2000, 256, 24, 1500, 1990, True, 300),
                (2, 40, 300, 32, 5, 0, 300, True, 0),
                (1, 150, 520, 96, 30, 0, 500, False, 0),
                (2, 21, 201, 64, 3, 0, 190, False, 0),
                (2, 100, 300, 64, 25, 150, 300, True, 0),
                (1, 130, 1200, 64, 130, 1030, 1200, True, 0)]


def _fwd_operands(g, dev, shape, stochastic):
    """attn_fwd's arguments at a TRAIN_SHAPES entry and its keywords."""
    bh, gs, t, d, s, q_off, kv_len, causal, window = shape
    qm, km, vm = (torch.randint(-127, 128, shp, generator=g, device=dev,
                                dtype=torch.int8)
                  for shp in ((bh, gs, d), (bh, t, d), (bh, t, d)))
    rp = prng.bits(prng.key(4), (bh, gs, t), dev) if stochastic else None
    eq, ek, ev = (torch.tensor(v, dtype=torch.int32, device=dev)
                  for v in (125, 125, 124))
    kw = dict(p=7, s=s, bt=kd.attn_block_t(t), causal=causal, window=window,
              stochastic=stochastic)
    return [qm, km, vm, rp, eq, ek, ev, q_off, kv_len], kw


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [4, 2])
@pytest.mark.parametrize("shape", [TRAIN_SHAPES[0], TRAIN_SHAPES[3],
                                   TRAIN_SHAPES[-2], TRAIN_SHAPES[-1]])
def test_attn_fwd_both_tilings_equal_plain(cuda, shape, nw):
    """The wgmma forward with four warpgroups a block (the tiling
    ``attn_fwd_tiles`` picks) and with two (D 64 only), launched through the
    C entry: y, m, l == the plain version; its shared memory is the layout
    ``_tc_fwd_layout`` mirrors."""
    import ctypes
    lib = kfa._lib_train()
    for bt in (128, 256, 512):
        for dd in (32, 64, 96, 128):
            assert lib.repro_attn_fwd_tc_smem(dd, bt) == \
                kfa._tc_fwd_layout(dd, bt)[0]
    g = torch.Generator(device=cuda).manual_seed(6)
    args, kw = _fwd_operands(g, cuda, shape, True)
    qm, km, vm, rp, eq, ek, ev, q_off, kv_len = args
    bh, gs, t, d = *qm.shape[:2], km.shape[1], qm.shape[2]
    want = kfa.attn_fwd_plain(*args, **kw)
    got = [torch.empty_like(x) for x in want]
    err = lib.repro_attn_fwd_tc(
        *(kfl._ptr(x) for x in (qm, km, vm, kfl.as_u32(rp), eq, ek, ev, *got)),
        bh, gs, t, d, kw["s"], q_off, min(kv_len, t), int(kw["causal"]),
        kw["window"], 7, kw["bt"], 1, nw,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    torch.cuda.synchronize()
    for name, x, y in zip(("y", "m", "l"), got, want):
        assert torch.equal(x, y), (name, (x - y).abs().max().item())


def _bwd_operands(g, dev, shape, stochastic):
    """attn_bwd's arguments at a TRAIN_SHAPES entry (the row stats from the
    forward's plain version) and its keywords."""
    bh, gs, t, d, s, q_off, kv_len, causal, window = shape

    def i8(*shp):
        return torch.randint(-127, 128, shp, generator=g, device=dev,
                             dtype=torch.int8)

    def e(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    qm, gm, km, vm = i8(bh, gs, d), i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    rp, rs, rp2 = (prng.bits(prng.key(i), (bh, gs, t), dev) if stochastic
                   else None for i in (4, 5, 6))
    eq, ek, ev, eg = e(125), e(125), e(124), e(110)
    kw = dict(p=7, s=s, bt=kd.attn_block_t(t), causal=causal, window=window,
              stochastic=stochastic)
    _, m, l = kfa.attn_fwd_plain(qm, km, vm, rp, eq, ek, ev, q_off, kv_len,
                                 **kw)
    delta = torch.randn((bh, gs, 1), generator=g, device=dev) * 1e-3
    return [qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, q_off,
            kv_len], kw


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_attn_train_kernels_equal_plain(cuda, shape, stochastic):
    """attn_fwd (y, m, l) and attn_bwd (dq, dk, dv) == their plain
    versions: the kernels reproduce the plain float order op for op; each
    on the route ``attn_fwd_variant`` / ``attn_bwd_variant`` names (its
    counter)."""
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
    counts = kd.kernel_launches()
    assert counts["attn_fwd"] == 1
    assert counts["attn_bwd"] == 1
    fvariant = kfa.attn_fwd_variant(gs, t, d, kw["bt"])
    assert fvariant == ("wgmma" if d in (32, 64, 96, 128) else "dp4a")
    assert counts[f"attn_fwd_{fvariant}"] == 1
    variant = kfa.attn_bwd_variant(gs, t, d, kw["bt"])
    assert variant == ("wgmma" if d in (32, 64, 96, 128) else "dp4a")
    assert counts[f"attn_bwd_{variant}"] == 1


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
# shapes: rows off the 64-row tile, K not a multiple of 32 nor of 4 (the
# __dp4a variant), N off the column tile (an odd GLU half), every epilogue.
EPI_SHAPES = [(512, 2304, 11520, "silu_glu", False),
              (512, 4608, 36864, "gelu_glu", False),
              (37, 67, 58, "silu_glu", True), (37, 67, 58, "gelu_glu", True),
              (130, 96, 70, "relu", True), (130, 96, 70, "gelu", True),
              (65, 40, 29, "gelu", False), (65, 40, 29, None, False)]


def _epi_variant_launches():
    return _variant_launches("gemm_epi", kfl.GEMM_EPI_VARIANTS)


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", EPI_SHAPES)
def test_gemm_epi_kernel_equal_plain(cuda, shape, stochastic):
    """y, both mantissas and ylin ==; a row of gate inputs so large that
    the logistic is sub-normal (flushed in both) and the tanh saturates;
    the call moves the counter of the variant ``gemm_epi_variant`` names."""
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
    assert _epi_variant_launches() == {
        f"gemm_epi_{kfl.gemm_epi_variant(m, k, n, act)}": 1}


def _epi_operands(g, dev, kind, m, k, n, stochastic, m_true=None):
    """gemm_epi's operands of ``kind``: f32 values (a row of them large) or
    int8 mantissas with exponents that put y well above the bias; the rows
    from ``m_true`` on are zero (the reference's padding rows)."""
    a = torch.randn((m, k), generator=g, device=dev)
    b = torch.randn((n, k), generator=g, device=dev)
    a[1] *= 300.0
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    if kind == "ii":
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8)
        ea = torch.tensor(129, dtype=torch.int32, device=dev)
    if kind != "qq":
        b = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                          dtype=torch.int8)
        eb = torch.tensor(127, dtype=torch.int32, device=dev)
    if m_true is not None:
        a[m_true:] = 0
    ra = (prng.bits(prng.key(14), (m, k), dev)
          if stochastic and kind != "ii" else None)
    rb = prng.bits(prng.key(15), (n, k), dev) if stochastic and kind == "qq" else None
    return a, ra, b, rb, ea, eb


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("act", kfl.EPI_ACTS)
@pytest.mark.parametrize("kind", ["qq", "qi", "ii"])
def test_gemm_epi_kinds_equal_plain(cuda, kind, act, with_bias):
    """Every kind with every act, with and without a bias, on the tensor
    cores (K 96, an odd GLU half of 35 columns) and on __dp4a (K 67),
    stochastic: y, the mantissas the kind quantizes and ylin ==."""
    g = torch.Generator(device=cuda).manual_seed(17)
    for m, k, n in ((130, 96, 70), (37, 67, 58)):
        a, ra, b, rb, ea, eb = _epi_operands(g, cuda, kind, m, k, n, True)
        bias = (torch.randn((1, n), generator=g, device=cuda) if with_bias
                else None)
        kw = dict(kind=kind, p=7, stochastic=True, act=act)
        kd.reset_kernel_launches()
        got = kfl.fused_gemm_epi(a, ra, b, rb, bias, None, ea, eb, **kw)
        want = kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, None, ea, eb, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (m, k, n, (x.float() - y.float()).abs().max().item())
        assert _epi_variant_launches() == {
            f"gemm_epi_{kfl.gemm_epi_variant(m, k, n, act)}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("m_true", [None, 100])
@pytest.mark.parametrize("kind", ["qq", "qi", "ii"])
def test_gemm_epi_out_q_equal_plain(cuda, kind, m_true, stochastic):
    """The per-tensor out-quantize (ym, the meta row, the residuals) ==,
    its exponent over every row or only the rows below m_true (the rest
    zero-padded, so y there is act(bias)): the SiLU-GLU on the tensor
    cores (an odd half), the GELU-GLU on __dp4a, a bias-free relu with M *
    N % 4 != 0 (the pass's tail)."""
    g = torch.Generator(device=cuda).manual_seed(19)
    for m, k, n, act in ((130, 96, 70, "silu_glu"), (130, 67, 58, "gelu_glu"),
                         (131, 96, 71, "relu")):
        a, ra, b, rb, ea, eb = _epi_operands(g, cuda, kind, m, k, n, stochastic,
                                             m_true)
        n_out = n // 2 if act.endswith("_glu") else n
        bias = (torch.randn((1, n), generator=g, device=cuda)
                if act != "relu" else None)
        rq = prng.bits(prng.key(16), (m, n_out), cuda) if stochastic else None
        kw = dict(kind=kind, p=7, stochastic=stochastic, act=act, out_q=True,
                  m_true=m_true)
        kd.reset_kernel_launches()
        got = kfl.fused_gemm_epi(a, ra, b, rb, bias, rq, ea, eb, **kw)
        want = kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, rq, ea, eb, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want) and got[0].dtype == torch.int8
        for x, y in zip(got, want):
            assert torch.equal(x, y), (m, k, n, (x.float() - y.float()).abs().max().item())
        assert _epi_variant_launches() == {
            f"gemm_epi_{kfl.gemm_epi_variant(m, k, n, act)}": 1}


@pytest.mark.cuda
def test_gemm_epi_unaligned_view_takes_dp4a(cuda):
    """An operand one element into its storage (K % 16 == 0, yet off
    16-byte alignment) runs on __dp4a, ==."""
    g = torch.Generator(device=cuda).manual_seed(23)
    m, k, n = 37, 64, 58
    a = torch.randn((m * k + 4,), generator=g, device=cuda)[1:1 + m * k].view(m, k)
    b = torch.randn((n, k), generator=g, device=cuda)
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    ra, rb = prng.bits(prng.key(3), a.shape, cuda), prng.bits(prng.key(4), b.shape, cuda)
    assert kfl.gemm_epi_variant(m, k, n, "silu_glu", kfl._aligned(a)) == "dp4a"
    kd.reset_kernel_launches()
    got = kfl.fused_gemm_epi(a, ra, b, rb, None, None, ea, eb, act="silu_glu")
    want = kfl.fused_gemm_epi_plain(a, ra, b, rb, None, None, ea, eb, act="silu_glu")
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert _epi_variant_launches() == {"gemm_epi_dp4a": 1}


# (M, K, N, center, beta): minicpm-2b's QKV training chain (512 tokens,
# 2304 -> 6912) and odd ones: rows off every strip and tile, K off the
# 32-wide slice and of 4 (the __dp4a variant), N off the 64-column tile,
# LayerNorm with and without the shift, a K of 40000 (the norm pass's
# 80 KB row), one row.
NORM_SHAPES = [(512, 2304, 6912, False, False), (37, 100, 70, True, True),
               (130, 67, 29, False, True), (16, 4000, 130, True, False),
               (37, 112, 70, True, True), (130, 96, 29, False, True),
               (9, 40000, 64, True, True), (1, 2304, 200, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_norm_gemm_kernel_equal_plain(cuda, shape, stochastic):
    """y, xq, meta and c ==; a row of zeros and a tiny row; the call moves
    the counter of the variant ``norm_gemm_variant`` names."""
    m, k, n, center, with_beta = shape
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn((m, k), generator=g, device=cuda) * 3.0
    x[0] = 0.0
    x[1 % m] *= 2.0 ** -60
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
    assert _variant_launches("norm_gemm", kfc.NORM_GEMM_VARIANTS) == {
        f"norm_gemm_{kfc.norm_gemm_variant(m, k)}": 1}


@pytest.mark.cuda
def test_norm_gemm_unaligned_weight_takes_dp4a(cuda):
    """A weight one byte into its storage (TMA's rule) runs on __dp4a, whose
    4-byte weight loads then read it byte by byte, ==."""
    g = torch.Generator(device=cuda).manual_seed(24)
    m, k, n = 37, 128, 70
    x = torch.randn((m, k), generator=g, device=cuda)
    gm = torch.randint(1 << 13, 1 << 15, (1, k), generator=g, device=cuda,
                       dtype=torch.int32)
    wm = torch.randint(-127, 128, (n * k + 16,), generator=g, device=cuda,
                       dtype=torch.int8)[1:1 + n * k].view(n, k)
    se_w = torch.full((1, n), -9, dtype=torch.int32, device=cuda)
    se_g = torch.tensor(-15, dtype=torch.int32, device=cuda)
    assert kfc.norm_gemm_variant(m, k, kfl._aligned(wm)) == "dp4a"
    args = (x, None, None, gm, se_g, None, None, wm, se_w)
    kd.reset_kernel_launches()
    got = kfc.fused_norm_gemm(*args, n=k)
    want = kfc.norm_gemm_plain(*args, n=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert _variant_launches("norm_gemm", kfc.NORM_GEMM_VARIANTS) == {"norm_gemm_dp4a": 1}


# (B, d, n_ff, hq, hkv, dh, T, pos, window): minicpm-2b's decode layer (4
# streams and one, a 160-row cache, the last position, mid-cache, the
# first, a window) and an odd one: GQA groups of 4, a sliding window, a
# cache of 40 rows, pos mid-cache.
DECODE_BLOCK_SHAPES = [(4, 2304, 5760, 36, 36, 64, 160, 159, 0),
                       (4, 2304, 5760, 36, 36, 64, 160, 128, 0),
                       (4, 2304, 5760, 36, 36, 64, 160, 0, 0),
                       (1, 2304, 5760, 36, 36, 64, 160, 159, 0),
                       (1, 2304, 5760, 36, 36, 64, 160, 7, 64),
                       (3, 256, 320, 8, 2, 32, 40, 37, 8)]


def _decode_block_args(g, dev, b, d, n_ff, hq, hkv, dh, t, pos):
    def i8(*shp):
        return torch.randint(-127, 128, shp, generator=g, device=dev,
                             dtype=torch.int8)

    def se(n):
        return torch.randint(-14, -9, (1, n), generator=g, device=dev,
                             dtype=torch.int32)

    def rows(*shp):
        return torch.randint(118, 126, shp, generator=g, device=dev,
                             dtype=torch.int32)

    nqkv = (hq + 2 * hkv) * dh
    ang = torch.rand(dh // 2, generator=g, device=dev) * 3
    cossin = torch.cat([ang.cos(), ang.cos(), ang.sin(), ang.sin()])[None]
    gains = [torch.randint(1 << 13, 1 << 15, (1, d), generator=g,
                           device=dev, dtype=torch.int32) for _ in range(2)]
    return (torch.randn((b, d), generator=g, device=dev), i8(nqkv, d),
            se(nqkv), i8(d, hq * dh), se(d), i8(2 * n_ff, d), se(2 * n_ff),
            i8(d, n_ff), se(d), *gains, i8(b, hkv, t, dh),
            rows(b, hkv, t, 1), i8(b, hkv, t, dh), rows(b, hkv, t, 1),
            cossin.contiguous(), pos)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_BLOCK_SHAPES)
def test_decode_block_kernel_equal_plain(cuda, shape):
    """x_out and the fresh K/V rows ==: the kernel spells the plain
    version's exp and its windowed softmax sum."""
    b, d, n_ff, hq, hkv, dh, t, pos, window = shape
    g = torch.Generator(device=cuda).manual_seed(31)
    args = _decode_block_args(g, cuda, b, d, n_ff, hq, hkv, dh, t, pos)
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


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["x", "km", "vm"])
def test_decode_block_offset_views_raise(cuda, operand):
    """x, the K cache or the V cache as a contiguous view one element into
    its storage: the launcher raises ValueError naming it instead of
    faulting, the card stays usable (a call right after ==), and
    ``run_decode_block`` copies the operand and runs."""
    b, d, n_ff, hq, hkv, dh, t, pos = 2, 256, 320, 8, 2, 32, 40, 37
    g = torch.Generator(device=cuda).manual_seed(33)
    args = list(_decode_block_args(g, cuda, b, d, n_ff, hq, hkv, dh, t, pos))
    i = {"x": 0, "km": 11, "vm": 13}[operand]
    full = torch.empty(args[i].numel() + 16, dtype=args[i].dtype, device=cuda)
    view = full[1:1 + args[i].numel()].view(args[i].shape)
    view.copy_(args[i])
    bad = list(args)
    bad[i] = view
    kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=7, se_g1=-14, se_g2=-14)
    with pytest.raises(ValueError, match=operand):
        kfc.fused_decode_block(*bad, **kw)
    torch.cuda.synchronize()
    want = kfc.decode_block_plain(*args, **kw)
    for x, y in zip(kfc.fused_decode_block(*args, **kw), want):
        assert torch.equal(x, y)
    dec = kd.Decision("b", kd.FUSED, "test", b, d, n_ff, "decode_block", "cuda", t)
    for x, y in zip(kd.run_decode_block(*bad, dec, **kw), want):
        assert torch.equal(x, y)


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
# Phase 9's shapes at full width (B, M, K, N): the LM head's forward and
# dW, the attention's batched QKᵀ, PV and QKᵀ's dW; then M <= 16 with a
# batch (the streaming variant).
MATMUL_MAIN_SHAPES = [(1, 512, 896, 151936), (1, 896, 512, 151936),
                      (8, 896, 64, 128), (8, 896, 128, 64), (8, 64, 896, 128),
                      (2, 4, 512, 70)]


def _int8_matmul_equal_plain(cuda, am, bm, variant):
    """Two calls (scale 2^-20 and one that flushes to 0) ``==`` the plain
    version, both on ``variant``."""
    kd.reset_kernel_launches()
    for e in (-20, -150):
        scale = kfl.pow2_f32(torch.tensor(e, device=cuda))
        got = kim.int8_matmul(am, bm, scale)
        want = kim.int8_matmul_plain(am, bm, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (got - want).abs().max().item()
    assert kd.kernel_launches()["int8_matmul"] == 2
    assert _variant_launches("int8_matmul", kim.INT8_MATMUL_VARIANTS) == {
        f"int8_matmul_{variant}": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_int8_matmul_kernel_equal_plain(cuda, shape):
    nb, m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(13)
    am = torch.randint(-127, 128, (nb, m, k), generator=g, device=cuda,
                       dtype=torch.int8)
    bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=cuda,
                       dtype=torch.int8)
    _int8_matmul_equal_plain(cuda, am, bm, kim.int8_matmul_variant(m, k))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MATMUL_MAIN_SHAPES + ["unaligned"])
def test_int8_matmul_variants_equal_plain(cuda, shape):
    """Phase 9's shapes on wgmma, M <= 16 on stream, and an operand one
    byte into its storage (K % 16 == 0, yet not 16-byte aligned) on wmma;
    each call moves its variant's counter."""
    g = torch.Generator(device=cuda).manual_seed(16)
    if shape == "unaligned":
        nb, m, k, n = 1, 37, 64, 29
        am = torch.randint(-127, 128, (nb * m * k + 16,), generator=g,
                           device=cuda, dtype=torch.int8
                           )[1:1 + nb * m * k].view(nb, m, k)
        want = "wmma"
    else:
        nb, m, k, n = shape
        am = torch.randint(-127, 128, (nb, m, k), generator=g, device=cuda,
                           dtype=torch.int8)
        want = "stream" if m <= 16 else "wgmma"
    bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=cuda,
                       dtype=torch.int8)
    assert kim.int8_matmul_variant(m, k, kfl._aligned(am, bm)) == want
    _int8_matmul_equal_plain(cuda, am, bm, want)


# The rounding-bit kernel's shapes: a scalar, one word, an odd count, one
# word either side of prng's 2^24-word chunk, and the LM head's weight
# (151936 x 896), the largest draw of a qwen2 step.
BITS_SHAPES = [(), (1,), (7,), (1 << 24) - 1, (1 << 24) + 3, (151936, 896)]


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["partitionable", "iota_halves", "hash"])
@pytest.mark.parametrize("shape", BITS_SHAPES)
def test_rounding_bits_kernel_equal_plain(cuda, shape, stream):
    """The kernel ``==`` ``prng.bits`` in both key modes and ``==``
    ``prng.hash_bits``, one launch a draw; ``core.bfp.rounding_bits`` on
    the card is the kernel, inside ``plain_kernels()`` the plain draw."""
    shape = shape if isinstance(shape, tuple) else (shape,)
    key = prng.fold_in(prng.key(7, partitionable=stream != "iota_halves"),
                       3)
    rng = "hash" if stream == "hash" else "threefry"
    kd.reset_kernel_launches()
    got = krb.rounding_bits(key, shape, rng, cuda)
    assert kd.kernel_launches()["rounding_bits"] == 1
    want = krb.rounding_bits_plain(key, shape, rng, cuda)
    assert got.dtype == torch.int64 and got.shape == want.shape
    assert torch.equal(got, want)
    routed = bfp.rounding_bits(key, shape, rng, cuda)
    with kd.plain_kernels():
        plain = bfp.rounding_bits(key, shape, rng, cuda)
    assert kd.kernel_launches()["rounding_bits"] == 2
    assert torch.equal(routed, want) and torch.equal(plain, want)


@pytest.mark.cuda
def test_rounding_bits_launch_failure_raises(cuda, monkeypatch):
    """A launch the kernel refuses (an unknown stream) raises and counts
    nothing: no fallback to the plain draw."""
    kd.reset_kernel_launches()
    with monkeypatch.context() as m:
        m.setattr(krb, "_mode", lambda key, rng: 3)
        with pytest.raises(RuntimeError, match="rounding_bits launch failed"):
            krb.rounding_bits(prng.key(0), (64,), device=cuda)
    assert kd.kernel_launches()["rounding_bits"] == 0
    assert torch.equal(krb.rounding_bits(prng.key(0), (64,), device=cuda)
                       .cpu(), prng.bits(prng.key(0), (64,)))


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
