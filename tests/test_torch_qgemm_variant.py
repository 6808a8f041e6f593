"""The shape rules that pick the qq / qi / ii, qq_blk and int8_matmul
kernel variants, and the decode block kernel's shape rule and layout (CPU,
no card).

``kernels.fused_linear.qgemm_variant`` (qi, ii) and ``qq_variant`` (qq)
choose, from the shapes alone and before any launch, between the
tensor-core kernel (``wgmma``, M > 16), the weight-streaming kernel
(``stream``, M <= 16) and the ``__dp4a`` kernel (K not a multiple of 16,
or an operand not 16-byte aligned); ``kernels.int8_matmul
.int8_matmul_variant`` between the same two Hopper kernels and the wmma
kernel in ``__dp4a``'s place; ``qq_blk_variant`` between the two tilings
of the Hopper per-block route and the ``__dp4a`` kernel;
``gemm_epi_variant`` and ``kernels.fused_chain.norm_gemm_variant``
between the tensor-core route (a quantize or norm pass, then ``wgmma``)
and the ``__dp4a`` kernel.
"""

import pytest
import torch

from repro_torch.core.bfp import QuantConfig
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as kfa
from repro_torch.kernels import fused_chain as kfc
from repro_torch.kernels import fused_linear as kfl
from repro_torch.kernels import int8_matmul as kim

# Every K the main path's qq / qi / ii / int8_matmul contractions take (the
# head dim, the sequence, the 512 tokens of a training batch, qwen2 /
# minicpm / starcoder2 widths, d_ff and starcoder2's vocabulary).
MAIN_PATH_K = (64, 128, 512, 896, 2304, 4608, 4864, 5760, 18432, 49152)


@pytest.mark.parametrize("k", [1, 8, 24, 33, 37, 67, 100, 4863])
@pytest.mark.parametrize("m", [4, 512])
def test_k_not_multiple_of_16_takes_dp4a(m, k):
    assert kfl.qgemm_variant(m, k) == "dp4a"


@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k", [16, 896, 2304, 4864])
def test_m_up_to_16_streams(m, k):
    assert kfl.qgemm_variant(m, k) == "stream"


@pytest.mark.parametrize("m,k", [(17, 896), (130, 96), (512, 4864),
                                 (896, 512), (16, 18432), (4, 49152)])
def test_larger_m_or_a_rows_past_shared_memory_take_wgmma(m, k):
    """M > 16, or a rows (M x K rounded up to 128, +16 bytes) over the
    stream kernel's 96 KB: the tensor cores."""
    assert kfl.qgemm_variant(m, k) == "wgmma"


@pytest.mark.parametrize("k", MAIN_PATH_K)
def test_main_path_k_never_takes_dp4a(k):
    for m in (4, 17, 512, 4864, 151936):
        assert kfl.qgemm_variant(m, k) in ("wgmma", "stream")


def test_misaligned_operand_takes_dp4a():
    base = torch.zeros(64 * 17, dtype=torch.int8)
    view = base[1:1 + 64 * 16].view(16, 64)
    assert kfl._aligned(base, None) and not kfl._aligned(base, view)
    assert kfl.qgemm_variant(16, 64, kfl._aligned(view)) == "dp4a"
    assert kfl.qgemm_variant(16, 64, kfl._aligned(base)) == "stream"


# The rules of the four kinds, each returning its fallback's name for K %
# 16 != 0 or an unaligned operand.
RULES = {"qi": (kfl.qgemm_variant, "dp4a"), "ii": (kfl.qgemm_variant, "dp4a"),
         "qq": (kfl.qq_variant, "dp4a"),
         "int8_matmul": (kim.int8_matmul_variant, "wmma")}


@pytest.mark.parametrize("kind", ["qq", "int8_matmul"])
@pytest.mark.parametrize("m,k,aligned,want", [
    (512, 67, True, "fallback"), (4, 33, True, "fallback"),
    (512, 896, False, "fallback"), (4, 896, True, "stream"),
    (16, 128, True, "stream"), (17, 896, True, "wgmma"),
    (4, 49152, True, "wgmma")])
def test_qq_and_int8_matmul_rules(kind, m, k, aligned, want):
    """K % 16 != 0 or an unaligned operand: the fallback (``__dp4a`` for
    qq, wmma for int8_matmul); M <= 16 whose a rows fit: stream; the rest
    on the tensor cores."""
    rule, fallback = RULES[kind]
    assert rule(m, k, aligned) == (fallback if want == "fallback" else want)


@pytest.mark.parametrize("kind", ["qq", "int8_matmul"])
@pytest.mark.parametrize("k", MAIN_PATH_K)
def test_qq_and_int8_matmul_main_path_k_never_fall_back(kind, k):
    rule, fallback = RULES[kind]
    for m in (4, 17, 64, 512, 896, 4864):
        assert rule(m, k) in ("wgmma", "stream") and rule(m, k) != fallback


@pytest.mark.parametrize("nb,m,k,n", [(8, 896, 64, 128), (8, 896, 128, 64),
                                      (16, 1152, 128, 128)])
def test_attention_qq_shapes_take_wgmma(nb, m, k, n):
    """The prefill attention's QKᵀ and PV (qwen2: batch 4 x 2 KV heads, 7
    query heads of 128 positions over D = 64; starcoder2: 4 x 4 KV heads,
    groups of 9 over D = 128): the tensor cores, which ``chip_smoke.py``
    measured faster there than the ``__dp4a`` kernel (PERF.md, row 1)."""
    assert kfl.qq_variant(m, k) == "wgmma"


def test_every_variant_has_a_counter():
    names = set(kd.kernel_launches())
    for kind, (_, fallback) in RULES.items():
        variants = (kim.INT8_MATMUL_VARIANTS if kind == "int8_matmul"
                    else kfl.QGEMM_VARIANTS)
        assert fallback in variants
        assert {f"{kind}_{v}" for v in variants} <= names
    assert {f"gemm_epi_{v}" for v in kfl.GEMM_EPI_VARIANTS} <= names
    assert {f"norm_gemm_{v}" for v in kfc.NORM_GEMM_VARIANTS} <= names


# qq_blk: (B, M, K, N) of every per-block contraction of a qwen2-0.5b
# int8_block step at 4 x 128 tokens (blk 128), calls a step, and the
# variant: the 128 x 128 tiles where they fill the card's 132 SMs, the
# 64 x 64 ones elsewhere (the LM head's dX among them: N 896).
INT8_BLOCK_STEP = [((1, 512, 896, 896), 96, "wgmma64"),
                   ((1, 512, 896, 128), 48, "wgmma64"),
                   ((1, 512, 128, 896), 48, "wgmma64"),
                   ((1, 512, 896, 4864), 72, "wgmma"),
                   ((1, 512, 4864, 896), 72, "wgmma64"),
                   ((1, 896, 512, 896), 48, "wgmma64"),
                   ((1, 896, 512, 128), 48, "wgmma64"),
                   ((1, 896, 512, 4864), 48, "wgmma"),
                   ((1, 4864, 512, 896), 24, "wgmma"),
                   ((8, 896, 128, 64), 48, "wgmma64"),
                   ((8, 128, 896, 64), 24, "wgmma64"),
                   ((8, 64, 896, 128), 24, "wgmma64"),
                   ((1, 512, 896, 151936), 1, "wgmma"),
                   ((1, 512, 151936, 896), 1, "wgmma64"),
                   ((1, 896, 512, 151936), 1, "wgmma")]


@pytest.mark.parametrize("shape,calls,want", INT8_BLOCK_STEP)
def test_qq_blk_int8_block_step_variants(shape, calls, want):
    nb, m, k, n = shape
    assert kfl.qq_blk_variant(m, n, k, 128, True, nb) == want


def test_qq_blk_int8_block_step_counts():
    """603 calls a step: 146 on the 128 x 128 tiles, 457 on the 64 x 64
    ones (chip_smoke.py phase 6 holds the card to the same split)."""
    by = {}
    for (nb, m, k, n), calls, _ in INT8_BLOCK_STEP:
        v = kfl.qq_blk_variant(m, n, k, 128, True, nb)
        by[v] = by.get(v, 0) + calls
    assert by == {"wgmma": 146, "wgmma64": 457}


@pytest.mark.parametrize("m,k,blk,aligned,want", [
    (512, 896, 128, True, "hopper"), (512, 1280, 32, True, "hopper"),
    (512, 512, 64, True, "hopper"), (512, 1024, 256, True, "hopper"),
    (512, 1536, 384, True, "hopper"), (130, 96, 32, True, "hopper"),
    (512, 896, 8, True, "dp4a"),      # blk % 32
    (512, 960, 96, True, "dp4a"),     # 96 neither divides 128 nor is a multiple
    (512, 168, 8, True, "dp4a"),      # K % 16
    (512, 896, 128, False, "dp4a"),   # an unaligned operand
    (16, 896, 128, True, "dp4a"),     # M <= 16
    (17, 896, 128, True, "hopper")])
def test_qq_blk_rule(m, k, blk, aligned, want):
    v = kfl.qq_blk_variant(m, 4864, k, blk, aligned)
    assert (v == "dp4a") == (want == "dp4a")
    assert v in kfl.QQ_BLK_VARIANTS


@pytest.mark.parametrize("nb,m,n,want", [(1, 512, 4864, "wgmma"), (1, 512, 896, "wgmma64"),
                                         (1, 4096, 4096, "wgmma"), (8, 896, 64, "wgmma64"),
                                         (33, 512, 128, "wgmma"), (32, 512, 128, "wgmma64")])
def test_qq_blk_tile_choice(nb, m, n, want):
    """128 x 128 tiles at 132 of them or more (a batch counts), else 64 x 64."""
    assert kfl.qq_blk_variant(m, n, 896, 128, True, nb) == want


def test_qq_blk_variants_have_counters():
    names = set(kd.kernel_launches())
    assert {f"qq_blk_{v}" for v in kfl.QQ_BLK_VARIANTS} <= names


# decode_block: the minicpm-2b layer (B 1-8, a 160-row cache) and the
# smoke widths fit the kernel with a ring of several stages; the layout
# the wrapper asks for is what the source computes.
@pytest.mark.parametrize("b", [1, 4, 8])
def test_decode_block_minicpm_fits_a_deep_ring(b):
    shape = (b, 2304, 5760, 36, 36, 64, 160)
    assert kfc.decode_block_unsupported(*shape) == ""
    assert kfc.decode_block_stages(*shape) >= 6
    assert kfc.decode_block_smem_bytes(*shape) <= kfa.SMEM_LIMIT


def test_decode_block_layout_sums():
    """rest + stages x (8 padded rows of the longest chunk + mbarriers and
    tag), the rows padded to 16 bytes past a multiple of 32."""
    shape = (4, 2304, 5760, 36, 36, 64, 160)
    rest, stage = kfc._dec_layout(*shape)
    assert stage == 8 * (2304 + 16) + 24
    assert kfc.decode_block_smem_bytes(*shape) == rest + kfc.decode_block_stages(*shape) * stage
    # K 5760 in three chunks of 1920; 2304 in one
    assert kfc._dec_chunk(5760) == 1920 and kfc._dec_chunk(2304) == 2304
    assert kfc._dec_chunk(2320) == 1184      # two chunks, rounded up to 32


@pytest.mark.parametrize("b", [1, 4, 8])
@pytest.mark.parametrize("t", [16, 160, 1024])
def test_decode_block_takes_minicpm_at_every_cache(b, t):
    """minicpm-2b, the repo's model that reaches the kernel, at batch 1-8
    and a cache of up to 1024 rows: a ring of 2304-byte chunks, 7 stages
    or more."""
    kch, nst, _, _ = kfc._dec_ring(b, 2304, 5760, 36, 36, 64, t)
    assert (kch, nst >= 7) == (2304, True)


def test_decode_block_ring_shortens_its_chunk_to_fit():
    """Near the shared-memory limit the stage's chunk of K shortens so that
    two stages fit (8 rows of starcoder2-7b widths at batch 8)."""
    shape = (8, 4608, 18432, 36, 4, 128, 16)
    kch, nst, rest, stage = kfc._dec_ring(*shape)
    assert kch < 2304 and nst >= 2
    assert rest + nst * stage == kfc.decode_block_smem_bytes(*shape) <= kfa.SMEM_LIMIT
    assert kfc.decode_block_unsupported(*shape) == ""


def test_decode_block_rejects_past_its_limits():
    assert "batch" in kfc.decode_block_unsupported(9, 256, 320, 8, 2, 32, 40)
    assert "multiples of 16" in kfc.decode_block_unsupported(2, 250, 320, 8, 2, 32, 40)
    assert "cache length" in kfc.decode_block_unsupported(2, 256, 320, 8, 2, 32, 1025)
    assert "shared memory" in kfc.decode_block_unsupported(8, 8192, 28672, 64, 8, 128, 1024)


# gemm_epi's main-path shapes (M, K, N, act): the gate|up GEMM with its GLU
# of minicpm-2b (phase 8) and starcoder2-7b (phase 10) training at 4 x 128
# tokens, and at one stream and four.
EPI_MAIN = [(m, 2304, 11520, "silu_glu") for m in (512, 4, 1)] + \
    [(m, 4608, 36864, "gelu_glu") for m in (512, 4, 1)]


@pytest.mark.parametrize("m,k,n,act", EPI_MAIN)
def test_gemm_epi_main_path_takes_wgmma(m, k, n, act):
    assert kfl.gemm_epi_variant(m, k, n, act) == "wgmma"


@pytest.mark.parametrize("act", kfl.EPI_ACTS)
@pytest.mark.parametrize("k", [40, 67, 100, 2300])
def test_gemm_epi_k_not_multiple_of_16_takes_dp4a(k, act):
    assert kfl.gemm_epi_variant(130, k, 70, act) == "dp4a"


@pytest.mark.parametrize("m,n", [(1, 58), (16, 70), (37, 2), (130, 74)])
def test_gemm_epi_odd_glu_half_and_small_m_take_wgmma(m, n):
    """A GLU half of 29, 35, 1 or 37 rows (each half its own tensor map,
    zero-filled past it) and M down to 1 (a 128-row tile masks the rest)."""
    for act in ("silu_glu", "gelu_glu"):
        assert kfl.gemm_epi_variant(m, 96, n, act) == "wgmma"


def test_gemm_epi_rule_rejects_odd_glu_and_unknown_act():
    with pytest.raises(ValueError, match="even N"):
        kfl.gemm_epi_variant(16, 96, 71, "silu_glu")
    with pytest.raises(ValueError, match="act"):
        kfl.gemm_epi_variant(16, 96, 70, "tanh")
    assert kfl.gemm_epi_variant(16, 96, 71, "relu") == "wgmma"


def test_gemm_epi_misaligned_operand_takes_dp4a():
    base = torch.zeros(64 * 40, dtype=torch.float32)
    view = base[1:1 + 64 * 37].view(37, 64)
    assert kfl.gemm_epi_variant(37, 64, 58, "silu_glu", kfl._aligned(view)) == "dp4a"
    assert kfl.gemm_epi_variant(37, 64, 58, "silu_glu", kfl._aligned(base)) == "wgmma"


# norm_gemm's main-path shapes (M, K): minicpm-2b's QKV chain at 4 x 128
# tokens, one stream and four; qwen2-0.5b's and starcoder2-7b's widths.
@pytest.mark.parametrize("m,k", [(512, 2304), (4, 2304), (1, 2304),
                                 (512, 896), (512, 4608)])
def test_norm_gemm_main_path_takes_wgmma(m, k):
    assert kfc.norm_gemm_variant(m, k) == "wgmma"


@pytest.mark.parametrize("k", [67, 100, 4000 + 8, 40001])
def test_norm_gemm_k_not_multiple_of_16_takes_dp4a(k):
    assert kfc.norm_gemm_variant(37, k) == "dp4a"


def test_norm_gemm_wide_rows_and_alignment():
    """The norm pass holds a row of int16 in shared memory: K 40000 (past
    the __dp4a strip's limit) takes the tensor cores, a K whose row does
    not fit and an unaligned weight take __dp4a, which then has its own
    limit (the plan says JNP past it)."""
    assert kfc.norm_gemm_variant(9, 40000) == "wgmma"
    assert kfc.norm_gemm_smem_bytes(16, 40000) > kfa.SMEM_LIMIT
    big = (kfa.SMEM_LIMIT // 2 // 16 + 1) * 16
    assert kfc.norm_pass_smem_bytes(big) > kfa.SMEM_LIMIT
    assert kfc.norm_gemm_variant(9, big) == "dp4a"
    base = torch.zeros(70 * 129, dtype=torch.int8)
    w = base[1:1 + 70 * 128].view(70, 128)
    assert kfc.norm_gemm_variant(37, 128, kfl._aligned(w)) == "dp4a"
    d = kd.plan_norm_gemm("n", 9, big, 64, QuantConfig(), kernel_mode="fused",
                          device="cuda")
    assert d.path == kd.JNP and "shared memory" in d.reason
