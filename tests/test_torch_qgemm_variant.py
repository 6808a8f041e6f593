"""The shape rules that pick the qq / qi / ii and int8_matmul kernel
variants (CPU, no card).

``kernels.fused_linear.qgemm_variant`` (qi, ii) and ``qq_variant`` (qq)
choose, from the shapes alone and before any launch, between the
tensor-core kernel (``wgmma``, M > 16), the weight-streaming kernel
(``stream``, M <= 16) and the ``__dp4a`` kernel (K not a multiple of 16,
or an operand not 16-byte aligned); ``kernels.int8_matmul
.int8_matmul_variant`` between the same two Hopper kernels and the wmma
kernel in ``__dp4a``'s place.
"""

import pytest
import torch

from repro_torch.kernels import dispatch as kd
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
