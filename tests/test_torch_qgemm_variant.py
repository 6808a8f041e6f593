"""The shape rule that picks the qi / ii kernel variant (CPU, no card).

``kernels.fused_linear.qgemm_variant`` chooses, from the shapes alone and
before any launch, between the tensor-core kernel (``wgmma``, M > 16), the
weight-streaming kernel (``stream``, M <= 16) and the ``__dp4a`` kernel
(K not a multiple of 16, or an operand not 16-byte aligned).
"""

import pytest
import torch

from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_linear as kfl

# Every K the main path's qi / ii contractions take (the head dim, the
# sequence, the 512 tokens of a training batch, qwen2 / minicpm /
# starcoder2 widths, d_ff and starcoder2's vocabulary).
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


def test_every_variant_has_a_counter():
    names = set(kd.kernel_launches())
    for kind in ("qi", "ii"):
        assert {f"{kind}_{v}" for v in kfl.QGEMM_VARIANTS} <= names
