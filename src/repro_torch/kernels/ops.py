"""The unfused building blocks as standalone ops (quantizer kernel -> int8
in device memory -> GEMM kernel).

The port of ``repro.kernels.ops``: entry points for sweeps and
benchmarks.  Model code goes through ``core.qops``, which plans every
contraction in ``kernels.dispatch``; no model path calls these.
``quantize_op`` also offers a per-row-block scale (one exponent per
``block_rows`` rows), which ``core.bfp`` does not; per tensor it equals
``core.bfp.quantize`` bit for bit given the same bits.  ``use_kernel``
picks the kernel wrapper (the plain version on the CPU) or the oracle of
``kernels.ref``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import prng
from ..core.bfp import pow2, rounding_bits
from . import bfp_quant as kbq
from . import int8_matmul as kim
from . import ref

__all__ = ["quantize_op", "int8_matmul_op"]


def quantize_op(x: torch.Tensor, key: prng.Key, *, per_tensor: bool = True,
                use_kernel: bool = True, block_rows: int = 8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a 2-D f32 tensor -> (int8 mantissas, int32 biased exponent
    of each row).  ``per_tensor`` broadcasts one shared exponent; otherwise
    each window of ``block_rows`` rows shares its largest, and rows past
    the last whole window take the last window's (the reference's
    ``jnp.repeat`` fill).  Bits: ``core.bfp.rounding_bits(key, x.shape)``."""
    m, n = x.shape
    if per_tensor:
        e_rows = ref.max_biased_exp_ref(x).reshape(1).expand(m).contiguous()
    else:
        nw = m // block_rows
        if nw == 0:
            raise ValueError(f"per-row-block scales need at least "
                             f"block_rows={block_rows} rows, got {m}")
        eff = ref.max_biased_exp_ref(x, axis=1)
        e = eff[:nw * block_rows].reshape(nw, block_rows).amax(1)
        e_rows = torch.cat([torch.repeat_interleave(e, block_rows),
                            e[-1:].expand(m - nw * block_rows)])
    rand = rounding_bits(key, (m, n), device=x.device)
    if not use_kernel:
        return ref.bfp_quantize_ref(x, rand, e_rows[:, None]), e_rows
    return kbq.bfp_quantize(x.contiguous(), rand, e_rows), e_rows


def int8_matmul_op(a_m: torch.Tensor, b_m: torch.Tensor, ea, eb, *,
                   use_kernel: bool = True) -> torch.Tensor:
    """(M, K) x (K, N) int8 mantissas with scalar biased exponents (p = 7)
    -> f32 (M, N): the exact integer product times 2^(sa + sb).  The kernel
    reads b contraction-last, so b is copied transposed once here."""
    scale = pow2((torch.as_tensor(ea, device=a_m.device) - 133)
                 + (torch.as_tensor(eb, device=a_m.device) - 133))
    if not use_kernel:
        return ref.int8_matmul_ref(a_m, b_m, scale)
    y = kim.int8_matmul(a_m.contiguous()[None], b_m.t().contiguous()[None],
                        scale)
    return y[0]
