"""The standalone BFP quantizer: CUDA kernel + plain version.

Port of ``repro.kernels.bfp_quant.bfp_quantize_pallas``, the quantize step
of the unfused rung (``kernel_mode="unfused"``): f32 (M, N) -> int8
mantissas against one shared biased exponent per row, stochastic rounding
against uint32 bits (the paper's Fig. 1(a) mapping, p = 7).  A per-tensor
exponent is passed broadcast to every row.  The CUDA source is
``csrc/bfp_quant.cu``; its note says what bounds it.  The wrapper runs the
kernel for CUDA tensors and the plain version for CPU tensors, and nothing
else.  Rounding bits are uint32 values held in int64 (``core.prng``), or
already converted to int32 (``fused_linear.as_u32``).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_linear import _check, _ptr, _raise_on, as_u32, quantize_tile

__all__ = ["bfp_quantize", "bfp_quantize_plain"]

_M32 = 0xFFFFFFFF


def bfp_quantize_plain(x: torch.Tensor, rand: torch.Tensor,
                       e_rows: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bfp_quantize``: the kernels' quantizer
    (``quantize_tile``) with p = 7, stochastic, one exponent per row."""
    r = rand.to(torch.int64) & _M32
    return quantize_tile(x, r, e_rows.to(torch.int32)[:, None], 7, True)


def _lib() -> ctypes.CDLL:
    lib = build.load("bfp_quant")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_bfp_quantize.argtypes = [vp] * 4 + [i] * 2 + [vp]
        lib.repro_bfp_quantize.restype = i
        lib._typed = True
    return lib


def bfp_quantize(x: torch.Tensor, rand: torch.Tensor,
                 e_rows: torch.Tensor) -> torch.Tensor:
    """x (M, N) f32, rand (M, N) uint32 bits (int64 or int32), e_rows (M,)
    int32 biased exponents -> int8 (M, N) mantissas."""
    if not x.is_cuda:
        return bfp_quantize_plain(x, rand, e_rows)
    m, n = x.shape
    dev = x.device
    rand = as_u32(rand)
    _check("x", x, torch.float32, (m, n), dev)
    _check("rand", rand, torch.int32, (m, n), dev)
    _check("e_rows", e_rows, torch.int32, (m,), dev)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    err = _lib().repro_bfp_quantize(
        _ptr(x), _ptr(rand), _ptr(e_rows), _ptr(out), m, n,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "bfp_quantize")
    bfp_quantize.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
bfp_quantize.launches = 0
