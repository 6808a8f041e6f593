"""The int8 GEMM with one scalar rescale: CUDA kernel + plain version.

Port of ``repro.kernels.int8_matmul.int8_matmul_pallas``, the contraction
step of the unfused rung (``kernel_mode="unfused"``): int8 mantissas a
(B, M, K) against b (B, N, K), contraction-last as the port holds every
mantissa (the reference takes b as (K, N); ``kernels.ops`` keeps that
interface), the exact int32 sum over K, times one float32 scale ->
f32 (B, M, N).  The CUDA source is ``csrc/int8_matmul.cu`` (tensor cores
through wmma); its note says what bounds it.  The wrapper runs the kernel
for CUDA tensors and the plain version for CPU tensors, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_linear import _check, _ptr, _raise_on, int8_dot

__all__ = ["int8_matmul", "int8_matmul_plain"]


def int8_matmul_plain(am: torch.Tensor, bm_t: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ``int8_matmul``: the exact integer sum rounded to
    float32 once, times ``scale``."""
    return int8_dot(am, bm_t).to(torch.float32) * scale


def _lib() -> ctypes.CDLL:
    lib = build.load("int8_matmul")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_int8_matmul.argtypes = [vp] * 4 + [i] * 4 + [vp]
        lib.repro_int8_matmul.restype = i
        lib._typed = True
    return lib


def int8_matmul(am: torch.Tensor, bm_t: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """am (B, M, K) int8, bm_t (B, N, K) int8, scale a float32 scalar
    tensor -> y (B, M, N) f32.  K must keep every int32 sum exact
    (K * 127^2 < 2^31)."""
    if not am.is_cuda:
        return int8_matmul_plain(am, bm_t, scale)
    nb, m, k = am.shape
    n = bm_t.shape[1]
    dev = am.device
    _check("am", am, torch.int8, (nb, m, k), dev)
    _check("bm_t", bm_t, torch.int8, (nb, n, k), dev)
    if scale.dtype != torch.float32 or scale.numel() != 1 \
            or scale.device != dev:
        raise ValueError(f"scale: expected one float32 value on {dev}")
    if k * 127 * 127 >= 1 << 31:
        raise ValueError(f"K={k} overflows the int32 accumulator")
    if nb > 65535 or -(-n // 64) > 65535:
        raise ValueError(f"int8_matmul grid: batch {nb} or N={n} too large")
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y
    err = _lib().repro_int8_matmul(
        _ptr(am), _ptr(bm_t), _ptr(scale), _ptr(y), nb, m, n,
        k, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


# Launches of the kernel since the count was last set to 0.
int8_matmul.launches = 0
