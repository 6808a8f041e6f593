"""Fused decode attention off the int8 KV cache: CUDA kernel + plain version.

Port of ``fused_attn_decode_pallas`` (``_decode_core``) of
``repro.kernels.fused_attention``: per (batch * KV-head) slice, scores of
the grouped query mantissas against the cache row mantissas with the K-row
exponents as a column epilogue, masks, a float32 softmax, the V-row
exponents folded into p, p quantized per query row over the band against
streamed rounding bits, and an int8 PV.  ``csrc/fused_attention.cu`` is
the kernel (its note says what bounds it); ``attn_decode_plain`` repeats
the JAX reference's arithmetic in torch.  The wrapper takes the plain
version only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .fused_linear import (_check, _ptr, _raise_on, _scalar_i32, as_u32,
                           int8_dot, pow2_f32, quantize_tile, scale_exp)

__all__ = ["attn_decode", "attn_decode_plain", "decode_p_plain",
           "decode_smem_bytes",
           "DECODE_SMEM_LIMIT", "DECODE_Y_RTOL"]

_NEG = -1e30          # models.attention._NEG
# Dynamic shared memory one block may use on an H100 (227 KB).
DECODE_SMEM_LIMIT = 232448
# Tolerance of the kernel's y against the plain version's, relative to the
# largest |y|: the two differ only in the order of the float32 softmax sum,
# which can move a stochastic-rounding decision of p by one unit (PERF.md).
DECODE_Y_RTOL = 2.0 ** -6


def decode_smem_bytes(gs: int, t: int, d: int) -> int:
    """Shared memory the decode kernel needs for one slice: f32 scores and
    int8 p for (GS, T), the packed query and int32 PV sums for (GS, D)."""
    return 4 * gs * t + 4 * gs * d + gs * d + 4 * gs + gs * t


def _eff_exp(x: torch.Tensor) -> torch.Tensor:
    return ((x.contiguous().view(torch.int32) >> 23) & 0xFF).clamp(min=1)


def decode_p_plain(qm, km, ek_rows, ev_rows, rp, eq, q_off: int,
                   kv_len: int, *, p: int, s: int, causal: bool,
                   window: int, stochastic: bool):
    """The integer half of ``attn_decode_plain``: the quantized
    probabilities (int8 (BH, GS, T)) and their per-row biased exponents
    (int32 (BH, GS, 1)), before the PV contraction."""
    gs, t = qm.shape[-2], km.shape[-2]
    dev = qm.device
    sek = scale_exp(ek_rows, p).transpose(-1, -2)            # (BH, 1, T)
    sev = scale_exp(ev_rows, p).transpose(-1, -2)
    kpos = torch.arange(t, dtype=torch.int32, device=dev)[None, :]
    qpos = (torch.arange(gs, dtype=torch.int32, device=dev) % s + q_off)[:, None]
    mask = kpos < min(kv_len, t)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & ((qpos - kpos) < window)
    sf = int8_dot(qm, km).to(torch.float32) * pow2_f32(scale_exp(eq, p) + sek)
    sf = torch.where(mask, sf, torch.full_like(sf, _NEG))
    mrow = sf.amax(dim=-1, keepdim=True)
    pe = torch.exp(sf - mrow)
    pn = torch.where(mask, pe / pe.sum(dim=-1, keepdim=True),
                     torch.zeros_like(pe))
    p2 = pn * pow2_f32(sev)
    e_row = _eff_exp(p2).amax(dim=-1, keepdim=True)
    ph = quantize_tile(p2, rp if stochastic else None, e_row, p, stochastic)
    return ph, e_row


def attn_decode_plain(qm, km, vm, ek_rows, ev_rows, rp, eq, q_off: int,
                      kv_len: int, *, p: int, s: int, causal: bool,
                      window: int, stochastic: bool) -> torch.Tensor:
    """qm (BH, GS, D) int8, km/vm (BH, T, D) int8, ek_rows/ev_rows (BH, T,
    1) int32, rp (BH, GS, T) uint32-in-int64 or None, eq int32 scalar ->
    y (BH, GS, D) f32.  The op order of ``_decode_core``."""
    ph, e_row = decode_p_plain(qm, km, ek_rows, ev_rows, rp, eq, q_off,
                               kv_len, p=p, s=s, causal=causal,
                               window=window, stochastic=stochastic)
    y = int8_dot(ph, vm.transpose(-1, -2)).to(torch.float32)
    return y * pow2_f32(scale_exp(e_row, p))


def _lib() -> ctypes.CDLL:
    lib = build.load("fused_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_attn_decode.argtypes = [vp] * 8 + [i] * 11 + [vp]
        lib.repro_attn_decode.restype = i
        lib._typed = True
    return lib


def attn_decode(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                ek_rows: torch.Tensor, ev_rows: torch.Tensor,
                rp: Optional[torch.Tensor], eq: torch.Tensor, q_off: int,
                kv_len: int, *, p: int, s: int, causal: bool, window: int,
                stochastic: bool) -> torch.Tensor:
    """Batched fused decode attention (shapes of ``attn_decode_plain``):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if not qm.is_cuda:
        return attn_decode_plain(qm, km, vm, ek_rows, ev_rows, rp, eq, q_off,
                                 kv_len, p=p, s=s, causal=causal,
                                 window=window, stochastic=stochastic)
    bh, gs, d = qm.shape
    t = km.shape[1]
    dev = qm.device
    if d % 4 or d > 256:
        raise ValueError(f"decode kernel needs D % 4 == 0 and D <= 256, got {d}")
    smem = decode_smem_bytes(gs, t, d)
    if smem > DECODE_SMEM_LIMIT:
        raise ValueError(f"decode kernel: T={t} needs {smem} B of shared "
                         f"memory > {DECODE_SMEM_LIMIT}")
    _check("qm", qm, torch.int8, (bh, gs, d), dev)
    _check("km", km, torch.int8, (bh, t, d), dev)
    _check("vm", vm, torch.int8, (bh, t, d), dev)
    _check("ek_rows", ek_rows, torch.int32, (bh, t, 1), dev)
    _check("ev_rows", ev_rows, torch.int32, (bh, t, 1), dev)
    if stochastic:
        rp = as_u32(rp)
        _check("rp", rp, torch.int32, (bh, gs, t), dev)
    eq = _scalar_i32("eq", eq, dev)
    y = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    err = _lib().repro_attn_decode(
        _ptr(qm), _ptr(eq), _ptr(km), _ptr(vm), _ptr(ek_rows), _ptr(ev_rows),
        _ptr(rp if stochastic else None), _ptr(y), bh, gs, t, d, s,
        int(q_off), int(min(kv_len, t)), int(causal), int(window), p,
        int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "attn_decode")
    attn_decode.launches += 1
    return y


# Launches of the kernel since the count was last set to 0.
attn_decode.launches = 0
