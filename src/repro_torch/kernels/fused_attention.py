"""Fused integer attention: CUDA kernels + plain versions.

Ports of three TPU kernels of ``repro.kernels.fused_attention``, per
(batch * KV-head) slice of grouped query rows (row r at position
r % s + q_off):

  ``attn_decode``  <- ``fused_attn_decode_pallas`` (``_decode_core``):
                   decode off the int8 cache, K-row exponents as a column
                   epilogue, a float32 softmax, the V-row exponents folded
                   into p, p quantized per query row over the band, int8
                   PV.  Kernel: ``csrc/fused_attention.cu``.
  ``attn_fwd``     <- ``fused_attn_fwd_pallas`` (``_fwd_blocks``): the
                   qflow training forward over per-tensor mantissas, an
                   online softmax over KV blocks of ``bt`` positions, p
                   quantized per row per block in the kernel.
  ``attn_bwd``     <- ``fused_attn_bwd_pallas`` (``_bwd_block``): the A.2
                   integer backward, probabilities recomputed from the
                   saved row stats, pn and dS quantized with one exponent
                   per (slice, block) tile.  Kernels of both:
                   ``csrc/attn_train.cu``.

Each ``*_plain`` repeats the JAX reference's arithmetic in torch, float
ops rounded as XLA's CPU build rounds them (``core.fmath``: the Cephes
exp, fused multiply-adds, window-of-32 sums).  The wrappers take the plain
version only for CPU tensors; a CUDA tensor launches the kernel or raises.
Each source's note says what bounds its kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import fmath
from . import build
from .fused_linear import (_check, _ptr, _raise_on, _scalar_i32, as_u32,
                           eff_exp, int8_dot, pow2_f32, quantize_tile,
                           scale_exp)

__all__ = ["attn_decode", "attn_decode_plain", "decode_p_plain",
           "decode_smem_bytes", "attn_fwd", "attn_fwd_plain", "attn_bwd",
           "attn_bwd_plain", "train_smem_bytes", "bwd_strip", "SMEM_LIMIT"]

_NEG = -1e30          # models.attention._NEG
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
_DECODE_WARPS = 8


def decode_smem_bytes(gs: int, t: int, d: int) -> int:
    """Shared memory the decode kernel needs for one slice: f32 scores and
    int8 p for (GS, T), the packed query and int32 PV sums for (GS, D),
    and each warp's window sums of a softmax row."""
    return (4 * gs * t + 4 * gs * d + gs * d + 4 * gs
            + 4 * _DECODE_WARPS * -(-t // 32) + gs * t)


def decode_p_plain(qm, km, ek_rows, ev_rows, rp, eq, q_off: int,
                   kv_len: int, *, p: int, s: int, causal: bool,
                   window: int, stochastic: bool):
    """The integer half of ``attn_decode_plain``: the quantized
    probabilities (int8 (BH, GS, T)) and their per-row biased exponents
    (int32 (BH, GS, 1)), before the PV contraction.  The softmax's exp and
    row sum round as the reference's (``core.fmath``); ``eq`` may be one
    exponent per slice, (BH, 1, 1)."""
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
    pe = fmath._exp(sf - mrow)
    pn = torch.where(mask, pe / fmath._sum_windows(pe, (-1,))[..., None],
                     torch.zeros_like(pe))
    p2 = pn * pow2_f32(sev)
    e_row = eff_exp(p2).amax(dim=-1, keepdim=True)
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
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode kernel: T={t} needs {smem} B of shared "
                         f"memory > {SMEM_LIMIT}")
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


# ---------------------------------------------------------------------------
# training attention: forward and backward over per-tensor mantissas
# ---------------------------------------------------------------------------

def _bwd_smem(d: int, bt: int, bq: int) -> int:
    """Dynamic shared memory of the backward's blocks with a query strip of
    ``bq`` rows (``BwdLayout``), plus pass A's static reduction buffer."""
    dw, tw = -(-d // 4), bt // 4
    kld, vld, rld = dw | 1, tw | 1, (bq // 4) | 1
    return 4 * (2 * bq * kld + 2 * bt * kld + 2 * d * rld + d * vld
                + bq * vld + 2 * bt * rld + bq * d + 3 * bq + 16)


def bwd_strip(d: int, bt: int) -> int:
    """Query rows per block of the ``attn_bwd`` kernels: the largest of 32,
    16, 8, 4 whose tiles fit in shared memory (4 when none does).  The
    strip does not change the results."""
    return next((bq for bq in (32, 16, 8) if _bwd_smem(d, bt, bq)
                 <= SMEM_LIMIT), 4)


def train_smem_bytes(op: str, d: int, bt: int) -> int:
    """Shared memory of one block of the ``attn_fwd`` or ``attn_bwd``
    kernel (the layouts of ``csrc/attn_train.cu``): packed int8 tiles with
    odd word strides, the score or pn/dS tiles, the float accumulators and
    the row stats."""
    if op == "attn_bwd":
        return _bwd_smem(d, bt, bwd_strip(d, bt))
    dw, tw = -(-d // 4), bt // 4
    kld, vld = dw | 1, tw | 1
    bq = 16
    return 4 * (bq * dw + bt * kld + d * vld + bq * bt + bq * tw
                + bq * d + 4 * bq)


def _block_mask(qpos, kpos, kv_len: int, causal: bool, window: int):
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & ((qpos - kpos) < window)
    return mask


def _block(x: Optional[torch.Tensor], c0: int, bt: int, axis: int):
    """Columns (axis -1) or rows (axis -2) [c0, c0 + bt) of x, zero-padded
    past its end to bt: the reference pads T to a multiple of bt."""
    if x is None:
        return None
    n = x.shape[axis]
    part = x.narrow(axis, c0, min(bt, n - c0))
    pad = bt - part.shape[axis]
    if not pad:
        return part
    return torch.nn.functional.pad(part, (0, pad) if axis == -1
                                   else (0, 0, 0, pad))


def _tile_exp(x: torch.Tensor) -> torch.Tensor:
    """Largest effective exponent of each (slice) tile, (BH, 1, 1)."""
    return eff_exp(x).flatten(1).amax(-1).view(-1, 1, 1)


def attn_fwd_plain(qm, km, vm, rp, eq, ek, ev, q_off: int, kv_len: int, *,
                   p: int, s: int, bt: int, causal: bool, window: int,
                   stochastic: bool):
    """qm (BH, GS, D) int8, km/vm (BH, T, D) int8, rp (BH, GS, T) uint32
    in int64 or None, eq/ek/ev int32 scalars -> (y (BH, GS, D), m, l
    (BH, GS, 1)) f32.  The op order of ``_fwd_blocks`` over every query
    row at once (the strips of the TPU kernel do not change results)."""
    bh, gs, d = qm.shape
    t = km.shape[1]
    kv = min(kv_len, t)
    dev = qm.device
    sc = pow2_f32(scale_exp(eq, p) + scale_exp(ek, p))
    sev = scale_exp(ev, p)
    qpos = (torch.arange(gs, dtype=torch.int32, device=dev) % s + q_off)[:, None]
    m = torch.full((bh, gs, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, gs, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, gs, d), dtype=torch.float32, device=dev)
    for j in range(-(-kv // bt)):
        c0 = j * bt
        kpos = c0 + torch.arange(bt, dtype=torch.int32, device=dev)[None, :]
        mask = _block_mask(qpos, kpos, kv, causal, window)
        sf = int8_dot(qm, _block(km, c0, bt, -2)).to(torch.float32) * sc
        sf = torch.where(mask, sf, torch.full_like(sf, _NEG))
        m_new = torch.maximum(m, sf.amax(dim=-1, keepdim=True))
        alpha = fmath._exp(m - m_new)
        pt = torch.where(mask, fmath._exp(sf - m_new), torch.zeros_like(sf))
        e_row = eff_exp(pt).amax(dim=-1, keepdim=True)
        ph = quantize_tile(pt, _block(rp, c0, bt, -1) if stochastic else None,
                           e_row, p, stochastic)
        pv = int8_dot(ph, _block(vm, c0, bt, -2).transpose(-1, -2))
        pv = pv.to(torch.float32) * pow2_f32(scale_exp(e_row, p) + sev)
        acc = fmath._fma(acc, alpha, pv)
        l = fmath._fma(l, alpha, fmath._sum_windows(pt, (-1,))[..., None])
        m = m_new
    return acc / l.clamp(min=1e-30), m, l


def attn_bwd_plain(qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg,
                   q_off: int, kv_len: int, *, p: int, s: int, bt: int,
                   causal: bool, window: int, stochastic: bool):
    """qm/gm (BH, GS, D) int8 (Q and quantized dO), km/vm (BH, T, D) int8,
    m/l/delta (BH, GS, 1) f32, rs/rp2 (BH, GS, T) bits or None -> (dq
    (BH, GS, D), dk, dv (BH, T, D)) f32.  The op order of ``_bwd_block``
    for each KV block, dq summed in block order."""
    bh, gs, d = qm.shape
    t = km.shape[1]
    kv = min(kv_len, t)
    dev = qm.device
    sq, sk = scale_exp(eq, p), scale_exp(ek, p)
    sv, sg = scale_exp(ev, p), scale_exp(eg, p)
    qpos = (torch.arange(gs, dtype=torch.int32, device=dev) % s + q_off)[:, None]
    lf = l.clamp(min=1e-30)
    dq = torch.zeros((bh, gs, d), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for j in range(-(-t // bt)):
        c0 = j * bt
        kj = _block(km, c0, bt, -2)
        kpos = c0 + torch.arange(bt, dtype=torch.int32, device=dev)[None, :]
        mask = _block_mask(qpos, kpos, kv, causal, window)
        sf = int8_dot(qm, kj).to(torch.float32) * pow2_f32(sq + sk)
        sf = torch.where(mask, sf, torch.full_like(sf, _NEG))
        pt = torch.where(mask, fmath._exp(sf - m), torch.zeros_like(sf))
        pn = pt / lf
        e_pn = _tile_exp(pn)
        pn_h = quantize_tile(pn, _block(rp2, c0, bt, -1) if stochastic else None,
                             e_pn, p, stochastic)
        dv = int8_dot(pn_h.transpose(-1, -2), gm.transpose(-1, -2))
        dvs.append(dv.to(torch.float32) * pow2_f32(scale_exp(e_pn, p) + sg))
        dp = int8_dot(gm, _block(vm, c0, bt, -2)).to(torch.float32) * pow2_f32(sg + sv)
        ds = pn * (dp - delta)
        e_ds = _tile_exp(ds)
        ds_h = quantize_tile(ds, _block(rs, c0, bt, -1) if stochastic else None,
                             e_ds, p, stochastic)
        sc_ds = scale_exp(e_ds, p)
        dq_c = int8_dot(ds_h, kj.transpose(-1, -2)).to(torch.float32)
        dq = dq + dq_c * pow2_f32(sc_ds + sk)
        dk = int8_dot(ds_h.transpose(-1, -2), qm.transpose(-1, -2))
        dks.append(dk.to(torch.float32) * pow2_f32(sc_ds + sq))
    return dq, torch.cat(dks, 1)[:, :t], torch.cat(dvs, 1)[:, :t]


def _lib_train() -> ctypes.CDLL:
    lib = build.load("attn_train")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.repro_attn_fwd.argtypes = [vp] * 10 + [i] * 12 + [vp]
        lib.repro_attn_fwd.restype = i
        lib.repro_attn_bwd.argtypes = [vp] * 18 + [i] * 13 + [vp]
        lib.repro_attn_bwd.restype = i
        lib._typed = True
    return lib


def _check_train(op: str, d: int, bt: int):
    if bt % 128:
        raise ValueError(f"attention kernels need bt % 128 == 0, got {bt}")
    need = train_smem_bytes(op, d, bt)
    if need > SMEM_LIMIT:
        raise ValueError(f"{op} kernel: D={d}, bt={bt} needs {need} B of "
                         f"shared memory > {SMEM_LIMIT}")


def attn_fwd(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
             rp: Optional[torch.Tensor], eq: torch.Tensor, ek: torch.Tensor,
             ev: torch.Tensor, q_off: int, kv_len: int, *, p: int, s: int,
             bt: int, causal: bool, window: int, stochastic: bool):
    """Batched fused attention forward (shapes of ``attn_fwd_plain``): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if not qm.is_cuda:
        return attn_fwd_plain(qm, km, vm, rp, eq, ek, ev, q_off, kv_len,
                              p=p, s=s, bt=bt, causal=causal, window=window,
                              stochastic=stochastic)
    bh, gs, d = qm.shape
    t = km.shape[1]
    dev = qm.device
    _check_train("attn_fwd", d, bt)
    _check("qm", qm, torch.int8, (bh, gs, d), dev)
    _check("km", km, torch.int8, (bh, t, d), dev)
    _check("vm", vm, torch.int8, (bh, t, d), dev)
    if stochastic:
        rp = as_u32(rp)
        _check("rp", rp, torch.int32, (bh, gs, t), dev)
    eq, ek, ev = (_scalar_i32(n, e, dev) for n, e in
                  (("eq", eq), ("ek", ek), ("ev", ev)))
    y = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    m = torch.empty((bh, gs, 1), dtype=torch.float32, device=dev)
    l = torch.empty((bh, gs, 1), dtype=torch.float32, device=dev)
    err = _lib_train().repro_attn_fwd(
        _ptr(qm), _ptr(km), _ptr(vm), _ptr(rp if stochastic else None),
        _ptr(eq), _ptr(ek), _ptr(ev), _ptr(y), _ptr(m), _ptr(l), bh, gs, t,
        d, s, int(q_off), int(min(kv_len, t)), int(causal), int(window), p,
        bt, int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "attn_fwd")
    attn_fwd.launches += 1
    return y, m, l


def attn_bwd(qm: torch.Tensor, gm: torch.Tensor, km: torch.Tensor,
             vm: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             delta: torch.Tensor, rs: Optional[torch.Tensor],
             rp2: Optional[torch.Tensor], eq: torch.Tensor, ek: torch.Tensor,
             ev: torch.Tensor, eg: torch.Tensor, q_off: int, kv_len: int, *,
             p: int, s: int, bt: int, causal: bool, window: int,
             stochastic: bool):
    """Batched fused attention backward (shapes of ``attn_bwd_plain``):
    the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if not qm.is_cuda:
        return attn_bwd_plain(qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek,
                              ev, eg, q_off, kv_len, p=p, s=s, bt=bt,
                              causal=causal, window=window,
                              stochastic=stochastic)
    bh, gs, d = qm.shape
    t = km.shape[1]
    dev = qm.device
    _check_train("attn_bwd", d, bt)
    for name, x, shape in (("qm", qm, (bh, gs, d)), ("gm", gm, (bh, gs, d)),
                           ("km", km, (bh, t, d)), ("vm", vm, (bh, t, d))):
        _check(name, x, torch.int8, shape, dev)
    for name, x in (("m", m), ("l", l), ("delta", delta)):
        _check(name, x, torch.float32, (bh, gs, 1), dev)
    if stochastic:
        rs, rp2 = as_u32(rs), as_u32(rp2)
        _check("rs", rs, torch.int32, (bh, gs, t), dev)
        _check("rp2", rp2, torch.int32, (bh, gs, t), dev)
    eq, ek, ev, eg = (_scalar_i32(n, e, dev) for n, e in
                      (("eq", eq), ("ek", ek), ("ev", ev), ("eg", eg)))
    nb = -(-t // bt)
    e_scratch = torch.empty((2, bh, nb), dtype=torch.int32, device=dev)
    acc_scratch = torch.empty((2, bh, t, d), dtype=torch.int32, device=dev)
    dq = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, t, d), dtype=torch.float32, device=dev)
    dv = torch.empty((bh, t, d), dtype=torch.float32, device=dev)
    err = _lib_train().repro_attn_bwd(
        _ptr(qm), _ptr(gm), _ptr(km), _ptr(vm), _ptr(m), _ptr(l),
        _ptr(delta), _ptr(rs if stochastic else None),
        _ptr(rp2 if stochastic else None), _ptr(eq), _ptr(ek), _ptr(ev),
        _ptr(eg), _ptr(e_scratch), _ptr(acc_scratch), _ptr(dq), _ptr(dk),
        _ptr(dv), bh, gs, t, d, s, int(q_off), int(min(kv_len, t)),
        int(causal), int(window), p, bt, bwd_strip(d, bt), int(stochastic),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "attn_bwd")
    attn_bwd.launches += 1
    return dq, dk, dv


# Launches of each wrapper's kernels since the count was last set to 0.
attn_fwd.launches = 0
attn_bwd.launches = 0
