"""Fused integer attention: CUDA kernels + plain versions.

Ports of three TPU kernels of ``repro.kernels.fused_attention``, per
(batch * KV-head) slice of grouped query rows (row r at position
r % s + q_off):

  ``attn_decode``  <- ``fused_attn_decode_pallas`` (``_decode_core``):
                   decode off the int8 cache, K-row exponents as a column
                   epilogue, a float32 softmax, the V-row exponents folded
                   into p, p quantized per query row over the band, int8
                   PV.  Kernel: ``csrc/fused_attention.cu``, one
                   thread-block cluster a slice (``decode_split``).
  ``attn_fwd``     <- ``fused_attn_fwd_pallas`` (``_fwd_blocks``): the
                   qflow training forward over per-tensor mantissas, an
                   online softmax over KV blocks of ``bt`` positions, p
                   quantized per row per block in the kernel; on
                   ``wgmma`` or ``__dp4a`` (``attn_fwd_variant``).
  ``attn_bwd``     <- ``fused_attn_bwd_pallas`` (``_bwd_block``): the A.2
                   integer backward, probabilities recomputed from the
                   saved row stats, pn and dS quantized with one exponent
                   per (slice, block) tile.  Kernels of both:
                   ``csrc/attn_train.cu``; the backward on ``wgmma`` or
                   ``__dp4a`` (``attn_bwd_variant``).

Each ``*_plain`` repeats the JAX reference's arithmetic in torch, float
ops rounded as XLA's CPU build rounds them (``core.fmath``: the Cephes
exp, fused multiply-adds, window-of-32 sums).  The wrappers take the plain
version only for CPU tensors; a CUDA tensor launches the kernel or raises.
Each source's note says what bounds its kernels.  The wrappers raise on
an operand off the alignment the kernels' loads need (``attn_misaligned``);
``kernels.dispatch`` copies such an operand first.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import fmath
from . import build
from .fused_linear import (_check, _Launches, _ptr, _raise_on, _scalar_i32,
                           as_u32, eff_exp, int8_dot, pow2_f32,
                           quantize_tile, scale_exp)

__all__ = ["attn_decode", "attn_decode_plain", "decode_p_plain",
           "decode_smem_bytes", "decode_split", "DECODE_SPLITS",
           "attn_decode_splits", "attn_misaligned", "attn_fwd",
           "attn_fwd_plain", "attn_fwd_variant", "attn_fwd_tiles",
           "ATTN_FWD_VARIANTS", "attn_fwd_variants", "attn_bwd",
           "attn_bwd_plain", "attn_bwd_variant", "ATTN_BWD_VARIANTS",
           "attn_bwd_variants",
           "train_smem_bytes", "bwd_strip", "SMEM_LIMIT"]

_NEG = -1e30          # models.attention._NEG
# Dynamic shared memory one block may use on an H100 (227 KB).
SMEM_LIMIT = 232448
# The decode kernel's block (``csrc/fused_attention.cu`` DecLayout): its
# threads, the positions a ring stage holds, the largest cluster and the
# rounding bits it prefetches into shared memory.
_DEC_THREADS, _DEC_CH, _DEC_NMAX, _DEC_BPRE = 256, 128, 16, 2048
# Windows of 32 positions a block takes at the least: a shorter band runs
# faster on fewer blocks than the cluster's exchanges cost.
_DEC_MIN_WINDOWS = 8
# Cluster sizes ``decode_split`` can name, each with a launch counter.
DECODE_SPLITS = tuple(range(1, _DEC_NMAX + 1))


def _a16(x: int) -> int:
    return (x + 15) & ~15


def _decode_layout_bytes(gs: int, t: int, d: int, n: int) -> int:
    """Shared memory one block of an ``n``-block decode cluster needs
    (``DecLayout``): its ring of K / V row chunks, the query padded to 16
    rows, its range's f32 scores (one pad float a window) and int8 p, every
    window sum of every row and their second-level sums, the exchanged row
    maxima and exponents, the int32 PV sums, prefetched row exponents and
    bits, the ring's mbarriers."""
    m = -(-t // 32)
    w = -(-m // n)
    dp = -(-d // 32) * 32
    stages = 4 if dp <= 64 else 2
    kld = -(-32 * w // _DEC_CH) * _DEC_CH + 16
    off = 0
    for size in (stages * _DEC_CH * dp,            # ring
                 16 * -(-gs // 16) * dp,           # query
                 4 * gs * 33 * w,                  # scores
                 gs * kld,                         # p
                 4 * gs * (m + m // 32 + 1),       # window sums
                 4 * gs * 2 * -(-m // 32),         # their second level
                 4 * _DEC_NMAX * gs,               # row maxima
                 4 * _DEC_NMAX * gs,               # row exponents
                 4 * gs,                           # the row's exponent
                 4 * gs,                           # the row's query position
                 4 * gs * dp,                      # PV sums
                 4 * 2 * _DEC_THREADS,             # row exponents of K, V
                 4 * min(gs * 32 * w, _DEC_BPRE)):  # rounding bits
        off = _a16(off + size)
    return off + 8 * stages


def decode_split(gs: int, t: int, d: int) -> int:
    """Blocks of the thread-block cluster that runs one decode slice: the
    band's m windows of 32 positions (``fmath.sum_windows``) spread evenly,
    whole windows a block, at least 8 a block (one block up to 256
    positions, T <= 32 included) over at most 8 blocks, or over at most 16
    where 8 blocks' shared memory cannot hold their ranges."""
    m = -(-t // 32)
    n = -(-m // max(_DEC_MIN_WINDOWS, -(-m // 8)))
    if _decode_layout_bytes(gs, t, d, n) <= SMEM_LIMIT:
        return n
    return -(-m // -(-m // _DEC_NMAX))


def decode_smem_bytes(gs: int, t: int, d: int) -> int:
    """Shared memory one block of the decode kernel needs for a (GS, T, D)
    slice on the cluster ``decode_split`` names."""
    return _decode_layout_bytes(gs, t, d, decode_split(gs, t, d))


# The alignment (bytes) each operand's loads need: 16-byte loads and bulk
# or asynchronous copies of the int8 tiles and of the backward's bits; the
# forward's bits two words at a time; words.
_ALIGN = {"attn_decode": {"qm": 16, "km": 16, "vm": 16, "ek_rows": 4,
                          "ev_rows": 4, "rp": 4, "eq": 4},
          "attn_fwd": {"qm": 16, "km": 16, "vm": 16, "rp": 8, "eq": 4,
                       "ek": 4, "ev": 4},
          "attn_bwd": {"qm": 16, "gm": 16, "km": 16, "vm": 16, "m": 4,
                       "l": 4, "delta": 4, "rs": 16, "rp2": 16, "eq": 4,
                       "ek": 4, "ev": 4, "eg": 4}}


def attn_misaligned(op: str, ptrs: dict) -> str:
    """Which operand of ``op`` (``attn_decode``, ``attn_fwd`` or
    ``attn_bwd``) sits off the alignment its kernel's loads need ('' when
    none): ``ptrs`` maps the operand names to their addresses (None or
    absent: not passed).  16 bytes for the int8 operands (16-byte loads,
    bulk copies) and the backward's rounding bits (16-byte copies), 8 for
    the forward's bits (two words a load), 4 for the stats, exponents and
    the decode's bits."""
    for name, align in _ALIGN[op].items():
        ptr = ptrs.get(name)
        if ptr is not None and ptr % align:
            return (f"{name} at address {ptr:#x} is not {align}-byte "
                    f"aligned (its loads need it)")
    return ""


def _addresses(**ts) -> dict:
    return {k: None if t is None else t.data_ptr() for k, t in ts.items()}


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
        lib.repro_attn_decode.argtypes = [vp] * 8 + [i] * 12 + [vp]
        lib.repro_attn_decode.restype = i
        lib.repro_attn_decode_smem.argtypes = [i] * 4
        lib.repro_attn_decode_smem.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def attn_decode(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                ek_rows: torch.Tensor, ev_rows: torch.Tensor,
                rp: Optional[torch.Tensor], eq: torch.Tensor, q_off: int,
                kv_len: int, *, p: int, s: int, causal: bool, window: int,
                stochastic: bool) -> torch.Tensor:
    """Batched fused decode attention (shapes of ``attn_decode_plain``):
    the CUDA kernel for CUDA tensors, on clusters of ``decode_split``
    blocks, the plain version for CPU tensors."""
    if not qm.is_cuda:
        return attn_decode_plain(qm, km, vm, ek_rows, ev_rows, rp, eq, q_off,
                                 kv_len, p=p, s=s, causal=causal,
                                 window=window, stochastic=stochastic)
    bh, gs, d = qm.shape
    t = km.shape[1]
    dev = qm.device
    if d % 4 or d > 256:
        raise ValueError(f"decode kernel needs D % 4 == 0 and D <= 256, got {d}")
    n = decode_split(gs, t, d)
    smem = _decode_layout_bytes(gs, t, d, n)
    if smem > SMEM_LIMIT:
        raise ValueError(f"decode kernel: T={t} needs {smem} B of shared "
                         f"memory a block of a {n}-block cluster > "
                         f"{SMEM_LIMIT}")
    _check("qm", qm, torch.int8, (bh, gs, d), dev)
    _check("km", km, torch.int8, (bh, t, d), dev)
    _check("vm", vm, torch.int8, (bh, t, d), dev)
    _check("ek_rows", ek_rows, torch.int32, (bh, t, 1), dev)
    _check("ev_rows", ev_rows, torch.int32, (bh, t, 1), dev)
    if stochastic:
        rp = as_u32(rp)
        _check("rp", rp, torch.int32, (bh, gs, t), dev)
    eq = _scalar_i32("eq", eq, dev)
    why = attn_misaligned("attn_decode", _addresses(
        qm=qm, km=km, vm=vm, ek_rows=ek_rows, ev_rows=ev_rows,
        rp=rp if stochastic else None, eq=eq))
    if why:
        raise ValueError(f"attn_decode: {why}")
    y = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    err = _lib().repro_attn_decode(
        _ptr(qm), _ptr(eq), _ptr(km), _ptr(vm), _ptr(ek_rows), _ptr(ev_rows),
        _ptr(rp if stochastic else None), _ptr(y), bh, gs, t, d, s,
        int(q_off), int(min(kv_len, t)), int(causal), int(window), p,
        int(stochastic), n,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _raise_on(err, "attn_decode")
    attn_decode.launches += 1
    attn_decode_splits[n].launches += 1
    return y


# Launches of the kernel since the count was last set to 0, and of each
# cluster size.
attn_decode.launches = 0
attn_decode_splits = {n: _Launches() for n in DECODE_SPLITS}


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
    """Query rows per block of the ``__dp4a`` backward kernels: the largest
    of 32, 16, 8, 4 whose tiles fit in shared memory (4 when none does).
    The strip does not change the results.  (The ``wgmma`` route takes
    row tiles of 128.)"""
    return next((bq for bq in (32, 16, 8) if _bwd_smem(d, bt, bq)
                 <= SMEM_LIMIT), 4)


# The routes of the attention backward (``attn_bwd_variant``).
ATTN_BWD_VARIANTS = ("wgmma", "dp4a")
# Head dims the wgmma route takes: one warpgroup instruction (or n64 + n32)
# covers the head dim, and a 128-byte tile row holds it.
_TC_BWD_DIMS = (32, 64, 96, 128)


def attn_bwd_variant(gs: int, t: int, d: int, bt: int,
                     aligned: bool = True) -> str:
    """The route of the attention backward for GS query rows over a band of
    T in KV blocks of bt, head dim D: ``wgmma`` (two launches, int8 tensor
    cores, each KV block in chunks of 128 positions, so any bt % 128 == 0
    and any GS, T) for D of 32, 64, 96 or 128 with ``aligned`` operands
    (16-byte loads; the wrapper raises on an operand that is not, see
    ``attn_misaligned``); else the ``__dp4a`` kernels."""
    del gs, t, bt  # the route does not depend on them
    return "wgmma" if aligned and d in _TC_BWD_DIMS else "dp4a"


# The routes of the attention forward (``attn_fwd_variant``).
ATTN_FWD_VARIANTS = ("wgmma", "dp4a")
# The wgmma forward's block (``csrc/attn_train.cu`` FwdTcLayout): its query
# rows, the most windows of 32 a KV block holds, the KV blocks it takes.
_FWD_ROWS, _FWD_MAXW, _FWD_BT = 64, 16, (128, 256, 512)


def attn_fwd_variant(gs: int, t: int, d: int, bt: int,
                     aligned: bool = True) -> str:
    """The route of the attention forward for GS query rows over a band of
    T in KV blocks of bt, head dim D: ``wgmma`` (int8 tensor cores, each KV
    block in chunks of 128 positions) for D of 32, 64, 96 or 128 at bt 128,
    256 or 512 with ``aligned`` operands (16-byte copies of the tiles,
    8-byte loads of the bits; the wrapper raises on an operand that is not,
    see ``attn_misaligned``); else the ``__dp4a`` kernel."""
    del gs, t  # the route does not depend on them
    return ("wgmma" if aligned and d in _TC_BWD_DIMS and bt in _FWD_BT
            else "dp4a")


def _tc_fwd_layout(d: int, bt: int) -> tuple:
    """(bytes, sets) of one block of the wgmma forward (``FwdTcLayout``):
    Q^'s tile (64 rows of 128 bytes), V^T of the KV block's chunks (D rows
    of 128 bytes each), the row stats its warpgroups exchange (two of 4 x
    64 words, 64 x 16 window sums), then one or two sets (two where they
    fit) of the block's K^ chunks and V^ staging chunks (128 x 128 bytes
    each), and the 1024 bytes of the tiles' alignment."""
    nch = bt // 128
    red = _FWD_ROWS * 128 + nch * d * 128 + 4 * (2 * 4 * _FWD_ROWS
                                                  + _FWD_ROWS * _FWD_MAXW)
    ks = -(-red // 1024) * 1024
    set_bytes = 2 * nch * 128 * 128
    sets = 2 if 1024 + ks + 2 * set_bytes <= SMEM_LIMIT else 1
    return 1024 + ks + sets * set_bytes, sets


def attn_fwd_tiles(d: int, bt: int) -> int:
    """Warpgroups a block of 64 query rows of the wgmma forward, each
    taking 128 / n positions of every chunk and D / n columns of PV: 4
    (the C entry also takes 2 at D 64, to time it)."""
    del d, bt
    return 4


def _tc_bwd_smem(d: int) -> int:
    """Shared memory of the wgmma backward's pass B (``TcLayout``): three
    128 x 128-byte tiles (Q^, G^, dS^), four of 64 x 128 (the block's half
    of K^ and V^ chunks, P^T, dS^T), three of D x 128 (Q^T, G^T, K^T), the
    partner's dQ partial (512 D bytes), 128 bytes of flags and the 1024
    bytes of the tiles' alignment."""
    return 1024 + 3 * 128 * 128 + 4 * 64 * 128 + 3 * d * 128 + 512 * d + 128


def train_smem_bytes(op: str, d: int, bt: int) -> int:
    """Shared memory of one block of the ``attn_fwd`` or ``attn_bwd``
    kernel on the route its rule names (the layouts of
    ``csrc/attn_train.cu``): for the ``__dp4a`` routes, packed int8 tiles
    with odd word strides, the score or pn/dS tiles, the float
    accumulators and the row stats; for the ``wgmma`` routes their
    swizzled tiles."""
    if op == "attn_bwd":
        if attn_bwd_variant(0, 0, d, bt) == "wgmma":
            return _tc_bwd_smem(d)
        return _bwd_smem(d, bt, bwd_strip(d, bt))
    if attn_fwd_variant(0, 0, d, bt) == "wgmma":
        return _tc_fwd_layout(d, bt)[0]
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
        lib.repro_attn_fwd_tc.argtypes = [vp] * 10 + [i] * 13 + [vp]
        lib.repro_attn_fwd_tc.restype = i
        lib.repro_attn_fwd_tc_smem.argtypes = [i] * 2
        lib.repro_attn_fwd_tc_smem.restype = ctypes.c_longlong
        lib.repro_attn_bwd.argtypes = [vp] * 18 + [i] * 13 + [vp]
        lib.repro_attn_bwd.restype = i
        lib.repro_attn_bwd_tc.argtypes = [vp] * 19 + [i] * 12 + [vp]
        lib.repro_attn_bwd_tc.restype = i
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
    CUDA kernel on the route ``attn_fwd_variant`` names for CUDA tensors,
    the plain version for CPU tensors."""
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
    why = attn_misaligned("attn_fwd", _addresses(
        qm=qm, km=km, vm=vm, rp=rp if stochastic else None, eq=eq, ek=ek,
        ev=ev))
    if why:
        raise ValueError(f"attn_fwd: {why}")
    variant = attn_fwd_variant(gs, t, d, bt)
    y = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    m = torch.empty((bh, gs, 1), dtype=torch.float32, device=dev)
    l = torch.empty((bh, gs, 1), dtype=torch.float32, device=dev)
    args = [_ptr(x) for x in (qm, km, vm, rp if stochastic else None, eq, ek,
                              ev, y, m, l)]
    args += [bh, gs, t, d, s, int(q_off), int(min(kv_len, t)), int(causal),
             int(window), p, bt, int(stochastic)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if variant == "wgmma":
        err = _lib_train().repro_attn_fwd_tc(*args, attn_fwd_tiles(d, bt),
                                             stream)
    else:
        err = _lib_train().repro_attn_fwd(*args, stream)
    _raise_on(err, f"attn_fwd ({variant})")
    attn_fwd.launches += 1
    attn_fwd_variants[variant].launches += 1
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
    why = attn_misaligned("attn_bwd", _addresses(
        qm=qm, gm=gm, km=km, vm=vm, m=m, l=l, delta=delta,
        rs=rs if stochastic else None, rp2=rp2 if stochastic else None,
        eq=eq, ek=ek, ev=ev, eg=eg))
    if why:
        raise ValueError(f"attn_bwd: {why}")
    variant = attn_bwd_variant(gs, t, d, bt)
    nb = -(-t // bt)
    dq = torch.empty((bh, gs, d), dtype=torch.float32, device=dev)
    dk = torch.empty((bh, t, d), dtype=torch.float32, device=dev)
    dv = torch.empty((bh, t, d), dtype=torch.float32, device=dev)
    operands = [_ptr(x) for x in (qm, gm, km, vm, m, l, delta,
                                  rs if stochastic else None,
                                  rp2 if stochastic else None,
                                  eq, ek, ev, eg)]
    shape = [bh, gs, t, d, s, int(q_off), int(min(kv_len, t)), int(causal),
             int(window), p, bt]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    acc = torch.empty((2, bh, t, d), dtype=torch.int32, device=dev)
    if variant == "wgmma":
        # every slot, sum and count is written (or zeroed) by the kernels'
        # first pass
        e_scratch = torch.empty((bh, nb, 2 * -(-gs // 128), 2),
                                dtype=torch.int32, device=dev)
        done = torch.empty((bh,), dtype=torch.int32, device=dev)
        err = _lib_train().repro_attn_bwd_tc(
            *operands, _ptr(e_scratch), _ptr(acc), _ptr(done), _ptr(dq),
            _ptr(dk), _ptr(dv), *shape, int(stochastic), stream)
    else:
        e_scratch = torch.empty((2, bh, nb), dtype=torch.int32, device=dev)
        err = _lib_train().repro_attn_bwd(
            *operands, _ptr(e_scratch), _ptr(acc), _ptr(dq), _ptr(dk),
            _ptr(dv), *shape, bwd_strip(d, bt), int(stochastic), stream)
    _raise_on(err, f"attn_bwd ({variant})")
    attn_bwd.launches += 1
    attn_bwd_variants[variant].launches += 1
    return dq, dk, dv


# Launches of each wrapper's kernels since the count was last set to 0
# (a backward call is two launches on wgmma, three on __dp4a, counted once).
attn_fwd.launches = 0
attn_bwd.launches = 0
attn_fwd_variants = {v: _Launches() for v in ATTN_FWD_VARIANTS}
attn_bwd_variants = {v: _Launches() for v in ATTN_BWD_VARIANTS}
