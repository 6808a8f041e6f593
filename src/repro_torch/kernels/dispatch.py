"""Routing between the hand-written CUDA kernels and the plain path.

The port of the pieces of ``repro.kernels.dispatch`` that quantized serving
uses.  ``core.qops`` asks :func:`plan_contract` for every integer
contraction and ``models.attention`` asks :func:`plan_attention` for decode
attention; each answer is a :class:`Decision` that ``record_decisions``
can collect.  Paths:

  ``fused``  the kernel: ``kernels.fused_linear`` / ``fused_attention`` —
             the CUDA kernel for CUDA tensors, its plain version (the same
             arithmetic in torch) for CPU tensors;
  ``jnp``    the plain oracle path of ``core.qops`` (quantize, then an
             exact integer contraction) — the JAX package's jnp path.

Rules (the JAX package's, with "off-TPU -> jnp" read as "off-CUDA ->
plain"): ``kernel_mode="jnp"`` or bits != 8 -> jnp; ``"auto"`` -> the
kernel on CUDA when feasible, jnp elsewhere; ``"fused"`` -> the kernel
numerics wherever feasible.  Feasibility is the kernels' own limits: K
inside one int32 accumulator, and for decode attention the band T that the
kernel's shared memory holds.  An infeasible plan says why.  Nothing here
catches a kernel failure and drops to another path: a failed build or
launch raises.

:func:`plain_kernels` is the one explicit switch that makes fused
decisions run the kernels' plain versions on the card, so the whole path
can be compared with its kernels; the default path never takes it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch

from ..core import prng
from ..core.bfp import BFP, PER_TENSOR, QuantConfig, pow2, rounding_bits
from . import fused_attention as kfa
from . import fused_linear as kfl
from . import ref

__all__ = ["FUSED", "JNP", "Decision", "plan_contract", "plan_attention",
           "record_decisions", "plain_kernels", "contract_qq", "contract_qi",
           "attn_decode", "kernel_launches", "reset_kernel_launches"]

FUSED = "fused"
JNP = "jnp"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routing decision (m, k, n: the contraction; for attention gs,
    d, t)."""

    op: str
    path: str
    reason: str
    m: int
    k: int
    n: int
    kind: str = "qq"
    device: str = "cpu"


_decision_log: Optional[List[Decision]] = None
_plain_on_card = False


@contextlib.contextmanager
def record_decisions():
    """Collect every Decision planned while the context is open."""
    global _decision_log
    prev = _decision_log
    _decision_log = log = []
    try:
        yield log
    finally:
        _decision_log = prev


@contextlib.contextmanager
def plain_kernels():
    """Run FUSED decisions through the kernels' plain versions, on any
    device, while the context is open (the comparison switch)."""
    global _plain_on_card
    prev = _plain_on_card
    _plain_on_card = True
    try:
        yield
    finally:
        _plain_on_card = prev


def kernel_launches() -> dict:
    """Launch counts of the three kernel wrappers."""
    return {"qq": kfl.fused_qq_pt.launches, "qi": kfl.fused_qi_pt.launches,
            "attn_decode": kfa.attn_decode.launches}


def reset_kernel_launches() -> None:
    kfl.fused_qq_pt.launches = 0
    kfl.fused_qi_pt.launches = 0
    kfa.attn_decode.launches = 0


def _record(d: Decision) -> Decision:
    if _decision_log is not None:
        _decision_log.append(d)
    return d


def _check_mode(kernel_mode: str):
    if kernel_mode == "unfused":
        raise ValueError("kernel_mode='unfused': the two-kernel pipeline "
                         "(bfp_quantize + int8_matmul) is not ported yet")
    if kernel_mode not in ("auto", "fused", "jnp"):
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}")


def plan_contract(op: str, m: int, k: int, n: int, cfg: QuantConfig, *,
                  kind: str = "qq", cfg2: Optional[QuantConfig] = None,
                  kernel_mode: str = "auto", accum_chunk: int = 65536,
                  device: str = "cpu") -> Decision:
    """Choose the path for one (M, K) x (N, K)^T contraction.  ``cfg`` is
    the config of the freshly quantized operand(s), ``cfg2`` that of a
    pre-quantized operand."""

    def decide(path, reason):
        return _record(Decision(op, path, reason, m, k, n, kind, device))

    _check_mode(kernel_mode)
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    bits = {cfg.bits} | ({cfg2.bits} if cfg2 is not None else set())
    if bits != {8}:
        return decide(JNP, f"bits={sorted(bits)} (kernels are int8-only)")
    if cfg.block != PER_TENSOR or (cfg2 is not None
                                   and cfg2.block != PER_TENSOR):
        return decide(JNP, "per-block scales: the per-block kernel is not "
                           "ported yet")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the plain path on device={device}")
    if k > accum_chunk:
        return decide(JNP, f"K={k} > accum_chunk={accum_chunk} "
                           "(flush emulation stays on the plain path)")
    if k * 127 * 127 >= (1 << 31):
        return decide(JNP, f"K={k} overflows the int32 accumulator")
    if kind not in ("qq", "qi"):
        return decide(JNP, f"kind {kind}: its kernel is not ported yet")
    return decide(FUSED, "fused kernel")


def plan_attention(op: str, gs: int, t: int, d: int, cfg: QuantConfig, *,
                   s: int, kind: str = "pp", kernel_mode: str = "auto",
                   device: str = "cpu") -> Decision:
    """Choose the path for one fused-attention op (``gs`` grouped query
    rows, band ``t``, head dim ``d``).  JNP means the caller keeps the
    scan of separately dispatched GEMMs."""

    def decide(path, reason):
        return _record(Decision(op, path, reason, gs, d, t, kind, device))

    _check_mode(kernel_mode)
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    if cfg.bits != 8:
        return decide(JNP, f"bits={cfg.bits} (kernels are int8-only)")
    if cfg.block != PER_TENSOR:
        return decide(JNP, "fused attention is per-tensor only")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the scan path on device={device}")
    if op != "attn_decode":
        return decide(JNP, f"the {op} kernel is not ported yet")
    if d % 4 or d > 256:
        return decide(JNP, f"decode kernel needs D % 4 == 0 and D <= 256, "
                           f"got D={d}")
    need = kfa.decode_smem_bytes(gs, t, d)
    if need > kfa.DECODE_SMEM_LIMIT:
        return decide(JNP, f"T={t} needs {need} B of shared memory, over "
                           f"the decode kernel's {kfa.DECODE_SMEM_LIMIT}")
    return decide(FUSED, "decode band fits the kernel's shared memory")


# ---------------------------------------------------------------------------
# execution (contraction-last layout, per-tensor scales)
# ---------------------------------------------------------------------------

def _flat3(x: torch.Tensor, nbatch: int) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[nbatch:])).contiguous()


def contract_qq(a: torch.Tensor, b: torch.Tensor, cfg: QuantConfig,
                ka: prng.Key, kb: prng.Key, dec: Decision, nbatch: int = 0,
                want_residuals: bool = True
                ) -> Tuple[torch.Tensor, Optional[BFP], Optional[BFP]]:
    """Quantize both contraction-last operands and contract on the qq
    kernel: a (*B, M, K), b (*B, N, K) f32 -> (y (*B, M, N), aq, bq), or
    (y, None, None) when ``want_residuals`` is False (no mantissa is
    written).  The shared exponents are the maxima over the whole
    (batched) tensors and the rounding bits are drawn on their logical
    shapes, exactly as ``core.bfp.quantize`` would."""
    assert cfg.block == PER_TENSOR and dec.path == FUSED
    sr = cfg.stochastic
    ra = rounding_bits(ka, a.shape, cfg.rng, a.device) if sr else None
    rb = rounding_bits(kb, b.shape, cfg.rng, b.device) if sr else None
    ea = ref.max_biased_exp_ref(a)
    eb = ref.max_biased_exp_ref(b)
    run = kfl.fused_qq_pt_plain if _plain_on_card else kfl.fused_qq_pt
    y, am, bm = run(_flat3(a, nbatch), None if ra is None else _flat3(ra, nbatch),
                    _flat3(b, nbatch), None if rb is None else _flat3(rb, nbatch),
                    ea, eb, p=cfg.p, stochastic=sr,
                    emit_residuals=want_residuals)
    y = y.reshape(*a.shape[:nbatch], *y.shape[1:])
    if not want_residuals:
        return y, None, None
    return (y, BFP(am.reshape(a.shape), ea, cfg),
            BFP(bm.reshape(b.shape), eb, cfg))


def contract_qi(a: torch.Tensor, bq: BFP, cfg: QuantConfig, ka: prng.Key,
                dec: Decision, nbatch: int = 0) -> Tuple[torch.Tensor, BFP]:
    """Quantize ``a`` in the qi kernel against pre-quantized mantissas:
    a (*B, M, K) f32, bq.m (*B, N, K) int8 per tensor -> (y, aq)."""
    assert cfg.block == PER_TENSOR and bq.cfg.block == PER_TENSOR
    assert dec.path == FUSED
    sr = cfg.stochastic
    ra = rounding_bits(ka, a.shape, cfg.rng, a.device) if sr else None
    ea = ref.max_biased_exp_ref(a)
    run = kfl.fused_qi_pt_plain if _plain_on_card else kfl.fused_qi_pt
    y, am = run(_flat3(a, nbatch), None if ra is None else _flat3(ra, nbatch),
                _flat3(bq.m, nbatch), ea, bq.e.to(torch.int32),
                pa=cfg.p, pb=bq.cfg.p, stochastic=sr)
    lead = a.shape[:nbatch]
    return y.reshape(*lead, *y.shape[1:]), BFP(am.reshape(a.shape), ea, cfg)


def attn_decode(qm, km, vm, ek_rows, ev_rows, rp, eq, q_off, kv_len, *, p,
                s, causal, window, stochastic):
    """Run a FUSED decode-attention decision (see
    ``kernels.fused_attention.attn_decode``)."""
    run = kfa.attn_decode_plain if _plain_on_card else kfa.attn_decode
    return run(qm.contiguous(), km.contiguous(), vm.contiguous(),
               ek_rows.contiguous(), ev_rows.contiguous(),
               None if rp is None else rp.contiguous(), eq, q_off, kv_len,
               p=p, s=s, causal=causal, window=window, stochastic=stochastic)


def _jnp_matmul(am: torch.Tensor, bmant: torch.Tensor, ea, eb, pa: int,
                pb: int) -> torch.Tensor:
    """Plain mirror of the kernel GEMMs: exact integer contraction of
    contraction-last mantissas and one f32 rescale."""
    sea = ea - 127 - 23 + (24 - pa)
    seb = eb - 127 - 23 + (24 - pb)
    return kfl.int8_dot(am, bmant).to(torch.float32) * pow2(sea + seb)
