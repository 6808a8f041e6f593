"""Routing between the hand-written CUDA kernels and the plain path.

The port of the pieces of ``repro.kernels.dispatch`` that quantized
serving and training use.  ``core.qops`` asks :func:`plan_contract` for
every integer contraction and ``models.attention`` asks
:func:`plan_attention` for fused attention; each answer is a
:class:`Decision` that ``record_decisions`` can collect.  Paths:

  ``fused``  the kernel: ``kernels.fused_linear`` / ``fused_attention`` —
             the CUDA kernel for CUDA tensors, its plain version (the same
             arithmetic in torch) for CPU tensors;
  ``unfused`` the two-kernel rung of ``kernel_mode="unfused"``: each
             fresh operand quantized by ``kernels.bfp_quant`` into int8 in
             device memory, then contracted by ``kernels.int8_matmul``
             (:func:`_quantize_rows`, :func:`_matmul_unfused`);
  ``jnp``    the plain oracle path of ``core.qops`` (quantize, then an
             exact integer contraction), or for attention the scan of
             separately dispatched contractions — the JAX package's jnp
             path.

The cross-op chains plan too: :func:`plan_norm_gemm` (``norm_gemm``),
:func:`plan_epilogue` (``gemm_epi``) and :func:`plan_decode_block`
(``decode_block``), run by :func:`run_norm_gemm`, :func:`contract_epi` and
:func:`run_decode_block`.  By default they follow the CUDA kernels' own
limits (the int32 accumulator, shared memory, the decode kernel's batch
and widths), and each ``reason`` names the limit that applied.  The
reference engages them only where a whole operand fits the TPU's VMEM
budget (12 MiB), so at full width it keeps the seams the port's kernels
replace: ``vmem_budget`` (or :func:`chain_vmem_budget` around a whole
model call) applies the reference's residency predicates as well, and
then a plan answers as the reference's does.  JNP for a chain means the
caller keeps the per-op seam; ``norm_gemm`` and ``decode_block`` define
their own norm numerics, so there the seam computes something else.

Contraction kinds: ``qq`` (both operands quantized in the kernel), ``qi``
(a fresh, b pre-quantized), ``iq`` (a pre-quantized, b fresh: the ``qi``
kernel with the roles swapped), ``ii`` and ``pp`` (both pre-quantized:
the ``ii`` kernel).  Rules (the JAX package's, with "off-TPU -> jnp" read
as "off-CUDA -> plain"): ``kernel_mode="jnp"`` or bits != 8 -> jnp;
``"auto"`` -> the kernel on CUDA when feasible, jnp elsewhere; ``"fused"``
-> the kernel numerics wherever feasible; ``"unfused"`` -> the unfused
rung for every feasible per-tensor contraction whose fresh operands round
stochastically (the quantizer kernel is SR-only), and jnp for the chains
and attention, which have no unfused pipeline.  Feasibility is the
kernels' own limits: K inside one int32 accumulator (per tensor; a
per-block partial sums only one block), and for attention the shared
memory one block holds.  Per-block scales have a kernel for kind ``qq``
only (``qq_blk``); any other per-block kind plans jnp on the CPU and
raises on the card, and so do the two plans that exist only under
``"unfused"`` (nearest rounding of a fresh operand, a per-block scale).
An infeasible plan says why.
Nothing here catches a kernel failure and drops to another path: a failed
build or launch raises.

:func:`plain_kernels` is the one explicit switch that makes fused
decisions run the kernels' plain versions on the card, so the whole path
can be compared with its kernels; the default path never takes it.  It
covers the rounding bits too: every draw on a card comes through
:func:`draw_bits`, the ``rounding_bits`` kernel or, inside the switch,
``prng.bits``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch

from ..core import prng
from ..core.bfp import BFP, PER_TENSOR, QuantConfig, pow2, rounding_bits
from . import bfp_quant as kbq
from . import fused_attention as kfa
from . import fused_chain as kfc
from . import fused_linear as kfl
from . import int8_matmul as kim
from . import ref
from . import rounding_bits as krb

__all__ = ["FUSED", "UNFUSED", "JNP", "Decision", "plan_contract",
           "plan_attention", "attn_block_t", "record_decisions",
           "plain_kernels", "contract_qq", "contract_qi", "contract_iq",
           "contract_ii", "attn_decode", "attn_fwd", "attn_bwd",
           "plan_norm_gemm", "run_norm_gemm", "plan_epilogue", "contract_epi",
           "plan_decode_block", "run_decode_block", "kernel_launches",
           "reset_kernel_launches", "REFERENCE_VMEM_BUDGET",
           "chain_vmem_budget", "draw_bits"]

FUSED = "fused"
UNFUSED = "unfused"
JNP = "jnp"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One routing decision (m, k, n: the contraction; for attention gs,
    d, t, and ``bt`` the KV block of the training attention kernels)."""

    op: str
    path: str
    reason: str
    m: int
    k: int
    n: int
    kind: str = "qq"
    device: str = "cpu"
    bt: int = 0


_decision_log: Optional[List[Decision]] = None
_plain_on_card = False
_chain_budget: Optional[int] = None


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
    """Run FUSED and UNFUSED decisions through the kernels' plain versions,
    on any device, while the context is open (the comparison switch)."""
    global _plain_on_card
    prev = _plain_on_card
    _plain_on_card = True
    try:
        yield
    finally:
        _plain_on_card = prev


@contextlib.contextmanager
def chain_vmem_budget(budget: Optional[int] = None):
    """Plan the chains under the reference's residency predicates with
    ``budget`` bytes (default the reference's 12 MiB) while the context is
    open, wherever a plan is not given its own ``vmem_budget``: a model
    call then takes the seams the reference takes."""
    global _chain_budget
    prev = _chain_budget
    _chain_budget = REFERENCE_VMEM_BUDGET if budget is None else budget
    try:
        yield
    finally:
        _chain_budget = prev


_WRAPPERS = {"qq": kfl.fused_qq_pt, "qi": kfl.fused_qi_pt,
             "ii": kfl.fused_ii_pt, "qq_blk": kfl.fused_qq_blk,
             "attn_decode": kfa.attn_decode,
             "attn_fwd": kfa.attn_fwd, "attn_bwd": kfa.attn_bwd,
             "gemm_epi": kfl.fused_gemm_epi, "norm_gemm": kfc.fused_norm_gemm,
             **{f"gemm_epi_{v}": c for v, c in kfl.gemm_epi_variants.items()},
             **{f"norm_gemm_{v}": c
                for v, c in kfc.norm_gemm_variants.items()},
             "decode_block": kfc.fused_decode_block,
             "bfp_quantize": kbq.bfp_quantize,
             "int8_matmul": kim.int8_matmul,
             "rounding_bits": krb.rounding_bits,
             **{f"qq_{v}": c for v, c in kfl.qq_variants.items()},
             **{f"qi_{v}": c for v, c in kfl.qi_variants.items()},
             **{f"ii_{v}": c for v, c in kfl.ii_variants.items()},
             **{f"qq_blk_{v}": c for v, c in kfl.qq_blk_variants.items()},
             **{f"int8_matmul_{v}": c
                for v, c in kim.int8_matmul_variants.items()},
             **{f"attn_decode_n{n}": c
                for n, c in kfa.attn_decode_splits.items()},
             **{f"attn_fwd_{v}": c for v, c in kfa.attn_fwd_variants.items()},
             **{f"attn_bwd_{v}": c for v, c in kfa.attn_bwd_variants.items()}}


def kernel_launches() -> dict:
    """Launch counts of the kernel wrappers, and of the ``qq`` / ``qi`` /
    ``ii`` variants (``qq_wgmma``, ``qq_stream``, ``qq_dp4a``, ``qi_...``,
    ``ii_...``), the ``qq_blk`` ones (``qq_blk_wgmma``,
    ``qq_blk_wgmma64``, ``qq_blk_dp4a``), the ``int8_matmul`` ones
    (``int8_matmul_wgmma``, ``_stream``, ``_wmma``) and those of
    ``gemm_epi`` and ``norm_gemm`` (``gemm_epi_wgmma``, ``_dp4a``,
    ``norm_gemm_wgmma``, ``_dp4a``), ``attn_decode`` by cluster size
    (``attn_decode_n1`` ... ``attn_decode_n16``) and ``attn_fwd`` and
    ``attn_bwd`` by route (``attn_fwd_wgmma``, ``attn_fwd_dp4a``,
    ``attn_bwd_wgmma``, ``attn_bwd_dp4a``), and the rounding-bit draws
    (``rounding_bits``)."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def draw_bits(key: prng.Key, shape, rng: str = "threefry",
              device=None) -> torch.Tensor:
    """Rounding bits on a card: the ``rounding_bits`` kernel, or its plain
    version (``prng.bits`` / ``prng.hash_bits``) inside
    :func:`plain_kernels`.  ``core.bfp.rounding_bits`` routes every draw on
    a CUDA device here."""
    run = krb.rounding_bits_plain if _plain_on_card else krb.rounding_bits
    return run(key, shape, rng, device)


def reset_kernel_launches() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def _record(d: Decision) -> Decision:
    if _decision_log is not None:
        _decision_log.append(d)
    return d


def _check_mode(kernel_mode: str):
    if kernel_mode not in ("auto", "fused", "unfused", "jnp"):
        raise ValueError(f"unknown kernel_mode {kernel_mode!r}")


def _no_kernel(op: str, why: str, device: str):
    """A plan with no kernel behind it: the card raises (its plain path
    runs only on the CPU)."""
    if device == "cuda":
        raise NotImplementedError(f"{op}: {why}; its plain path runs only "
                                  f"on the CPU")


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
    if kind not in ("qq", "qi", "iq", "ii", "pp"):
        raise ValueError(f"unknown contraction kind {kind!r}")
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    bits = {cfg.bits} | ({cfg2.bits} if cfg2 is not None else set())
    if bits != {8}:
        return decide(JNP, f"bits={sorted(bits)} (kernels are int8-only)")
    per_block = cfg.block != PER_TENSOR or (cfg2 is not None
                                            and cfg2.block != PER_TENSOR)
    if per_block and kind != "qq":
        why = (f"per-block scales have a kernel only for kind qq (both "
               f"operands quantized in it), not {kind}")
        _no_kernel(op, why, device)
        return decide(JNP, why)
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the plain path on device={device}")
    if per_block:
        if kernel_mode == "unfused":
            why = "per-block scale has no unfused kernel path"
            _no_kernel(op, why, device)
            return decide(JNP, why)
        # a per-block partial sums only ``block`` products: no flush
        # emulation, no int32 overflow
        return decide(FUSED, "per-block kernel (qq_blk)")
    if k > accum_chunk:
        return decide(JNP, f"K={k} > accum_chunk={accum_chunk} "
                           "(flush emulation stays on the plain path)")
    if k * 127 * 127 >= (1 << 31):
        return decide(JNP, f"K={k} overflows the int32 accumulator")
    if kernel_mode == "unfused":
        if kind not in ("ii", "pp") and not cfg.stochastic:
            # the standalone quantizer implements stochastic rounding only
            why = "unfused quantizer kernel is SR-only"
            _no_kernel(op, why, device)
            return decide(JNP, why)
        return decide(UNFUSED, "kernel_mode=unfused")
    return decide(FUSED, "fused kernel")


def attn_block_t(t: int) -> int:
    """KV block ``bt`` of the training attention kernels for band length
    ``t`` (``repro.kernels.dispatch.attn_block_t``): part of the numerics
    (p's per-row exponent spans one block, pn's and dS's one block of
    every row), so forward, backward and the plain versions derive it from
    the shape alone."""
    if t <= 1024:
        return 128
    if t <= 4096:
        return 256
    return 512


def plan_attention(op: str, gs: int, t: int, d: int, cfg: QuantConfig, *,
                   s: int, kind: str = "pp", kernel_mode: str = "auto",
                   device: str = "cpu") -> Decision:
    """Choose the path for one fused-attention op (``gs`` grouped query
    rows, band ``t``, head dim ``d``).  JNP means the caller keeps the
    jnp path: the scan of separately dispatched GEMMs (``attn_fwd``,
    ``attn_decode``) or the backward's plain version (``attn_bwd``, CPU
    only).  A fused forward commits its backward to the fused numerics,
    so ``attn_fwd`` is FUSED only where the ``attn_bwd`` kernels fit too."""

    def decide(path, reason, bt=0):
        return _record(Decision(op, path, reason, gs, d, t, kind, device,
                                bt))

    _check_mode(kernel_mode)
    if op not in ("attn_fwd", "attn_bwd", "attn_decode"):
        raise ValueError(f"unknown attention op {op!r}")
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    if kernel_mode == "unfused":
        return decide(JNP, "attention has no unfused pipeline")
    if cfg.bits != 8:
        return decide(JNP, f"bits={cfg.bits} (kernels are int8-only)")
    if cfg.block != PER_TENSOR:
        return decide(JNP, "fused attention is per-tensor only")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the scan path on device={device}")
    if op != "attn_decode":
        bt = attn_block_t(t)
        for k in (op, "attn_bwd"):
            need = kfa.train_smem_bytes(k, d, bt)
            if need > kfa.SMEM_LIMIT:
                return decide(JNP, f"D={d}, bt={bt} needs {need} B of "
                                   f"shared memory, over the {k} kernel's "
                                   f"{kfa.SMEM_LIMIT}")
        return decide(FUSED, "fused attention fits the kernels' shared "
                             "memory", bt)
    if d % 4 or d > 256:
        return decide(JNP, f"decode kernel needs D % 4 == 0 and D <= 256, "
                           f"got D={d}")
    n = kfa.decode_split(gs, t, d)
    need = kfa.decode_smem_bytes(gs, t, d)
    if need > kfa.SMEM_LIMIT:
        return decide(JNP, f"T={t} needs {need} B of shared memory a block "
                           f"of a {n}-block cluster, over the decode "
                           f"kernel's {kfa.SMEM_LIMIT}")
    return decide(FUSED, f"decode band fits the shared memory of a {n}-block "
                         f"cluster")


# ---------------------------------------------------------------------------
# execution (contraction-last layout)
# ---------------------------------------------------------------------------

def _flat3(x: torch.Tensor, nbatch: int) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[nbatch:])).contiguous()


def contract_qq(a: torch.Tensor, b: torch.Tensor, cfg: QuantConfig,
                ka: prng.Key, kb: prng.Key, dec: Decision, nbatch: int = 0,
                want_residuals: bool = True
                ) -> Tuple[torch.Tensor, Optional[BFP], Optional[BFP]]:
    """Quantize both contraction-last operands and contract on the qq
    kernel (per-tensor ``cfg``) or the qq_blk kernel (per-block ``cfg``):
    a (*B, M, K), b (*B, N, K) f32 -> (y (*B, M, N), aq, bq), or (y, None,
    None) when ``want_residuals`` is False (no mantissa is written).  The
    shared exponents are the maxima over the whole (batched) tensors, or
    over each row's blocks of K ((*B, M, K/blk) int32), and the rounding
    bits are drawn on the logical shapes, exactly as ``core.bfp.quantize``
    would.  The reference pads K with blocks of exponent 1, which add exact
    zeros; the kernels take K as it is.  An UNFUSED plan quantizes each
    operand on the quantizer kernel and contracts on the int8 GEMM
    kernel."""
    assert dec.path in (FUSED, UNFUSED)
    sr = cfg.stochastic
    ra = rounding_bits(ka, a.shape, cfg.rng, a.device) if sr else None
    rb = rounding_bits(kb, b.shape, cfg.rng, b.device) if sr else None
    if dec.path == UNFUSED:
        ea = ref.max_biased_exp_ref(a)
        eb = ref.max_biased_exp_ref(b)
        am, bm = _quantize_rows(a, ra, ea), _quantize_rows(b, rb, eb)
        y = _matmul_unfused(am, bm, ea, eb, cfg.p, cfg.p, nbatch)
        if not want_residuals:
            return y, None, None
        return y, BFP(am, ea, cfg), BFP(bm, eb, cfg)
    ra3 = None if ra is None else _flat3(ra, nbatch)
    rb3 = None if rb is None else _flat3(rb, nbatch)
    if cfg.block == PER_TENSOR:
        ea = ref.max_biased_exp_ref(a)
        eb = ref.max_biased_exp_ref(b)
        run = kfl.fused_qq_pt_plain if _plain_on_card else kfl.fused_qq_pt
        y, am, bm = run(_flat3(a, nbatch), ra3, _flat3(b, nbatch), rb3, ea,
                        eb, p=cfg.p, stochastic=sr,
                        emit_residuals=want_residuals)
    else:
        a, b = a.contiguous(), b.contiguous()
        ea = ref.max_biased_exp_blocks_ref(a, cfg.block)
        eb = ref.max_biased_exp_blocks_ref(b, cfg.block)
        run = kfl.fused_qq_blk_plain if _plain_on_card else kfl.fused_qq_blk
        y, am, bm = run(_flat3(a, nbatch), ra3, _flat3(ea, nbatch),
                        _flat3(b, nbatch), rb3, _flat3(eb, nbatch), p=cfg.p,
                        blk=cfg.block, stochastic=sr,
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
    assert dec.path in (FUSED, UNFUSED)
    sr = cfg.stochastic
    ra = rounding_bits(ka, a.shape, cfg.rng, a.device) if sr else None
    ea = ref.max_biased_exp_ref(a)
    if dec.path == UNFUSED:
        am = _quantize_rows(a, ra, ea)
        y = _matmul_unfused(am, bq.m, ea, bq.e, cfg.p, bq.cfg.p, nbatch)
        return y, BFP(am, ea, cfg)
    run = kfl.fused_qi_pt_plain if _plain_on_card else kfl.fused_qi_pt
    y, am = run(_flat3(a, nbatch), None if ra is None else _flat3(ra, nbatch),
                _flat3(bq.m, nbatch), ea, bq.e.to(torch.int32),
                pa=cfg.p, pb=bq.cfg.p, stochastic=sr)
    lead = a.shape[:nbatch]
    return y.reshape(*lead, *y.shape[1:]), BFP(am.reshape(a.shape), ea, cfg)


def contract_iq(aq: BFP, b: torch.Tensor, cfg: QuantConfig, kb: prng.Key,
                dec: Decision, nbatch: int = 0) -> Tuple[torch.Tensor, BFP]:
    """Contract pre-quantized mantissas against a freshly quantized ``b``:
    aq.m (*B, M, K) int8 per tensor, b (*B, N, K) f32 -> (y (*B, M, N),
    bq).  The qi kernel with the operand roles swapped: ``b`` is the side
    quantized in the kernel, and its (N, M) tile output is transposed
    back."""
    assert cfg.block == PER_TENSOR and aq.cfg.block == PER_TENSOR
    assert dec.path in (FUSED, UNFUSED)
    sr = cfg.stochastic
    rb = rounding_bits(kb, b.shape, cfg.rng, b.device) if sr else None
    eb = ref.max_biased_exp_ref(b)
    if dec.path == UNFUSED:
        bm = _quantize_rows(b, rb, eb)
        y = _matmul_unfused(aq.m, bm, aq.e, eb, aq.cfg.p, cfg.p, nbatch)
        return y, BFP(bm, eb, cfg)
    run = kfl.fused_qi_pt_plain if _plain_on_card else kfl.fused_qi_pt
    yt, bm = run(_flat3(b, nbatch), None if rb is None else _flat3(rb, nbatch),
                 _flat3(aq.m, nbatch), eb, aq.e.to(torch.int32), pa=cfg.p,
                 pb=aq.cfg.p, stochastic=sr)
    y = yt.transpose(-1, -2).reshape(*aq.m.shape[:-1], b.shape[-2])
    return y, BFP(bm.reshape(b.shape), eb, cfg)


def contract_ii(aq: BFP, bq: BFP, dec: Decision,
                nbatch: int = 0) -> torch.Tensor:
    """Contract two stored residual mantissa tensors on the ii kernel (the
    backward's dW = X^T G): aq.m (*B, M, K) int8, bq.m (*B, N, K) int8, per
    tensor -> y (*B, M, N) f32.  Transposed residuals arrive as views;
    ``_flat3`` copies them contiguous."""
    assert aq.cfg.block == PER_TENSOR and bq.cfg.block == PER_TENSOR
    assert dec.path in (FUSED, UNFUSED)
    if dec.path == UNFUSED:
        return _matmul_unfused(aq.m, bq.m, aq.e, bq.e, aq.cfg.p, bq.cfg.p,
                               nbatch)
    run = kfl.fused_ii_pt_plain if _plain_on_card else kfl.fused_ii_pt
    y = run(_flat3(aq.m, nbatch), _flat3(bq.m, nbatch),
            aq.e.to(torch.int32), bq.e.to(torch.int32), pa=aq.cfg.p,
            pb=bq.cfg.p)
    return y.reshape(*aq.m.shape[:nbatch], *y.shape[1:])


def _quantize_rows(x: torch.Tensor, rand: Optional[torch.Tensor],
                   e: torch.Tensor) -> torch.Tensor:
    """Per-tensor quantization of ``x`` (any leading dims) on the quantizer
    kernel: the rows of its last axis, each against the one exponent
    ``e``.  ``plan_contract`` routes only stochastic operands here."""
    assert rand is not None, "the unfused quantizer is SR-only"
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    e_rows = e.to(torch.int32).reshape(1).expand(x2.shape[0]).contiguous()
    run = kbq.bfp_quantize_plain if _plain_on_card else kbq.bfp_quantize
    return run(x2, rand.reshape(x2.shape), e_rows).reshape(x.shape)


def _matmul_unfused(am: torch.Tensor, bmant: torch.Tensor, ea, eb, pa: int,
                    pb: int, nbatch: int = 0) -> torch.Tensor:
    """The int8 GEMM kernel on contraction-last mantissas am (*B, M, K),
    bmant (*B, N, K) with per-tensor exponents -> y (*B, M, N): one scalar
    scale for the whole batch."""
    scale = pow2(kfl.scale_exp(ea, pa) + kfl.scale_exp(eb, pb))
    run = kim.int8_matmul_plain if _plain_on_card else kim.int8_matmul
    y = run(_flat3(am, nbatch), _flat3(bmant, nbatch), scale)
    return y.reshape(*am.shape[:nbatch], *y.shape[1:])


def attn_fwd(qm, km, vm, rp, eq, ek, ev, q_off, kv_len, *, p, s, bt, causal,
             window, stochastic):
    """Run a FUSED training-attention forward (see
    ``kernels.fused_attention.attn_fwd``); an int8 operand or the bits off
    the alignment the kernel's loads need is copied first."""
    run = kfa.attn_fwd_plain if _plain_on_card else kfa.attn_fwd
    qm, km, vm = (x.contiguous() for x in (qm, km, vm))
    rp = None if rp is None else rp.contiguous()
    if qm.is_cuda and not _plain_on_card:
        qm, km, vm = (_aligned_to(x, 16) for x in (qm, km, vm))
        rp = None if rp is None else _aligned_to(rp, 8)
    return run(qm, km, vm, rp, eq, ek, ev, q_off, kv_len, p=p, s=s, bt=bt,
               causal=causal, window=window, stochastic=stochastic)


def attn_bwd(qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, q_off,
             kv_len, *, p, s, bt, causal, window, stochastic):
    """Run a FUSED training-attention backward (see
    ``kernels.fused_attention.attn_bwd``)."""
    run = kfa.attn_bwd_plain if _plain_on_card else kfa.attn_bwd
    c = (lambda x: None if x is None else x.contiguous())
    qm, gm, km, vm, m, l, delta, rs, rp2 = (
        c(x) for x in (qm, gm, km, vm, m, l, delta, rs, rp2))
    if qm.is_cuda and not _plain_on_card:
        qm, gm, km, vm = (_aligned_to(x, 16) for x in (qm, gm, km, vm))
        rs, rp2 = (None if x is None else _aligned_to(x, 16) for x in (rs, rp2))
    return run(qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, q_off,
               kv_len, p=p, s=s, bt=bt, causal=causal, window=window,
               stochastic=stochastic)


def attn_decode(qm, km, vm, ek_rows, ev_rows, rp, eq, q_off, kv_len, *, p,
                s, causal, window, stochastic):
    """Run a FUSED decode-attention decision (see
    ``kernels.fused_attention.attn_decode``)."""
    run = kfa.attn_decode_plain if _plain_on_card else kfa.attn_decode
    qm, km, vm = (x.contiguous() for x in (qm, km, vm))
    if qm.is_cuda and not _plain_on_card:
        qm, km, vm = (_aligned_to(x, 16) for x in (qm, km, vm))
    return run(qm, km, vm, ek_rows.contiguous(), ev_rows.contiguous(),
               None if rp is None else rp.contiguous(), eq, q_off, kv_len,
               p=p, s=s, causal=causal, window=window, stochastic=stochastic)


def _jnp_matmul(am: torch.Tensor, bmant: torch.Tensor, ea, eb, pa: int,
                pb: int) -> torch.Tensor:
    """Plain mirror of the kernel GEMMs: exact integer contraction of
    contraction-last mantissas and one f32 rescale."""
    sea = ea - 127 - 23 + (24 - pa)
    seb = eb - 127 - 23 + (24 - pb)
    return kfl.int8_dot(am, bmant).to(torch.float32) * pow2(sea + seb)


def _jnp_block_matmul(am: torch.Tensor, bmant: torch.Tensor, ea, eb, pa: int,
                      pb: int, blk: int) -> torch.Tensor:
    """Plain mirror of the per-block kernel: exact per-block partials of
    contraction-last mantissas, each times its block scale, summed in
    block order (the kernel's order, not ``core.qops._blk_dot``'s)."""
    return kfl.blk_combine(am, bmant, kfl.scale_exp(ea, pa),
                           kfl.scale_exp(eb, pb), blk)


# ---------------------------------------------------------------------------
# cross-op chains
# ---------------------------------------------------------------------------

# The reference's residency budget of one chain instance (12 MiB of a
# TPU's VMEM), its last-dim tile, and its row-strip candidates
# (``repro.kernels.dispatch.DEFAULT_VMEM_BUDGET``, ``_LANE``,
# ``repro.kernels.autotune.BM_CANDIDATES``).
REFERENCE_VMEM_BUDGET = 12 * 1024 * 1024
_LANE = 128
_BM_CANDIDATES = (32, 64, 128, 256, 512)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _vmem_bytes(kind: str, bm: int, k: int, n: int) -> int:
    """The reference's residency estimate of one per-tensor fused GEMM
    instance of kind qq, qi or ii (``repro.kernels.dispatch._vmem_bytes``):
    a double-buffered row strip and the resident b side."""
    y = 4 * bm * n
    a_strip = (1 if kind == "ii" else 4 + 4 + 1) * bm * k + y
    b_res = (4 + 4 + 1 if kind == "qq" else 1) * n * k
    return 2 * a_strip + b_res


def _norm_gemm_vmem_bytes(bm: int, kp: int, n: int, stochastic: bool,
                          emit_residuals: bool) -> int:
    """The reference's ``_norm_gemm_vmem_bytes``: the f32 x strip and its
    two bit strips (double-buffered), the resident weight and its column
    exponents, the output and residual strips."""
    r8 = 4 if stochastic else 0
    strip = (4 + 2 * r8) * bm * kp + 4 * bm * n
    if emit_residuals:
        strip += 2 * bm * kp + 4 * bm * _LANE
    resident = 1 * n * kp + 4 * n + 2 * 4 * kp
    return 2 * strip + resident


def _epi_vmem_bytes(kind: str, bm: int, kp: int, np_: int, n_out: int,
                    stochastic: bool, bias: bool, act: bool,
                    out_q: bool) -> int:
    """The reference's ``_epi_vmem_bytes``: the base GEMM kind's footprint
    plus the bias row, the out-quantize's bit strip and the pre-activation
    strip."""
    r8 = 4 if stochastic else 0
    extra = (4 * np_ if bias else 0)
    if out_q:
        extra += 2 * r8 * bm * n_out
    if act:
        extra += 2 * 4 * bm * np_
    return _vmem_bytes(kind, bm, kp, np_) + extra


def _decode_block_vmem_bytes(b: int, d: int, n_ff: int, t: int, hq: int,
                             hkv: int, dh: int) -> int:
    """The reference's ``_decode_block_vmem_bytes``: every weight mantissa,
    the cache band and the f32 working tiles of one whole-layer instance."""
    w_i8 = d * (hq + 2 * hkv) * dh + hq * dh * d + 2 * d * n_ff + n_ff * d
    w_exp = 4 * ((hq + 2 * hkv) * dh + d + 2 * n_ff + d + 2 * d)
    cache = b * hkv * t * (2 * 1 * dh + 2 * 4)
    widest = max((hq + 2 * hkv) * dh, 2 * n_ff, d)
    work = 6 * 4 * b * widest + 4 * b * hq * t
    return w_i8 + w_exp + cache + work


def _budget(vmem_budget: Optional[int]) -> Optional[int]:
    return vmem_budget if vmem_budget is not None else _chain_budget


def plan_norm_gemm(op: str, m: int, k: int, n: int, cfg: QuantConfig, *,
                   kernel_mode: str = "auto", device: str = "cpu",
                   vmem_budget: Optional[int] = None) -> Decision:
    """Choose the path for one norm -> quantize -> GEMM chain (``m`` rows
    of width ``k`` projected to ``n``).  FUSED runs ``fused_norm_gemm``;
    JNP keeps the per-op seam (qnorm, then qmatmul), whose numerics differ:
    the chain has its own per-row norm.  ``vmem_budget``: also the
    reference's residency predicate (some row strip of the weight-resident
    kernel fits the budget)."""

    def decide(path, reason):
        return _record(Decision(op, path, reason, m, k, n, "norm_gemm",
                                device))

    _check_mode(kernel_mode)
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    if kernel_mode == "unfused":
        return decide(JNP, "chain ops have no unfused pipeline")
    if cfg.bits != 8:
        return decide(JNP, f"bits={cfg.bits} (kernels are int8-only)")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the per-op seam on device={device}")
    budget = _budget(vmem_budget)
    if budget is not None and not any(
            _norm_gemm_vmem_bytes(bm, _round_up(k, _LANE), _round_up(n, _LANE),
                                  cfg.stochastic, True) <= budget
            for bm in _BM_CANDIDATES):
        return decide(JNP, f"no bm candidate fits vmem_budget={budget}")
    if k * 127 * 127 >= (1 << 31):
        return decide(JNP, f"K={k} overflows the int32 accumulator")
    variant = kfc.norm_gemm_variant(m, k)
    need = kfc.norm_gemm_smem_bytes(16, k)
    if variant == "dp4a" and need > kfa.SMEM_LIMIT:
        return decide(JNP, f"K={k}: the __dp4a kernel's strip of 16 rows "
                           f"needs {need} B of shared memory > "
                           f"{kfa.SMEM_LIMIT}")
    return decide(FUSED, f"norm_gemm kernel ({variant})")


def run_norm_gemm(x, rand_in, rand_out, gm, se_g, beta_m, se_b, w_m, se_w,
                  dec: Decision, *, n: int, p: int = 7, eps_m: int = 1,
                  eps_e: int = -32, center: bool = False):
    """Run a FUSED norm -> GEMM: x (M, K) f32 at its true width ``n``, the
    rounding bits drawn at the reference's lane-padded width (M, Kp) (or
    None), gm / beta_m (1, K) int32 -> (y (M, N), xq (M, K), meta (M,
    128), c (M, K))."""
    assert dec.path == FUSED
    k = x.shape[-1]
    if rand_in is not None:
        rand_in = rand_in[:, :k].contiguous()
        rand_out = rand_out[:, :k].contiguous()
    run = kfc.norm_gemm_plain if _plain_on_card else kfc.fused_norm_gemm
    return run(x.contiguous(), rand_in, rand_out, gm, se_g, beta_m, se_b,
               w_m.contiguous(), se_w, n=n, p=p, eps_m=eps_m, eps_e=eps_e,
               center=center)


def plan_epilogue(op: str, m: int, k: int, n: int, cfg: QuantConfig, *,
                  kind: str = "qq", cfg2: Optional[QuantConfig] = None,
                  act: Optional[str] = None, bias: bool = False,
                  out_q: bool = False, kernel_mode: str = "auto",
                  accum_chunk: int = 65536, device: str = "cpu",
                  vmem_budget: Optional[int] = None) -> Decision:
    """Choose the path for one GEMM + bias / activation (+ out-quantize)
    epilogue of kind qq, qi, ii or pp.  JNP keeps the per-op composition,
    which the chain equals bit for bit, so this plan moves cost only.
    ``vmem_budget``: also the reference's predicates (GLU halves on whole
    256-column tiles, some row strip of its b-resident kernel fits the
    budget)."""

    def decide(path, reason):
        return _record(Decision(op, path, reason, m, k, n, f"{kind}_epi",
                                device))

    _check_mode(kernel_mode)
    if kind not in ("qq", "qi", "ii", "pp"):
        raise ValueError(f"unknown epilogue kind {kind!r}")
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    if kernel_mode == "unfused":
        return decide(JNP, "chain ops have no unfused pipeline")
    bits = {cfg.bits} | ({cfg2.bits} if cfg2 is not None else set())
    if bits != {8}:
        return decide(JNP, f"bits={sorted(bits)} (kernels are int8-only)")
    if cfg.block != PER_TENSOR or (cfg2 is not None
                                   and cfg2.block != PER_TENSOR):
        return decide(JNP, "epilogue chains are per-tensor only")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the per-op composition on "
                           f"device={device}")
    if k > accum_chunk:
        return decide(JNP, f"K={k} > accum_chunk={accum_chunk} "
                           "(flush emulation stays on the plain path)")
    if k * 127 * 127 >= (1 << 31):
        return decide(JNP, f"K={k} overflows the int32 accumulator")
    glu = (act or "").endswith("_glu")
    if glu and n % 2:
        return decide(JNP, f"a GLU needs an even N, got {n}")
    budget = _budget(vmem_budget)
    if budget is not None:
        if glu and n % (2 * _LANE):
            return decide(JNP, "glu halves must be lane-aligned")
        kp, np_ = _round_up(k, _LANE), _round_up(n, _LANE)
        base = {"qq": "qq", "qi": "qi"}.get(kind, "ii")
        if not any(_epi_vmem_bytes(base, bm, kp, np_, n // 2 if glu else np_,
                                   cfg.stochastic, bias, act is not None,
                                   out_q) <= budget
                   for bm in _BM_CANDIDATES):
            return decide(JNP, f"no bm candidate fits vmem_budget={budget}")
    extra = "" if kind == "qq" and not out_q else f", {kind}, out_q={out_q}"
    return decide(FUSED, f"gemm_epi kernel (act={act}, bias={bias}{extra})")


def contract_epi(a, b, dec: Decision, *, cfg: Optional[QuantConfig] = None,
                 ka: Optional[prng.Key] = None, kb: Optional[prng.Key] = None,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None,
                 qcfg: Optional[QuantConfig] = None,
                 kq: Optional[prng.Key] = None):
    """Run a FUSED epilogue plan, operands by ``dec.kind`` (the reference's
    ``contract_epi``): ``qq_epi`` a (M, K), b (N, K) f32 quantized in the
    kernel under ``cfg`` with keys ``ka`` / ``kb``; ``qi_epi`` a f32 and b
    a :class:`BFP`; ``ii_epi`` / ``pp_epi`` both :class:`BFP`.  bias (1, N)
    or None; ``qcfg`` / ``kq`` (per tensor) switch on the out-quantize.
    Returns (out, aq, bq, ylin): out f32 (M, N or N/2), or a :class:`BFP`
    with ``qcfg``; aq / bq the operands quantized here (else None); ylin
    the pre-activation (None without an act)."""
    assert dec.path == FUSED
    kind = dec.kind.split("_")[0]
    out_q = qcfg is not None
    if kind in ("ii", "pp"):
        a_arr, ea, p = a.m, a.e.to(torch.int32), a.cfg.p
    else:
        a_arr, ea, p = a.contiguous(), ref.max_biased_exp_ref(a), cfg.p
    if kind == "qq":
        b_arr, eb = b.contiguous(), ref.max_biased_exp_ref(b)
    else:
        b_arr, eb = b.m, b.e.to(torch.int32)
        assert b.cfg.p == p, "the kernel takes one mantissa width"
    # one stochastic flag drives the in-op and the out-op quantize
    if cfg is not None and out_q:
        assert qcfg.stochastic == cfg.stochastic, (cfg, qcfg)
    sr = cfg.stochastic if cfg is not None else (out_q and qcfg.stochastic)
    m, n = a_arr.shape[-2], b_arr.shape[-2]
    n_out = n // 2 if (act or "").endswith("_glu") else n
    ra = (rounding_bits(ka, a_arr.shape, cfg.rng, a_arr.device)
          if kind in ("qq", "qi") and sr else None)
    rb = (rounding_bits(kb, b_arr.shape, cfg.rng, b_arr.device)
          if kind == "qq" and sr else None)
    rq = (rounding_bits(kq, (m, n_out), qcfg.rng, a_arr.device)
          if out_q and qcfg.stochastic else None)
    run = kfl.fused_gemm_epi_plain if _plain_on_card else kfl.fused_gemm_epi
    outs = iter(run(a_arr.contiguous(), ra, b_arr.contiguous(), rb,
                    None if bias is None else bias.contiguous(), rq, ea, eb,
                    kind="ii" if kind == "pp" else kind, p=p, stochastic=sr,
                    act=act, out_q=out_q, qp=qcfg.p if out_q else 7))
    y = next(outs)
    out = BFP(y, next(outs)[0, 0], qcfg) if out_q else y
    aq = BFP(next(outs), ea, cfg) if kind in ("qq", "qi") else None
    bq = BFP(next(outs), eb, cfg) if kind == "qq" else None
    ylin = next(outs) if act is not None else None
    return out, aq, bq, ylin


def plan_decode_block(op: str, b: int, d: int, n_ff: int, t: int, hq: int,
                      hkv: int, dh: int, cfg: QuantConfig, *,
                      kernel_mode: str = "auto", device: str = "cpu",
                      vmem_budget: Optional[int] = None) -> Decision:
    """Choose the path for one whole-layer decode block; JNP keeps the
    per-op decode path (whose norm numerics differ).  ``vmem_budget``:
    also the reference's residency predicate (the whole layer, its weights
    and cache band resident in the budget)."""

    def decide(path, reason):
        return _record(Decision(op, path, reason, b, d, n_ff,
                                "decode_block", device, t))

    _check_mode(kernel_mode)
    if kernel_mode == "jnp":
        return decide(JNP, "kernel_mode=jnp")
    if kernel_mode == "unfused":
        return decide(JNP, "chain ops have no unfused pipeline")
    if cfg.bits != 8:
        return decide(JNP, f"bits={cfg.bits} (kernels are int8-only)")
    if kernel_mode == "auto" and device != "cuda":
        return decide(JNP, f"auto keeps the per-op path on device={device}")
    budget = _budget(vmem_budget)
    if budget is not None and _decode_block_vmem_bytes(
            b, d, n_ff, t, hq, hkv, dh) > budget:
        return decide(JNP, f"no residency fits vmem_budget={budget}")
    why = kfc.decode_block_unsupported(b, d, n_ff, hq, hkv, dh, t)
    if why:
        return decide(JNP, f"decode_block kernel: {why}")
    return decide(FUSED, "decode_block kernel: the layer's widths, batch "
                         "and cache fit its limits")


def _aligned_to(t: torch.Tensor, align: int) -> torch.Tensor:
    """``t``, or a copy of it (the same values) where its address is off
    ``align`` bytes."""
    return t if t.data_ptr() % align == 0 else t.clone()


def run_decode_block(x, wqkv_m, se_qkv, wo_m, se_o, wgu_m, se_gu, wd_m, se_d,
                     g1m, g2m, km, ke, vm, ve, cossin, pos: int,
                     dec: Decision, **kw):
    """Run a FUSED decode block (arguments of ``fused_decode_block``):
    (x_out, k_new, ek_new, v_new, ev_new), the fresh rows for the caller
    to append.  An activation, cache or rope operand off the alignment the
    kernel's loads need is copied first."""
    assert dec.path == FUSED
    x = x.contiguous()
    if x.is_cuda and not _plain_on_card:
        x, vm, cossin = (_aligned_to(t, 16) for t in (x, vm, cossin))
        km, ke, ve = (_aligned_to(t, 4) for t in (km, ke, ve))
    run = kfc.decode_block_plain if _plain_on_card else kfc.fused_decode_block
    return run(x, wqkv_m, se_qkv, wo_m, se_o, wgu_m, se_gu, wd_m,
               se_d, g1m, g2m, km, ke, vm, ve, cossin, pos, **kw)
