#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU (one card).

    python3 chip_smoke.py

Phases, any of which failing exits non-zero:

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
2. call each kernel at the shapes the serving and training paths give it
   and hold it against its plain torch version on the same inputs: each
   variant of ``qq`` (``wgmma``, ``stream``, ``__dp4a``:
   ``fused_linear.qq_variant``) y and both mantissas ``==`` at every
   main-path shape of qwen2-0.5b, minicpm-2b and starcoder2-7b (the
   projections, the LM heads, the prefill attention) and odd ones, both
   roundings, with and without residuals; each variant of ``qi`` and
   ``ii`` (``fused_linear.qgemm_variant``) y and
   mantissas ``==`` at the main path's shapes, ragged, batched and odd-K
   ones, both roundings, and the ``iq`` and ``pp`` routes through
   dispatch; each call moving its variant's counter; ``attn_decode`` y ``==``
   at qwen2-0.5b's decode slice for bands of 160, 4096 and 32768 positions
   (each planned FUSED, on the cluster size ``decode_split`` names, its
   counter moved), ``attn_fwd`` (y, m, l) and ``attn_bwd`` (dq, dk, dv)
   ``==`` at the qwen2 training slice (each on the route
   ``attn_fwd_variant`` / ``attn_bwd_variant`` names) and at an odd shape, ``qq_blk`` y and
   mantissas ``==`` on each variant (``fused_linear.qq_blk_variant``: the
   128 x 128 and 64 x 64 tilings of the Hopper route, ``__dp4a``) at the
   per-block training shapes and odd ones (blocks of 128, 32 and 8, more
   than 32 blocks, a batch, K % 16 != 0, M <= 16, an unaligned view, both
   rounding modes, with and without residuals, a flushed block scale),
   each call moving its variant's counter; time kernel, plain version and
   one library call where there is one, and compute the card's bound for
   the same work;
3. serve full-width qwen2-0.5b (random weights from a seeded generator):
   4 prompts x 128 tokens, 32 greedy tokens, int8 weights quantized once
   and an int8 KV cache, with the launch counts set to 0 just before and
   read just after; then replay the same prompts and tokens with every
   kernel swapped for its plain version and compare: prefill and decode
   logits ``==``;
4. train full-width qwen2-0.5b: one int8 step (int8
   forward, A.2 integer backward, int16 SGD; batch 4 x 128 tokens of
   ``SyntheticLM(seed=0)``, random weights from ``torch.Generator(0)``)
   through ``launch.train``, the launch counts set to 0 just before and
   read just after; then replay the same steps from the same state with
   every kernel swapped for its plain version: the losses and every int16
   master and momentum leaf ``==``; the losses and a digest of every leaf
   are kept for phase 9.  Also the step's device busy share under
   ``torch.profiler`` and the peak device memory.  The phase runs under
   ``torch.use_deterministic_algorithms`` (warn-only: an op without a
   deterministic implementation is named in the record, not hidden);
5. the same for ``int8_qflow`` training (quantized activations between
   layers, attention through the fused ``attn_fwd`` / ``attn_bwd``
   kernels): ``TRAIN_STEPS_QFLOW`` (2) steps, the launch counts read
   around them, the plain
   replay ``==`` in losses and every master and momentum leaf;
6. the same for ``int8_block`` training (one exponent per 128 elements of
   each contraction axis): one step, every per-block contraction, forward
   and A.2 backward, on ``qq_blk`` and the per-tensor rest on ``qq``
   (``EXPECTED_PER_STEP`` launches, the ``qq_blk`` ones split between its
   two tilings as the shape rule names them; each shape's count
   recorded), no contraction planned on a plain path, the plain replay
   ``==``;
7. serve full-width minicpm-2b (all 40 layers, random weights): 4 prompts
   x 128 tokens, 32 greedy tokens, int8 weights and KV cache; every decode
   step runs each layer as one ``decode_block`` launch (1240 in all); the
   plain replay as in phase 3;
8. train full-width minicpm-2b cut to ``CHAIN_TRAIN_LAYERS`` (12) layers under
   ``PAPER_INT8`` with ``fused_proj``: the pre-attention norm and the
   merged QKV projection on ``norm_gemm``, gate|up and its SiLU-GLU on
   ``gemm_epi`` (``EXPECTED_PER_STEP`` launches), no chain planned on a
   plain path, the plain replay ``==`` in the loss and every master and
   momentum leaf;
9. train full-width qwen2-0.5b for one ``PAPER_INT8`` step under
   ``kernel_mode="unfused"`` through ``make_train_step`` (the unfused
   rung: each fresh operand quantized by ``bfp_quantize`` into int8 in
   device memory, each product on ``int8_matmul``), the launch counts set
   to 0 before and read after (``EXPECTED_PER_STEP``, no fused kernel, no
   plain-path decision but the LM head's dX); the plain replay ``==``; and
   the loss and every leaf ``==`` phase 4's step from the same state, key
   and batch on the fused kernels;
10. train full-width starcoder2-7b (LayerNorm, QKV bias, 36 query over 4
   KV heads of 128, GELU) cut to ``GELU_TRAIN_LAYERS`` layers under
   ``PAPER_INT8`` with ``fused_proj``: gate|up and its GELU-GLU on
   ``gemm_epi`` once a layer, the merged QKV projection on ``qq`` (no
   ``norm_gemm``), the LM head's dX on ``qi`` (``GELU_PER_STEP``
   launches, each the count of the step's FUSED plans), no chain planned
   on a plain path, the plain replay ``==``;
11. train full-width qwen2-0.5b (all 24 layers) for one ``int8_qweights``
   step through ``make_train_step`` from the trainer's initial state, keys
   and batch: the int8 forward weights narrowed from the int16 masters
   once a step (``derive_qweights``, its time inside the step recorded),
   every forward projection and the LM head on ``qi`` (no ``qmatmul_fwd``
   plan of kind ``qq``: no weight is quantized inside a GEMM), attention's
   products on ``qq`` (``QWEIGHTS_PER_STEP`` launches, each the count of
   the step's FUSED plans, every one on ``wgmma``), the plain replay
   ``==``;
12. the same for one ``int8_qfull`` step (qflow and qweights): the
   projections after a norm and the LM head contract two pre-quantized
   operands (kind ``pp``, on ``ii``), ``wo`` and ``w_down`` on ``qi``,
   attention on ``attn_fwd`` / ``attn_bwd``, no ``qmatmul_fwd`` plan of
   kind ``qq`` or ``iq``, no ``qq`` launch;
13. train ResNet-18 for CIFAR (``CNN_CFG``: widths 64-128-256-512, two
   basic blocks a stage, random weights from ``torch.Generator(0)``) for
   one ``int8`` step of 128 ``SyntheticVision(img=32, seed=0)`` images
   under ``kernel_mode="fused"``: every convolution an im2col ``qq``
   forward, ``qi`` dX and ``ii`` dW (``CNN_PER_STEP`` launches, each the
   count of the step's FUSED plans), the integer batch-norm in plain
   integer torch ops; the two ``__dp4a`` launches the variant rule names
   (``CNN_DP4A``: the stem's K 27, the head's dX K 10) and no other; the
   five dW plans over 131072 rows on the plain chunked path, each timed;
   the plain replay ``==``; one float32 step of the same net timed;
14. the same under ``int8_qflow``: each block's conv -> bn -> relu ->
   conv chain on BFP activations (kind ``iq`` forwards);
15. serve full-width qwen2-0.5b under qflow (``PAPER_INT8`` with qflow,
   qweights and qcache) through ``make_prefill_step`` /
   ``make_decode_step``: phase 3's prompts, keys and 32 greedy tokens; the
   projections after a norm and the tied LM head of kind ``pp`` (on
   ``ii``), ``wo`` and ``w_down`` on ``qi``, attention on ``attn_fwd`` in
   prefill and ``attn_decode`` in each decode step
   (``QFLOW_SERVE_LAUNCHES``); the plain replay as in phase 3.

Every stochastic-rounding word on the card is drawn by the
``rounding_bits`` kernel (``csrc/rounding_bits.cu``, threefry2x32 in both
key modes and the hash stream): phase 2 holds it ``==`` ``prng.bits`` /
``prng.hash_bits`` at ``BITS_SHAPES`` and times it at the LM head's
weight; each of phases 3-15 must launch it, and their plain replays draw
through ``prng.bits``, so each replay's ``==`` holds the kernel too.

Phase 2 also holds ``qq`` at ResNet-18's stem (timed on ``__dp4a``),
a stage-1 (timed), a stage-4 convolution and the head, ``qi`` at a stage-1
dX and the head's dX and ``ii`` at a stage-2 dW ``==``, and ``gemm_epi``
(y, mantissas, ylin), ``norm_gemm`` (y,
xq, meta, c) and ``decode_block`` (x_out and the fresh cache rows, at
positions 159 and 0, with a window, for one stream) ``==`` at the shapes
of phases 7, 8 and 10 (the SiLU- and GELU-GLU) and at odd ones (relu,
gelu, an odd GLU half), and ``bfp_quantize``
(mantissas) and ``int8_matmul`` (y; ``wgmma``, ``stream`` and wmma:
``int8_matmul.int8_matmul_variant``) ``==`` at the shapes of phase 9 and
at odd ones (edge values, a batch, unaligned operands, a flushed scale),
each call moving its variant's counter.

After each of phases 3-15 every ``qq``, ``qi`` and ``ii`` launch must be
one of the ``wgmma`` or ``stream`` variant (none on ``__dp4a`` but
phases 13-14's ``CNN_DP4A``), every
``qq_blk`` launch one of ``wgmma`` or ``wgmma64``, every ``int8_matmul``
launch one of ``wgmma``, every ``attn_decode`` launch on the cluster size
``decode_split`` names for the decode slice and every ``attn_fwd`` and
``attn_bwd`` launch on ``wgmma``: the variants the shape rules name for the main path's
shapes; the counts by variant are printed.  Each step
profile also sums the device time of the port's own kernels by name.

Kernel, plain and library times are device times from ``torch.profiler``
(the sum of the CUDA kernels each call launches, per call); the wrapper's
whole call, host included, is timed with CUDA events as ``call_ms``.

It prints one JSON line of kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  A fuller
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks: HBM bytes/s, dense int8 op/s; and the issue
# rate of 32-bit integer instructions: 4 warp schedulers an SM, each one
# 32-lane instruction a cycle (the Hopper white paper), x 132 SMs x the
# 1980 MHz boost clock.  Integer adds, shifts and logic issue to the
# INT32 and the FMA pipes both, so the 64 INT32 lanes an SM are not the
# limit (the rounding-bit kernel ran 21.9 T int32 op/s).
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
INT32_OPS_PER_S = 4 * 32 * 132 * 1.98e9

ARCH, BATCH, PROMPT, GEN, SEED = "qwen2_0_5b", 4, 128, 32, 0
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 1, 4, 128, 0.05
# Phase 5 (int8_qflow) steps: its replay is the card's only check of the
# attention kernels once momentum is non-zero and the masters have moved,
# which the second step already is (cut from 3 to 2 when phases 13-14
# brought the script to 965 s of its 1200 s; PERF.md).  The other
# training phases take TRAIN_STEPS (phase 4 was cut from 3 to 1 when
# phase 5 pushed the script past 900 s; PERF.md).
TRAIN_STEPS_QFLOW = 2
# Kernels each training phase must launch.
TRAIN_KERNELS = {"int8": ("qq", "qi", "ii"),
                 "int8_qflow": ("qq", "qi", "ii", "attn_fwd", "attn_bwd"),
                 "int8_block": ("qq", "qq_blk"),
                 "int8_qweights": ("qq", "qi", "ii"),
                 "int8_qfull": ("qi", "ii", "attn_fwd", "attn_bwd")}
# Launches per int8_block step (qwen2-0.5b, 4 x 128 tokens): 25 per-block
# contractions a layer (7 projections x forward, dX, dW; QKᵀ's dA and dB;
# PV's forward and dB) and 3 of the tied LM head; QKᵀ's forward and PV's
# dA contract the head dim 64, per tensor.
# Of those, qq_blk_variant puts on the 128 x 128 tiles the gate and up
# forwards, w_down's dX, the gate, up and w_down dW (6 a layer) and the LM
# head's forward and dW; on the 64 x 64 tiles the 19 others a layer (fewer
# than 132 tiles of 128 x 128) and the LM head's dX (N 896).
EXPECTED_PER_STEP = {"int8_block": {"qq_blk": 24 * 25 + 3, "qq": 24 * 2,
                                    "qi": 0, "ii": 0,
                                    "qq_blk_wgmma": 24 * 6 + 2,
                                    "qq_blk_wgmma64": 24 * 19 + 1,
                                    "qq_blk_dp4a": 0},
                     # phase 9: per layer 9 contractions (7 projections,
                     # QKᵀ, PV) a direction, qq forward (2 quantizes), qi
                     # dX (1), ii dW (0); the LM head's forward and dW, its
                     # dX (K = vocab > accum_chunk) on the plain path; every
                     # int8_matmul on its wgmma variant (M > 16, K % 16 == 0)
                     "train_unfused": {"bfp_quantize": 24 * 27 + 2,
                                       "int8_matmul": 24 * 27 + 2,
                                       "int8_matmul_wgmma": 24 * 27 + 2}}
# Phases 7 and 8: minicpm-2b.  Training keeps full width and cuts the
# depth from 40 to 12 layers (PERF.md §4: the int64 rounding-bit
# temporaries grow with the stacked layer leaves; 24 layers fit the card's
# 80 GB, 40 would not; 12 leave the script's time limit room for phases 11
# and 12, and phase 8 was its longest phase).
CHAIN_ARCH, CHAIN_TRAIN_LAYERS = "minicpm_2b", 12
# Launches per fused_proj step: per layer norm_gemm and gemm_epi one each;
# qq for QK^T, PV, wo and w_down; qi for the dX of the QKV chain, QK^T,
# PV, wo, the gate|up chain and w_down, ii for their dW; the tied LM head
# one qq and one ii (its dX contracts the vocabulary, 122753 > accum_chunk:
# the plain chunked path, as in the reference).
CHAIN_PER_STEP = {"norm_gemm": CHAIN_TRAIN_LAYERS,
                  "gemm_epi": CHAIN_TRAIN_LAYERS,
                  "qq": 4 * CHAIN_TRAIN_LAYERS + 1,
                  "qi": 6 * CHAIN_TRAIN_LAYERS,
                  "ii": 6 * CHAIN_TRAIN_LAYERS + 1}
# Phase 10: starcoder2-7b under fused_proj, full width, the depth cut from
# 32 to 4 layers (PERF.md §4: its gate|up leaves, 84.9M elements a layer,
# stack to about the largest leaf minicpm-2b's 24 layers hold).  Per layer
# gemm_epi with the GELU-GLU once; the QKV bias keeps the merged QKV
# projection a qmatmul (no norm_gemm), so qq for QKV, QK^T, PV, wo and
# w_down; qi and ii as in phase 8; the tied LM head one qq, one ii and one
# qi (its dX contracts the vocabulary, 49152 <= accum_chunk: the kernel).
GELU_ARCH, GELU_TRAIN_LAYERS = "starcoder2_7b", 4
GELU_PER_STEP = {"norm_gemm": 0, "gemm_epi": GELU_TRAIN_LAYERS,
                 "qq": 5 * GELU_TRAIN_LAYERS + 1,
                 "qi": 6 * GELU_TRAIN_LAYERS + 1,
                 "ii": 6 * GELU_TRAIN_LAYERS + 1}
# Phases 11 and 12: qwen2-0.5b, all 24 layers, one step each.  qweights:
# per layer 7 projection forwards on qi (a float x against a BFP weight),
# QKᵀ and PV on qq, 7 projection dX and attention's 2 dA on qi, 7 dW and
# attention's 2 dB on ii; the tied LM head's forward on qi, its dW on ii,
# its dX (K = vocab > accum_chunk) on the plain chunked path.  qfull: the
# 5 projections after a norm and the LM head's forward are kind pp (the ii
# kernel), wo and w_down qi; attention one attn_fwd and one attn_bwd a
# layer; 7 dX a layer on qi, 7 dW and the LM head's on ii.
QW_LAYERS = 24
QWEIGHTS_PER_STEP = {
    "int8_qweights": {"qq": 2 * QW_LAYERS, "qi": 16 * QW_LAYERS + 1,
                      "ii": 9 * QW_LAYERS + 1, "attn_fwd": 0, "attn_bwd": 0},
    "int8_qfull": {"qq": 0, "qi": 9 * QW_LAYERS, "ii": 12 * QW_LAYERS + 2,
                   "attn_fwd": QW_LAYERS, "attn_bwd": QW_LAYERS}}
# Phases 7 and 8 also run at the reference's chain plans (its 12 MiB VMEM
# budget keeps the per-op seams at full width): phase 7 for the prefill
# and this many decode steps, phase 8 for its one step.
SEAM_DECODE_STEPS = 4
# Phase 15: qwen2-0.5b served under qflow, by the number of layers L: the
# prefill and each of the GEN - 1 decode steps contract the 5 projections
# after a norm and the tied LM head as kind pp (the ii kernel), wo and
# w_down as qi; attention on attn_fwd in prefill and attn_decode in each
# decode step, one a layer; nothing on qq.
QFLOW_SERVE_LAUNCHES = {"ii": lambda L: (5 * L + 1) * GEN,
                        "qi": lambda L: 2 * L * GEN,
                        "qq": lambda L: 0,
                        "attn_fwd": lambda L: L,
                        "attn_decode": lambda L: L * (GEN - 1),
                        "attn_bwd": lambda L: 0}
# Phases 13 and 14: ResNet-18 for CIFAR (He et al. 2015, Table 1 widths
# 64-128-256-512, two basic blocks a stage, the 3 x 3 stem, no max-pool;
# the model of the survey's Table 1) at full width and depth, one step of
# 128 SyntheticVision(img=32, seed=0) images, the JAX example's lr 0.02
# and momentum 0.9.
CNN_CFG = dict(n_classes=10, width=64, n_blocks=2, n_stages=4,
               in_channels=3, img=32)
CNN_BATCH, CNN_LR = 128, 0.02
# Launches per step: 20 convolutions (the stem, 16 in the blocks, 3 1 x 1
# projections) and the head.  int8: every forward on qq; every dX on qi but
# the stem's (its input is the data: no dX); every dW on ii but the five
# over 128 x 32 x 32 = 131072 rows (the stem and stage 1's four), which
# exceed accum_chunk and take the plain chunked path.  qflow: block 0's
# conv1 and every conv2 contract a BFP input (kind iq, on qi), the other
# forwards are qq.
CNN_PER_STEP = {"int8": {"qq": 21, "qi": 20, "ii": 16},
                "int8_qflow": {"qq": 12, "qi": 29, "ii": 16}}
# The two contractions per step the variant rule sends to the __dp4a
# kernel, by (op, M, K, N, kind): the stem's forward contracts K = 3*3*3 =
# 27 and the head's dX the 10 classes; TMA reads rows of 16-byte multiples,
# so neither K % 16 != 0 runs on the tensor cores.
CNN_DP4A = {("qmatmul_fwd", CNN_BATCH * 32 * 32, 27, 64, "qq"): 1,
            ("qmatmul_dx", CNN_BATCH, 10, 512, "qi"): 1}


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _device_ms(torch, fn, iters: int = 10, split=None) -> float:
    """Device time per call: every CUDA kernel the call launches, summed,
    from torch.profiler; ``split`` (a dict), when given, gets each
    kernel's share by ``_kernel_name``.  A profile that holds no device
    event at all is taken again, up to three times (a CUPTI trace of a few
    short launches has come back empty once); raises if every one does."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        total_us = sum(us for _, us in events)
        if total_us > 0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    if split is not None:
        for name, us in events:
            key = _kernel_name(name)
            split[key] = split.get(key, 0.0) + us / iters / 1e3
    return total_us / iters / 1e3


def _is_port_kernel(name: str) -> bool:
    """The port's kernels live in an anonymous namespace, torch's under
    at::native."""
    return "(anonymous namespace)::" in name and "at::native" not in name


def _kernel_name(name: str) -> str:
    """A device event's function name: the port's kernels without
    namespace, template arguments and parameters; torch's and the rest cut
    to 80 characters."""
    if _is_port_kernel(name):
        return name.split("(anonymous namespace)::", 1)[1].split("(")[0] \
            .split("<")[0]
    return name[:80]


def _device_events(prof):
    """(name, µs) of every event of a finished torch.profiler run that ran
    on the card (a kernel, memcpy or memset), read from the raw trace:
    turning a training step's half a million launches into the profiler's
    per-op event objects (``key_averages``) took 80-150 s a step."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _int_mm_ms(torch, am, bm):
    """One torch._int_mm per slice on the same int8 operands (a yardstick
    the port never calls); rows padded to 32 where _int_mm needs M > 16."""
    m = am.shape[-2]
    if m <= 16:
        am = torch.nn.functional.pad(am, (0, 0, 0, 32 - m))
    pairs = [(am[i], bm[i].t()) for i in range(am.shape[0])]
    try:
        return _device_ms(torch, lambda: [torch._int_mm(a, b) for a, b in pairs])
    except RuntimeError as err:       # the yardstick only; not the port
        print(f"library call unavailable: {err}", file=sys.stderr)
        return None


def check_kernels(torch, dev, rec):
    from repro_torch.core import prng
    from repro_torch.kernels import fused_attention as kfa
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    g = torch.Generator(device=dev).manual_seed(1234)
    out = []

    def bits(k, shape):
        return prng.bits(prng.key(k), shape, dev)

    out += check_qgemm(torch, dev, g, bits)

    out += check_qq(torch, dev, g, bits)

    tokens = TRAIN_BATCH * TRAIN_SEQ

    # The LM head's dX contracts over the vocabulary (K = 151936 >
    # accum_chunk): no kernel takes it; it stays on the plain chunked path
    # of core.qops (the JAX package's own jnp path), timed here.
    from repro_torch.core.bfp import BFP, QuantConfig
    from repro_torch.core.qops import _contract_q
    gq = BFP(torch.randint(-127, 128, (tokens, 151936), generator=g, device=dev,
                           dtype=torch.int8), torch.tensor(110, device=dev), QuantConfig())
    wq = BFP(torch.randint(-127, 128, (151936, 896), generator=g, device=dev,
                           dtype=torch.int8).t(), torch.tensor(120, device=dev), QuantConfig())
    rec["lm_head_dx_plain"] = dict(
        shape=[tokens, 151936, 896],
        ms=_device_ms(torch, lambda: _contract_q(gq, wq, 0, 65536), iters=3),
        call_ms=_time_ms(torch, lambda: _contract_q(gq, wq, 0, 65536), iters=3, warmup=1))
    print(f"LM-head dX on the plain chunked path: "
          f"{rec['lm_head_dx_plain']['ms']:.3f} ms device time")
    del gq, wq

    out += check_decode(torch, dev, g, bits)
    out += check_attn_train(torch, dev, g, bits)
    out += check_qq_blk(torch, dev, g, bits)
    out += check_chain(torch, dev, g, bits)
    out += check_unfused(torch, dev, g, bits)
    out += check_rounding_bits(torch, dev)
    return out


# The rounding-bit kernel's shapes: a scalar, one word, an odd count, a
# word either side of prng's 2^24-word chunk, and the LM head's weight,
# the largest draw of a qwen2 step (timed).
BITS_SHAPES = [(), (1,), (7,), ((1 << 24) - 1,), ((1 << 24) + 3,),
               (151936, 896)]
# Integer operations a word: threefry2x32 is 2 + 5 * (4 * 3 + 2) = 72 (two
# words a hash) plus the XOR of its halves (partitionable: one hash a
# word); the hash stream's avalanche 10.
BITS_OPS = {"partitionable": 73, "iota_halves": 36, "hash": 10}


def check_rounding_bits(torch, dev):
    """The rounding-bit kernel against ``prng.bits`` in both key modes and
    ``prng.hash_bits`` at ``BITS_SHAPES``, one launch a draw; timed at the
    LM head's weight in each stream beside the plain draw on the card."""
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import rounding_bits as krb

    src = "src/repro_torch/kernels/csrc/rounding_bits.cu"
    replaces = "src/repro/core/bfp.py:289 (jax.random.bits; no Pallas kernel)"
    out = []
    for stream in krb.MODES:
        key = prng.fold_in(prng.key(11, partitionable=stream != "iota_halves"),
                           5)
        rng = "hash" if stream == "hash" else "threefry"
        for shape in BITS_SHAPES:
            before = dispatch.kernel_launches()["rounding_bits"]
            got = krb.rounding_bits(key, shape, rng, dev)
            if dispatch.kernel_launches()["rounding_bits"] != before + 1:
                raise AssertionError(f"rounding_bits {stream} {shape}: the "
                                     "launch was not counted once")
            want = krb.rounding_bits_plain(key, shape, rng, dev)
            if got.dtype != torch.int64 or not torch.equal(got, want):
                raise AssertionError(f"rounding_bits {stream} {shape} != "
                                     f"plain")
            del got, want
        n = 151936 * 896
        name = "rounding_bits" if stream == "partitionable" \
            else f"rounding_bits_{stream}"
        out.append(_record_kernel(
            torch, name, src, replaces, [151936, 896], 0,
            lambda: krb.rounding_bits(key, (151936, 896), rng, dev),
            lambda: krb.rounding_bits_plain(key, (151936, 896), rng, dev),
            8 * n, BITS_OPS[stream] * n, None,
            note="no PyTorch call draws threefry2x32 or this hash stream",
            plain_iters=2, ops_per_s=INT32_OPS_PER_S) | {"stream": stream})
        torch.cuda.empty_cache()
    print(f"rounding_bits == prng.bits / hash_bits at {BITS_SHAPES}, "
          f"streams {krb.MODES}")
    return out


# attn_decode timed at qwen2-0.5b's decode slice (B*Hkv = 8, GS = 7, D =
# 64): the serve phase's band (PROMPT + GEN), 4096 positions and the
# model's published 32768-token context.
DECODE_TIMED = [("attn_decode", PROMPT + GEN), ("attn_decode_t4096", 4096),
                ("attn_decode_t32768", 32768)]


def check_decode(torch, dev, g, bits):
    """attn_decode against its plain version at ``DECODE_TIMED``: each band
    planned FUSED by the planner, the kernel's shared memory per block the
    planner's, y ``==``, the call on the cluster size ``decode_split``
    names (its counter); timed beside its bytes bound."""
    from repro_torch.core.bfp import QuantConfig
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_attention as kfa
    from repro_torch.kernels import fused_linear as kfl

    out = []
    bh, gs, d = BATCH * 2, 7, 64
    for name, t in DECODE_TIMED:
        plan = dispatch.plan_attention("attn_decode", gs, t, d, QuantConfig(),
                                       s=1, kind="qi", device="cuda")
        if plan.path != dispatch.FUSED:
            raise AssertionError(f"{name}: planned {plan.path} ({plan.reason})")
        n = kfa.decode_split(gs, t, d)
        smem = kfa._lib().repro_attn_decode_smem(gs, t, d, n)
        if smem != kfa.decode_smem_bytes(gs, t, d):
            raise AssertionError(f"{name}: the kernel's layout takes {smem} B, "
                                 f"the planner's {kfa.decode_smem_bytes(gs, t, d)}")
        pos = t - 1
        qm = torch.randint(-127, 128, (bh, gs, d), generator=g, device=dev, dtype=torch.int8)
        km = torch.randint(-127, 128, (bh, t, d), generator=g, device=dev, dtype=torch.int8)
        vm = torch.randint(-127, 128, (bh, t, d), generator=g, device=dev, dtype=torch.int8)
        ek = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev, dtype=torch.int32)
        ev = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev, dtype=torch.int32)
        rp = bits(4, (bh, gs, t))
        eq = torch.tensor(122, dtype=torch.int32, device=dev)
        kw = dict(p=7, s=1, causal=True, window=0, stochastic=True)
        dispatch.reset_kernel_launches()
        y = kfa.attn_decode(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
        yp = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        if not torch.equal(y, yp):
            raise AssertionError(f"{name}: kernel != plain (max |dy| {err})")
        if dispatch.kernel_launches()[f"attn_decode_n{n}"] != 1:
            raise AssertionError(f"{name}: not on its {n}-block cluster")
        rp32 = kfl.as_u32(rp)
        nbytes = bh * (gs * d + 2 * t * d + 8 * t + 4 * gs * t + 4 * gs * d) + 4
        row = _record_kernel(
            torch, name, "src/repro_torch/kernels/csrc/fused_attention.cu",
            "src/repro/kernels/fused_attention.py:503", [bh, gs, t, d], err,
            lambda: kfa.attn_decode(qm, km, vm, ek, ev, rp32, eq, pos, t, **kw),
            lambda: kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw),
            nbytes, 2.0 * 2 * bh * gs * t * d, None,
            note="no single PyTorch call computes int8 scores, softmax, the "
                 "per-row p quantize and int8 PV", plain_iters=2)
        print(f"{name}: T={t} on {n}-block clusters, {smem} B of shared "
              f"memory a block ({plan.reason})")
        out.append(dict(row, variant=f"n{n}", split=n, smem=smem,
                        plan=plan.reason,
                        line_as=[f"attn_decode_n{n}"] if name == "attn_decode"
                        else []))
        del qm, km, vm, ek, ev, rp, rp32, y, yp
        torch.cuda.empty_cache()
    return out


# qi / ii shapes held == in phase 2 beyond the four timed ones: ragged M
# (17, 130) and N (70; 151936 at M = 4 is timed), a batch, K that is not a
# multiple of 16 (the __dp4a variant), N % 4 != 0 on the tensor cores
# (y's rows not 16-byte aligned: 4-byte stores), and ResNet-18's shapes.
# (kind, B, M, K, N)
QGEMM_EDGE = [("qi", 1, 17, 896, 4864), ("qi", 1, 130, 896, 896),
              ("qi", 1, 4, 896, 70), ("qi", 1, 130, 96, 70),
              ("qi", 2, 130, 96, 72), ("qi", 3, 4, 128, 200),
              ("qi", 1, 37, 67, 29), ("qi", 1, 4, 37, 100),
              ("ii", 1, 17, 512, 4864), ("ii", 2, 130, 96, 70),
              ("ii", 2, 4, 512, 70), ("ii", 1, 37, 67, 29),
              ("ii", 3, 5, 33, 17),
              # ResNet-18 (phases 13, 14): a stage-1 convolution's dX, the
              # head's dX (K 10: __dp4a), a stage-2 3 x 3 convolution's dW
              ("qi", 1, CNN_BATCH * 32 * 32, 64, 576),
              ("qi", 1, CNN_BATCH, 10, 512),
              ("ii", 1, 128 * 9, CNN_BATCH * 16 * 16, 128)]


def check_qgemm(torch, dev, g, bits):
    """The qi and ii kernels' variants (``fused_linear.qgemm_variant``)
    against their plain versions, y and mantissas ``==``, both roundings:
    at the four timed shapes of the main path (the decode LM head and the
    prefill gate on qi, the LM head's and ``w_down``'s training dW on ii),
    at ``QGEMM_EDGE``, and through the ``iq`` and ``pp`` routes of
    ``dispatch.contract_iq`` / ``contract_ii``.  Each call must move the
    counter of the variant the rule names.  Returns the timed rows; each
    row's ``line_as`` names the variant it stands for on the kernels
    line."""
    from repro_torch.core import prng
    from repro_torch.core.bfp import BFP, QuantConfig
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def expect(kind, m, k, fn):
        want = kfl.qgemm_variant(m, k)
        return _expect_variant(torch, kind, kfl.QGEMM_VARIANTS, want,
                               f"M={m} K={k}", fn), want

    def qi_case(nb, m, k, n, stochastic):
        a = torch.randn((nb, m, k), generator=g, device=dev)
        ra = bits(5, a.shape) if stochastic else None
        b_m = i8(nb, n, k)
        ea = ref.max_biased_exp_ref(a)
        eb = torch.tensor(130, dtype=torch.int32, device=dev)
        (y, am), variant = expect("qi", m, k, lambda: kfl.fused_qi_pt(
            a, ra, b_m, ea, eb, stochastic=stochastic))
        yp, amp = kfl.fused_qi_pt_plain(a, ra, b_m, ea, eb,
                                        stochastic=stochastic)
        err = (y - yp).abs().max().item() if y.numel() else 0.0
        if not (torch.equal(y, yp) and torch.equal(am, amp)):
            raise AssertionError(f"qi {variant} {(nb, m, k, n)} "
                                 f"stochastic={stochastic}: kernel != plain "
                                 f"(max |dy| {err})")
        return (a, ra, b_m, ea, eb, am), variant, err

    def ii_case(nb, m, k, n):
        am, b_m = i8(nb, m, k), i8(nb, n, k)
        ea = torch.tensor(121, dtype=torch.int32, device=dev)
        eb = torch.tensor(117, dtype=torch.int32, device=dev)
        y, variant = expect("ii", m, k, lambda: kfl.fused_ii_pt(am, b_m, ea, eb))
        yp = kfl.fused_ii_pt_plain(am, b_m, ea, eb)
        err = (y - yp).abs().max().item() if y.numel() else 0.0
        if not torch.equal(y, yp):
            raise AssertionError(f"ii {variant} {(nb, m, k, n)}: kernel != "
                                 f"plain (max |dy| {err})")
        return (am, b_m, ea, eb), variant, err

    out, held = [], []
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # the timed shapes: (row name, kind, B, M, K, N, names on the line)
    timed = [("qi", "qi", 1, BATCH, 896, 151936, ("qi_stream",)),
             ("qi_prefill_gate", "qi", 1, BATCH * PROMPT, 896, 4864,
              ("qi_wgmma",)),
             ("ii", "ii", 1, 896, tokens, 151936, ("ii_wgmma",)),
             ("ii_w_down", "ii", 1, 4864, tokens, 896, ()),
             ("ii_decode_shape", "ii", 1, BATCH, tokens, 896, ("ii_stream",)),
             ("qi_odd_k", "qi", 1, 130, 67, 70, ("qi_dp4a",)),
             ("ii_odd_k", "ii", 1, 130, 67, 70, ("ii_dp4a",))]
    for name, kind, nb, m, k, n, line_as in timed:
        if kind == "qi":
            qi_case(nb, m, k, n, False)
            (a, ra, b_m, ea, eb, am), variant, err = qi_case(nb, m, k, n, True)
            ra32 = kfl.as_u32(ra)
            kernel = (lambda a=a, ra32=ra32, b_m=b_m, ea=ea, eb=eb:
                      kfl.fused_qi_pt(a, ra32, b_m, ea, eb))
            plain = (lambda a=a, ra=ra, b_m=b_m, ea=ea, eb=eb:
                     kfl.fused_qi_pt_plain(a, ra, b_m, ea, eb))
            lib = _int_mm_ms(torch, am, b_m)
            nbytes = nb * (8 * m * k + n * k + 4 * m * n + m * k)
            replaces = "src/repro/kernels/fused_linear.py:241"
        else:
            (am, b_m, ea, eb), variant, err = ii_case(nb, m, k, n)
            kernel = (lambda am=am, b_m=b_m, ea=ea, eb=eb:
                      kfl.fused_ii_pt(am, b_m, ea, eb))
            plain = (lambda am=am, b_m=b_m, ea=ea, eb=eb:
                     kfl.fused_ii_pt_plain(am, b_m, ea, eb))
            lib = _int_mm_ms(torch, am, b_m)
            nbytes = nb * (m * k + n * k + 4 * m * n)
            replaces = "src/repro/kernels/fused_linear.py:279"
        source = ("src/repro_torch/kernels/csrc/fused_linear.cu"
                  if variant == "dp4a"
                  else "src/repro_torch/kernels/csrc/qgemm_sm90.cu")
        row = _record_kernel(torch, name, source, replaces, [nb, m, k, n],
                             err, kernel, plain, nbytes, 2.0 * nb * m * n * k,
                             lib, plain_iters=2)
        out.append(dict(row, variant=variant, line_as=list(line_as)))
        held.append(f"{name} {variant}")
        torch.cuda.empty_cache()
    for kind, nb, m, k, n in QGEMM_EDGE:
        if kind == "qi":
            for sr in (True, False):
                variant = qi_case(nb, m, k, n, sr)[1]
        else:
            variant = ii_case(nb, m, k, n)[1]
        held.append(f"{kind} {(nb, m, k, n)} {variant}")

    # the iq route (qi with the roles swapped: b quantized in the kernel)
    # and pp (ii) through dispatch, against the same calls on the plain
    # versions: (a rows, b rows, K) with b's rows the kernel's M
    cfg = QuantConfig()
    for m, n, k in ((512, 4864, 896), (151936, BATCH, 896), (130, 70, 96)):
        aq = BFP(i8(m, k), torch.tensor(119, dtype=torch.int32, device=dev),
                 cfg)
        b = torch.randn((n, k), generator=g, device=dev)
        for sr in (True, False):
            c = QuantConfig(stochastic=sr)
            dec = dispatch.Decision("iq_check", dispatch.FUSED, "phase 2",
                                    m, k, n, "iq", "cuda")
            key = prng.key(7)
            (y, bq), variant = expect("qi", n, k, lambda: dispatch.contract_iq(
                aq, b, c, key, dec))
            with dispatch.plain_kernels():
                yp, bqp = dispatch.contract_iq(aq, b, c, key, dec)
            if not (torch.equal(y, yp) and torch.equal(bq.m, bqp.m)
                    and torch.equal(bq.e, bqp.e)):
                raise AssertionError(f"iq {variant} {(m, k, n)} "
                                     f"stochastic={sr}: kernel != plain")
            held.append(f"iq {(m, k, n)} {variant}")
    for m, n, k in ((4864, 896, tokens), (BATCH, 896, tokens), (130, 70, 96)):
        aq = BFP(i8(m, k), torch.tensor(119, dtype=torch.int32, device=dev),
                 cfg)
        bq = BFP(i8(n, k), torch.tensor(123, dtype=torch.int32, device=dev),
                 cfg)
        dec = dispatch.Decision("pp_check", dispatch.FUSED, "phase 2", m, k,
                                n, "pp", "cuda")
        y, variant = expect("ii", m, k, lambda: dispatch.contract_ii(aq, bq,
                                                                     dec))
        with dispatch.plain_kernels():
            yp = dispatch.contract_ii(aq, bq, dec)
        if not torch.equal(y, yp):
            raise AssertionError(f"pp {variant} {(m, k, n)}: kernel != plain")
        held.append(f"pp {(m, k, n)} {variant}")
    torch.cuda.empty_cache()
    print(f"qi / ii variants == plain ({len(held)} cases): {held}")
    return out


def _expect_variant(torch, kind, variants, want, what, fn):
    """``fn()`` with the launch counts set to 0 just before: of the
    variant counters of ``kind`` it must move ``want``'s alone, by one."""
    from repro_torch.kernels import dispatch
    dispatch.reset_kernel_launches()
    res = fn()
    torch.cuda.synchronize()
    counts = dispatch.kernel_launches()
    got = {v: counts[f"{kind}_{v}"] for v in variants
           if counts[f"{kind}_{v}"]}
    if got != {want: 1}:
        raise AssertionError(f"{kind} {what}: variant launches {got}, "
                             f"expected {want}")
    return res


# qq shapes of the main path, (B, M, K, N): qwen2's prefill attention
# (QKᵀ and PV of B*Hkv slices), its projections (wq, wk / wv, gate / up,
# w_down) and tied LM head; minicpm-2b's (phase 8) wq, w_down and LM head
# (N % 4 != 0); starcoder2-7b's (phase 10) merged QKV, w_down and LM head;
# ResNet-18's (phases 13 and 14) stem (K 27: __dp4a), a stage-1 and a
# stage-4 3 x 3 convolution and the 10-class head; then odd ones: M <= 16
# (stream), K % 16 != 0 (__dp4a), a batch with ragged M and N.  The timed rows name themselves; the row named "qq"
# stands on the kernels line for the kernel and for its wgmma variant.
QQ_SHAPES = {"qq_attn": (BATCH * 2, 7 * PROMPT, 64, PROMPT),
             "attn_pv": (BATCH * 2, 7 * PROMPT, PROMPT, 64),
             "wq": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 896),
             "wk": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 128),
             "qq": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 4864),
             "qq_w_down": (1, TRAIN_BATCH * TRAIN_SEQ, 4864, 896),
             "qq_lm_head": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 151936),
             "minicpm_wq": (1, TRAIN_BATCH * TRAIN_SEQ, 2304, 2304),
             "minicpm_w_down": (1, TRAIN_BATCH * TRAIN_SEQ, 5760, 2304),
             "minicpm_lm_head": (1, TRAIN_BATCH * TRAIN_SEQ, 2304, 122753),
             "starcoder2_qkv": (1, TRAIN_BATCH * TRAIN_SEQ, 4608, 5632),
             "starcoder2_w_down": (1, TRAIN_BATCH * TRAIN_SEQ, 18432, 4608),
             "starcoder2_lm_head": (1, TRAIN_BATCH * TRAIN_SEQ, 4608, 49152),
             "cnn_stem": (1, CNN_BATCH * 32 * 32, 27, 64),
             "cnn_stage1": (1, CNN_BATCH * 32 * 32, 576, 64),
             "cnn_stage4": (1, CNN_BATCH * 4 * 4, 4608, 512),
             "cnn_head": (1, CNN_BATCH, 512, 10),
             "qq_stream": (1, BATCH, 896, 1000),
             "qq_dp4a": (1, 130, 67, 70),
             "odd_batch": (2, 130, 96, 70)}
QQ_TIMED = ("qq_attn", "qq", "qq_w_down", "qq_lm_head", "qq_stream",
            "qq_dp4a", "cnn_stem", "cnn_stage1")


def check_qq(torch, dev, g, bits):
    """qq against its plain version at ``QQ_SHAPES``: y and both mantissas
    ``==``, stochastic and half up, with residuals and without (y alone),
    each call moving the counter of the variant ``qq_variant`` names;
    timed at ``QQ_TIMED`` beside ``torch._int_mm`` of the same mantissas
    and the bytes bound (f32 values and bits of both operands in, y and
    both mantissas out)."""
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    out, held = [], []
    for name, (nb, m, k, n) in QQ_SHAPES.items():
        a = torch.randn((nb, m, k), generator=g, device=dev)
        b = torch.randn((nb, n, k), generator=g, device=dev)
        ra, rb = bits(2, a.shape), bits(3, b.shape)
        ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
        variant = kfl.qq_variant(m, k)
        err = 0.0
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(stochastic=sr)
            res = _expect_variant(torch, "qq", kfl.QGEMM_VARIANTS, variant,
                                  str((nb, m, k, n)), lambda: kfl.fused_qq_pt(
                                      a, r[0], b, r[1], ea, eb, **kw))
            y_only = _expect_variant(
                torch, "qq", kfl.QGEMM_VARIANTS, variant, str((nb, m, k, n)),
                lambda: kfl.fused_qq_pt(a, r[0], b, r[1], ea, eb,
                                        emit_residuals=False, **kw))
            want = kfl.fused_qq_pt_plain(a, r[0], b, r[1], ea, eb, **kw)
            torch.cuda.synchronize()
            err = max(err, (res[0] - want[0]).abs().max().item())
            if not (all(torch.equal(x, y) for x, y in zip(res, want))
                    and torch.equal(y_only[0], want[0])
                    and y_only[1:] == (None, None)):
                raise AssertionError(f"qq {name} {variant} stochastic={sr}: "
                                     f"kernel != plain (max |dy| {err})")
        held.append(f"{name} {variant}")
        if name in QQ_TIMED:
            ra32, rb32 = kfl.as_u32(ra), kfl.as_u32(rb)
            src = ("src/repro_torch/kernels/csrc/fused_linear.cu"
                   if variant == "dp4a"
                   else "src/repro_torch/kernels/csrc/qgemm_sm90.cu")
            nbytes = nb * (8 * m * k + 8 * n * k + 4 * m * n + m * k + n * k)
            row = _record_kernel(
                torch, name, src, "src/repro/kernels/fused_linear.py:188",
                [nb, m, k, n], err,
                lambda: kfl.fused_qq_pt(a, ra32, b, rb32, ea, eb),
                lambda: kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb), nbytes,
                2.0 * nb * m * n * k, _int_mm_ms(torch, res[1], res[2]),
                "library_ms: torch._int_mm of the same mantissas, one a "
                "batch slice", plain_iters=2)
            if name == "qq_attn":
                row["dp4a_ms"] = _dp4a_qq_ms(
                    torch, kfl, a, ra32, b, rb32, ea, eb,
                    kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb)[0])
                print(f"qq_attn on the __dp4a kernel: {row['dp4a_ms']:.4f} ms "
                      f"device time (the rule's wgmma: {row['ms']:.4f} ms)")
            out.append(dict(row, variant=variant,
                            line_as=["qq_wgmma"] if name == "qq" else []))
        del a, b, ra, rb, res, y_only, want
        torch.cuda.empty_cache()
    print(f"qq == plain at every shape ({len(held)}, both roundings, with "
          f"and without residuals): {held}")
    return out


def _dp4a_qq_ms(torch, kfl, a, ra32, b, rb32, ea, eb, y_want):
    """Device ms of the __dp4a qq kernel on the same operands, launched
    through its C entry point (the shape rule no longer picks it at K % 16
    == 0): the comparison behind the rule at the attention shapes.  Its y
    must equal ``y_want``, the plain version's stochastic y."""
    import ctypes
    nb, m, k = a.shape
    n = b.shape[1]
    y = torch.empty((nb, m, n), dtype=torch.float32, device=a.device)
    am = torch.empty((nb, m, k), dtype=torch.int8, device=a.device)
    bm = torch.empty((nb, n, k), dtype=torch.int8, device=a.device)
    p = kfl._ptr
    lib = kfl._lib_linear()

    def run():
        err = lib.repro_fused_qq(
            p(a), p(ra32), p(b), p(rb32), p(ea), p(eb), p(y), p(am), p(bm),
            nb, m, n, k, 7, 1, ctypes.c_void_p(
                torch.cuda.current_stream(a.device).cuda_stream))
        kfl._raise_on(err, "qq (__dp4a, timed)")
    run()
    torch.cuda.synchronize()
    if not torch.equal(y, y_want):
        raise AssertionError("qq __dp4a at the attention shape != plain")
    return _device_ms(torch, run)


def _check_variants(label, launches, dp4a=None):
    """Every qq, qi, ii, qq_blk, int8_matmul, gemm_epi and norm_gemm launch
    of a main-path phase is one of a variant, and each on the variant the
    shape rule names for it: every main-path K of phases 3-12 is a multiple
    of 16, every block 128 and every operand aligned, so none on the
    fallback (``__dp4a``, wmma), except ``dp4a`` (kind -> __dp4a launches):
    the CNN phases' stem and head dX, whose K % 16 != 0 (``CNN_DP4A``), and
    no other; every int8_matmul launch (M > 16 throughout phase 9) on
    wgmma, every gemm_epi and norm_gemm launch (phases 8 and 10) on
    wgmma (phase 6 also holds the qq_blk split between the two tilings to
    its count); every attn_decode launch (phase 3) on the cluster size
    decode_split names and every attn_fwd and attn_bwd launch (phase 5)
    on wgmma."""
    from repro_torch.kernels import fused_chain as kfc
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import int8_matmul as kim
    # every phase rounds stochastically: its bits drawn on the kernel
    if launches["rounding_bits"] <= 0:
        raise AssertionError(f"{label}: no rounding_bits launch")
    print(f"{label}: rounding_bits launches {launches['rounding_bits']}")
    for kind, variants, allowed in (
            ("qq", kfl.QGEMM_VARIANTS, ("wgmma", "stream")),
            ("qi", kfl.QGEMM_VARIANTS, ("wgmma", "stream")),
            ("ii", kfl.QGEMM_VARIANTS, ("wgmma", "stream")),
            ("qq_blk", kfl.QQ_BLK_VARIANTS, ("wgmma", "wgmma64")),
            ("int8_matmul", kim.INT8_MATMUL_VARIANTS, ("wgmma",)),
            ("gemm_epi", kfl.GEMM_EPI_VARIANTS, ("wgmma",)),
            ("norm_gemm", kfc.NORM_GEMM_VARIANTS, ("wgmma",))):
        per = {v: launches[f"{kind}_{v}"] for v in variants}
        off = {v: c for v, c in per.items() if v not in allowed and c}
        n_dp4a = (dp4a or {}).get(kind, 0)
        if sum(per.values()) != launches[kind] \
                or off != ({"dp4a": n_dp4a} if n_dp4a else {}):
            raise AssertionError(f"{label}: {launches[kind]} {kind} launches "
                                 f"as {per}, expected all on {allowed} but "
                                 f"{n_dp4a} on dp4a")
        print(f"{label}: {kind} launches by variant {per}")
    # every attn_decode launch (phase 3: the decode slice, GS 7, T PROMPT +
    # GEN, D 64) on the cluster size decode_split names, every attn_bwd
    # launch (phase 5) on wgmma
    from repro_torch.kernels import fused_attention as kfa
    n = kfa.decode_split(7, PROMPT + GEN, 64)
    per = {k: launches[f"attn_decode_n{k}"] for k in kfa.DECODE_SPLITS
           if launches[f"attn_decode_n{k}"]}
    if sum(per.values()) != launches["attn_decode"] or set(per) - {n}:
        raise AssertionError(f"{label}: {launches['attn_decode']} attn_decode "
                             f"launches by cluster size {per}, expected all "
                             f"on {n}")
    per_f = {v: launches[f"attn_fwd_{v}"] for v in kfa.ATTN_FWD_VARIANTS}
    if sum(per_f.values()) != launches["attn_fwd"] or per_f["dp4a"]:
        raise AssertionError(f"{label}: {launches['attn_fwd']} attn_fwd "
                             f"launches as {per_f}, expected all on wgmma")
    per_b = {v: launches[f"attn_bwd_{v}"] for v in kfa.ATTN_BWD_VARIANTS}
    if sum(per_b.values()) != launches["attn_bwd"] or per_b["dp4a"]:
        raise AssertionError(f"{label}: {launches['attn_bwd']} attn_bwd "
                             f"launches as {per_b}, expected all on wgmma")
    if launches["attn_decode"] or launches["attn_fwd"] or launches["attn_bwd"]:
        print(f"{label}: attn_decode launches by cluster size {per}, "
              f"attn_fwd by route {per_f}, attn_bwd by route {per_b}")


def _record_kernel(torch, name, source, replaces, shape, err, kernel, plain,
                   nbytes, ops, library_ms, note=None, plain_iters=3,
                   ops_per_s=INT8_OPS_PER_S):
    """Time a kernel call and its plain version; the row of the kernels
    line, with the device ms of each kernel the call launches."""
    split = {}
    ms = _device_ms(torch, kernel, split=split)
    call = _time_ms(torch, kernel)
    pms = _device_ms(torch, plain, iters=plain_iters)
    bound, by = _bound_ms(nbytes, ops, ops_per_s)
    print(f"{name} {shape}: {ms:.4f} ms device time (bound {bound:.5f} ms by "
          f"{by}; plain {pms:.3f} ms; library {library_ms}), kernel == plain; "
          f"by kernel {({k: round(v, 5) for k, v in split.items()})}")
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               shape=shape, max_abs_err=err, ms=ms, call_ms=call,
               plain_ms=pms, bound_ms=bound, bound_by=by, bytes=nbytes,
               ops=ops, library_ms=library_ms, ms_by_kernel=split)
    if note:
        row["library_note"] = note
    return row


def _dp4a_ms(torch, lib_fn, args, want, what):
    """Device ms of a ``__dp4a`` kernel launched through its C entry point
    on the same operands (the shape rule sends the main path's shapes to
    the tensor cores): the comparison behind the rule.  ``args`` builds
    the call's arguments and its outputs; the first output must equal
    ``want``."""
    outs, call = args()

    def run():
        err = lib_fn(*call, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{what} (__dp4a, timed): cudaError {err}")
    run()
    torch.cuda.synchronize()
    if not torch.equal(outs[0], want):
        raise AssertionError(f"{what} on __dp4a != plain")
    return _device_ms(torch, run)


def _epi_dp4a_call(torch, kfl, a, ra, b, rb, ea, eb, act):
    """The outputs and C arguments of gemm_epi (kind qq, no out-quantize)
    on fused_linear.cu's __dp4a kernel."""
    m, k = a.shape
    n = b.shape[0]
    glu = act.endswith("_glu")
    y = torch.empty((m, n // 2 if glu else n), dtype=torch.float32, device=a.device)
    ylin = torch.empty((m, n), dtype=torch.float32, device=a.device)
    am = torch.empty((m, k), dtype=torch.int8, device=a.device)
    bm = torch.empty((n, k), dtype=torch.int8, device=a.device)
    p = kfl._ptr
    return (y, ylin, am, bm), (
        p(a), p(ra), p(b), p(rb), None, None, p(ea), p(eb), p(y), p(ylin), p(am),
        p(bm), None, None, None, m, n, k, 7, 7, m, 0, kfl.EPI_ACTS.index(act), 0, 1)


def check_chain(torch, dev, g, bits):
    """gemm_epi, norm_gemm and decode_block against their plain versions
    at the minicpm-2b shapes of phases 7 and 8, gemm_epi also at the
    starcoder2-7b shape of phase 10, and at odd ones, ``==``, each
    gemm_epi and norm_gemm call on the variant its shape rule names; timed
    at the minicpm-2b and starcoder2-7b shapes, beside the ``__dp4a``
    kernels' times on the same operands.  gemm_epi's kinds qi and ii and
    its out-quantize (with and without m_true) ``==`` at small shapes."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_chain as kfc
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    src_sm90 = "src/repro_torch/kernels/csrc/qgemm_sm90.cu"
    src_chain = "src/repro_torch/kernels/csrc/fused_chain.cu"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = []

    # gemm_epi: the gate|up GEMM + GLU of training, minicpm-2b's SiLU
    # (512 x 2304 -> 2 x 5760) and starcoder2-7b's GELU (512 x 4608 -> 2 x
    # 18432), timed under the kernel's name; then odd shapes with a bias
    # (an odd GLU half on both variants, relu, gelu), both roundings, the
    # gelu one timed for the record only
    for label, (m, k, n, act, with_bias), row in (
            ("train", (tokens, 2304, 2 * 5760, "silu_glu", False), "gemm_epi"),
            ("train_gelu_glu", (tokens, 4608, 2 * 18432, "gelu_glu", False),
             "gemm_epi"),
            ("odd", (37, 67, 58, "silu_glu", True), None),
            ("odd_gelu_glu", (37, 67, 58, "gelu_glu", True), None),
            ("odd_wgmma", (37, 96, 58, "silu_glu", True), None),
            ("odd_relu", (130, 96, 70, "relu", True), None),
            ("odd_gelu", (130, 96, 70, "gelu", True), "gemm_epi_gelu_odd")):
        a = torch.randn((m, k), generator=g, device=dev)
        b = torch.randn((n, k), generator=g, device=dev)
        a[1] *= 300.0            # a sub-normal logistic, a saturated tanh
        bias = (torch.randn((1, n), generator=g, device=dev) if with_bias
                else None)
        ra, rb = bits(14, a.shape), bits(15, b.shape)
        ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
        variant = kfl.gemm_epi_variant(m, k, n, act)
        err = 0.0
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(stochastic=sr, act=act)
            got = _expect_variant(
                torch, "gemm_epi", kfl.GEMM_EPI_VARIANTS, variant, label,
                lambda: kfl.fused_gemm_epi(a, r[0], b, r[1], bias, None, ea, eb, **kw))
            want = kfl.fused_gemm_epi_plain(a, r[0], b, r[1], bias, None, ea,
                                            eb, **kw)
            torch.cuda.synchronize()
            err = max(err, (got[0] - want[0]).abs().max().item())
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"gemm_epi {label}: kernel != plain "
                                     f"(max |dy| {err})")
        if row is None:
            continue
        a32, b32 = kfl.as_u32(ra), kfl.as_u32(rb)
        kw = dict(act=act)
        n_out = n // 2 if act.endswith("_glu") else n
        # f32 values and bits of both operands and the bias in; y, ylin,
        # both mantissas out
        nbytes = (8 * m * k + 8 * n * k + 4 * n * with_bias + 4 * m * n_out
                  + 4 * m * n + m * k + n * k)
        out.append(_record_kernel(
            torch, row, src_sm90 if variant == "wgmma"
            else "src/repro_torch/kernels/csrc/fused_linear.cu",
            "src/repro/kernels/fused_linear.py:556",
            [m, k, n], err,
            lambda: kfl.fused_gemm_epi(a, a32, b, b32, bias, None, ea, eb, **kw),
            lambda: kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, None, ea, eb,
                                             **kw),
            nbytes, 2.0 * m * n * k, _int_mm_ms(torch, want[1][None], want[2][None]),
            f"no single PyTorch call quantizes, contracts and applies the "
            f"{act} epilogue; library_ms times torch._int_mm of the same "
            "mantissas"))
        out[-1].update(act=act, variant=variant,
                       line_as=["gemm_epi_wgmma"] if label == "train" else [])
        if not with_bias:
            out[-1]["dp4a_ms"] = _dp4a_ms(
                torch, kfl._lib_linear().repro_gemm_epi,
                lambda: _epi_dp4a_call(torch, kfl, a, a32, b, b32, ea, eb, act),
                kfl.fused_gemm_epi_plain(a, ra, b, rb, None, None, ea, eb, **kw)[0],
                f"gemm_epi {label}")
            print(f"gemm_epi {label} on the __dp4a kernel: "
                  f"{out[-1]['dp4a_ms']:.4f} ms device time (the rule's "
                  f"{variant}: {out[-1]['ms']:.4f} ms; by kernel "
                  f"{out[-1]['ms_by_kernel']})")
        del a, b, ra, rb, a32, b32, got, want
        torch.cuda.empty_cache()

    # gemm_epi's kinds qi and ii and its out-quantize: every kind, each act
    # with a bias, the out-quantize over all rows and over the rows below
    # m_true (the rest zero, so y there is act(bias)), both roundings, on
    # both variants (K 96 and 67)
    held = []
    for kind in ("qq", "qi", "ii"):
        for m, k, n, act in ((130, 96, 70, "silu_glu"), (130, 67, 58, "gelu_glu"),
                             (131, 96, 71, "relu"), (64, 96, 70, "gelu"),
                             (64, 96, 70, None)):
            for out_q, m_true in ((False, None), (True, None), (True, 100)):
                for sr in (True, False):
                    a = torch.randn((m, k), generator=g, device=dev)
                    b = torch.randn((n, k), generator=g, device=dev)
                    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
                    if kind == "ii":
                        a = torch.randint(-127, 128, (m, k), generator=g,
                                          device=dev, dtype=torch.int8)
                        ea = torch.tensor(129, dtype=torch.int32, device=dev)
                    if kind != "qq":
                        b = torch.randint(-127, 128, (n, k), generator=g,
                                          device=dev, dtype=torch.int8)
                        eb = torch.tensor(127, dtype=torch.int32, device=dev)
                    if m_true is not None:
                        a[m_true:] = 0
                    n_out = n // 2 if (act or "").endswith("_glu") else n
                    ra = bits(18, (m, k)) if sr and kind != "ii" else None
                    rb = bits(19, (n, k)) if sr and kind == "qq" else None
                    rq = bits(20, (m, n_out)) if sr and out_q else None
                    bias = torch.randn((1, n), generator=g, device=dev)
                    kw = dict(kind=kind, stochastic=sr, act=act, out_q=out_q,
                              m_true=m_true)
                    variant = kfl.gemm_epi_variant(m, k, n, act)
                    got = _expect_variant(
                        torch, "gemm_epi", kfl.GEMM_EPI_VARIANTS, variant,
                        f"{kind} {(m, k, n)}",
                        lambda: kfl.fused_gemm_epi(a, ra, b, rb, bias, rq, ea, eb, **kw))
                    want = kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, rq, ea, eb, **kw)
                    if len(got) != len(want) or not all(
                            torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(
                            f"gemm_epi kind {kind} {(m, k, n)} act={act} out_q="
                            f"{out_q} m_true={m_true} stochastic={sr} ({variant}):"
                            " kernel != plain")
            held.append(f"{kind} {(m, k, n)} {act} {variant}")
    print(f"gemm_epi kinds qq / qi / ii, out_q with and without m_true, both "
          f"roundings == plain ({len(held)} shapes): {held}")

    # norm_gemm: the QKV chain of training (512 x 2304 -> 6912), then odd
    # shapes: LayerNorm with a shift, rows off every strip, K off the
    # slice (__dp4a), a wide K on the tensor cores, both roundings
    for label, (m, k, n, center, with_beta) in (
            ("train", (tokens, 2304, 6912, False, False)),
            ("odd", (37, 100, 70, True, True)),
            ("odd_wgmma", (37, 112, 70, True, True)),
            ("odd_wide", (130, 4000, 29, False, True))):
        x = torch.randn((m, k), generator=g, device=dev) * 3.0
        x[1] *= 2.0 ** -60
        gm = torch.randint(1 << 13, 1 << 15, (1, k), generator=g, device=dev,
                           dtype=torch.int32)
        bm = (torch.randint(-(1 << 14), 1 << 14, (1, k), generator=g,
                            device=dev, dtype=torch.int32) if with_beta
              else None)
        wm = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        se_w = torch.full((1, n), -9, dtype=torch.int32, device=dev)
        se_g = torch.tensor(-15, dtype=torch.int32, device=dev)
        se_b = torch.tensor(-20, dtype=torch.int32, device=dev)
        rin, rout = bits(16, (m, k)), bits(17, (m, k))
        variant = kfc.norm_gemm_variant(m, k)
        err = 0.0
        for sr in (True, False):
            r = (rin, rout) if sr else (None, None)
            args = (x, r[0], r[1], gm, se_g, bm, se_b, wm, se_w)
            got = _expect_variant(
                torch, "norm_gemm", kfc.NORM_GEMM_VARIANTS, variant, label,
                lambda: kfc.fused_norm_gemm(*args, n=k, center=center))
            want = kfc.norm_gemm_plain(*args, n=k, center=center)
            torch.cuda.synchronize()
            err = max(err, (got[0] - want[0]).abs().max().item())
            if not all(torch.equal(x_, y_) for x_, y_ in zip(got, want)):
                raise AssertionError(f"norm_gemm {label}: kernel != plain "
                                     f"(max |dy| {err})")
        if label != "train":
            continue
        args32 = (x, kfl.as_u32(rin), kfl.as_u32(rout), gm, se_g, bm, se_b,
                  wm, se_w)
        args = (x, rin, rout, gm, se_g, bm, se_b, wm, se_w)
        # x and its two bit streams, gain, weight, column exponents in;
        # y, xq, c, meta out
        nbytes = 12 * m * k + 4 * k + n * k + 4 * n + 4 * m * n + 2 * m * k + 4 * m * 128
        out.append(_record_kernel(
            torch, "norm_gemm", src_sm90 if variant == "wgmma" else src_chain,
            "src/repro/kernels/fused_chain.py:299",
            [m, k, n], err, lambda: kfc.fused_norm_gemm(*args32, n=k),
            lambda: kfc.norm_gemm_plain(*args, n=k), nbytes, 2.0 * m * n * k,
            _int_mm_ms(torch, want[1][None], wm[None]),
            "no single PyTorch call computes the integer norm and the "
            "per-row quantize; library_ms times torch._int_mm of xq and "
            "the weight"))
        out[-1].update(variant=variant, line_as=["norm_gemm_wgmma"],
                       source_norm_pass=src_chain)

        def dp4a_args():
            y = torch.empty((m, n), dtype=torch.float32, device=dev)
            xq = torch.empty((m, k), dtype=torch.int8, device=dev)
            meta = torch.empty((m, 128), dtype=torch.int32, device=dev)
            c = torch.empty((m, k), dtype=torch.int8, device=dev)
            p = kfl._ptr
            return (y, xq, meta, c), (
                p(x), p(args32[1]), p(args32[2]), p(gm), p(se_g), None, None, p(wm),
                p(se_w), p(y), p(xq), p(meta), p(c), m, n, k, 7, 1, -32, 0,
                *kfc.div_n_consts(k), 64, 1)
        out[-1]["dp4a_ms"] = _dp4a_ms(torch, kfc._lib().repro_norm_gemm, dp4a_args,
                                      kfc.norm_gemm_plain(*args, n=k)[0],
                                      "norm_gemm train")
        print(f"norm_gemm train on the __dp4a kernel: {out[-1]['dp4a_ms']:.4f} "
              f"ms device time (the rule's {variant}: {out[-1]['ms']:.4f} ms; "
              f"by kernel {out[-1]['ms_by_kernel']})")
        del x, rin, rout, got, want

    # decode_block: one minicpm-2b layer for 4 streams at the last decode
    # position of phase 7 (timed), at position 0, with a window, for one
    # stream; then GQA groups of 4 with a window
    minicpm = (2304, 5760, 36, 36, 64, PROMPT + GEN)
    for label, (b, d, n_ff, hq, hkv, dh, t, pos, window) in (
            ("serve", (BATCH, *minicpm, PROMPT + GEN - 1, 0)),
            ("serve_pos0", (BATCH, *minicpm, 0, 0)),
            ("serve_window", (BATCH, *minicpm, PROMPT + GEN - 10, 64)),
            ("serve_b1", (1, *minicpm, PROMPT + GEN - 1, 0)),
            ("odd", (3, 256, 320, 8, 2, 32, 40, 37, 8))):
        def i8(*shp):
            return torch.randint(-127, 128, shp, generator=g, device=dev,
                                 dtype=torch.int8)

        def se(n_):
            return torch.randint(-14, -9, (1, n_), generator=g, device=dev,
                                 dtype=torch.int32)

        def rows(*shp):
            return torch.randint(118, 126, shp, generator=g, device=dev,
                                 dtype=torch.int32)

        nqkv = (hq + 2 * hkv) * dh
        ang = torch.rand(dh // 2, generator=g, device=dev) * 3
        cossin = torch.cat([ang.cos(), ang.cos(), ang.sin(), ang.sin()])[None]
        gains = [torch.randint(1 << 13, 1 << 15, (1, d), generator=g,
                               device=dev, dtype=torch.int32) for _ in range(2)]
        args = (torch.randn((b, d), generator=g, device=dev), i8(nqkv, d),
                se(nqkv), i8(d, hq * dh), se(d), i8(2 * n_ff, d),
                se(2 * n_ff), i8(d, n_ff), se(d), *gains, i8(b, hkv, t, dh),
                rows(b, hkv, t, 1), i8(b, hkv, t, dh), rows(b, hkv, t, 1),
                cossin.contiguous(), pos)
        kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, window=window,
                  se_g1=-14, se_g2=-14)
        dispatch.reset_kernel_launches()
        got = kfc.fused_decode_block(*args, **kw)
        want = kfc.decode_block_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        if not all(torch.equal(x_, y_) for x_, y_ in zip(got, want)):
            raise AssertionError(f"decode_block {label}: kernel != plain "
                                 f"(max |dx_out| {err})")
        if dispatch.kernel_launches()["decode_block"] != 1:
            raise AssertionError(f"decode_block {label}: launch not counted")
        if label != "serve":
            continue
        weights = nqkv * d + d * hq * dh + 2 * n_ff * d + d * n_ff
        vis = b * hkv * (pos + 1)          # cache rows the attention reads
        nbytes = (weights + 4 * (nqkv + 2 * d + 2 * n_ff + 2 * d)
                  + 2 * vis * dh + 8 * vis + 8 * b * d + 8 * dh
                  + 2 * b * hkv * (dh + 4))
        ops = 2.0 * b * weights + 4.0 * b * hq * (pos + 1) * dh
        out.append(_record_kernel(
            torch, "decode_block", src_chain,
            "src/repro/kernels/fused_chain.py:489", [b, d, n_ff, hq, hkv, dh, t],
            err, lambda: kfc.fused_decode_block(*args, **kw),
            lambda: kfc.decode_block_plain(*args, **kw), nbytes, ops, None,
            "no single PyTorch call computes a decoder layer over an int8 "
            "cache"))
    print("gemm_epi, norm_gemm and decode_block == plain at every shape "
          "(odd shapes and positions untimed)")
    return out


def _edge_values(torch, g, m, n, dev):
    """f32 (m, n) with zeros, sub-normals, a row whose largest value
    rounds past 127 (clamped) and a value 2^40 that puts every other
    element 32 and more binades below the tensor's exponent."""
    x = torch.randn((m, n), generator=g, device=dev)
    x[0, : n // 2] = 0.0
    x[1 % m] *= 2.0 ** -140
    x[2 % m] = x[2 % m].clamp(-0.5, 0.5)
    x[2 % m, 0] = 1.0 - 2.0 ** -24
    x[3 % m, 0] = 2.0 ** 40
    return x


def check_unfused(torch, dev, g, bits):
    """bfp_quantize (mantissas) and int8_matmul (y) against their plain
    versions ``==``: at the shapes of phase 9 (the projection and LM-head
    shapes timed, the attention's batched qbmm not) and at odd ones
    (edge values with a per-tensor and a per-row exponent, shapes off
    every tile, a batch, unaligned operands, a scale that flushes to 0)."""
    from repro_torch.kernels import bfp_quant as kbq
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import int8_matmul as kim
    from repro_torch.kernels import ref

    src_q = "src/repro_torch/kernels/csrc/bfp_quant.cu"
    src_m = "src/repro_torch/kernels/csrc/int8_matmul.cu"
    src_sm90 = "src/repro_torch/kernels/csrc/qgemm_sm90.cu"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out, held = [], []
    # name: (M, N); the LM-head weight and an MLP activation of phase 9
    for name, (m, n) in (("bfp_quantize", (151936, 896)),
                         ("bfp_quantize_act", (tokens, 4864)),
                         ("odd", (37, 67)), ("odd_tail", (5, 3)),
                         ("odd_rows", (130, 97))):
        x = _edge_values(torch, g, m, n, dev)
        r = bits(18, (m, n))
        err = 0
        for e_rows in (ref.max_biased_exp_ref(x).reshape(1).expand(m).contiguous(),
                       ref.max_biased_exp_ref(x, axis=1).to(torch.int32)):
            got = kbq.bfp_quantize(x, r, e_rows)
            want = kbq.bfp_quantize_plain(x, r, e_rows)
            torch.cuda.synchronize()
            err = max(err, (got.int() - want.int()).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"bfp_quantize {name}: kernel != plain "
                                     f"(max |d| {err})")
        if name == "odd":                 # an operand off 16-byte alignment
            xs = x.reshape(-1)[1:36].reshape(5, 7)
            rs = r.reshape(-1)[1:36].reshape(5, 7)
            es = ref.max_biased_exp_ref(xs).reshape(1).expand(5).contiguous()
            if not torch.equal(kbq.bfp_quantize(xs, rs, es),
                               kbq.bfp_quantize_plain(xs, rs, es)):
                raise AssertionError("bfp_quantize unaligned: kernel != plain")
        if not name.startswith("bfp_quantize"):
            continue
        r32 = kfl.as_u32(r)
        out.append(_record_kernel(
            torch, name, src_q, "src/repro/kernels/bfp_quant.py:57", [m, n],
            err, lambda: kbq.bfp_quantize(x, r32, e_rows),
            lambda: kbq.bfp_quantize_plain(x, r, e_rows),
            9 * m * n + 4 * m, 0.0, None,
            "no single PyTorch call quantizes with stochastic rounding "
            "against given bits"))
        del x, r, r32, got, want
    # (B, M, K, N): a projection, the LM head's forward and its dW, the
    # attention's batched qbmm (batch x kv heads, the 7 query heads of a
    # group x 128 positions: QKᵀ, PV and QKᵀ's dW; phase 9's shapes), then
    # odd ones: K % 16 != 0 (wmma), M <= 16 (stream), ragged M and N with a
    # batch, an operand off 16-byte alignment (wmma).  Each call must move
    # the counter of the variant int8_matmul_variant names.  The names
    # starting with int8_matmul are timed; those named as a variant counter
    # stand for it on the kernels line.
    qrows = 14 // 2 * TRAIN_SEQ
    for name, (nb, m, k, n), line_as in (
            ("int8_matmul", (1, tokens, 896, 4864), ["int8_matmul_wgmma"]),
            ("int8_matmul_lm_head", (1, tokens, 896, 151936), []),
            ("int8_matmul_lm_head_dw", (1, 896, tokens, 151936), []),
            ("qbmm_qk", (TRAIN_BATCH * 2, qrows, 64, TRAIN_SEQ), []),
            ("qbmm_pv", (TRAIN_BATCH * 2, qrows, TRAIN_SEQ, 64), []),
            ("qbmm_qk_dw", (TRAIN_BATCH * 2, 64, qrows, TRAIN_SEQ), []),
            ("odd", (3, 37, 67, 29), []),
            ("int8_matmul_wmma", (1, 5, 33, 130), []),
            ("int8_matmul_stream", (2, 4, 512, 70), []),
            ("odd_batch", (2, 130, 96, 70), []),
            ("odd_unaligned", (1, 37, 64, 29), [])):
        am = torch.randint(-127, 128, (nb, m, k), generator=g, device=dev,
                           dtype=torch.int8)
        bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=dev,
                           dtype=torch.int8)
        if name == "odd_unaligned":       # a view one byte into its storage
            am = torch.randint(-127, 128, (nb * m * k + 16,), generator=g,
                               device=dev, dtype=torch.int8
                               )[1:1 + nb * m * k].view(nb, m, k)
        variant = kim.int8_matmul_variant(m, k, kfl._aligned(am, bm))
        err = 0.0
        for e in (-20, -150):             # -150: the scale flushes to 0
            scale = kfl.pow2_f32(torch.tensor(e, device=dev))
            got = _expect_variant(torch, "int8_matmul",
                                  kim.INT8_MATMUL_VARIANTS, variant,
                                  str((nb, m, k, n)),
                                  lambda: kim.int8_matmul(am, bm, scale))
            want = kim.int8_matmul_plain(am, bm, scale)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul {name} {variant}: kernel "
                                     f"!= plain (max |dy| {err})")
        held.append(f"{name} {variant}")
        del got, want
        if not name.startswith("int8_matmul"):
            continue
        scale = kfl.pow2_f32(torch.tensor(-20, device=dev))
        pairs = [(am[i], bm[i].t()) for i in range(nb)]
        if m <= 16:                       # _int_mm needs M > 16
            pairs = [(torch.nn.functional.pad(x, (0, 0, 0, 32 - m)), w)
                     for x, w in pairs]
        try:                              # the yardstick only; not the port
            lib = _device_ms(torch, lambda: [torch._int_mm(a, b) * scale
                                             for a, b in pairs], iters=5)
        except RuntimeError as err_lib:
            print(f"library call unavailable: {err_lib}", file=sys.stderr)
            lib = None
        src = src_m if variant == "wmma" else src_sm90
        row = _record_kernel(
            torch, name, src, "src/repro/kernels/int8_matmul.py:47",
            [nb, m, k, n], err, lambda: kim.int8_matmul(am, bm, scale),
            lambda: kim.int8_matmul_plain(am, bm, scale),
            nb * (m * k + n * k + 4 * m * n) + 4, 2.0 * nb * m * n * k, lib,
            "library_ms: torch._int_mm of the same mantissas times the "
            "scale" + (" (rows padded to 32)" if m <= 16 else ""),
            plain_iters=2)
        out.append(dict(row, variant=variant, line_as=line_as))
        del am, bm
        torch.cuda.empty_cache()
    print(f"int8_matmul == plain at every shape ({held}; qbmm and odd "
          "shapes untimed)")
    return out


def _int_mm_blocks_ms(torch, am, bm, blk):
    """The per-block sum of torch._int_mm products on the same mantissas
    (one _int_mm per block, no block scales): a yardstick of the int8
    work in many calls, not one; the port never calls it."""
    a, b = am[0], bm[0]
    parts = [(a[:, i:i + blk], b[:, i:i + blk].t())
             for i in range(0, a.shape[1], blk)]

    def run():
        acc = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32,
                          device=a.device)
        for x, y in parts:
            acc += torch._int_mm(x, y)
        return acc
    try:
        return _device_ms(torch, run, iters=3)
    except RuntimeError as err:       # the yardstick only; not the port
        print(f"library call unavailable: {err}", file=sys.stderr)
        return None


# qq_blk shapes, (B, M, K, N, blk, residuals): the int8_block step's
# (phase 6) gate forward, w_down forward, gate dW, the tied LM head's
# forward, dX (1187 blocks, the 64 x 64 tiles) and dW, the attention's
# batched PV; then odd ones: blk 32 with the 64 x 64 tiles, K % 16 != 0
# and M <= 16 (the __dp4a kernel).  The names starting with qq_blk are
# timed; those named as a variant counter stand for it on the kernels line.
QQ_BLK_CASES = {"qq_blk": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 4864, 128, True),
                "qq_blk_w_down": (1, TRAIN_BATCH * TRAIN_SEQ, 4864, 896, 128, True),
                "qq_blk_gate_dw": (1, 4864, TRAIN_BATCH * TRAIN_SEQ, 896, 128, True),
                "qq_blk_lm_head": (1, TRAIN_BATCH * TRAIN_SEQ, 896, 151936, 128, True),
                "qq_blk_lm_head_dx": (1, TRAIN_BATCH * TRAIN_SEQ, 151936, 896, 128,
                                      False),
                "qq_blk_lm_head_dw": (1, 896, TRAIN_BATCH * TRAIN_SEQ, 151936, 128,
                                      True),
                "pv": (TRAIN_BATCH * 2, 7 * TRAIN_SEQ, TRAIN_SEQ, 64, 128, True),
                "odd": (2, 37, 40 * 32, 29, 32, True),
                "odd_k": (1, 37, 168, 29, 8, True),
                "odd_m16": (1, 16, 256, 64, 128, True),
                "odd_unaligned": (1, 37, 256, 29, 32, True)}
QQ_BLK_LINE_AS = {"qq_blk": ["qq_blk_wgmma"], "qq_blk_lm_head_dx": ["qq_blk_wgmma64"]}


def check_qq_blk(torch, dev, g, bits):
    """qq_blk against its plain version, y and both mantissa arrays ==:
    stochastic with residuals, half up, and y alone, each call moving the
    counter of the variant ``qq_blk_variant`` names (an unaligned view of
    a takes __dp4a); the first block of row 0 of both operands is tiny, so
    its scale 2^(sa + sb) is below 2^-126 and flushes to 0.  Timed at the
    names starting with qq_blk."""
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    out, held = [], []
    for name, (nb, m, k, n, blk, res) in QQ_BLK_CASES.items():
        if name == "odd_unaligned":      # a view one float into its storage
            a = torch.randn((nb * m * k + 4,), generator=g, device=dev
                            )[1:1 + nb * m * k].view(nb, m, k)
        else:
            a = torch.randn((nb, m, k), generator=g, device=dev)
        b = torch.randn((nb, n, k), generator=g, device=dev)
        a[:, 0, :blk] *= 2.0 ** -70
        b[:, 0, :blk] *= 2.0 ** -70
        ra, rb = bits(8, a.shape), bits(9, b.shape)
        ea = ref.max_biased_exp_blocks_ref(a, blk)
        eb = ref.max_biased_exp_blocks_ref(b, blk)
        if int(kfl.scale_exp(ea[0, 0, 0], 7) + kfl.scale_exp(eb[0, 0, 0], 7)) >= -126:
            raise AssertionError(f"{name}: the flush case is not below 2^-126")
        variant = kfl.qq_blk_variant(m, n, k, blk, kfl._aligned(a), nb)
        err = 0.0
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(blk=blk, stochastic=sr)
            got = _expect_variant(torch, "qq_blk", kfl.QQ_BLK_VARIANTS, variant,
                                  str((nb, m, k, n, blk)), lambda: kfl.fused_qq_blk(
                                      a, r[0], ea, b, r[1], eb, **kw))
            want = kfl.fused_qq_blk_plain(a, r[0], ea, b, r[1], eb, **kw)
            y_only = _expect_variant(
                torch, "qq_blk", kfl.QQ_BLK_VARIANTS, variant, str((nb, m, k, n, blk)),
                lambda: kfl.fused_qq_blk(a, r[0], ea, b, r[1], eb,
                                         emit_residuals=False, **kw))
            torch.cuda.synchronize()
            err = max(err, (got[0] - want[0]).abs().max().item())
            if not (all(torch.equal(x, y) for x, y in zip(got, want))
                    and torch.equal(y_only[0], want[0])
                    and y_only[1:] == (None, None)):
                raise AssertionError(f"{name}: qq_blk {variant} kernel != plain "
                                     f"(max |dy| {err})")
        held.append(f"{name} {variant}")
        if name.startswith("qq_blk"):
            row = _time_qq_blk(torch, kfl, name, (a, ra, ea, b, rb, eb),
                               want[1], want[2], blk, res, err)
            out.append(dict(row, variant=variant, line_as=QQ_BLK_LINE_AS.get(name, [])))
        del a, b, ra, rb, got, want, y_only
        torch.cuda.empty_cache()
    print(f"qq_blk == plain at every shape ({len(held)}, both roundings, with "
          f"and without residuals): {held}")
    return out


def _time_qq_blk(torch, kfl, name, args, am, bm, blk, res, err):
    a, ra, ea, b, rb, eb = args
    nb, m, k = a.shape
    n = b.shape[1]
    args32 = (a, kfl.as_u32(ra), ea, b, kfl.as_u32(rb), eb)
    kw = dict(blk=blk, emit_residuals=res)
    split = {}
    ms = _device_ms(torch, lambda: kfl.fused_qq_blk(*args32, **kw), split=split)
    call = _time_ms(torch, lambda: kfl.fused_qq_blk(*args32, **kw))
    pms = _device_ms(torch, lambda: kfl.fused_qq_blk_plain(*args, **kw),
                     iters=2)
    blocks_ms = _int_mm_blocks_ms(torch, am, bm, blk)
    # f32 values and u32 bits of both operands, the block exponents, y,
    # and the mantissas when they are written
    nbytes = nb * (8 * m * k + 8 * n * k + 4 * (m + n) * (k // blk)
                   + 4 * m * n + ((m + n) * k if res else 0))
    bound, by = _bound_ms(nbytes, 2.0 * nb * m * n * k)
    print(f"{name} {[m, k, n]}: {ms:.4f} ms device time (bound "
          f"{bound:.5f} ms by {by}; plain {pms:.3f} ms; per-block "
          f"_int_mm {blocks_ms}), kernel == plain")
    src = "fused_linear.cu" if kfl.qq_blk_variant(m, n, k, blk, True, nb) == "dp4a" \
        else "qgemm_sm90.cu"
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{src}",
                replaces="src/repro/kernels/fused_linear.py:367",
                shape=[nb, m, k, n], blk=blk, residuals=res, max_abs_err=err,
                ms=ms, call_ms=call, plain_ms=pms, bound_ms=bound,
                bound_by=by, bytes=nbytes, library_ms=None, ms_by_kernel=split,
                int_mm_blocks_ms=blocks_ms,
                library_note="no single PyTorch call applies a scale per "
                             "row and block inside the contraction; "
                             "int_mm_blocks_ms times one torch._int_mm per "
                             "block, summed unscaled")


def check_attn_train(torch, dev, g, bits):
    """attn_fwd and attn_bwd against their plain versions: the qwen2
    training slice (B*Hkv = 8, GS = 7 x 128, T = 128, D = 64, causal) and
    an odd shape (GS = 21, T = 200, kv_len = 170, two KV blocks, not
    causal), each on the route its rule names (its counter moved); timed
    at the training slice, the forward also on its ``__dp4a`` kernel
    through the C entry (the comparison behind the rule)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_attention as kfa
    from repro_torch.kernels import fused_linear as kfl

    out = []
    shapes = {"train": (TRAIN_BATCH * 2, 7 * TRAIN_SEQ, TRAIN_SEQ, 64,
                        TRAIN_SEQ, TRAIN_SEQ, True),
              "odd": (2, 21, 200, 12, 3, 170, False)}
    timed = {}
    for label, (bh, gs, t, d, s, kv_len, causal) in shapes.items():
        def i8(*shape):
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)

        qm, gm, km, vm = i8(bh, gs, d), i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
        rp, rs, rp2 = (bits(k, (bh, gs, t)) for k in (5, 6, 7))
        eq, ek, ev, eg = (torch.tensor(v, dtype=torch.int32, device=dev)
                          for v in (125, 125, 124, 110))
        kw = dict(p=7, s=s, bt=dispatch.attn_block_t(t), causal=causal,
                  window=0, stochastic=True)
        fwd = (qm, km, vm, rp, eq, ek, ev, 0, kv_len)
        fvariant = kfa.attn_fwd_variant(gs, t, d, kw["bt"])
        if fvariant != ("wgmma" if label == "train" else "dp4a"):
            raise AssertionError(f"attn_fwd {label}: the rule names {fvariant}")
        before = dispatch.kernel_launches()[f"attn_fwd_{fvariant}"]
        got = kfa.attn_fwd(*fwd, **kw)
        want = kfa.attn_fwd_plain(*fwd, **kw)
        torch.cuda.synchronize()
        err_f = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"attn_fwd {label}: kernel != plain "
                                 f"(max |d| {err_f})")
        if dispatch.kernel_launches()[f"attn_fwd_{fvariant}"] != before + 1:
            raise AssertionError(f"attn_fwd {label}: not on {fvariant}")
        print(f"attn_fwd {label}: on {fvariant}, kernel == plain")
        want_f = want
        _, m, l = want
        delta = torch.randn((bh, gs, 1), generator=g, device=dev) * 1e-3
        bwd = (qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, 0, kv_len)
        variant = kfa.attn_bwd_variant(gs, t, d, kw["bt"])
        before = dispatch.kernel_launches()[f"attn_bwd_{variant}"]
        got = kfa.attn_bwd(*bwd, **kw)
        want = kfa.attn_bwd_plain(*bwd, **kw)
        torch.cuda.synchronize()
        err_b = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"attn_bwd {label}: kernel != plain "
                                 f"(max |d| {err_b})")
        if dispatch.kernel_launches()[f"attn_bwd_{variant}"] != before + 1:
            raise AssertionError(f"attn_bwd {label}: not on {variant}")
        print(f"attn_bwd {label}: on {variant}, kernel == plain")
        if label == "train":
            timed = dict(fwd=fwd, bwd=bwd, kw=kw, err_f=err_f, err_b=err_b,
                         shape=[bh, gs, t, d], kv_len=kv_len, s=s,
                         causal=causal, variant=variant, fvariant=fvariant,
                         y=want_f[0])

    bh, gs, t, d = timed["shape"]
    kw = timed["kw"]
    fwd32 = timed["fwd"][:3] + (kfl.as_u32(timed["fwd"][3]),) + timed["fwd"][4:]
    b = timed["bwd"]
    bwd32 = b[:7] + (kfl.as_u32(b[7]), kfl.as_u32(b[8])) + b[9:]
    # the (row, position) pairs the masks leave visible: the work each
    # integer product must do on this run's data
    # and the rounding bits they read: a masked p, pn or dS is 0 whatever
    # its bits are
    qpos = torch.arange(gs, device=dev) % timed["s"]
    kpos = torch.arange(t, device=dev)
    vis = (kpos[None, :] < timed["kv_len"]).expand(gs, t)
    if timed["causal"]:
        vis = vis & (kpos[None, :] <= qpos[:, None])
    pairs = bh * int(vis.sum().item())
    for name, fn, plain, args, nbytes, ops, err, line in (
            ("attn_fwd", kfa.attn_fwd, kfa.attn_fwd_plain, (fwd32, timed["fwd"]),
             bh * (gs * d + 2 * t * d + 4 * gs * d + 8 * gs) + 4 * pairs + 12,
             2 * 2 * d * pairs, timed["err_f"], 292),
            ("attn_bwd", kfa.attn_bwd, kfa.attn_bwd_plain, (bwd32, timed["bwd"]),
             bh * (2 * gs * d + 2 * t * d + 12 * gs + 4 * gs * d + 8 * t * d)
             + 8 * pairs + 16,
             5 * 2 * d * pairs, timed["err_b"], 402)):
        split = {}
        ms = _device_ms(torch, lambda: fn(*args[0], **kw), split=split)
        call = _time_ms(torch, lambda: fn(*args[0], **kw))
        pms = _device_ms(torch, lambda: plain(*args[1], **kw), iters=3)
        bound, by = _bound_ms(nbytes, ops)
        row = dict(name=name, route="cuda",
                   source="src/repro_torch/kernels/csrc/attn_train.cu",
                   replaces=f"src/repro/kernels/fused_attention.py:{line}",
                   shape=[bh, gs, t, d], max_abs_err=err, ms=ms,
                   call_ms=call, plain_ms=pms, bound_ms=bound,
                   bound_by=by, bytes=nbytes, ops=ops, ms_by_kernel=split,
                   library_ms=None,
                   library_note="no single PyTorch call computes int8 "
                                "scores, the online softmax and the "
                                "in-kernel quantizations")
        if name == "attn_bwd":
            row.update(variant=timed["variant"],
                       line_as=[f"attn_bwd_{timed['variant']}"])
        else:
            row.update(variant=timed["fvariant"],
                       line_as=[f"attn_fwd_{timed['fvariant']}"])
            row["dp4a_ms"] = _dp4a_ms(
                torch, kfa._lib_train().repro_attn_fwd,
                lambda: _fwd_dp4a_call(torch, fwd32, kw, timed), timed["y"],
                "attn_fwd")
            print(f"attn_fwd train on the __dp4a kernel: {row['dp4a_ms']:.4f} "
                  f"ms device time (the rule's {timed['fvariant']}: {ms:.4f})")
        out.append(row)
        print(f"{name}: {ms:.4f} ms device time (bound {bound:.5f} ms by "
              f"{by}; plain {pms:.3f} ms), kernel == plain at both shapes")
    return out


def _fwd_dp4a_call(torch, fwd32, kw, timed):
    """Outputs and C arguments of ``repro_attn_fwd`` (the ``__dp4a``
    forward) on the training slice's operands."""
    from repro_torch.kernels import fused_linear as kfl
    qm, km, vm, rp, eq, ek, ev, q_off, kv_len = fwd32
    bh, gs, t, d = timed["shape"]
    y, m, l = (torch.empty(shape, dtype=torch.float32, device=qm.device)
               for shape in ((bh, gs, d), (bh, gs, 1), (bh, gs, 1)))
    call = [kfl._ptr(x) for x in (qm, km, vm, rp, eq, ek, ev, y, m, l)]
    call += [bh, gs, t, d, kw["s"], q_off, kv_len, int(kw["causal"]),
             kw["window"], kw["p"], kw["bt"], int(kw["stochastic"])]
    return (y, m, l), call


def step_profile(torch, step, step_ms: float, rec, name="decode_step_profile"):
    """One kernel-path step under torch.profiler: summed device time, the
    top kernels, and the card's idle share against ``step_ms``, the same
    step's wall time measured without the profiler.  Only device activity
    is traced: the busy time and launch counts come from the device
    events alone, and tracing every host op of a training step (about half
    a million launches) cost the profiler some 250 s to process."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for key, us in _device_events(prof):
        by_name[key][0] += us / 1e3
        by_name[key][1] += 1
    events = sorted(((k, t, c) for k, (t, c) in by_name.items()),
                    key=lambda x: -x[1])
    busy_ms = sum(t for _, t, _ in events)
    idle = 1.0 - busy_ms / step_ms
    # the port's own kernels, by function name
    port = collections.defaultdict(lambda: [0.0, 0])
    for k, t, c in events:
        if _is_port_kernel(k):
            port[_kernel_name(k)][0] += t
            port[_kernel_name(k)][1] += c
    rec[name] = dict(
        profiled_wall_ms=wall_ms, step_ms=step_ms, device_busy_ms=busy_ms,
        device_idle_share=idle,
        device_launches=sum(c for _, _, c in events),
        top=[dict(name=k[:120], ms=t, count=c) for k, t, c in events[:12]],
        port_kernels={k: dict(ms=t, count=c) for k, (t, c) in port.items()})
    print(f"{name}: device busy {busy_ms:.2f} ms of a {step_ms:.1f} ms "
          f"step (idle share {idle:.3f}), {rec[name]['device_launches']} "
          f"device launches; the port's kernels (ms, launches): "
          f"{ {k: (round(t, 3), c) for k, (t, c) in port.items()} }")


def serve_and_compare(torch, dev, rec, arch=ARCH, label="serve",
                      need=("qq", "qi", "attn_decode"), exact=None,
                      seam_steps=0):
    """Serve ``arch`` at full width with the launch counts read around the
    call (``need`` launched at all, ``exact`` counts met), then replay the
    prompts and tokens through the plain versions.  ``seam_steps``: then
    also prefill and decode that many steps of the same tokens with the
    chains planned as the reference plans them (its 12 MiB VMEM budget:
    the per-op decode path), on the kernels, and record how far their
    logits lie from the chain's."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as srv
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_kernel_launches()
    t0 = time.perf_counter()
    toks, stats = srv.serve(arch, smoke=False, batch=BATCH, prompt_len=PROMPT,
                            gen=GEN, seed=SEED, qcache=True, quiet=True)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dispatch.kernel_launches()
    logits = stats.pop("logits")
    cfg = get_config(arch)
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    for lg in logits:
        if lg.shape != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite or misshapen logits")
    for name in need:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{label} path")
    for name, want in (exact or {}).items():
        if launches[name] != want:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches, expected {want}")
    rec[label] = dict(stats, launches=launches, tokens=toks.tolist(),
                      serve_call_s=serve_s, peak_bytes=torch.cuda.max_memory_allocated())
    print(f"{label} {cfg.name} full width: prefill {BATCH}x{PROMPT} in "
          f"{stats['prefill_s']:.4f} s, decode {stats['decode_ms_per_step']:.3f}"
          f" ms/step, {stats['tok_per_s']:.1f} tok/s, launches {launches}")

    # Replay prompts and tokens with the plain versions in place of the
    # kernels (same weights: same seed).
    policy = srv.serving_policy("int8", qcache=True)
    params = srv.load_params(cfg, policy, SEED, dev)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1))
    key = prng.key(SEED)
    prefill = make_prefill_step(cfg, policy, PROMPT + GEN, dev)
    decode = make_decode_step(cfg, policy, dev)
    dev_toks = toks.to(dev)
    _replay_serve(torch, rec, label, prefill, decode, params, prompts, key,
                  dev_toks, logits, stats["decode_ms_per_step"])
    if seam_steps:
        rec[f"{label}_seam"] = _decode_seam(
            torch, dispatch, prefill, decode, params, prompts, key, dev_toks,
            logits, seam_steps)
    return launches


def _replay_serve(torch, rec, label, prefill, decode, params, prompts, key,
                  dev_toks, logits, decode_ms):
    """Replay a serve run's prompts and tokens through ``dispatch.
    plain_kernels()`` (the kernels' plain versions, the rounding bits
    drawn by ``prng.bits``): prefill and every decode step's logits ``==``
    the kernel path's; then one kernel-path decode step under the
    profiler."""
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    t0 = time.perf_counter()
    with torch.inference_mode(), dispatch.plain_kernels():
        cache, lg0 = prefill(params, {"tokens": prompts}, prng.fold_in(key, 3))
        if not torch.equal(lg0, logits[0]):
            raise AssertionError("prefill logits: kernel path != plain path "
                                 f"(max {(lg0 - logits[0]).abs().max().item()})")
        for i in range(GEN - 1):
            lg, cache = decode(params, cache, dev_toks[:, i], PROMPT + i,
                               prng.fold_in(key, 10 + i))
            if not torch.equal(lg, logits[i + 1]):
                err = (lg - logits[i + 1]).abs().max().item()
                raise AssertionError(f"decode step {i} logits: kernel path "
                                     f"!= plain path (max {err})")
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with torch.inference_mode():
        step_profile(torch, lambda: decode(
            params, cache, dev_toks[:, -1], PROMPT + GEN - 1,
            prng.fold_in(key, 10 + GEN)), decode_ms, rec,
            "decode_step_profile" if label == "serve"
            else f"{label}_decode_step_profile")
    rec["compare" if label == "serve" else f"{label}_compare"] = dict(
        prefill_equal=True, decode_equal=True, decode_steps=GEN - 1,
        replay_call_s=replay_s, profile_call_s=time.perf_counter() - t0)
    print(f"plain-version replay: prefill and {GEN - 1} decode steps' "
          f"logits ==")


def serve_qflow_and_compare(torch, dev, rec, label="serve_qflow"):
    """Phase 15: serve full-width qwen2-0.5b under qflow (``PAPER_INT8``
    with qflow, qweights and qcache) through ``make_prefill_step`` /
    ``make_decode_step``: the prompts, keys and greedy decode of phase 3,
    the launch counts set to 0 before the weights load and read after the
    last step (``QFLOW_SERVE_LAUNCHES``), then the plain replay."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.policy import PAPER_INT8
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as srv
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    cfg = get_config(ARCH)
    policy = dataclasses.replace(PAPER_INT8, qflow=True, qweights=True,
                                 qcache=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_kernel_launches()
    t_all = time.perf_counter()
    params = srv.load_params(cfg, policy, SEED, dev)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1))
    key = prng.key(SEED)
    prefill = make_prefill_step(cfg, policy, PROMPT + GEN, dev)
    decode = make_decode_step(cfg, policy, dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, lg = prefill(params, {"tokens": prompts}, prng.fold_in(key, 3))
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        logits, toks = [lg], [tok]
        t0 = time.perf_counter()
        for i in range(GEN - 1):
            lg, cache = decode(params, cache, tok, PROMPT + i,
                               prng.fold_in(key, 10 + i))
            tok = lg.argmax(-1)
            logits.append(lg)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
    serve_s = time.perf_counter() - t_all
    launches = dispatch.kernel_launches()
    del cache
    toks = torch.stack(toks, dim=1)
    if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"{label}: bad tokens")
    for lg in logits:
        if lg.shape != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{label}: non-finite or misshapen logits")
    want = {k: v(cfg.n_layers) for k, v in QFLOW_SERVE_LAUNCHES.items()}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{label}: {launches[name]} {name} "
                                 f"launches, expected {n}")
    stats = dict(prefill_s=prefill_s, decode_s=decode_s,
                 decode_ms_per_step=1e3 * decode_s / (GEN - 1),
                 tok_per_s=BATCH * (GEN - 1) / decode_s)
    rec[label] = dict(stats, launches=launches, tokens=toks.tolist(),
                      serve_call_s=serve_s,
                      peak_bytes=torch.cuda.max_memory_allocated())
    print(f"{label} {cfg.name} full width: prefill {BATCH}x{PROMPT} in "
          f"{prefill_s:.4f} s, decode {stats['decode_ms_per_step']:.3f} "
          f"ms/step, {stats['tok_per_s']:.1f} tok/s, peak "
          f"{rec[label]['peak_bytes'] / 2 ** 30:.2f} GiB, launches {launches}")
    _replay_serve(torch, rec, label, prefill, decode, params, prompts, key,
                  toks, logits, stats["decode_ms_per_step"])
    return launches


def _decode_seam(torch, dispatch, prefill, decode, params, prompts, key,
                 dev_toks, logits, steps):
    """Prefill and ``steps`` decode steps of the same prompts, tokens and
    keys under the reference's chain plans (``chain_vmem_budget``: no
    decode block fits 12 MiB), on the kernels: the largest |dlogit|
    against the decode-block run's logits, prefill and decode apart, and
    how many greedy tokens agree."""
    from repro_torch.core import prng
    t0 = time.perf_counter()
    dev_pre, dev_dec, agree = 0.0, 0.0, 0
    with torch.inference_mode(), dispatch.chain_vmem_budget(), \
            dispatch.record_decisions() as log:
        cache, lg = prefill(params, {"tokens": prompts}, prng.fold_in(key, 3))
        dev_pre = (lg - logits[0]).abs().max().item()
        for i in range(steps):
            lg, cache = decode(params, cache, dev_toks[:, i], PROMPT + i,
                               prng.fold_in(key, 10 + i))
            dev_dec = max(dev_dec, (lg - logits[i + 1]).abs().max().item())
            agree += int((lg.argmax(-1) == logits[i + 1].argmax(-1)).sum())
    planned = {d.path for d in log if d.op == "qdecode_block"}
    if planned != {dispatch.JNP}:
        raise AssertionError(f"seam run planned the decode block {planned}")
    res = dict(decode_steps=steps, prefill_max_abs_dlogit=dev_pre,
               decode_max_abs_dlogit=dev_dec,
               logit_max_abs=max(lg_.abs().max().item() for lg_ in logits[:steps + 1]),
               greedy_tokens_equal=agree, greedy_tokens=steps * BATCH,
               seam_call_s=time.perf_counter() - t0)
    print(f"chain vs seam (decode_block vs the reference's per-op decode at "
          f"its 12 MiB budget): max |dlogit| prefill {dev_pre}, decode "
          f"{dev_dec} over {steps} steps (largest |logit| "
          f"{res['logit_max_abs']}); greedy tokens equal {agree} of "
          f"{steps * BATCH}")
    return res


def train_and_compare(torch, dev, rec, policy_name="int8", steps=TRAIN_STEPS):
    """Train full-width qwen2-0.5b under ``policy_name`` for ``steps``
    steps, the launch counts read around them, and replay the steps with
    the plain versions (losses and every state leaf ``==``)."""
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.integer_sgd import tree_items
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import TrainHyper, make_train_step
    from repro_torch.launch.train import POLICIES, train

    kw = dict(smoke=False, steps=steps, batch=TRAIN_BATCH,
              seq=TRAIN_SEQ, lr=TRAIN_LR, momentum=0.9, seed=SEED, quiet=True,
              policy_name=policy_name)
    label = "train" if policy_name == "int8" else f"train_{policy_name}"
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_kernel_launches()
        t0 = time.perf_counter()
        with dispatch.record_decisions() as log, _qq_blk_census() as shapes:
            losses, state, stats = train(ARCH, **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        if policy_name == "int8":         # for phase 9
            rec["train_leaf_sha1"] = _state_digest(state)
        launches = dispatch.kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        for name in TRAIN_KERNELS[policy_name]:
            if launches[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the "
                                     f"{label} path")
        if not all(x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"non-finite training loss {losses}")
        step_s = sorted(stats["step_s"])[len(stats["step_s"]) // 2]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        per_step = {k: v / steps for k, v in launches.items()}
        jnp = sorted({(d.op, d.reason) for d in log if d.path == dispatch.JNP})
        for name, want in EXPECTED_PER_STEP.get(policy_name, {}).items():
            if per_step[name] != want:
                raise AssertionError(f"{label}: {per_step[name]} {name} "
                                     f"launches per step, expected {want}")
        if policy_name == "int8_block" and jnp:
            raise AssertionError(f"{label}: contractions planned on the "
                                 f"plain path: {jnp}")
        print(f"{label} qwen2-0.5b full width: {steps} steps of "
              f"{TRAIN_BATCH}x{TRAIN_SEQ}, {step_s:.3f} s/step (median), "
              f"{tokens / step_s:.1f} tokens/s, losses {losses}, launches "
              f"per step {per_step}, peak memory {peak / 2**30:.2f} GiB")

        # the same steps from the same state with the kernels' plain versions
        t0 = time.perf_counter()
        with dispatch.plain_kernels():
            losses_p, state_p, stats_p = train(ARCH, **kw)
        replay_s = time.perf_counter() - t0
        if losses_p != losses:
            raise AssertionError(f"losses: kernel path {losses} != plain "
                                 f"path {losses_p}")
        for tree, tree_p in ((state.masters, state_p.masters),
                             (state.momentum, state_p.momentum)):
            for (path, q), (_, qp) in zip(tree_items(tree), tree_items(tree_p)):
                if not (torch.equal(q.m, qp.m) and torch.equal(q.e, qp.e)):
                    raise AssertionError(f"state leaf "
                                         f"{'/'.join(map(str, path))}: "
                                         "kernel path != plain path")
        del state_p
        print("plain-version replay: losses ==, every master and momentum "
              "leaf ==")

        # one more kernel-path step under the profiler
        cfg = get_config(ARCH)
        step = make_train_step(cfg, POLICIES[policy_name],
                               TrainHyper(lr=TRAIN_LR, momentum=0.9), dev)
        batch = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                            global_batch=TRAIN_BATCH,
                            seed=SEED).batch_for_step(steps)
        t0 = time.perf_counter()
        step_profile(torch, lambda: step(state, batch, prng.fold_in(
            prng.key(SEED), steps)), 1e3 * step_s, rec,
            f"{label}_step_profile")
        profile_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:200] for w in caught
                     if "deterministic" in str(w.message)})
    if shapes:
        print(f"{label}: qq_blk launches per step by (B, M, K, N, blk, "
              f"variant): {shapes}")
    rec[label] = dict(stats, losses=losses, launches=launches,
                      qq_blk_shapes={str(k): v / steps for k, v in shapes.items()},
                      launches_per_step=per_step, step_s_median=step_s,
                      tokens_per_s=tokens / step_s, peak_bytes=peak,
                      plain_replay_equal=True, jnp_decisions=jnp,
                      nondeterministic_ops=nondet, train_call_s=train_s,
                      replay_call_s=replay_s, profile_call_s=profile_s,
                      replay_step_s=stats_p["step_s"])
    return launches


class _qq_blk_census:
    """Counts each qq_blk call's (B, M, K, N, blk, variant) while open: the
    wrapper asks ``qq_blk_variant`` once a call, so the count wraps it."""

    def __enter__(self):
        import collections

        from repro_torch.kernels import fused_linear as kfl
        self.kfl, self.rule = kfl, kfl.qq_blk_variant
        self.seen = collections.Counter()

        def counted(m, n, k, blk, aligned=True, nb=1):
            v = self.rule(m, n, k, blk, aligned, nb)
            self.seen[(nb, m, k, n, blk, v)] += 1
            return v
        kfl.qq_blk_variant = counted
        return self.seen

    def __exit__(self, *exc):
        self.kfl.qq_blk_variant = self.rule


def _state_digest(state) -> dict:
    """SHA-1 of every int16 master and momentum leaf (mantissas and
    exponent) and of the step counter, on the host: enough to hold two
    runs' states ``==`` without keeping both on the card."""
    import hashlib

    from repro_torch.core.integer_sgd import tree_items
    out = {"step": hashlib.sha1(state.step.cpu().numpy().tobytes()).hexdigest()}
    for tag, tree in (("masters", state.masters), ("momentum", state.momentum)):
        for path, q in tree_items(tree):
            h = hashlib.sha1(q.m.cpu().numpy().tobytes())
            h.update(q.e.cpu().numpy().tobytes())
            out["/".join(map(str, (tag,) + path))] = h.hexdigest()
    return out


def train_step_and_compare(torch, dev, rec, label, cfg, policy, check,
                           steps=1, seam=False, data=None,
                           items=("tokens", TRAIN_BATCH * TRAIN_SEQ),
                           lr=TRAIN_LR):
    """Train ``cfg`` under ``policy`` for ``steps`` steps through
    ``make_train_step`` from the trainer's initial state, keys and batches
    (``launch.train``; ``data`` None: its ``SyntheticLM``; ``items``: the
    name and count of what a step consumes), the launch counts and
    decisions read around the
    steps and handed to ``check(log, per_step)``; then replay the steps
    from the same state with the plain versions (losses and every state
    leaf ``==``) and profile one more step.  ``seam``: then also run the
    steps with the chains planned as the reference plans them at its 12
    MiB VMEM budget (the per-op seams), on the kernels, and record |dloss|
    and the leaves that differ (the kernel path's state is kept as digests
    for that run and not returned: both states do not fit the card beside
    the step's temporaries).  Returns (launches, losses, state)."""
    import warnings

    from repro_torch.core import prng
    from repro_torch.core.integer_sgd import tree_items
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _init_state, train_hyper

    step = make_train_step(cfg, policy, train_hyper(steps, lr=lr,
                                                    momentum=0.9), dev)
    if data is None:
        data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=SEED)
    key = prng.key(SEED)

    def run():
        state = _init_state(cfg, policy, SEED, dev)
        losses, times = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, data.batch_for_step(i),
                               prng.fold_in(key, i))
            losses.append(float(loss))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return losses, state, times

    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_kernel_launches()
        t0 = time.perf_counter()
        with dispatch.record_decisions() as log:
            losses, state, times = run()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dispatch.kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        if not all(x == x and abs(x) < float("inf") for x in losses):
            raise AssertionError(f"non-finite training loss {losses}")
        per_step = {k: v / steps for k, v in launches.items()}
        check(log, per_step)
        jnp = sorted({(d.op, d.reason) for d in log if d.path == dispatch.JNP})
        step_s = sorted(times)[len(times) // 2]
        unit, count = items
        print(f"{label} {cfg.name} full width, "
              f"{getattr(cfg, 'n_layers', '-')} layers: {steps} steps of "
              f"{count} {unit}, {step_s:.3f} s/step, {count / step_s:.1f} "
              f"{unit}/s, losses {losses}, launches per step {per_step}, "
              f"peak memory {peak / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        with dispatch.plain_kernels():
            losses_p, state_p, times_p = run()
        replay_s = time.perf_counter() - t0
        if losses_p != losses:
            raise AssertionError(f"losses: kernel path {losses} != plain "
                                 f"path {losses_p}")
        for tree, tree_p in ((state.masters, state_p.masters),
                             (state.momentum, state_p.momentum)):
            for (path, q), (_, qp) in zip(tree_items(tree), tree_items(tree_p)):
                if not (torch.equal(q.m, qp.m) and torch.equal(q.e, qp.e)):
                    raise AssertionError(f"state leaf "
                                         f"{'/'.join(map(str, path))}: "
                                         "kernel path != plain path")
        del state_p
        print("plain-version replay: losses ==, every master and momentum "
              "leaf ==")
        t0 = time.perf_counter()
        step_profile(torch, lambda: step(state, data.batch_for_step(steps),
                                         prng.fold_in(key, steps)),
                     1e3 * step_s, rec, f"{label}_step_profile")
        profile_s = time.perf_counter() - t0
        if seam:
            digest = _state_digest(state)
            del state
            state = None
            torch.cuda.empty_cache()
            rec[f"{label}_seam"] = _train_seam(torch, dispatch, run, losses,
                                               digest)
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:200] for w in caught
                     if "deterministic" in str(w.message)})
    rec[label] = dict(losses=losses, step_s=times, launches=launches,
                      launches_per_step=per_step, step_s_median=step_s,
                      **{f"{unit}_per_s": count / step_s}, peak_bytes=peak,
                      n_layers=getattr(cfg, "n_layers", None),
                      plain_replay_equal=True,
                      jnp_decisions=jnp, nondeterministic_ops=nondet,
                      train_call_s=train_s, replay_call_s=replay_s,
                      profile_call_s=profile_s, replay_step_s=times_p)
    return launches, losses, state


def _train_seam(torch, dispatch, run, losses, digest):
    """The same steps with the chains planned at the reference's 12 MiB
    VMEM budget (``chain_vmem_budget``: minicpm-2b's QKV weight alone is
    15.9 MB, so qnorm and qmatmul instead of norm_gemm), on the kernels:
    |dloss| and the int16 leaves whose digest differs from the chain's."""
    t0 = time.perf_counter()
    with dispatch.chain_vmem_budget(), dispatch.record_decisions() as log:
        losses_s, state_s, _ = run()
    fused = {d.op for d in log if d.path == dispatch.FUSED
             and d.op in ("qnorm_gemm", "qmatmul_epi")}
    if fused:
        raise AssertionError(f"seam run planned a chain: {sorted(fused)}")
    digest_s = _state_digest(state_s)
    del state_s
    differ = sum(digest_s[k] != v for k, v in digest.items() if k != "step")
    res = dict(losses=losses_s, max_abs_dloss=max(
        abs(x - y) for x, y in zip(losses, losses_s)), leaves_differ=differ,
        leaves=len(digest) - 1, seam_call_s=time.perf_counter() - t0)
    print(f"chain vs seam (norm_gemm vs the reference's qnorm + qmatmul at "
          f"its 12 MiB budget): losses {losses} vs {losses_s}, |dloss| "
          f"{res['max_abs_dloss']}; {differ} of {res['leaves']} master / "
          f"momentum leaves differ")
    return res


# Decision kind -> the kernel counter a FUSED plan of that kind launches.
KIND_KERNEL = {"qq": "qq", "qi": "qi", "iq": "qi", "ii": "ii", "pp": "ii",
               "qq_epi": "gemm_epi", "norm_gemm": "norm_gemm"}


def _planned_kernels(log, dispatch):
    """The kernel launches a decision log's FUSED plans stand for: each
    contraction's by its kind, each fused-attention op's by its name."""
    import collections
    return collections.Counter(
        d.op if d.op in ("attn_fwd", "attn_bwd") else KIND_KERNEL[d.kind]
        for d in log if d.path == dispatch.FUSED)


def train_chain_and_compare(torch, dev, rec, label, arch, n_layers, want,
                            seam=False):
    """Phases 8 and 10: full-width ``arch`` cut to ``n_layers`` layers, one
    step under ``PAPER_INT8`` with ``fused_proj`` (as the JAX package's own
    chain tests reach it; the trainer has no flag for it): ``want``
    launches per step, each also the count of the step's FUSED plans of
    that kernel; no chain planned on a plain path; ``seam``: the step
    against the reference's seams too (``train_step_and_compare``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import PAPER_INT8
    from repro_torch.kernels import dispatch

    chains = {"qnorm_gemm", "qmatmul_epi"}

    def check(log, per_step):
        planned = _planned_kernels(log, dispatch)
        for name, n in want.items():
            if per_step[name] != n or planned[name] != n:
                raise AssertionError(
                    f"{label}: {per_step[name]} {name} launches and "
                    f"{planned[name]} FUSED plans per step, expected {n}")
        jnp = {d.op for d in log if d.path == dispatch.JNP}
        if jnp & chains:
            raise AssertionError(f"{label}: a chain planned on a plain "
                                 f"path: {sorted(jnp & chains)}")

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    policy = dataclasses.replace(PAPER_INT8, fused_proj=True)
    return train_step_and_compare(torch, dev, rec, label, cfg, policy,
                                  check, seam=seam)[0]


def train_qweights_and_compare(torch, dev, rec, policy_name):
    """Phases 11 and 12: full-width qwen2-0.5b, all 24 layers, one step
    under ``policy_name`` (``int8_qweights`` or ``int8_qfull``) through
    ``make_train_step`` from the trainer's state, keys and batch:
    ``QWEIGHTS_PER_STEP`` launches, each also the count of the step's
    FUSED plans of that kernel, every ``qq`` / ``qi`` / ``ii`` one on
    ``wgmma``; no weight quantized inside a GEMM (no ``qmatmul_fwd`` plan
    of kind ``qq``, nor under qflow of kind ``iq``); the plain replay
    ``==``.  ``derive_qweights`` is timed inside each step it runs in
    (train, replay, profile; the device synchronised around it)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps
    from repro_torch.launch.train import POLICIES

    label = f"train_{policy_name}"
    want = QWEIGHTS_PER_STEP[policy_name]
    policy = POLICIES[policy_name]
    banned = {"qq", "iq"} if policy.qflow else {"qq"}

    def check(log, per_step):
        planned = _planned_kernels(log, dispatch)
        for name, n in want.items():
            if per_step[name] != n or planned[name] != n:
                raise AssertionError(
                    f"{label}: {per_step[name]} {name} launches and "
                    f"{planned[name]} FUSED plans per step, expected {n}")
            if name in ("qq", "qi", "ii") and per_step[f"{name}_wgmma"] != n:
                raise AssertionError(f"{label}: {name} launches off wgmma")
        quantized = sorted({d.kind for d in log if d.op == "qmatmul_fwd"}
                           & banned)
        if quantized:
            raise AssertionError(f"{label}: a weight quantized inside a "
                                 f"GEMM (qmatmul_fwd kinds {quantized})")

    derive_ms, derive = [], steps.derive_qweights

    def timed_derive(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = derive(*args)
        torch.cuda.synchronize()
        derive_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    steps.derive_qweights = timed_derive
    try:
        launches = train_step_and_compare(torch, dev, rec, label,
                                          get_config(ARCH), policy, check)[0]
    finally:
        steps.derive_qweights = derive
    rec[label]["derive_qweights_ms"] = derive_ms
    print(f"{label}: derive_qweights {derive_ms} ms (train, replay, "
          f"profile step)")
    return launches


def train_unfused_and_compare(torch, dev, rec):
    """Phase 9: full-width qwen2-0.5b, one ``PAPER_INT8`` step under
    ``kernel_mode="unfused"`` (no trainer flag in either package):
    ``EXPECTED_PER_STEP`` launches of ``bfp_quantize`` and
    ``int8_matmul``, none of any other kernel but the rounding-bit draws
    (``_check_variants`` holds those), no plain-path decision but
    the LM head's dX; then the loss and every leaf ``==`` phase 4's fused
    step from the same state, key and batch (its digest)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import PAPER_INT8
    from repro_torch.kernels import dispatch

    label = "train_unfused"
    want = EXPECTED_PER_STEP[label]

    def check(log, per_step):
        for name, n in per_step.items():
            if name != "rounding_bits" and n != want.get(name, 0):
                raise AssertionError(f"{label}: {n} {name} launches per "
                                     f"step, expected {want.get(name, 0)}")
        jnp = [(d.op, d.reason) for d in log if d.path != dispatch.UNFUSED]
        if len(jnp) != 1 or jnp[0][0] != "qmatmul_dx" \
                or "accum_chunk" not in jnp[0][1]:
            raise AssertionError(f"{label}: contractions off the unfused "
                                 f"rung: {jnp}")

    policy = dataclasses.replace(PAPER_INT8, kernel_mode="unfused")
    launches, losses, state = train_step_and_compare(
        torch, dev, rec, label, get_config(ARCH), policy, check)
    if losses != rec["train"]["losses"][:1]:
        raise AssertionError(f"{label}: loss {losses} != phase 4's "
                             f"{rec['train']['losses'][:1]}")
    digest, want_digest = _state_digest(state), rec.pop("train_leaf_sha1")
    differ = sorted(k for k in want_digest if digest.get(k) != want_digest[k])
    if differ or digest.keys() != want_digest.keys():
        raise AssertionError(f"{label}: leaves differ from phase 4's fused "
                             f"step: {differ[:5]}")
    rec[label]["equal_to_fused_step"] = True
    print(f"{label}: loss and all {len(digest)} state digests == phase 4's "
          f"fused step")
    return launches


def _plan_variant(d, kfl):
    """The qq / qi / ii kernel variant a FUSED contraction plan launches:
    the shape rule on the kernel's (M, K); kind iq runs the qi kernel with
    the roles swapped (the weight quantized in it: M is the plan's N)."""
    return kfl.qgemm_variant(d.n if d.kind == "iq" else d.m, d.k)


def train_cnn_and_compare(torch, dev, rec, policy_name):
    """Phases 13 and 14: ResNet-18 for CIFAR (``CNN_CFG``) at full width,
    one step under ``policy_name`` (``int8`` or ``int8_qflow``) in
    ``kernel_mode="fused"`` through ``make_train_step`` from the trainer's
    state and key and ``CNN_BATCH`` ``SyntheticVision`` images:
    ``CNN_PER_STEP`` launches, each also the count of the step's FUSED
    plans; every ``__dp4a`` launch one of ``CNN_DP4A``, named by its shape;
    no plan on the plain path but the dW contractions over more than
    ``accum_chunk`` rows, each timed on it; the plain replay ``==``.  Then
    one float32 step of the same net (``make_float_train_step``) timed for
    context."""
    import collections
    import dataclasses

    from repro_torch.core import prng
    from repro_torch.core.bfp import BFP, QuantConfig
    from repro_torch.core.policy import NumericPolicy
    from repro_torch.core.qops import _contract_q
    from repro_torch.data import SyntheticVision
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.launch.steps import TrainHyper, make_float_train_step
    from repro_torch.launch.train import _init_state
    from repro_torch.models.convnet import CNNConfig

    label = "train_cnn" if policy_name == "int8" else "train_cnn_qflow"
    cfg = CNNConfig(**CNN_CFG)
    policy = NumericPolicy(qflow=policy_name == "int8_qflow",
                           kernel_mode="fused")
    want = CNN_PER_STEP[policy_name]
    plain_plans = []

    def check(log, per_step):
        planned = _planned_kernels(log, dispatch)
        dp4a = collections.Counter(
            (d.op, d.m, d.k, d.n, d.kind) for d in log
            if d.path == dispatch.FUSED and d.kind in KIND_KERNEL
            and KIND_KERNEL[d.kind] in ("qq", "qi", "ii")
            and _plan_variant(d, kfl) == "dp4a")
        if dict(dp4a) != CNN_DP4A:
            raise AssertionError(f"{label}: __dp4a plans {dict(dp4a)}, "
                                 f"expected {CNN_DP4A}")
        for name, n in want.items():
            n_dp4a = sum(c for key, c in CNN_DP4A.items()
                         if KIND_KERNEL[key[4]] == name)
            if per_step[name] != n or planned[name] != n \
                    or per_step[f"{name}_dp4a"] != n_dp4a:
                raise AssertionError(
                    f"{label}: {per_step[name]} {name} launches "
                    f"({per_step[f'{name}_dp4a']} on __dp4a) and "
                    f"{planned[name]} FUSED plans per step, expected {n} "
                    f"({n_dp4a})")
        for d in log:
            if d.path == dispatch.JNP:
                if "accum_chunk" not in d.reason:
                    raise AssertionError(f"{label}: {d.op} planned on the "
                                         f"plain path: {d.reason}")
                plain_plans.append((d.op, d.m, d.k, d.n, d.kind))

    data = SyntheticVision(img=cfg.img, batch=CNN_BATCH, seed=SEED)
    launches = train_step_and_compare(
        torch, dev, rec, label, cfg, policy, check, data=data,
        items=("images", CNN_BATCH), lr=CNN_LR)[0]
    print(f"{label}: __dp4a launches per step by (op, M, K, N, kind): "
          f"{CNN_DP4A}")

    # the plans on the plain chunked path (dW over 131072 rows), timed
    g = torch.Generator(device=dev).manual_seed(5)
    plain = []
    for (op, m, k, n, kind), count in sorted(
            collections.Counter(plain_plans).items()):
        aq, bq = (BFP(torch.randint(-127, 128, (r, k), generator=g,
                                    device=dev, dtype=torch.int8),
                      torch.tensor(120, device=dev), QuantConfig())
                  for r in (m, n))
        ms = _device_ms(torch, lambda: _contract_q(aq, bq, 0, 65536), iters=3)
        plain.append(dict(op=op, shape=[m, k, n], kind=kind, per_step=count,
                          ms=ms))
        del aq, bq
    torch.cuda.empty_cache()
    print(f"{label}: plans on the plain chunked path (K > accum_chunk), "
          f"device ms each: {[(p['op'], p['shape'], p['per_step'], round(p['ms'], 3)) for p in plain]}")

    # one float32 step of the same net, for context (the second of two)
    fstep = make_float_train_step(
        cfg, TrainHyper(lr=CNN_LR, momentum=0.9), dev)
    carry = _init_state(cfg, dataclasses.replace(policy, enabled=False),
                        SEED, dev)
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, floss = fstep(carry, data.batch_for_step(i),
                             prng.fold_in(prng.key(SEED), i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    del carry
    torch.cuda.empty_cache()
    rec[label].update(plain_chunked_plans=plain, float32_step_s=times,
                      float32_loss=float(floss), dp4a_plans={
                          str(k): v for k, v in CNN_DP4A.items()})
    print(f"{label}: float32 step of the same net {times[-1]:.3f} s (the "
          f"second of two; loss {float(floss):.4f})")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is false")
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "kernels", "csrc")):
        return _fail(f"no src/repro_torch beside {__file__}")
    sys.path.insert(0, src)
    from repro_torch.kernels import build, dispatch

    # cuBLAS is deterministic only with a fixed workspace (phase 4)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    reports = build.build()
    rec["build_s"] = time.perf_counter() - t0
    rec["nvcc"] = reports
    print(f"build: {sorted(build.SOURCES)} in {rec['build_s']:.1f} s")

    phases = [("kernels", lambda: check_kernels(torch, dev, rec)),
              ("serve", lambda: serve_and_compare(torch, dev, rec)),
              ("train", lambda: train_and_compare(torch, dev, rec)),
              ("train_int8_qflow", lambda: train_and_compare(
                  torch, dev, rec, "int8_qflow", steps=TRAIN_STEPS_QFLOW)),
              ("train_int8_block", lambda: train_and_compare(
                  torch, dev, rec, "int8_block")),
              ("serve_minicpm", lambda: serve_and_compare(
                  torch, dev, rec, CHAIN_ARCH, "serve_minicpm",
                  need=("qq", "qi", "decode_block"),
                  exact={"decode_block": 40 * (GEN - 1), "attn_decode": 0},
                  seam_steps=SEAM_DECODE_STEPS)),
              ("train_fused_proj", lambda: train_chain_and_compare(
                  torch, dev, rec, "train_fused_proj", CHAIN_ARCH,
                  CHAIN_TRAIN_LAYERS, CHAIN_PER_STEP, seam=True)),
              ("train_unfused", lambda: train_unfused_and_compare(
                  torch, dev, rec)),
              ("train_fused_proj_gelu", lambda: train_chain_and_compare(
                  torch, dev, rec, "train_fused_proj_gelu", GELU_ARCH,
                  GELU_TRAIN_LAYERS, GELU_PER_STEP)),
              ("train_int8_qweights", lambda: train_qweights_and_compare(
                  torch, dev, rec, "int8_qweights")),
              ("train_int8_qfull", lambda: train_qweights_and_compare(
                  torch, dev, rec, "int8_qfull")),
              ("train_cnn", lambda: train_cnn_and_compare(
                  torch, dev, rec, "int8")),
              ("train_cnn_qflow", lambda: train_cnn_and_compare(
                  torch, dev, rec, "int8_qflow")),
              ("serve_qflow", lambda: serve_qflow_and_compare(
                  torch, dev, rec))]
    # the CNN phases' __dp4a launches (CNN_DP4A), by kernel: the only main
    # path K that is not a multiple of 16 (the stem's 27 and the head's dX
    # 10), which the variant rule itself sends to __dp4a; the other phases
    # keep 0
    cnn_dp4a = collections.Counter()
    for key, count in CNN_DP4A.items():
        cnn_dp4a[KIND_KERNEL[key[4]]] += count
    results, rec["phase_s"] = {}, {}
    for name, run in phases:
        t1 = time.perf_counter()
        results[name] = run()
        if name != "kernels":
            _check_variants(name, results[name],
                            cnn_dp4a if name.startswith("train_cnn") else None)
        rec["phase_s"][name] = time.perf_counter() - t1
        print(f"phase {name}: {rec['phase_s'][name]:.1f} s")
    kernels = results.pop("kernels")
    by_path = results
    line = []
    for kern in kernels:
        # extra shapes of a kernel stay in the json record; a row that
        # stands for a qi / ii variant goes on the line under its name too
        for name in [kern["name"]] + kern.get("line_as", []):
            if name not in dispatch.kernel_launches():
                continue
            line.append({k: kern[k] for k in (
                "route", "source", "replaces", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
                "act", "variant") if k in kern}
                | {"name": name,
                   "launches": sum(p[name] for p in by_path.values()),
                   "launches_by_path": {k: p[name]
                                        for k, p in by_path.items()}})
    rec["kernels"] = kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rec["nvidia_smi"] = smi
    rec["total_s"] = time.perf_counter() - t0
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
