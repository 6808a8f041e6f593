#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU (one card).

    python3 chip_smoke.py

Phases, any of which failing exits non-zero:

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
2. call each kernel at the shapes the serving and training paths give it
   and hold it against its plain torch version on the same inputs: ``qq``,
   ``qi`` and ``ii`` y and mantissas ``==``, ``attn_decode`` y ``==``,
   ``attn_fwd`` (y, m, l) and ``attn_bwd`` (dq, dk, dv) ``==``
   at the qwen2 training slice and at an odd shape, ``qq_blk`` y and
   mantissas ``==`` at the per-block training shapes and odd ones (blocks
   of 128 and 32, more than 32 blocks, a batch, both rounding modes, with
   and without residuals, a flushed block scale); time kernel, plain
   version and one library call where there is one, and compute the
   card's bound for the same work;
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
   kernels): ``TRAIN_STEPS_QFLOW`` (3) steps, the launch counts read
   around them, the plain
   replay ``==`` in losses and every master and momentum leaf;
6. the same for ``int8_block`` training (one exponent per 128 elements of
   each contraction axis): one step, every per-block contraction, forward
   and A.2 backward, on ``qq_blk`` and the per-tensor rest on ``qq``
   (``EXPECTED_PER_STEP`` launches), no contraction planned on a plain
   path, the plain replay ``==``;
7. serve full-width minicpm-2b (all 40 layers, random weights): 4 prompts
   x 128 tokens, 32 greedy tokens, int8 weights and KV cache; every decode
   step runs each layer as one ``decode_block`` launch (1240 in all); the
   plain replay as in phase 3;
8. train full-width minicpm-2b cut to ``CHAIN_TRAIN_LAYERS`` layers under
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
   on a plain path, the plain replay ``==``.

Phase 2 also holds ``gemm_epi`` (y, mantissas, ylin), ``norm_gemm`` (y,
xq, meta, c) and ``decode_block`` (x_out and the fresh cache rows) ``==``
at the shapes of phases 7, 8 and 10 (the SiLU- and GELU-GLU) and at odd
ones (relu, gelu, an odd GLU half), and ``bfp_quantize``
(mantissas) and ``int8_matmul`` (y) ``==`` at the shapes of phase 9 and at
odd ones (edge values, a batch, unaligned operands).

Kernel, plain and library times are device times from ``torch.profiler``
(the sum of the CUDA kernels each call launches, per call); the wrapper's
whole call, host included, is timed with CUDA events as ``call_ms``.

It prints one JSON line of kernel results, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  A fuller
record goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# H100 SXM published peaks: HBM bytes/s, dense int8 op/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

ARCH, BATCH, PROMPT, GEN, SEED = "qwen2_0_5b", 4, 128, 32, 0
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 1, 4, 128, 0.05
# Phase 5 (int8_qflow) steps: its replay is the card's only check of the
# attention kernels once momentum is non-zero and the masters have moved.
# The other training phases take TRAIN_STEPS (phase 4 was cut from 3 to 1
# when phase 5 pushed the script past 900 s of its 1200 s; PERF.md).
TRAIN_STEPS_QFLOW = 3
# Kernels each training phase must launch.
TRAIN_KERNELS = {"int8": ("qq", "qi", "ii"),
                 "int8_qflow": ("qq", "qi", "ii", "attn_fwd", "attn_bwd"),
                 "int8_block": ("qq", "qq_blk")}
# Launches per int8_block step (qwen2-0.5b, 4 x 128 tokens): 25 per-block
# contractions a layer (7 projections x forward, dX, dW; QKᵀ's dA and dB;
# PV's forward and dB) and 3 of the tied LM head; QKᵀ's forward and PV's
# dA contract the head dim 64, per tensor.
EXPECTED_PER_STEP = {"int8_block": {"qq_blk": 24 * 25 + 3, "qq": 24 * 2,
                                    "qi": 0, "ii": 0},
                     # phase 9: per layer 9 contractions (7 projections,
                     # QKᵀ, PV) a direction, qq forward (2 quantizes), qi
                     # dX (1), ii dW (0); the LM head's forward and dW, its
                     # dX (K = vocab > accum_chunk) on the plain path
                     "train_unfused": {"bfp_quantize": 24 * 27 + 2,
                                       "int8_matmul": 24 * 27 + 2}}
# Phases 7 and 8: minicpm-2b.  Training keeps full width and cuts the
# depth from 40 to 24 layers (PERF.md §4: the int64 rounding-bit
# temporaries grow with the stacked layer leaves; 24 layers fit the card's
# 80 GB, 40 would not).
CHAIN_ARCH, CHAIN_TRAIN_LAYERS = "minicpm_2b", 24
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


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def _device_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call: every CUDA kernel the call launches, summed,
    from torch.profiler.  Raises if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for _, us in _device_events(prof))
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / iters / 1e3


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


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
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

    # qi: the tied LM head at decode, and the MLP gate/up at prefill.
    for name, (nb, m, k, n) in (("qi", (1, BATCH, 896, 151936)),
                                ("qi_prefill_gate", (1, BATCH * PROMPT, 896, 4864))):
        a = torch.randn((nb, m, k), generator=g, device=dev)
        ra = bits(1, a.shape)
        b_m = torch.randint(-127, 128, (nb, n, k), generator=g, device=dev,
                            dtype=torch.int8)
        ea = ref.max_biased_exp_ref(a)
        eb = torch.tensor(130, dtype=torch.int32, device=dev)
        y, am = kfl.fused_qi_pt(a, ra, b_m, ea, eb)
        yp, amp = kfl.fused_qi_pt_plain(a, ra, b_m, ea, eb)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        if not (torch.equal(y, yp) and torch.equal(am, amp)):
            raise AssertionError(f"{name}: kernel != plain (max |dy| {err})")
        ra32 = kfl.as_u32(ra)
        ms = _device_ms(torch, lambda: kfl.fused_qi_pt(a, ra32, b_m, ea, eb))
        call = _time_ms(torch, lambda: kfl.fused_qi_pt(a, ra32, b_m, ea, eb))
        pms = _device_ms(torch, lambda: kfl.fused_qi_pt_plain(a, ra, b_m, ea, eb), iters=3)
        lib = _int_mm_ms(torch, am, b_m)
        nbytes = nb * (8 * m * k + n * k + 4 * m * n + m * k)
        bound, by = _bound_ms(nbytes, 2.0 * nb * m * n * k)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/fused_linear.cu",
                        replaces="src/repro/kernels/fused_linear.py:241",
                        shape=[nb, m, k, n], max_abs_err=err, ms=ms,
                        call_ms=call, plain_ms=pms, bound_ms=bound,
                        bound_by=by, library_ms=lib))

    # qq: the batched QKᵀ of the prefill attention (B*Hkv slices of
    # (g*S, D) x (T, D)): stochastic and half up, with and without the
    # mantissa residuals.
    nb, m, k, n = BATCH * 2, 7 * PROMPT, 64, PROMPT
    a = torch.randn((nb, m, k), generator=g, device=dev)
    b = torch.randn((nb, n, k), generator=g, device=dev)
    ra, rb = bits(2, a.shape), bits(3, b.shape)
    ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
    res = kfl.fused_qq_pt(a, ra, b, rb, ea, eb)
    resp = kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb)
    resn = kfl.fused_qq_pt(a, None, b, None, ea, eb, stochastic=False)
    resnp = kfl.fused_qq_pt_plain(a, None, b, None, ea, eb, stochastic=False)
    y_only = kfl.fused_qq_pt(a, ra, b, rb, ea, eb, emit_residuals=False)[0]
    torch.cuda.synchronize()
    err = max((res[0] - resp[0]).abs().max().item(),
              (resn[0] - resnp[0]).abs().max().item())
    for x, y in list(zip(res, resp)) + list(zip(resn, resnp)) + [(y_only, resp[0])]:
        if not torch.equal(x, y):
            raise AssertionError(f"qq: kernel != plain (max |dy| {err})")
    ra32, rb32 = kfl.as_u32(ra), kfl.as_u32(rb)
    ms = _device_ms(torch, lambda: kfl.fused_qq_pt(a, ra32, b, rb32, ea, eb))
    call = _time_ms(torch, lambda: kfl.fused_qq_pt(a, ra32, b, rb32, ea, eb))
    pms = _device_ms(torch, lambda: kfl.fused_qq_pt_plain(a, ra, b, rb, ea, eb), iters=3)
    lib = _int_mm_ms(torch, res[1], res[2])
    nbytes = nb * (8 * m * k + 8 * n * k + 4 * m * n + m * k + n * k)
    bound, by = _bound_ms(nbytes, 2.0 * nb * m * n * k)
    out.append(dict(name="qq", route="cuda",
                    source="src/repro_torch/kernels/csrc/fused_linear.cu",
                    replaces="src/repro/kernels/fused_linear.py:188",
                    shape=[nb, m, k, n], max_abs_err=err, ms=ms, call_ms=call,
                    plain_ms=pms, bound_ms=bound, bound_by=by,
                    library_ms=lib))

    # ii: the training dW = X̂ᵀĜ over the 512 tokens of a 4 x 128 batch, at
    # the tied LM head (d_model x vocab) and at one layer's w_down.
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for name, (m, n) in (("ii", (896, 151936)), ("ii_w_down", (4864, 896))):
        am = torch.randint(-127, 128, (1, m, tokens), generator=g, device=dev,
                           dtype=torch.int8)
        b_m = torch.randint(-127, 128, (1, n, tokens), generator=g, device=dev,
                            dtype=torch.int8)
        ea = torch.tensor(121, dtype=torch.int32, device=dev)
        eb = torch.tensor(117, dtype=torch.int32, device=dev)
        y = kfl.fused_ii_pt(am, b_m, ea, eb)
        yp = kfl.fused_ii_pt_plain(am, b_m, ea, eb)
        torch.cuda.synchronize()
        err = (y - yp).abs().max().item()
        if not torch.equal(y, yp):
            raise AssertionError(f"{name}: kernel != plain (max |dy| {err})")
        del y, yp
        ms = _device_ms(torch, lambda: kfl.fused_ii_pt(am, b_m, ea, eb))
        call = _time_ms(torch, lambda: kfl.fused_ii_pt(am, b_m, ea, eb))
        pms = _device_ms(torch, lambda: kfl.fused_ii_pt_plain(am, b_m, ea, eb), iters=2)
        lib = _int_mm_ms(torch, am, b_m)
        nbytes = m * tokens + n * tokens + 4 * m * n
        bound, by = _bound_ms(nbytes, 2.0 * m * n * tokens)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/fused_linear.cu",
                        replaces="src/repro/kernels/fused_linear.py:279",
                        shape=[1, m, tokens, n], max_abs_err=err, ms=ms,
                        call_ms=call, plain_ms=pms, bound_ms=bound,
                        bound_by=by, library_ms=lib))
        del am, b_m

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

    # attn_decode: the qwen2 decode slice, B*Hkv = 8, GS = 7, D = 64, T = 160.
    bh, gs, d, t, pos = BATCH * 2, 7, 64, PROMPT + GEN, PROMPT + GEN - 1
    qm = torch.randint(-127, 128, (bh, gs, d), generator=g, device=dev, dtype=torch.int8)
    km = torch.randint(-127, 128, (bh, t, d), generator=g, device=dev, dtype=torch.int8)
    vm = torch.randint(-127, 128, (bh, t, d), generator=g, device=dev, dtype=torch.int8)
    ek = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev, dtype=torch.int32)
    ev = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev, dtype=torch.int32)
    rp = bits(4, (bh, gs, t))
    eq = torch.tensor(122, dtype=torch.int32, device=dev)
    kw = dict(p=7, s=1, causal=True, window=0, stochastic=True)
    y = kfa.attn_decode(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    yp = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw)
    torch.cuda.synchronize()
    err = (y - yp).abs().max().item()
    if not torch.equal(y, yp):
        raise AssertionError(f"attn_decode: kernel != plain (max |dy| {err})")
    rp32 = kfl.as_u32(rp)
    ms = _device_ms(torch, lambda: kfa.attn_decode(qm, km, vm, ek, ev, rp32, eq, pos, t, **kw))
    call = _time_ms(torch, lambda: kfa.attn_decode(qm, km, vm, ek, ev, rp32, eq, pos, t, **kw))
    pms = _device_ms(torch, lambda: kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, pos, t, **kw), iters=3)
    nbytes = bh * (gs * d + 2 * t * d + 8 * t + 4 * gs * t + 4 * gs * d) + 4
    bound, by = _bound_ms(nbytes, 2.0 * 2 * bh * gs * t * d)
    out.append(dict(name="attn_decode", route="cuda",
                    source="src/repro_torch/kernels/csrc/fused_attention.cu",
                    replaces="src/repro/kernels/fused_attention.py:503",
                    shape=[bh, gs, t, d], max_abs_err=err, ms=ms,
                    call_ms=call, plain_ms=pms,
                    bound_ms=bound, bound_by=by, library_ms=None,
                    library_note="no single PyTorch call computes int8 "
                                 "scores, softmax, the per-row p quantize "
                                 "and int8 PV"))
    out += check_attn_train(torch, dev, g, bits)
    out += check_qq_blk(torch, dev, g, bits)
    out += check_chain(torch, dev, g, bits)
    out += check_unfused(torch, dev, g, bits)
    return out


def _record_kernel(torch, name, source, replaces, shape, err, kernel, plain,
                   nbytes, ops, library_ms, note=None, plain_iters=3):
    """Time a kernel call and its plain version; the row of the kernels
    line."""
    ms = _device_ms(torch, kernel)
    call = _time_ms(torch, kernel)
    pms = _device_ms(torch, plain, iters=plain_iters)
    bound, by = _bound_ms(nbytes, ops)
    print(f"{name} {shape}: {ms:.4f} ms device time (bound {bound:.5f} ms by "
          f"{by}; plain {pms:.3f} ms; library {library_ms}), kernel == plain")
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               shape=shape, max_abs_err=err, ms=ms, call_ms=call,
               plain_ms=pms, bound_ms=bound, bound_by=by, bytes=nbytes,
               ops=ops, library_ms=library_ms)
    if note:
        row["library_note"] = note
    return row


def check_chain(torch, dev, g, bits):
    """gemm_epi, norm_gemm and decode_block against their plain versions
    at the minicpm-2b shapes of phases 7 and 8, gemm_epi also at the
    starcoder2-7b shape of phase 10, and at odd ones, ``==``; timed at the
    minicpm-2b and starcoder2-7b shapes."""
    from repro_torch.kernels import fused_chain as kfc
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    src_lin = "src/repro_torch/kernels/csrc/fused_linear.cu"
    src_chain = "src/repro_torch/kernels/csrc/fused_chain.cu"
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = []

    # gemm_epi: the gate|up GEMM + GLU of training, minicpm-2b's SiLU
    # (512 x 2304 -> 2 x 5760) and starcoder2-7b's GELU (512 x 4608 -> 2 x
    # 18432), timed under the kernel's name; then odd shapes with a bias
    # (an odd GLU half, relu, gelu), both roundings, the gelu one timed
    # for the record only
    for label, (m, k, n, act, with_bias), row in (
            ("train", (tokens, 2304, 2 * 5760, "silu_glu", False), "gemm_epi"),
            ("train_gelu_glu", (tokens, 4608, 2 * 18432, "gelu_glu", False),
             "gemm_epi"),
            ("odd", (37, 67, 58, "silu_glu", True), None),
            ("odd_gelu_glu", (37, 67, 58, "gelu_glu", True), None),
            ("odd_relu", (130, 96, 70, "relu", True), None),
            ("odd_gelu", (130, 96, 70, "gelu", True), "gemm_epi_gelu_odd")):
        a = torch.randn((m, k), generator=g, device=dev)
        b = torch.randn((n, k), generator=g, device=dev)
        a[1] *= 300.0            # a sub-normal logistic, a saturated tanh
        bias = (torch.randn((1, n), generator=g, device=dev) if with_bias
                else None)
        ra, rb = bits(14, a.shape), bits(15, b.shape)
        ea, eb = ref.max_biased_exp_ref(a), ref.max_biased_exp_ref(b)
        err = 0.0
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(stochastic=sr, act=act)
            got = kfl.fused_gemm_epi(a, r[0], b, r[1], bias, None, ea, eb, **kw)
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
            torch, row, src_lin, "src/repro/kernels/fused_linear.py:556",
            [m, k, n], err,
            lambda: kfl.fused_gemm_epi(a, a32, b, b32, bias, None, ea, eb, **kw),
            lambda: kfl.fused_gemm_epi_plain(a, ra, b, rb, bias, None, ea, eb,
                                             **kw),
            nbytes, 2.0 * m * n * k, _int_mm_ms(torch, want[1][None], want[2][None]),
            f"no single PyTorch call quantizes, contracts and applies the "
            f"{act} epilogue; library_ms times torch._int_mm of the same "
            "mantissas"))
        out[-1]["act"] = act
        del a, b, ra, rb, a32, b32, got, want

    # norm_gemm: the QKV chain of training (512 x 2304 -> 6912), then odd
    # shapes: LayerNorm with a shift, rows off every strip, K off the
    # slice, both roundings
    for label, (m, k, n, center, with_beta) in (
            ("train", (tokens, 2304, 6912, False, False)),
            ("odd", (37, 100, 70, True, True)),
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
        err = 0.0
        for sr in (True, False):
            r = (rin, rout) if sr else (None, None)
            args = (x, r[0], r[1], gm, se_g, bm, se_b, wm, se_w)
            got = kfc.fused_norm_gemm(*args, n=k, center=center)
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
            torch, "norm_gemm", src_chain, "src/repro/kernels/fused_chain.py:299",
            [m, k, n], err, lambda: kfc.fused_norm_gemm(*args32, n=k),
            lambda: kfc.norm_gemm_plain(*args, n=k), nbytes, 2.0 * m * n * k,
            _int_mm_ms(torch, want[1][None], wm[None]),
            "no single PyTorch call computes the integer norm and the "
            "per-row quantize; library_ms times torch._int_mm of xq and "
            "the weight"))
        del x, rin, rout, got, want

    # decode_block: one minicpm-2b layer for 4 streams at the last decode
    # position of phase 7, then GQA groups of 4 with a window
    for label, (b, d, n_ff, hq, hkv, dh, t, pos, window) in (
            ("serve", (BATCH, 2304, 5760, 36, 36, 64, PROMPT + GEN,
                       PROMPT + GEN - 1, 0)),
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
        got = kfc.fused_decode_block(*args, **kw)
        want = kfc.decode_block_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got[0] - want[0]).abs().max().item()
        if not all(torch.equal(x_, y_) for x_, y_ in zip(got, want)):
            raise AssertionError(f"decode_block {label}: kernel != plain "
                                 f"(max |dx_out| {err})")
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
          "(odd shapes untimed)")
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
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = []
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
    # odd ones
    qrows = 14 // 2 * TRAIN_SEQ
    for name, (nb, m, k, n) in (
            ("int8_matmul", (1, tokens, 896, 4864)),
            ("int8_matmul_lm_head", (1, tokens, 896, 151936)),
            ("int8_matmul_lm_head_dw", (1, 896, tokens, 151936)),
            ("qbmm_qk", (TRAIN_BATCH * 2, qrows, 64, TRAIN_SEQ)),
            ("qbmm_pv", (TRAIN_BATCH * 2, qrows, TRAIN_SEQ, 64)),
            ("qbmm_qk_dw", (TRAIN_BATCH * 2, 64, qrows, TRAIN_SEQ)),
            ("odd", (3, 37, 67, 29)), ("odd_k", (1, 5, 33, 130)),
            ("odd_batch", (2, 130, 96, 70))):
        am = torch.randint(-127, 128, (nb, m, k), generator=g, device=dev,
                           dtype=torch.int8)
        bm = torch.randint(-127, 128, (nb, n, k), generator=g, device=dev,
                           dtype=torch.int8)
        err = 0.0
        for e in (-20, -150):             # -150: the scale flushes to 0
            scale = kfl.pow2_f32(torch.tensor(e, device=dev))
            got = kim.int8_matmul(am, bm, scale)
            want = kim.int8_matmul_plain(am, bm, scale)
            torch.cuda.synchronize()
            err = max(err, (got - want).abs().max().item())
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul {name}: kernel != plain "
                                     f"(max |dy| {err})")
        del got, want
        if not name.startswith("int8_matmul"):
            continue
        scale = kfl.pow2_f32(torch.tensor(-20, device=dev))
        pairs = [(am[i], bm[i].t()) for i in range(nb)]
        try:                              # the yardstick only; not the port
            lib = _device_ms(torch, lambda: [torch._int_mm(a, b) * scale
                                             for a, b in pairs], iters=5)
        except RuntimeError as err_lib:
            print(f"library call unavailable: {err_lib}", file=sys.stderr)
            lib = None
        out.append(_record_kernel(
            torch, name, src_m, "src/repro/kernels/int8_matmul.py:47",
            [nb, m, k, n], err, lambda: kim.int8_matmul(am, bm, scale),
            lambda: kim.int8_matmul_plain(am, bm, scale),
            nb * (m * k + n * k + 4 * m * n) + 4, 2.0 * nb * m * n * k, lib,
            "library_ms: torch._int_mm of the same mantissas times the "
            "scale", plain_iters=2))
        del am, bm
    print("bfp_quantize and int8_matmul == plain at every shape (qbmm and "
          "odd shapes untimed)")
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


def check_qq_blk(torch, dev, g, bits):
    """qq_blk against its plain version, y and both mantissa arrays ==:
    stochastic with residuals, half up, and y alone; the first block of
    row 0 of both operands is tiny, so its scale 2^(sa + sb) is below
    2^-126 and flushes to 0.  Timed at the gate's forward, the tied LM
    head's forward and its dX over 1187 blocks of the vocabulary."""
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref

    tokens = TRAIN_BATCH * TRAIN_SEQ
    # name: (B, M, K, N, blk, residuals); the names starting with qq_blk
    # are timed
    shapes = {"qq_blk": (1, tokens, 896, 4864, 128, True),
              "qq_blk_lm_head": (1, tokens, 896, 151936, 128, True),
              "qq_blk_lm_head_dx": (1, tokens, 151936, 896, 128, False),
              "pv": (TRAIN_BATCH * 2, 7 * TRAIN_SEQ, TRAIN_SEQ, 64, 128, True),
              "odd": (2, 37, 40 * 32, 29, 32, True)}
    out = []
    for name, (nb, m, k, n, blk, res) in shapes.items():
        a = torch.randn((nb, m, k), generator=g, device=dev)
        b = torch.randn((nb, n, k), generator=g, device=dev)
        a[:, 0, :blk] *= 2.0 ** -70
        b[:, 0, :blk] *= 2.0 ** -70
        ra, rb = bits(8, a.shape), bits(9, b.shape)
        ea = ref.max_biased_exp_blocks_ref(a, blk)
        eb = ref.max_biased_exp_blocks_ref(b, blk)
        if int(kfl.scale_exp(ea[0, 0, 0], 7) + kfl.scale_exp(eb[0, 0, 0], 7)) >= -126:
            raise AssertionError(f"{name}: the flush case is not below 2^-126")
        err = 0.0
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(blk=blk, stochastic=sr)
            got = kfl.fused_qq_blk(a, r[0], ea, b, r[1], eb, **kw)
            want = kfl.fused_qq_blk_plain(a, r[0], ea, b, r[1], eb, **kw)
            y_only = kfl.fused_qq_blk(a, r[0], ea, b, r[1], eb,
                                      emit_residuals=False, **kw)[0]
            torch.cuda.synchronize()
            err = max(err, (got[0] - want[0]).abs().max().item())
            for x, y in list(zip(got, want)) + [(y_only, want[0])]:
                if not torch.equal(x, y):
                    raise AssertionError(f"{name}: qq_blk kernel != plain "
                                         f"(max |dy| {err})")
        if name.startswith("qq_blk"):
            out.append(_time_qq_blk(torch, kfl, name, (a, ra, ea, b, rb, eb),
                                    want[1], want[2], blk, res, err))
        del a, b, ra, rb, got, want, y_only
        torch.cuda.empty_cache()
    print("qq_blk == plain at every shape (pv and odd shapes untimed)")
    return out


def _time_qq_blk(torch, kfl, name, args, am, bm, blk, res, err):
    a, ra, ea, b, rb, eb = args
    nb, m, k = a.shape
    n = b.shape[1]
    args32 = (a, kfl.as_u32(ra), ea, b, kfl.as_u32(rb), eb)
    kw = dict(blk=blk, emit_residuals=res)
    ms = _device_ms(torch, lambda: kfl.fused_qq_blk(*args32, **kw))
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
    return dict(name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/fused_linear.cu",
                replaces="src/repro/kernels/fused_linear.py:367",
                shape=[nb, m, k, n], blk=blk, residuals=res, max_abs_err=err,
                ms=ms, call_ms=call, plain_ms=pms, bound_ms=bound,
                bound_by=by, bytes=nbytes, library_ms=None,
                int_mm_blocks_ms=blocks_ms,
                library_note="no single PyTorch call applies a scale per "
                             "row and block inside the contraction; "
                             "int_mm_blocks_ms times one torch._int_mm per "
                             "block, summed unscaled")


def check_attn_train(torch, dev, g, bits):
    """attn_fwd and attn_bwd against their plain versions: the qwen2
    training slice (B*Hkv = 8, GS = 7 x 128, T = 128, D = 64, causal) and
    an odd shape (GS = 21, T = 200, kv_len = 170, two KV blocks, not
    causal); timed at the training slice."""
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
        got = kfa.attn_fwd(*fwd, **kw)
        want = kfa.attn_fwd_plain(*fwd, **kw)
        torch.cuda.synchronize()
        err_f = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"attn_fwd {label}: kernel != plain "
                                 f"(max |d| {err_f})")
        _, m, l = want
        delta = torch.randn((bh, gs, 1), generator=g, device=dev) * 1e-3
        bwd = (qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, 0, kv_len)
        got = kfa.attn_bwd(*bwd, **kw)
        want = kfa.attn_bwd_plain(*bwd, **kw)
        torch.cuda.synchronize()
        err_b = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"attn_bwd {label}: kernel != plain "
                                 f"(max |d| {err_b})")
        if label == "train":
            timed = dict(fwd=fwd, bwd=bwd, kw=kw, err_f=err_f, err_b=err_b,
                         shape=[bh, gs, t, d], kv_len=kv_len, s=s,
                         causal=causal)

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
        ms = _device_ms(torch, lambda: fn(*args[0], **kw))
        call = _time_ms(torch, lambda: fn(*args[0], **kw))
        pms = _device_ms(torch, lambda: plain(*args[1], **kw), iters=3)
        bound, by = _bound_ms(nbytes, ops)
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/attn_train.cu",
                        replaces=f"src/repro/kernels/fused_attention.py:{line}",
                        shape=[bh, gs, t, d], max_abs_err=err, ms=ms,
                        call_ms=call, plain_ms=pms, bound_ms=bound,
                        bound_by=by, bytes=nbytes, ops=ops,
                        library_ms=None,
                        library_note="no single PyTorch call computes int8 "
                                     "scores, the online softmax and the "
                                     "in-kernel quantizations"))
        print(f"{name}: {ms:.4f} ms device time (bound {bound:.5f} ms by "
              f"{by}; plain {pms:.3f} ms), kernel == plain at both shapes")
    return out


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
    rec[name] = dict(
        profiled_wall_ms=wall_ms, step_ms=step_ms, device_busy_ms=busy_ms,
        device_idle_share=idle,
        device_launches=sum(c for _, _, c in events),
        top=[dict(name=k[:120], ms=t, count=c) for k, t, c in events[:12]])
    print(f"{name}: device busy {busy_ms:.2f} ms of a {step_ms:.1f} ms "
          f"step (idle share {idle:.3f}), {rec[name]['device_launches']} "
          f"device launches")


def serve_and_compare(torch, dev, rec, arch=ARCH, label="serve",
                      need=("qq", "qi", "attn_decode"), exact=None):
    """Serve ``arch`` at full width with the launch counts read around the
    call (``need`` launched at all, ``exact`` counts met), then replay the
    prompts and tokens through the plain versions."""
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
            prng.fold_in(key, 10 + GEN)), stats["decode_ms_per_step"], rec,
            "decode_step_profile" if label == "serve"
            else f"{label}_decode_step_profile")
    rec["compare" if label == "serve" else f"{label}_compare"] = dict(
        prefill_equal=True, decode_equal=True, decode_steps=GEN - 1,
        replay_call_s=replay_s, profile_call_s=time.perf_counter() - t0)
    print(f"plain-version replay: prefill and {GEN - 1} decode steps' "
          f"logits ==")
    return launches


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
        with dispatch.record_decisions() as log:
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
                    raise AssertionError(f"state leaf {'/'.join(path)}: "
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
    rec[label] = dict(stats, losses=losses, launches=launches,
                      launches_per_step=per_step, step_s_median=step_s,
                      tokens_per_s=tokens / step_s, peak_bytes=peak,
                      plain_replay_equal=True, jnp_decisions=jnp,
                      nondeterministic_ops=nondet, train_call_s=train_s,
                      replay_call_s=replay_s, profile_call_s=profile_s,
                      replay_step_s=stats_p["step_s"])
    return launches


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
            out["/".join((tag,) + path)] = h.hexdigest()
    return out


def train_step_and_compare(torch, dev, rec, label, cfg, policy, check,
                           steps=1):
    """Train ``cfg`` under ``policy`` for ``steps`` steps through
    ``make_train_step`` from the trainer's initial state, keys and batches
    (``launch.train``), the launch counts and decisions read around the
    steps and handed to ``check(log, per_step)``; then replay the steps
    from the same state with the plain versions (losses and every state
    leaf ``==``) and profile one more step.  Returns (launches, losses,
    state)."""
    import warnings

    from repro_torch.core import prng
    from repro_torch.core.integer_sgd import tree_items
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import dispatch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import _init_state, train_hyper

    step = make_train_step(cfg, policy, train_hyper(steps, lr=TRAIN_LR,
                                                    momentum=0.9), dev)
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
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"{label} {cfg.name} full width, {cfg.n_layers} layers: "
              f"{steps} steps of {TRAIN_BATCH}x{TRAIN_SEQ}, {step_s:.3f} "
              f"s/step, {tokens / step_s:.1f} tokens/s, losses {losses}, "
              f"launches per step {per_step}, peak memory "
              f"{peak / 2**30:.2f} GiB")
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
                    raise AssertionError(f"state leaf {'/'.join(path)}: "
                                         "kernel path != plain path")
        del state_p
        print("plain-version replay: losses ==, every master and momentum "
              "leaf ==")
        t0 = time.perf_counter()
        step_profile(torch, lambda: step(state, data.batch_for_step(steps),
                                         prng.fold_in(key, steps)),
                     1e3 * step_s, rec, f"{label}_step_profile")
        profile_s = time.perf_counter() - t0
    torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message)[:200] for w in caught
                     if "deterministic" in str(w.message)})
    rec[label] = dict(losses=losses, step_s=times, launches=launches,
                      launches_per_step=per_step, step_s_median=step_s,
                      tokens_per_s=tokens / step_s, peak_bytes=peak,
                      n_layers=cfg.n_layers, plain_replay_equal=True,
                      jnp_decisions=jnp, nondeterministic_ops=nondet,
                      train_call_s=train_s, replay_call_s=replay_s,
                      profile_call_s=profile_s, replay_step_s=times_p)
    return launches, losses, state


# Decision kind -> the kernel counter a FUSED plan of that kind launches.
KIND_KERNEL = {"qq": "qq", "qi": "qi", "iq": "qi", "ii": "ii", "pp": "ii",
               "qq_epi": "gemm_epi", "norm_gemm": "norm_gemm"}


def train_chain_and_compare(torch, dev, rec, label, arch, n_layers, want):
    """Phases 8 and 10: full-width ``arch`` cut to ``n_layers`` layers, one
    step under ``PAPER_INT8`` with ``fused_proj`` (as the JAX package's own
    chain tests reach it; the trainer has no flag for it): ``want``
    launches per step, each also the count of the step's FUSED plans of
    that kernel; no chain planned on a plain path."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.policy import PAPER_INT8
    from repro_torch.kernels import dispatch

    chains = {"qnorm_gemm", "qmatmul_epi"}

    def check(log, per_step):
        planned = collections.Counter(
            KIND_KERNEL[d.kind] for d in log if d.path == dispatch.FUSED)
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
                                  check)[0]


def train_unfused_and_compare(torch, dev, rec):
    """Phase 9: full-width qwen2-0.5b, one ``PAPER_INT8`` step under
    ``kernel_mode="unfused"`` (no trainer flag in either package):
    ``EXPECTED_PER_STEP`` launches of ``bfp_quantize`` and
    ``int8_matmul``, none of any other kernel, no plain-path decision but
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
            if n != want.get(name, 0):
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
                  exact={"decode_block": 40 * (GEN - 1), "attn_decode": 0})),
              ("train_fused_proj", lambda: train_chain_and_compare(
                  torch, dev, rec, "train_fused_proj", CHAIN_ARCH,
                  CHAIN_TRAIN_LAYERS, CHAIN_PER_STEP)),
              ("train_unfused", lambda: train_unfused_and_compare(
                  torch, dev, rec)),
              ("train_fused_proj_gelu", lambda: train_chain_and_compare(
                  torch, dev, rec, "train_fused_proj_gelu", GELU_ARCH,
                  GELU_TRAIN_LAYERS, GELU_PER_STEP))]
    results, rec["phase_s"] = {}, {}
    for name, run in phases:
        t1 = time.perf_counter()
        results[name] = run()
        rec["phase_s"][name] = time.perf_counter() - t1
        print(f"phase {name}: {rec['phase_s'][name]:.1f} s")
    kernels = results.pop("kernels")
    by_path = results
    line = []
    for kern in kernels:
        if kern["name"] not in dispatch.kernel_launches():
            continue           # extra shapes of a kernel: the json record
        name = kern["name"]
        line.append({k: kern[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape", "act")
            if k in kern}
            | {"launches": sum(p[name] for p in by_path.values()),
               "launches_by_path": {k: p[name] for k, p in by_path.items()}})
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
