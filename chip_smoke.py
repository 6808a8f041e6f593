#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on the GPU (one card).

    python3 chip_smoke.py

Phases, any of which failing exits non-zero:

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc;
2. call each kernel at the shapes the serving path gives it and hold it
   against its plain torch version on the same inputs: ``qq`` and ``qi``
   y and mantissas ``==``, ``attn_decode`` y within ``DECODE_Y_RTOL``
   (kernels/fused_attention.py) of the plain y's largest magnitude; time
   kernel, plain version and one
   library call, and compute the card's bound for the same work;
3. serve full-width qwen2-0.5b (random weights from a seeded generator):
   4 prompts x 128 tokens, 32 greedy tokens, int8 weights quantized once
   and an int8 KV cache, with the launch counts set to 0 just before and
   read just after; then replay the same prompts and tokens with every
   kernel swapped for its plain version and compare: prefill logits
   ``==``, decode logits within ``DECODE_LOGIT_RTOL`` of their largest
   magnitude (decode attention's softmax sum differs in order, and a
   stochastic-rounding decision downstream can move with it).

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

# Tolerances (PERF.md, "Parity").  The decode kernel differs from its plain
# version only in the order of the float32 softmax sum, which can move a
# stochastic-rounding decision of p by one unit.
DECODE_LOGIT_RTOL = 0.1

# H100 SXM published peaks: HBM bytes/s, dense int8 op/s.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

ARCH, BATCH, PROMPT, GEN, SEED = "qwen2_0_5b", 4, 128, 32, 0


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
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / iters / 1e3


def _self_device_us(e) -> float:
    """Device time of a profiler event that runs on the card (a kernel,
    memcpy or memset); 0 for host-side ops, whose device time is already
    counted by the kernels they launch."""
    from torch.autograd import DeviceType
    if e.device_type != DeviceType.CUDA:
        return 0.0
    t = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0.0) if t is None else t


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
    scale = yp.abs().max().item()
    rec["attn_decode_check"] = dict(max_abs_err=err, max_abs_y=scale,
                                    exact=bool(torch.equal(y, yp)))
    if not (err <= kfa.DECODE_Y_RTOL * scale):
        raise AssertionError(f"attn_decode: max |dy| {err} > "
                             f"{kfa.DECODE_Y_RTOL} * {scale}")
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
    return out


def step_profile(torch, step, step_ms: float, rec):
    """One kernel-path decode step under torch.profiler: summed device
    time, the top kernels, and the card's idle share against ``step_ms``,
    the same step's wall time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [(e.key, _self_device_us(e) / 1e3, e.count)
              for e in prof.key_averages() if _self_device_us(e) > 0]
    events.sort(key=lambda x: -x[1])
    busy_ms = sum(t for _, t, _ in events)
    idle = 1.0 - busy_ms / step_ms
    rec["decode_step_profile"] = dict(
        profiled_wall_ms=wall_ms, step_ms=step_ms, device_busy_ms=busy_ms,
        device_idle_share=idle,
        device_launches=sum(c for _, _, c in events),
        top=[dict(name=k[:120], ms=t, count=c) for k, t, c in events[:12]])
    print(f"decode step profile: device busy {busy_ms:.2f} ms of a "
          f"{step_ms:.1f} ms step (idle share {idle:.3f}), "
          f"{rec['decode_step_profile']['device_launches']} device launches")


def serve_and_compare(torch, dev, rec):
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch
    from repro_torch.launch import serve as srv
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    dispatch.reset_kernel_launches()
    toks, stats = srv.serve(ARCH, smoke=False, batch=BATCH, prompt_len=PROMPT,
                            gen=GEN, seed=SEED, qcache=True, quiet=True)
    torch.cuda.synchronize()
    launches = dispatch.kernel_launches()
    logits = stats.pop("logits")
    cfg = get_config(ARCH)
    if toks.shape != (BATCH, GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab:
        raise AssertionError(f"bad tokens {tuple(toks.shape)}")
    for lg in logits:
        if lg.shape != (BATCH, cfg.vocab) or not bool(torch.isfinite(lg).all()):
            raise AssertionError("non-finite or misshapen logits")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving path")
    rec["serve"] = dict(stats, launches=launches, tokens=toks.tolist())
    print(f"serve qwen2-0.5b full width: prefill {BATCH}x{PROMPT} in "
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
    with torch.inference_mode(), dispatch.plain_kernels():
        cache, lg0 = prefill(params, {"tokens": prompts}, prng.fold_in(key, 3))
        if not torch.equal(lg0, logits[0]):
            raise AssertionError("prefill logits: kernel path != plain path "
                                 f"(max {(lg0 - logits[0]).abs().max().item()})")
        worst, agree = 0.0, 0
        for i in range(GEN - 1):
            lg, cache = decode(params, cache, dev_toks[:, i], PROMPT + i,
                               prng.fold_in(key, 10 + i))
            ref_lg = logits[i + 1]
            rel = ((lg - ref_lg).abs().max() / ref_lg.abs().max()).item()
            worst = max(worst, rel)
            agree += int(torch.equal(lg.argmax(-1), ref_lg.argmax(-1)))
    with torch.inference_mode():
        step_profile(torch, lambda: decode(
            params, cache, dev_toks[:, -1], PROMPT + GEN - 1,
            prng.fold_in(key, 10 + GEN)), stats["decode_ms_per_step"], rec)
    rec["compare"] = dict(prefill_equal=True, decode_max_rel_err=worst,
                          decode_steps_argmax_agree=agree,
                          decode_steps=GEN - 1)
    print(f"plain-version replay: prefill logits ==, decode max rel err "
          f"{worst:.3e}, argmax agrees on {agree}/{GEN - 1} steps")
    if not worst <= DECODE_LOGIT_RTOL:
        raise AssertionError(f"decode logits rel err {worst} > "
                             f"{DECODE_LOGIT_RTOL}")
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
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    reports = build.build()
    rec["build_s"] = time.perf_counter() - t0
    rec["nvcc"] = reports
    print(f"build: {sorted(build.SOURCES)} in {rec['build_s']:.1f} s")

    kernels = check_kernels(torch, dev, rec)
    launches = serve_and_compare(torch, dev, rec)
    line = []
    for kern in kernels:
        base = kern["name"].split("_prefill")[0]
        if base != kern["name"]:
            continue
        line.append({k: kern[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
            | {"launches": launches[kern["name"]]})
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
