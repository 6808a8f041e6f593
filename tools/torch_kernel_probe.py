#!/usr/bin/env python3
"""Probe the port's ``qq_blk`` and ``decode_block`` kernels on one card:

    python3 tools/torch_kernel_probe.py [--census] [--out chiprun_out/probe.json]

1. ``qq_blk``: y and both mantissa arrays ``==`` the plain version on every
   variant (``fused_linear.qq_blk_variant``: the 128 x 128 and 64 x 64
   tiles of the Hopper route, ``__dp4a``) at the ``int8_block`` training
   shapes of qwen2-0.5b and odd ones; each main-path shape timed (device
   ms, ``torch.profiler``) on both Hopper tilings, forced through the C
   entry point, beside the bytes bound;
2. ``decode_block``: x_out and the fresh cache rows ``==`` the plain
   version at one minicpm-2b layer (4 streams, positions 0 and 159, a
   window, one stream) and an odd shape; timed, and each stage timed from
   the kernel's clock64 stamps (``fused_chain.DECODE_BLOCK_STAMPS``; per
   block: a stage's work, then the wait at the grid barrier after it, the
   row passes inside the stages, the attention's steps; the mean and the
   largest over the blocks, in SM cycles); at the 4-stream layer also
   timed with 1 and 3 ring stages in flight;
3. ``--census``: one qwen2-0.5b ``int8_block`` training step at full width
   (4 x 128 tokens), every ``qq_blk`` call's shape and variant counted;
   each shape then timed on its variant and on the ``__dp4a`` kernel,
   summed over the step's calls.
``--decode-only`` skips 1.

Prints each result and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
TOKENS = 512


def device_ms(torch, fn, iters=10, split=None):
    """Device ms per call, every kernel the call launches summed
    (torch.profiler); ``split`` gets each kernel's share by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    if split is not None:
        for name, us in events:
            key = name.split("(anonymous namespace)::")[-1].split("(")[0]
            split[key] = split.get(key, 0.0) + us / iters / 1e3
    return sum(us for _, us in events) / iters / 1e3


def qq_blk_forced(torch, kfl, a, ra, ea, b, rb, eb, blk, variant, res):
    """The Hopper route of qq_blk on ``variant``'s tiling, whatever the
    rule would pick."""
    nb, m, k = a.shape
    n = b.shape[1]
    dev = a.device
    y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
    am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
    bm = torch.empty((nb, n, k), dtype=torch.int8, device=dev)
    sa = torch.empty((nb, k // blk, -(-m // 128) * 128), dtype=torch.int32, device=dev)
    sb = torch.empty((nb, k // blk, -(-n // 128) * 128), dtype=torch.int32, device=dev)
    p = kfl._ptr
    err = kfl._lib_sm90().repro_qq_blk_sm90(
        p(a), p(ra), p(ea), p(b), p(rb), p(eb), p(y), p(am), p(bm), p(sa), p(sb),
        nb, m, n, k, blk, 7, int(ra is not None),
        kfl.QQ_BLK_VARIANTS.index(variant),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    kfl._raise_on(err, f"qq_blk ({variant}, forced)")
    return (y, am, bm) if res else (y, None, None)


# (B, M, K, N, blk, timed): the int8_block shapes (the gate's forward, the
# LM head's forward, dX and dW, w_down's forward, a layer's dW, the
# attention's batched PV), then odd ones: blk 32 with K off the 128-byte
# stage, blk 64 and 256, M <= 16 and K % 16 != 0 (__dp4a).
QQ_BLK_SHAPES = {
    "gate": (1, TOKENS, 896, 4864, 128, True),
    "lm_head": (1, TOKENS, 896, 151936, 128, True),
    "lm_head_dx": (1, TOKENS, 151936, 896, 128, True),
    "lm_head_dw": (1, 896, TOKENS, 151936, 128, True),
    "w_down": (1, TOKENS, 4864, 896, 128, True),
    "gate_dw": (1, 4864, TOKENS, 896, 128, True),
    "pv": (8, 896, 128, 64, 128, True),
    "odd_blk32": (2, 37, 1280, 29, 32, False),
    "odd_k96": (1, 130, 96, 70, 32, False),
    "odd_blk64": (1, 65, 512, 131, 64, False),
    "odd_blk256": (1, 200, 1024, 300, 256, False),
    "odd_m16": (1, 16, 256, 64, 128, False),
    "odd_dp4a": (1, 19, 42, 23, 6, False),
}


def probe_qq_blk(torch, dev, rec):
    from repro_torch.core import prng
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(5)
    rec["qq_blk"] = {}
    for name, (nb, m, k, n, blk, timed) in QQ_BLK_SHAPES.items():
        a = torch.randn((nb, m, k), generator=g, device=dev)
        b = torch.randn((nb, n, k), generator=g, device=dev)
        a[:, 0, :blk] *= 2.0 ** -70       # block 0 of row 0: a flushed scale
        b[:, 0, :blk] *= 2.0 ** -70
        ra64, rb64 = prng.bits(prng.key(8), a.shape, dev), prng.bits(prng.key(9), b.shape, dev)
        ra, rb = kfl.as_u32(ra64), kfl.as_u32(rb64)     # the kernels' form
        ea = ref.max_biased_exp_blocks_ref(a, blk)
        eb = ref.max_biased_exp_blocks_ref(b, blk)
        variant = kfl.qq_blk_variant(m, n, k, blk, True, nb)
        row = dict(shape=[nb, m, k, n], blk=blk, variant=variant)
        for sr in (True, False):
            r = (ra, rb) if sr else (None, None)
            kw = dict(blk=blk, stochastic=sr)
            want = kfl.fused_qq_blk_plain(a, ra64 if sr else None, ea, b,
                                          rb64 if sr else None, eb, **kw)
            kd.reset_kernel_launches()
            got = kfl.fused_qq_blk(a, r[0], ea, b, r[1], eb, **kw)
            y_only = kfl.fused_qq_blk(a, r[0], ea, b, r[1], eb, emit_residuals=False,
                                      **kw)
            torch.cuda.synchronize()
            if kd.kernel_launches()[f"qq_blk_{variant}"] != 2:
                raise AssertionError(f"qq_blk {name}: not on {variant}")
            outs = list(zip(got, want)) + [(y_only[0], want[0])]
            if variant != "dp4a":
                other = "wgmma64" if variant == "wgmma" else "wgmma"
                forced = qq_blk_forced(torch, kfl, a, r[0], ea, b, r[1], eb, blk, other,
                                       True)
                outs += list(zip(forced, want))
            bad = [i for i, (x, y) in enumerate(outs) if not torch.equal(x, y)]
            if bad:
                err = (got[0] - want[0]).abs().max().item()
                raise AssertionError(f"qq_blk {name} stochastic={sr}: outputs {bad} "
                                     f"!= plain (max |dy| {err})")
        if timed:
            nbytes = nb * (8 * m * k + 8 * n * k + 4 * (m + n) * (k // blk) + 4 * m * n
                           + (m + n) * k)
            row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            for v in ("wgmma", "wgmma64"):
                row[f"{v}_by_kernel"] = {}
                row[f"{v}_ms"] = device_ms(torch, lambda: qq_blk_forced(
                    torch, kfl, a, ra, ea, b, rb, eb, blk, v, True),
                    split=row[f"{v}_by_kernel"])
            row["dp4a_ms"] = device_ms(torch, lambda: kfl._lib_linear().repro_fused_qq_blk(
                *(kfl._ptr(t) for t in (a, ra, ea, b, rb, eb, got[0], got[1], got[2])),
                nb, m, n, k, blk, 7, 1,
                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)), iters=2)
        rec["qq_blk"][name] = row
        print(f"qq_blk {name} {row}", flush=True)
        del a, b, ra, rb, got, want, y_only
        torch.cuda.empty_cache()


# (B, d, n_ff, hq, hkv, dh, T, pos, window)
DECODE_SHAPES = {
    "serve": (4, 2304, 5760, 36, 36, 64, 160, 159, 0),
    "serve_pos0": (4, 2304, 5760, 36, 36, 64, 160, 0, 0),
    "serve_window": (4, 2304, 5760, 36, 36, 64, 160, 150, 64),
    "serve_b1": (1, 2304, 5760, 36, 36, 64, 160, 159, 0),
    "odd": (3, 256, 320, 8, 2, 32, 40, 37, 8),
}
STAGES = ("qkv", "qkv_wait", "attention", "attention_wait", "out_proj",
          "out_proj_wait", "gate_up", "gate_up_wait", "down")
ATT_STEPS = ("att_load", "att_rows", "att_scores", "att_softmax", "att_pv")


def probe_decode_block(torch, dev, rec):
    from repro_torch.kernels import dispatch as kd
    from repro_torch.kernels import fused_chain as kfc
    g = torch.Generator(device=dev).manual_seed(31)
    rec["decode_block"] = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (b, d, n_ff, hq, hkv, dh, t, pos, window) in DECODE_SHAPES.items():
        def i8(*shp):
            return torch.randint(-127, 128, shp, generator=g, device=dev,
                                 dtype=torch.int8)

        def se(n):
            return torch.randint(-14, -9, (1, n), generator=g, device=dev,
                                 dtype=torch.int32)

        def rows(*shp):
            return torch.randint(118, 126, shp, generator=g, device=dev,
                                 dtype=torch.int32)
        nqkv = (hq + 2 * hkv) * dh
        ang = torch.rand(dh // 2, generator=g, device=dev) * 3
        cossin = torch.cat([ang.cos(), ang.cos(), ang.sin(), ang.sin()])[None]
        gains = [torch.randint(1 << 13, 1 << 15, (1, d), generator=g, device=dev,
                               dtype=torch.int32) for _ in range(2)]
        args = (torch.randn((b, d), generator=g, device=dev), i8(nqkv, d), se(nqkv),
                i8(d, hq * dh), se(d), i8(2 * n_ff, d), se(2 * n_ff), i8(d, n_ff), se(d),
                *gains, i8(b, hkv, t, dh), rows(b, hkv, t, 1), i8(b, hkv, t, dh),
                rows(b, hkv, t, 1), cossin.contiguous())
        kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=7, window=window,
                  eps_m=1, eps_e=-32, se_g1=-14, se_g2=-14)
        kd.reset_kernel_launches()
        got = kfc.fused_decode_block(*args, pos, **kw)
        want = kfc.decode_block_plain(*args, pos, **kw)
        torch.cuda.synchronize()
        if kd.kernel_launches()["decode_block"] != 1:
            raise AssertionError(f"decode_block {name}: launch not counted")
        for what, x, y in zip(("x_out", "k_new", "ek_new", "v_new", "ev_new"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"decode_block {name} {what}: kernel != plain "
                                     f"(max {(x.float() - y.float()).abs().max().item()})")
        row = dict(shape=[b, d, n_ff, hq, hkv, dh, t], pos=pos, window=window,
                   stages=kfc.decode_block_stages(b, d, n_ff, hq, hkv, dh, t),
                   smem=kfc.decode_block_smem_bytes(b, d, n_ff, hq, hkv, dh, t),
                   ms=device_ms(torch, lambda: kfc.fused_decode_block(*args, pos, **kw)))
        stamps = torch.zeros((sms, kfc.DECODE_BLOCK_STAMPS), dtype=torch.int64, device=dev)
        per = collections.defaultdict(list)
        for _ in range(5):
            kfc._launch_decode_block(args, pos, stamps=stamps, **kw)
            torch.cuda.synchronize()
            s = stamps.cpu()
            dt = (s[:, 1:10] - s[:, :9]).double()
            for i, st in enumerate(STAGES):
                per[st].append((dt[:, i].mean().item(), dt[:, i].max().item()))
            # the row passes at each stage's start, the producer's end
            for part, (i0, i1) in (("norm1", (0, 15)), ("qkv_gemv", (15, 1)),
                                   ("quant_attn", (4, 16)), ("out_gemv", (16, 5)),
                                   ("norm2", (6, 17)), ("gu_gemv", (17, 7)),
                                   ("quant_act", (8, 18)), ("down_gemv", (18, 9)),
                                   ("producer", (0, 19))):
                v = (s[:, i1] - s[:, i0]).double()
                per[part].append((v.mean().item(), v.max().item()))
            # warp 0's attention unit, from the stage's start (stamp 2)
            sub = (s[:, [2, 10, 11, 12, 13, 14]][:, 1:] - s[:, [2, 10, 11, 12, 13, 14]][:, :-1]).double()
            for i, st in enumerate(ATT_STEPS):
                per[st].append((sub[:, i].mean().item(), sub[:, i].max().item()))
            per["total"].append(((s[:, 9] - s[:, 0]).double().mean().item(),
                                 (s[:, 9] - s[:, 0]).double().max().item()))
        row["stage_cycles_mean_max"] = {k: [sum(x for x, _ in v) / len(v),
                                            sum(y for _, y in v) / len(v)]
                                        for k, v in per.items()}
        row["sm_clock_mhz"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True).stdout.strip()
        if name == "serve":
            # the same layer with other limits on the stages in flight
            chosen = kfc._DEC_INFLIGHT
            row["ms_by_inflight"] = {}
            try:
                for n in (1, 3):
                    kfc._DEC_INFLIGHT = n
                    row["ms_by_inflight"][n] = device_ms(
                        torch, lambda: kfc.fused_decode_block(*args, pos, **kw))
            finally:
                kfc._DEC_INFLIGHT = chosen
        rec["decode_block"][name] = row
        print(f"decode_block {name} {row}", flush=True)


def census(torch, dev, rec):
    """One int8_block step: each qq_blk call's (B, M, K, N, blk, variant)."""
    from repro_torch.kernels import fused_linear as kfl
    from repro_torch.launch.train import train
    seen = collections.Counter()
    rule = kfl.qq_blk_variant

    def recording(m, n, k, blk, aligned=True, nb=1):
        v = rule(m, n, k, blk, aligned, nb)
        seen[(nb, m, k, n, blk, v)] += 1
        return v
    kfl.qq_blk_variant = recording      # the wrapper asks the rule once a call
    try:
        train("qwen2_0_5b", smoke=False, steps=1, batch=4, seq=128, lr=0.05,
              momentum=0.9, seed=0, quiet=True, policy_name="int8_block")
    finally:
        kfl.qq_blk_variant = rule
    rec["census"] = [dict(shape=list(k[:4]), blk=k[4], variant=k[5], calls=c)
                     for k, c in sorted(seen.items())]
    by = collections.Counter()
    for k, c in seen.items():
        by[k[5]] += c
    rec["census_by_variant"] = dict(by)
    # each shape timed on its variant and on the __dp4a kernel (the only
    # qq_blk kernel before the Hopper route), summed over the step's calls
    from repro_torch.core import prng
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(6)
    step = {"rule": 0.0, "dp4a": 0.0}
    for row in rec["census"]:
        nb, m, k, n = row["shape"]
        blk = row["blk"]
        a = torch.randn((nb, m, k), generator=g, device=dev)
        b = torch.randn((nb, n, k), generator=g, device=dev)
        ra = kfl.as_u32(prng.bits(prng.key(1), a.shape, dev))
        rb = kfl.as_u32(prng.bits(prng.key(2), b.shape, dev))
        ea = ref.max_biased_exp_blocks_ref(a, blk)
        eb = ref.max_biased_exp_blocks_ref(b, blk)
        y = torch.empty((nb, m, n), dtype=torch.float32, device=dev)
        am = torch.empty((nb, m, k), dtype=torch.int8, device=dev)
        bm = torch.empty((nb, n, k), dtype=torch.int8, device=dev)
        row["ms"] = device_ms(torch, lambda: kfl.fused_qq_blk(a, ra, ea, b, rb, eb, blk=blk),
                              iters=3)
        row["dp4a_ms"] = device_ms(torch, lambda: kfl._lib_linear().repro_fused_qq_blk(
            *(kfl._ptr(t) for t in (a, ra, ea, b, rb, eb, y, am, bm)), nb, m, n, k, blk, 7, 1,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)), iters=2)
        step["rule"] += row["calls"] * row["ms"]
        step["dp4a"] += row["calls"] * row["dp4a_ms"]
        del a, b, ra, rb, y, am, bm
        torch.cuda.empty_cache()
    rec["census_step_ms"] = step
    for row in rec["census"]:
        print(f"census {row}")
    print(f"census by variant {dict(by)}; qq_blk device ms a step: {step}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--census", action="store_true")
    ap.add_argument("--decode-only", action="store_true")
    ap.add_argument("--out", default="chiprun_out/probe.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels import build
    dev = torch.device("cuda")
    rec = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip()}
    reports = build.build(("qgemm_sm90", "fused_chain", "fused_linear"))
    rec["nvcc"] = reports
    for name, text in reports.items():
        print(f"nvcc {name}:\n" + "\n".join(ln for ln in text.splitlines()
                                            if "registers" in ln or "spill" in ln
                                            or "error" in ln.lower()))
    try:
        probe_decode_block(torch, dev, rec)
        if not args.decode_only:
            probe_qq_blk(torch, dev, rec)
        if args.census:
            census(torch, dev, rec)
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1, default=str)
    print(rec["nvidia_smi"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
