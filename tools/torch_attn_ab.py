#!/usr/bin/env python3
"""Time the attention kernels of one checkout of the PyTorch port on the card.

``attn_decode`` at qwen2-0.5b's decode slice (B*Hkv = 8, GS = 7, D = 64) for
bands of 160, 4096 and 32768 positions, ``attn_fwd`` at its qflow training
slice (8 slices, GS = 7 x 128, T = 128, D = 64, causal) and at T 4100, D
128 (one slice of GS 20, KV blocks of 512), on the route the checkout's
wrapper takes and on the ``__dp4a`` kernel through its C entry, and
``attn_bwd`` at the training slice, each held ``==`` its plain version
first; device ms per call from ``torch.profiler``
(``chip_smoke._device_ms``).  A band the checkout's planner sends to the
scan path is recorded with the planner's reason and no time.

    python tools/torch_attn_ab.py --src build/ab/parent/src --label parent \\
        --out chiprun_out/attn_ab.jsonl

``--src`` is the ``src`` directory of the checkout to time (default: this
one's).  Run it for two checkouts in turns (parent, change, change,
parent) in one call to compare them on one card; each appends one JSON line
a kernel and shape to ``--out``.  ``--splits`` instead times the decode
kernel at T 160 and 4096 on every cluster size that splits the band on its
windows and fits shared memory, through the C entry (the rule
``decode_split`` picks one of them).  ``--fwd-tiles`` instead times the
``wgmma`` forward at the training slice with four and with two
warpgroups a block of 64 rows, through the C entry (``attn_fwd_tiles``
picks one).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_T = (160, 4096, 32768)
# (BH, GS, T, D, s, q_off, kv_len, causal): the forward's shapes
FWD_SHAPES = ((8, 7 * 128, 128, 64, 128, 0, 128, True),
              (1, 20, 4100, 128, 10, 0, 4100, False))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--fwd-tiles", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("torch_attn_ab: needs the card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core import prng
    from repro_torch.core.bfp import QuantConfig
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels import fused_attention as kfa
    from repro_torch.kernels import fused_linear as kfl

    build.build(["fused_attention", "attn_train"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rows = []

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    if args.fwd_tiles:
        rows = time_fwd_tiles(torch, cs, kfa, kfl, prng, dispatch, dev, g,
                              smi, args.label)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        for row in rows:
            print(f"{args.label}: attn_fwd {row['shape']} with {row['wg']} "
                  f"warpgroups a block: {row['ms']} ms"
                  f"{' (the rule)' if row['rule'] else ''}")
        print(smi)
        return 0

    if args.splits:
        rows = time_splits(torch, cs, kfa, kfl, prng, dev, g, smi, args.label)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        for row in rows:
            print(f"{args.label}: attn_decode T={row['shape'][2]} on "
                  f"{row['split']}-block clusters: {row['ms']} ms"
                  f"{' (the rule)' if row['rule'] else ''}")
        print(smi)
        return 0

    bh, gs, d = 8, 7, 64
    for t in DECODE_T:
        plan = dispatch.plan_attention("attn_decode", gs, t, d, QuantConfig(),
                                       s=1, kind="qi", device="cuda")
        row = dict(label=args.label, kernel="attn_decode",
                   shape=[bh, gs, t, d], plan=plan.path, reason=plan.reason,
                   card=smi, ms=None)
        if plan.path == dispatch.FUSED:
            qm, km, vm = i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
            ek = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev,
                               dtype=torch.int32)
            ev = torch.randint(118, 126, (bh, t, 1), generator=g, device=dev,
                               dtype=torch.int32)
            rp = prng.bits(prng.key(4), (bh, gs, t), dev)
            eq = torch.tensor(122, dtype=torch.int32, device=dev)
            kw = dict(p=7, s=1, causal=True, window=0, stochastic=True)
            y = kfa.attn_decode(qm, km, vm, ek, ev, rp, eq, t - 1, t, **kw)
            yp = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, t - 1, t,
                                       **kw)
            torch.cuda.synchronize()
            if not torch.equal(y, yp):
                raise AssertionError(f"attn_decode T={t}: kernel != plain")
            rp32 = kfl.as_u32(rp)
            row["ms"] = cs._device_ms(torch, lambda: kfa.attn_decode(
                qm, km, vm, ek, ev, rp32, eq, t - 1, t, **kw), iters=20)
        rows.append(row)

    for shape in FWD_SHAPES:
        rows.append(time_fwd(torch, cs, kfa, kfl, prng, dispatch, dev, g,
                             smi, args.label, shape))

    bh, gs, t, d, s = 8, 7 * 128, 128, 64, 128
    qm, gm, km, vm = i8(bh, gs, d), i8(bh, gs, d), i8(bh, t, d), i8(bh, t, d)
    rp, rs, rp2 = (prng.bits(prng.key(k), (bh, gs, t), dev) for k in (5, 6, 7))
    eq, ek, ev, eg = (torch.tensor(v, dtype=torch.int32, device=dev)
                      for v in (125, 125, 124, 110))
    kw = dict(p=7, s=s, bt=dispatch.attn_block_t(t), causal=True, window=0,
              stochastic=True)
    _, m, l = kfa.attn_fwd_plain(qm, km, vm, rp, eq, ek, ev, 0, t, **kw)
    delta = torch.randn((bh, gs, 1), generator=g, device=dev) * 1e-3
    bwd = (qm, gm, km, vm, m, l, delta, rs, rp2, eq, ek, ev, eg, 0, t)
    got = kfa.attn_bwd(*bwd, **kw)
    want = kfa.attn_bwd_plain(*bwd, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError("attn_bwd: kernel != plain")
    bwd32 = bwd[:7] + (kfl.as_u32(rs), kfl.as_u32(rp2)) + bwd[9:]
    split = {}
    ms = cs._device_ms(torch, lambda: kfa.attn_bwd(*bwd32, **kw), iters=20,
                       split=split)
    rows.append(dict(label=args.label, kernel="attn_bwd", shape=[bh, gs, t, d],
                     plan="fused", card=smi, ms=ms, ms_by_kernel=split))

    with open(args.out, "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    for row in rows:
        print(f"{args.label}: {row['kernel']} {row['shape']}: "
              f"{row['ms'] if row['ms'] is not None else 'not run'} ms "
              f"({row['plan']}{': ' + row['reason'] if row['ms'] is None else ''})"
              + (f", __dp4a {row['dp4a_ms']} ms" if "dp4a_ms" in row else ""))
    print(smi)
    return 0


def _fwd_operands(torch, prng, dispatch, dev, g, shape):
    """attn_fwd's operands (bits as int64 and int32) and keywords at one
    of FWD_SHAPES."""
    bh, gs, t, d, s, q_off, kv_len, causal = shape
    qm, km, vm = (torch.randint(-127, 128, shp, generator=g, device=dev,
                                dtype=torch.int8)
                  for shp in ((bh, gs, d), (bh, t, d), (bh, t, d)))
    rp = prng.bits(prng.key(5), (bh, gs, t), dev)
    eq, ek, ev = (torch.tensor(v, dtype=torch.int32, device=dev)
                  for v in (125, 125, 124))
    kw = dict(p=7, s=s, bt=dispatch.attn_block_t(t), causal=causal,
              window=0, stochastic=True)
    return (qm, km, vm, rp, eq, ek, ev, q_off, kv_len), kw


def _fwd_c_call(torch, kfl, args32, kw, outs, extra=()):
    """The C arguments of repro_attn_fwd (or, with ``extra`` (wg,),
    repro_attn_fwd_tc) on the operands, writing ``outs``."""
    import ctypes
    qm, km, vm, rp, eq, ek, ev, q_off, kv_len = args32
    bh, gs, d = qm.shape
    t = km.shape[1]
    return [*(kfl._ptr(x) for x in (qm, km, vm, rp, eq, ek, ev, *outs)), bh,
            gs, t, d, kw["s"], q_off, min(kv_len, t), int(kw["causal"]),
            kw["window"], kw["p"], kw["bt"], 1, *extra,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)]


def time_fwd(torch, cs, kfa, kfl, prng, dispatch, dev, g, smi, label, shape):
    """attn_fwd at one of FWD_SHAPES: the checkout's wrapper (the route its
    rule names; the parent has only __dp4a) and the __dp4a kernel through
    its C entry, both held == the plain version first."""
    args, kw = _fwd_operands(torch, prng, dispatch, dev, g, shape)
    args32 = args[:3] + (kfl.as_u32(args[3]),) + args[4:]
    want = kfa.attn_fwd_plain(*args, **kw)
    got = kfa.attn_fwd(*args32, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, want)):
        raise AssertionError(f"attn_fwd {shape}: kernel != plain")
    rule = getattr(kfa, "attn_fwd_variant", None)
    bh, gs, t, d = shape[:4]
    variant = rule(gs, t, d, kw["bt"]) if rule else "dp4a"
    ms = cs._device_ms(torch, lambda: kfa.attn_fwd(*args32, **kw), iters=20)
    lib = kfa._lib_train()
    outs = [torch.empty_like(x) for x in want]
    call = _fwd_c_call(torch, kfl, args32, kw, outs)

    def run():
        err = lib.repro_attn_fwd(*call)
        if err:
            raise RuntimeError(f"attn_fwd __dp4a: cudaError {err}")
    run()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(outs, want)):
        raise AssertionError(f"attn_fwd __dp4a {shape}: kernel != plain")
    return dict(label=label, kernel="attn_fwd", shape=[bh, gs, t, d],
                plan="fused", variant=variant, card=smi, ms=ms,
                dp4a_ms=cs._device_ms(torch, run, iters=20))


def time_fwd_tiles(torch, cs, kfa, kfl, prng, dispatch, dev, g, smi, label):
    """The wgmma forward at the training slice with four and with two
    warpgroups a block of 64 rows, through the C entry, held == the plain
    version first."""
    lib = kfa._lib_train()
    rows = []
    shape = FWD_SHAPES[0]
    args, kw = _fwd_operands(torch, prng, dispatch, dev, g, shape)
    args32 = args[:3] + (kfl.as_u32(args[3]),) + args[4:]
    want = kfa.attn_fwd_plain(*args, **kw)
    bh, gs, t, d = shape[:4]
    for nw in (4, 2):
        outs = [torch.empty_like(x) for x in want]
        call = _fwd_c_call(torch, kfl, args32, kw, outs, (nw,))

        def run(call=call, nw=nw):
            err = lib.repro_attn_fwd_tc(*call)
            if err:
                raise RuntimeError(f"attn_fwd nw={nw}: cudaError {err}")
        run()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(outs, want)):
            raise AssertionError(f"attn_fwd {shape} nw={nw}: != plain")
        rows.append(dict(label=label, kernel="attn_fwd_tiles",
                         shape=[bh, gs, t, d], wg=nw,
                         rule=nw == kfa.attn_fwd_tiles(d, kw["bt"]),
                         card=smi, ms=cs._device_ms(torch, run, iters=50)))
    return rows


def time_splits(torch, cs, kfa, kfl, prng, dev, g, smi, label):
    """attn_decode at (8, 7, T, 64), T 160 and 4096, on each cluster size n
    with n == ceil(m / ceil(m / n)) whose blocks fit shared memory, held
    == its plain version first."""
    import ctypes
    lib = kfa._lib()
    bh, gs, d = 8, 7, 64
    rows = []
    for t in (160, 4096):
        m = -(-t // 32)
        qm = torch.randint(-127, 128, (bh, gs, d), generator=g, device=dev,
                           dtype=torch.int8)
        km, vm = (torch.randint(-127, 128, (bh, t, d), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ek, ev = (torch.randint(118, 126, (bh, t, 1), generator=g, device=dev,
                                dtype=torch.int32) for _ in range(2))
        rp = prng.bits(prng.key(4), (bh, gs, t), dev)
        rp32 = kfl.as_u32(rp)
        eq = torch.tensor(122, dtype=torch.int32, device=dev)
        want = kfa.attn_decode_plain(qm, km, vm, ek, ev, rp, eq, t - 1, t,
                                     p=7, s=1, causal=True, window=0,
                                     stochastic=True)
        y = torch.empty_like(want)
        for n in range(1, 17):
            if -(-m // -(-m // n)) != n or \
                    kfa._decode_layout_bytes(gs, t, d, n) > kfa.SMEM_LIMIT:
                continue

            def run(n=n):
                err = lib.repro_attn_decode(
                    *(kfl._ptr(x) for x in (qm, eq, km, vm, ek, ev, rp32, y)),
                    bh, gs, t, d, 1, t - 1, t, 1, 0, 7, 1, n,
                    ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
                if err:
                    raise RuntimeError(f"attn_decode n={n}: cudaError {err}")
            run()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                raise AssertionError(f"attn_decode T={t} n={n}: != plain")
            rows.append(dict(label=label, kernel="attn_decode_split",
                             shape=[bh, gs, t, d], split=n,
                             rule=n == kfa.decode_split(gs, t, d), card=smi,
                             ms=cs._device_ms(torch, run, iters=50)))
    return rows


if __name__ == "__main__":
    sys.exit(main())
