#!/usr/bin/env python3
"""Time and profile the PyTorch port's full-width serving decode step on
one card, for the ``repro_torch`` package under ``--src``, so that two
checkouts can be compared in one run on the same card:

    for s in parent change change parent; do
        python3 tools/torch_decode_ab.py --src $s/src --label $s \\
            --out decode_ab.jsonl
    done

qwen2-0.5b at full width, random weights from seed 0, int8 weights
quantized once and an int8 KV cache: a prefill of 4 x 128 tokens, then
``--gen`` greedy decode steps timed with the device synchronised at both
ends, then one more step under ``torch.profiler``: the device kernels it
launches, their summed device time, the idle share against the timed
step, and the host-side CUDA runtime calls that block (``cudaMemcpy*``
and ``cudaStreamSynchronize``).  Appends one JSON line per run to
``--out`` and prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ARCH, BATCH, PROMPT, SEED = "qwen2_0_5b", 4, 128, 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a checkout's src/")
    ap.add_argument("--label", required=True)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.kernels import build, dispatch
    from repro_torch.launch import serve as srv
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    build.build()
    cfg = get_config(ARCH)
    policy = srv.serving_policy("int8", qcache=True)
    params = srv.load_params(cfg, policy, SEED, dev)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(SEED + 1))
    key = prng.key(SEED)
    prefill = make_prefill_step(cfg, policy, PROMPT + args.gen + 2, dev)
    decode = make_decode_step(cfg, policy, dev)
    with torch.inference_mode():
        cache, logits = prefill(params, {"tokens": prompts},
                                prng.fold_in(key, 3))
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        dispatch.reset_kernel_launches()
        t0 = time.perf_counter()
        for i in range(args.gen):
            logits, cache = decode(params, cache, tok, PROMPT + i,
                                   prng.fold_in(key, 10 + i))
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.gen
        launches = {k: v / args.gen
                    for k, v in dispatch.kernel_launches().items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode(params, cache, tok, PROMPT + args.gen,
                   prng.fold_in(key, 10 + args.gen))
            torch.cuda.synchronize()
    busy_us, n_dev, host = 0.0, 0, {}
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset), as in
        # chip_smoke.py: a host op's self device time repeats its kernels'
        us = 0.0
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
        if us > 0:
            busy_us += us
            n_dev += e.count
        if e.key.startswith(("cudaMemcpy", "cudaStreamSynchronize",
                             "cudaDeviceSynchronize")):
            host[e.key] = host.get(e.key, 0) + e.count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    rec = dict(label=args.label, card=smi, decode_steps=args.gen,
               decode_ms_per_step=step_ms, device_launches=n_dev,
               device_busy_ms=busy_us / 1e3,
               device_idle_share=1.0 - busy_us / 1e3 / step_ms,
               blocking_host_calls=host, kernel_launches_per_step=launches)
    line = json.dumps(rec)
    print(line)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
