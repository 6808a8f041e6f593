#!/usr/bin/env python3
"""How deep phase 10 of ``chip_smoke.py`` (full-width starcoder2-7b
``fused_proj`` training) fits on one card.

    python3 tools/torch_fused_proj_depth.py 4 5

For each depth, runs ``chip_smoke.train_chain_and_compare`` as phase 10
runs it (one step under ``replace(PAPER_INT8, fused_proj=True)``, its
plain replay beside the step's state, its profile) and prints the step's
peak device memory, or that it ran out of memory and how much was
allocated by then.  Run on the card.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> int:
    import torch

    import chip_smoke
    from repro_torch.kernels import build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("layers", type=int, nargs="+")
    args = ap.parse_args()
    build.build()
    dev = torch.device("cuda")
    for n in args.layers:
        want = {"norm_gemm": 0, "gemm_epi": n, "qq": 5 * n + 1,
                "qi": 6 * n + 1, "ii": 6 * n + 1}      # GELU_PER_STEP
        rec = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            chip_smoke.train_chain_and_compare(
                torch, dev, rec, "depth", chip_smoke.GELU_ARCH, n, want)
            print(f"{chip_smoke.GELU_ARCH} {n} layers: fits, step peak "
                  f"{rec['depth']['peak_bytes'] / 2**30:.2f} GiB")
        except torch.cuda.OutOfMemoryError as err:
            print(f"{chip_smoke.GELU_ARCH} {n} layers: out of memory at "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                  f"allocated ({str(err)[:120]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
