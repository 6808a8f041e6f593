"""Trainer: synthetic data -> integer train step, on the card.

The port of ``repro.launch.train``: the paper's integer pipeline (int8
forward and A.2 backward, int16 SGD; policy ``int8``), the same with
quantized activations as the inter-layer currency (``int8_qflow``, or
``qflow=True``: norms emit int8 BFP that the projections contract as they
are, attention runs through the fused attention kernels), with one shared
exponent per 128 elements of each contraction axis (``int8_block``, the
MX-style variant) or the float32 baseline (``float32``) on a ported
architecture, full or smoke config, with random initial weights from a
seeded ``torch.Generator``.  On the card every contraction runs on the
hand-written kernels (``qq`` forward, ``qi`` dX and the q-in forward,
``ii`` dW; under qflow ``attn_fwd`` and ``attn_bwd``; under
``int8_block`` ``qq_blk`` for every per-block contraction, forward and
backward, and ``qq`` where a contraction length does not divide by 128).
It runs on the card unless it is given ``device="cpu"``.

    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 3 \\
        --batch 4 --seq 128 [--qflow | --policy int8_block]
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3

Checkpoints, the health supervisor, the qweights currency and the JAX
package's other policies are not ported yet; asking for one raises and
names the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core import prng
from ..core.integer_sgd import integer_sgd_init
from ..core.policy import FLOAT32, PAPER_INT8, NumericPolicy
from ..data import SyntheticLM
from ..device import resolve_device, synchronize
from ..models.registry import get_model
from ..optim import sgd_init, wsd_schedule
from .steps import TrainHyper, make_float_train_step, make_train_step

__all__ = ["POLICIES", "train_hyper", "train", "main"]

POLICIES = {"int8": PAPER_INT8, "float32": FLOAT32,
            "int8_qflow": NumericPolicy(qflow=True),
            "int8_block": NumericPolicy(block=128)}

# The JAX package's other options, each with the ROADMAP item that ports it.
_UNPORTED_POLICIES = {
    "int8_qweights": "qweights training (ROADMAP queue 1, qweights training)",
    "int8_qfull": "qflow and qweights training (ROADMAP queue 1)",
    "int4": "int4 policies (ROADMAP queue 1 item 7: they need no kernel, "
            "every contraction with bits != 8 plans the plain path)",
}
_UNPORTED_OPTIONS = {
    "ckpt_dir": "checkpoints (ROADMAP queue 1, robustness)",
    "health": "the health report and supervisor (ROADMAP queue 1, "
              "robustness)",
    "fault_plan": "fault injection (ROADMAP queue 1, robustness)",
    "qweights": "qweights training (ROADMAP queue 1, qweights training)",
}


def _refuse_unported(policy_name: str, options: dict):
    if policy_name in _UNPORTED_POLICIES:
        raise NotImplementedError(f"policy {policy_name!r} is not ported "
                                  f"yet: {_UNPORTED_POLICIES[policy_name]}")
    if policy_name not in POLICIES:
        raise ValueError(f"unknown policy {policy_name!r}; choose from "
                         f"{sorted(POLICIES)}")
    for name, value in options.items():
        if value:
            raise NotImplementedError(f"{name} is not ported yet: "
                                      f"{_UNPORTED_OPTIONS[name]}")


def _init_state(cfg, policy, seed: int, dev: torch.device):
    """Random float32 weights from ``torch.Generator(seed)`` -> the
    training state: int16 masters (key ``key(seed)``) for an integer
    policy, else ``(params, SGDState)``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = get_model(cfg).init_params(cfg, gen, dev)
    if policy.enabled:
        return integer_sgd_init(params, policy, key=prng.key(seed))
    return params, sgd_init(params)


def train_hyper(steps: int, *, lr: float = 0.05, momentum: float = 0.9,
                weight_decay: float = 0.0, microbatch: int = 1,
                use_wsd: bool = False) -> TrainHyper:
    """The step hyperparameters of a ``steps``-step run, as the JAX
    package's trainer sets them (WSD: a tenth warm-up, half stable, a
    third decay)."""
    schedule = ((lambda s: wsd_schedule(s, lr, steps // 10, steps // 2,
                                        steps // 3)) if use_wsd else None)
    return TrainHyper(lr=lr, momentum=momentum, weight_decay=weight_decay,
                      microbatch=microbatch, schedule=schedule)


def train(arch: str, *, smoke: bool = True, steps: int = 50, batch: int = 8,
          seq: int = 64, policy_name: str = "int8", lr: float = 0.05,
          microbatch: int = 1, log_every: int = 10, seed: int = 0,
          momentum: float = 0.9, weight_decay: float = 0.0,
          use_wsd: bool = False, quiet: bool = False,
          ckpt_dir: Optional[str] = None, qflow: bool = False,
          qweights: bool = False, health: bool = False, fault_plan=None,
          device=None):
    """Train ``steps`` steps on ``device`` (None: the card) on the
    ``SyntheticLM`` stream.  Step ``i`` takes key ``fold_in(key(seed),
    i)``, as in the JAX package.  Returns ``(losses, state, stats)``;
    ``stats["step_s"]`` holds each step's wall time (the device
    synchronised)."""
    _refuse_unported(policy_name, {"ckpt_dir": ckpt_dir, "health": health,
                                   "fault_plan": fault_plan,
                                   "qweights": qweights})
    if steps < 1 or batch < 1 or seq < 1 or batch % microbatch:
        raise ValueError(f"need steps, batch, seq >= 1 and microbatch | "
                         f"batch, got steps={steps} batch={batch} seq={seq} "
                         f"microbatch={microbatch}")
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    policy = POLICIES[policy_name]
    if qflow and policy.enabled:
        policy = dataclasses.replace(policy, qflow=True)
    key = prng.key(seed)
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                     seed=seed)
    hyper = train_hyper(steps, lr=lr, momentum=momentum,
                        weight_decay=weight_decay, microbatch=microbatch,
                        use_wsd=use_wsd)
    state = _init_state(cfg, policy, seed, dev)
    if policy.enabled:
        step_fn = make_train_step(cfg, policy, hyper, dev)
    else:
        step_fn = make_float_train_step(cfg, hyper, dev)

    losses, times = [], []
    for step in range(steps):
        synchronize(dev)
        t0 = time.perf_counter()
        state, loss = step_fn(state, ds.batch_for_step(step),
                              prng.fold_in(key, step))
        losses.append(float(loss))
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        if not quiet and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d} loss {losses[-1]:.4f} ({times[-1]:.2f}s)")
    stats = {"step_s": times, "tokens_per_step": batch * seq,
             "device": str(dev)}
    return losses, state, stats


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_0_5b")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    default=True, help="the published config, not SMOKE")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--policy", default="int8",
                    choices=list(POLICIES) + list(_UNPORTED_POLICIES))
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--wsd", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--qflow", action="store_true")
    ap.add_argument("--qweights", action="store_true")
    ap.add_argument("--health", action="store_true")
    args = ap.parse_args(argv)
    try:
        losses, _, _ = train(args.arch, smoke=args.smoke, steps=args.steps,
                             batch=args.batch, seq=args.seq,
                             policy_name=args.policy, lr=args.lr,
                             microbatch=args.microbatch, use_wsd=args.wsd,
                             seed=args.seed, ckpt_dir=args.ckpt_dir,
                             qflow=args.qflow, qweights=args.qweights,
                             health=args.health, device=args.device)
    except NotImplementedError as err:
        ap.exit(2, f"error: {err}\n")
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
