"""Residual CNN for CIFAR-style classification: the paper's own model
family (ResNet-18 for CIFAR at ``CNNConfig(width=64, n_blocks=2,
n_stages=4)``).

The port of ``repro.models.convnet`` as plain functions on the parameter
tree, in the style of ``models.transformer``: integer convolutions
(``qconv``: im2col integer GEMMs, forward and A.2 backward), the integer
batch-norm with its integer backward (``qbatchnorm``), ReLU, float32
residual adds on the dequantized values, the global average pool, an int8
linear head and a float32 log-softmax cross entropy.  Under qflow the
conv -> bn -> relu -> conv chain of each block stays on BFP activations.
The pool and the loss sum in the reference's order (``core.fmath``).
Strides are structural (``block_plan``), never parameters; the blocks are
a list, so ``params["blocks"][i]`` is block ``i``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from ..core import fmath, prng
from ..core.bfp import bfp_value
from ..core.policy import QW_NONE, QW_TENSOR, NumericPolicy
from ..core.qnorm import qbatchnorm
from ..core.qops import qconv, qmatmul, qrelu
from .common import dense_init, log_softmax_nll

__all__ = ["CNNConfig", "init_params", "weight_mask", "block_plan", "apply",
           "loss_fn", "accuracy"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    n_classes: int = 10
    width: int = 16            # stem channels (ResNet-18 for CIFAR: 64)
    n_blocks: int = 2          # residual blocks a stage
    n_stages: int = 2          # stages (stride 2 between stages)
    in_channels: int = 3
    img: int = 32

    @property
    def name(self) -> str:
        return (f"cnn_w{self.width}_s{self.n_stages}x{self.n_blocks}"
                f"_img{self.img}")


def _conv_init(generator, kh, kw, cin, cout, device):
    return dense_init((kh, kw, cin, cout), generator,
                      math.sqrt(2.0 / (kh * kw * cin)), device)


def block_plan(cfg: CNNConfig):
    """(stage, out channels, stride) of every block, in order."""
    plan = []
    for s in range(cfg.n_stages):
        cout = cfg.width * (2 ** s)
        for b in range(cfg.n_blocks):
            plan.append((s, cout, 2 if (b == 0 and s > 0) else 1))
    return plan


def init_params(cfg: CNNConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters from a seeded ``torch.Generator`` (He-scaled
    truncated normal filters, the JAX package's sigmas; the draws differ
    from ``jax.random``).  A block whose width or stride changes has a
    1 x 1 projection shortcut (no batch-norm on it, as in the reference)."""

    def bn(c):
        return {"g": torch.ones((c,), device=device),
                "b": torch.zeros((c,), device=device)}

    params: Dict[str, Any] = {
        "stem": _conv_init(generator, 3, 3, cfg.in_channels, cfg.width,
                           device),
        "stem_bn": bn(cfg.width), "blocks": []}
    c = cfg.width
    for _, cout, stride in block_plan(cfg):
        blk = {"conv1": _conv_init(generator, 3, 3, c, cout, device),
               "bn1": bn(cout),
               "conv2": _conv_init(generator, 3, 3, cout, cout, device),
               "bn2": bn(cout)}
        if c != cout or stride != 1:
            blk["proj"] = _conv_init(generator, 1, 1, c, cout, device)
        params["blocks"].append(blk)
        c = cout
    params["head"] = dense_init((c, cfg.n_classes), generator, None, device)
    return params


def weight_mask(cfg: CNNConfig) -> Dict[str, Any]:
    """qweights currency: every filter and the head one per-tensor BFP;
    batch-norm gains and shifts stay float32."""
    bn = {"g": QW_NONE, "b": QW_NONE}
    mask: Dict[str, Any] = {"stem": QW_TENSOR, "stem_bn": dict(bn),
                            "blocks": [], "head": QW_TENSOR}
    c = cfg.width
    for _, cout, stride in block_plan(cfg):
        blk = {"conv1": QW_TENSOR, "bn1": dict(bn), "conv2": QW_TENSOR,
               "bn2": dict(bn)}
        if c != cout or stride != 1:
            blk["proj"] = QW_TENSOR
        mask["blocks"].append(blk)
        c = cout
    return mask


def _block(x, blk, stride: int, key: prng.Key, policy: NumericPolicy):
    # qflow: conv1 emits a BFP, bn1 adopts its mantissas and emits one,
    # relu acts on the mantissas, conv2 contracts them; bn2 returns
    # float32 for the residual add
    oq = policy.qflow_seams
    ks = prng.split(key, 4)
    st = (stride, stride)
    h = qconv(x, blk["conv1"], ks[0], policy, stride=st, out_q=oq)
    h, _, _ = qbatchnorm(h, blk["bn1"]["g"], blk["bn1"]["b"], ks[1], policy,
                         out_q=oq)
    h = qrelu(h)
    h = qconv(h, blk["conv2"], ks[2], policy, out_q=oq)
    h, _, _ = qbatchnorm(h, blk["bn2"]["g"], blk["bn2"]["b"], ks[3], policy)
    sc = x
    if "proj" in blk:
        sc = qconv(x, blk["proj"], prng.fold_in(key, 9), policy, stride=st)
    return torch.relu(h + bfp_value(sc))


def apply(params, x: torch.Tensor, key: prng.Key, policy: NumericPolicy,
          cfg: CNNConfig = CNNConfig()) -> torch.Tensor:
    """x (B, H, W, C) f32 -> logits (B, n_classes)."""
    oq = policy.qflow_seams
    ks = prng.split(key, 3)
    h = qconv(x, params["stem"], ks[0], policy, out_q=oq)
    h, _, _ = qbatchnorm(h, params["stem_bn"]["g"], params["stem_bn"]["b"],
                         ks[1], policy, out_q=oq)
    h = qrelu(h)
    for i, ((_, _, stride), blk) in enumerate(zip(block_plan(cfg),
                                                  params["blocks"])):
        h = _block(h, blk, stride, prng.fold_in(key, 100 + i), policy)
    return qmatmul(fmath.mean_hw(h), params["head"], ks[2], policy)


def loss_fn(params, batch: Dict[str, torch.Tensor], key: prng.Key,
            policy: NumericPolicy, cfg: CNNConfig = CNNConfig()):
    """Mean cross entropy of {images, labels}; the softmax stays float."""
    logits = apply(params, batch["images"], key, policy, cfg)
    return log_softmax_nll(logits, batch["labels"])


def accuracy(params, batch: Dict[str, torch.Tensor], key: prng.Key,
             policy: NumericPolicy, cfg: CNNConfig = CNNConfig()
             ) -> torch.Tensor:
    logits = apply(params, batch["images"], key, policy, cfg)
    return (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
