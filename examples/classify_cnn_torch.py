"""The paper's classification setting on the PyTorch port: a residual CNN
with integer convolutions, the integer batch-norm (forward and backward)
and int16 SGD, trained beside the float32 baseline with the same
hyperparameters on synthetic 10-class images.

    PYTHONPATH=src python examples/classify_cnn_torch.py --device cpu
    PYTHONPATH=src python examples/classify_cnn_torch.py --full --steps 20

The default is the small smoke net (16 x 16 images, widths 8-16); ``--full``
is ResNet-18 for CIFAR (32 x 32 images, widths 64-128-256-512, two basic
blocks a stage, batch 128).  Runs on the card unless ``--device cpu``.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import prng  # noqa: E402
from repro_torch.core.integer_sgd import (integer_sgd_init,  # noqa: E402
                                          master_params_f32)
from repro_torch.core.policy import FLOAT32, NumericPolicy  # noqa: E402
from repro_torch.data import SyntheticVision  # noqa: E402
from repro_torch.device import resolve_device, synchronize  # noqa: E402
from repro_torch.launch.steps import (TrainHyper,  # noqa: E402
                                      make_float_train_step, make_train_step)
from repro_torch.models import convnet  # noqa: E402
from repro_torch.optim import sgd_init  # noqa: E402

# ResNet-18 for CIFAR (He et al. 2015, Table 1 widths; the 3 x 3 stem, no
# max-pool): the model of the survey's Table 1, at its batch of 128.
RESNET18_CIFAR = convnet.CNNConfig(n_classes=10, width=64, n_blocks=2,
                                   n_stages=4, in_channels=3, img=32)
SMOKE = convnet.CNNConfig(img=16, width=8, n_blocks=1, n_stages=2)
POLICIES = {"int8": NumericPolicy(), "int8_qflow": NumericPolicy(qflow=True)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--batch", type=int, default=None,
                    help="default 32, 128 with --full")
    ap.add_argument("--full", action="store_true",
                    help="ResNet-18 for CIFAR instead of the smoke net")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="int8")
    ap.add_argument("--device", default=None, help="cpu, or the card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = RESNET18_CIFAR if args.full else SMOKE
    batch = args.batch or (128 if args.full else 32)
    dev = resolve_device(args.device)
    policy = POLICIES[args.policy]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params0 = convnet.init_params(cfg, gen, dev)
    key = prng.key(args.seed)
    hyper = TrainHyper(lr=args.lr, momentum=0.9)
    st_i = integer_sgd_init(params0, policy, key=key)
    st_f = (params0, sgd_init(params0))
    step_i = make_train_step(cfg, policy, hyper, dev)
    step_f = make_float_train_step(cfg, hyper, dev)
    ds = SyntheticVision(img=cfg.img, batch=batch, seed=args.seed)

    print(f"{cfg.name} on {dev}, batch {batch}, {args.policy} against "
          f"float32")
    print("step   integer-loss   float32-loss   integer s/step")
    for s in range(args.steps):
        b = ds.batch_for_step(s)
        k = prng.fold_in(key, s)
        synchronize(dev)
        t0 = time.perf_counter()
        st_i, li = step_i(st_i, b, k)
        synchronize(dev)
        dt = time.perf_counter() - t0
        st_f, lf = step_f(st_f, b, k)
        if s % 5 == 0 or s == args.steps - 1:
            print(f"{s:4d}   {float(li):12.4f}   {float(lf):12.4f}   "
                  f"{dt:10.3f}")

    accs_i, accs_f = [], []
    for s in range(1000, 1004):
        b = {k: torch.as_tensor(v).to(dev)
             for k, v in ds.batch_for_step(s).items()}
        k = prng.fold_in(key, s)
        accs_i.append(float(convnet.accuracy(master_params_f32(st_i), b, k,
                                             policy, cfg)))
        accs_f.append(float(convnet.accuracy(st_f[0], b, k, FLOAT32, cfg)))
    print(f"\neval accuracy: integer={np.mean(accs_i):.3f}  "
          f"float32={np.mean(accs_f):.3f}")


if __name__ == "__main__":
    main()
