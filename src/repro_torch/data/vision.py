"""Synthetic vision data for the paper's classification setting.

The port's own copy of ``repro.data.vision`` (numpy only, the same draws):
each class has a fixed random template, and a sample is its class's
template plus Gaussian noise, so a CNN separates the classes quickly and
integer-against-float training is comparable in a few steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticVision"]


@dataclasses.dataclass(frozen=True)
class SyntheticVision:
    n_classes: int = 10
    img: int = 32
    channels: int = 3
    batch: int = 64
    seed: int = 0
    noise: float = 0.6

    def _templates(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.randn(self.n_classes, self.img, self.img,
                         self.channels).astype(np.float32)

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """{"images": (B, img, img, channels) f32, "labels": (B,) int32}."""
        rng = np.random.Generator(np.random.Philox(
            key=self.seed + 1, counter=[step, 0, 0, 2]))
        labels = rng.integers(0, self.n_classes, size=(self.batch,))
        t = self._templates()[labels]
        x = t + self.noise * rng.standard_normal(t.shape).astype(np.float32)
        return {"images": x.astype(np.float32),
                "labels": labels.astype(np.int32)}
