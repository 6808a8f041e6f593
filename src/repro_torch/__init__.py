"""PyTorch + CUDA port of the integer-arithmetic training and serving system.

``repro`` (JAX, Pallas kernels for the TPU) is the reference; this package
mirrors its module layout (``core/``, ``kernels/``, ``models/``,
``configs/``, ``launch/``) and replaces each TPU kernel on a ported path
with a kernel written by hand for Hopper (``kernels/csrc/*.cu``).  It
imports torch, never jax, and nothing of ``repro``.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device  # noqa: F401
