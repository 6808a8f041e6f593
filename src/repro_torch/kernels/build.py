"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout, at first use.  The hash covers the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
a stale library is never loaded.  There is
no fallback: without ``nvcc`` or a card the build raises.

Flags keep IEEE float semantics: no ``--use_fast_math``, no flush to zero,
IEEE division and square root, and no contraction of a multiply and an add
into one FMA, so each float operation rounds as the plain version's does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build_dir", "build", "load"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fused_linear", "fused_attention", "attn_train", "fused_chain",
           "bfp_quant", "int8_matmul", "qgemm_sm90", "rounding_bits")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-ftz=false", "-prec-div=true",
          "-prec-sqrt=true", "-fmad=false", "-Xptxas", "-v"]
_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(_FLAGS).encode()
                          ).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source not yet built, one ``nvcc`` each, all
    started together.  Returns each compiler's report (registers, shared
    memory, spills).  Raises if any build fails."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib
