"""The serving slice end to end on the CPU, against the JAX package.

* ``auto`` (the plain mirror of JAX's off-TPU path, decode through
  qcache_qk / qcache_pv) reproduces ``tests/goldens/train_decode_pr5.npz``
  ``decode_logits_0..3`` bit for bit.  Those goldens were drawn under
  ``jax_threefry_partitionable=False``, so both sides use that key mode.
* ``fused`` (the kernels' numerics through their plain versions) matches
  live JAX ``kernel_mode="fused"`` serving (Pallas in interpret mode)
  bit for bit on the same weights, prompts and tokens.
* The package imports no jax and nothing of ``repro``; entry points
  refuse to run without a card unless given ``device="cpu"``.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.policy import NumericPolicy as JaxPolicy
from repro.launch.steps import make_decode_step as jax_decode_step
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import quantize_serving_params as jax_quantize
from repro.models import get_model
from repro_torch.configs import get_smoke_config as torch_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.core.policy import NumericPolicy
from repro_torch.kernels import dispatch as kd
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "train_decode_pr5.npz")
ARCH, BATCH, PROMPT, GEN = "qwen2_0_5b", 2, 8, 4


def _jax_inputs(partitionable: bool):
    """JAX init params (numpy) and prompts under the given key mode."""
    cfg = get_smoke_config(ARCH)
    with jax.threefry_partitionable(partitionable):
        key = jax.random.key(0)
        params = get_model(cfg).init_params(key, cfg)
        np_params = jax.tree_util.tree_map(np.array, params)
        prompts = np.array(jax.random.randint(
            jax.random.fold_in(key, 1), (BATCH, PROMPT), 0, cfg.vocab))
    return params, np_params, prompts


def _port_serve(np_params, prompts, policy, key, tokens=None):
    """Prefill + GEN-1 decode steps on the port; greedy unless ``tokens``
    (B, GEN) forces the fed tokens.  Returns (logits list, tokens)."""
    cfg = torch_smoke_config(ARCH)
    params = tsteps.quantize_serving_params(
        params_from_numpy(np_params, "cpu"), cfg, policy,
        prng.fold_in(key, 0x9E))
    prefill = tsteps.make_prefill_step(cfg, policy, PROMPT + GEN, "cpu")
    decode = tsteps.make_decode_step(cfg, policy, "cpu")
    cache, lg = prefill(params, {"tokens": torch.from_numpy(prompts)},
                        prng.fold_in(key, 3))
    outs, toks = [lg.numpy()], [lg.argmax(-1)]
    for i in range(GEN - 1):
        tok = toks[-1] if tokens is None else torch.from_numpy(tokens[:, i])
        lg, cache = decode(params, cache, tok, PROMPT + i,
                           prng.fold_in(key, 10 + i))
        outs.append(lg.numpy())
        toks.append(lg.argmax(-1))
    return outs, np.stack([t.numpy() for t in toks], axis=1)


def test_auto_reproduces_decode_goldens():
    golden = np.load(GOLDEN)
    _, np_params, prompts = _jax_inputs(partitionable=False)
    outs, _ = _port_serve(np_params, prompts,
                          NumericPolicy(qweights=True, qcache=True),
                          prng.key(0, partitionable=False))
    for i, got in enumerate(outs):
        want = golden[f"decode_logits_{i}"]
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_array_equal(got, want)


def test_fused_matches_live_jax_fused_serving():
    params, np_params, prompts = _jax_inputs(partitionable=True)
    cfg = get_smoke_config(ARCH)
    jpol = JaxPolicy(qweights=True, qcache=True, kernel_mode="fused")
    key = jax.random.key(0)
    jparams = jax_quantize(params, cfg, jpol, jax.random.fold_in(key, 0x9E))
    prefill = jax.jit(jax_prefill_step(cfg, jpol, PROMPT + GEN))
    decode = jax.jit(jax_decode_step(cfg, jpol))
    cache, lg = prefill(jparams, {"tokens": jnp.asarray(prompts)},
                        jax.random.fold_in(key, 3))
    want, toks = [np.asarray(lg)], [np.asarray(jnp.argmax(lg, -1))]
    for i in range(GEN - 1):
        lg, cache = decode(jparams, cache, jnp.asarray(toks[-1], jnp.int32),
                           jnp.int32(PROMPT + i), jax.random.fold_in(key, 10 + i))
        want.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg, -1)))
    toks = np.stack(toks, axis=1)
    with kd.record_decisions() as log:
        got, got_toks = _port_serve(
            np_params, prompts, NumericPolicy(qweights=True, qcache=True,
                                              kernel_mode="fused"),
            prng.key(0), tokens=toks)
    np.testing.assert_array_equal(got_toks, toks)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fused = {(d.op, d.kind) for d in log if d.path == kd.FUSED}
    assert fused == {("qmatmul_fwd", "qi"), ("qbmm_fwd", "qq"),
                     ("attn_decode", "qi")}


def test_quantize_serving_params_equal_jax():
    params, np_params, _ = _jax_inputs(partitionable=True)
    policy = NumericPolicy(qweights=True)
    got = tsteps.quantize_serving_params(
        params_from_numpy(np_params, "cpu"), torch_smoke_config(ARCH),
        policy, prng.fold_in(prng.key(0), 0x9E))
    want = jax_quantize(params, get_smoke_config(ARCH),
                        JaxPolicy(qweights=True),
                        jax.random.fold_in(jax.random.key(0), 0x9E))
    for name in ("wq", "wo", "w_down"):
        np.testing.assert_array_equal(got["layers"][name].m.numpy(),
                                      np.asarray(want["layers"][name].m))
        np.testing.assert_array_equal(got["layers"][name].e.numpy(),
                                      np.asarray(want["layers"][name].e))
    np.testing.assert_array_equal(got["embed"].m.numpy(),
                                  np.asarray(want["embed"].m))
    np.testing.assert_array_equal(got["fn_g"].numpy(),
                                  np.asarray(want["fn_g"]))
    # BFP leaves given to the converter as (m, e) pairs land in the same
    # values and the same K-innermost layout as the port's own quantization
    pairs = jax.tree_util.tree_map(
        lambda x: (np.array(x.m), np.array(x.e)) if hasattr(x, "cfg")
        else np.array(x), want, is_leaf=lambda x: hasattr(x, "cfg"))
    conv = params_from_numpy(pairs, "cpu")
    for name in ("wq", "w_down"):
        a, b = conv["layers"][name], got["layers"][name]
        assert torch.equal(a.m, b.m) and torch.equal(a.e, b.e)
        assert a.m.stride() == b.m.stride()
        assert a.m.transpose(-1, -2)[0].is_contiguous()


def test_serve_runs_on_cpu_only_when_asked():
    toks, stats = tserve.serve(ARCH, batch=BATCH, prompt_len=PROMPT, gen=3,
                               qcache=True, device="cpu", quiet=True)
    assert toks.shape == (BATCH, 3) and stats["device"] == "cpu"
    assert all(bool(torch.isfinite(lg).all()) for lg in stats["logits"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    for call in (lambda: tserve.serve(ARCH, quiet=True),
                 lambda: tsteps.make_decode_step(torch_smoke_config(ARCH),
                                                 NumericPolicy()),
                 lambda: params_from_numpy({"w": np.zeros(2)})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_validate_request_rejects_bad_requests():
    with pytest.raises(tserve.ServeConfigError):
        tserve.validate_request("rwkv6_3b", "int8", batch=1, prompt_len=1,
                                gen=1)
    with pytest.raises(tserve.ServeConfigError):
        tserve.validate_request(ARCH, "float32", batch=1, prompt_len=1,
                                gen=1, qcache=True)
    with pytest.raises(tserve.ServeConfigError):
        tserve.validate_request(ARCH, "int8", batch=0, prompt_len=1, gen=1)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.launch.steps, "
            "repro_torch.convert, repro_torch.kernels.dispatch, "
            "repro_torch.core.fmath, repro_torch.core.integer_sgd, "
            "repro_torch.optim, repro_torch.data, "
            "repro_torch.models.transformer, repro_torch.models.attention, "
            "repro_torch.kernels.fused_attention, repro_torch.core.qnorm; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
