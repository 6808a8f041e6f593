"""The chain kernels' plain versions against the JAX package, ``==``.

* ``norm_gemm_plain`` against ``fused_norm_gemm_pallas`` (interpret mode)
  and ``norm_gemm_ref``: RMS and LayerNorm, stochastic and nearest, with
  and without the shift, a true width off the 128 lanes (zero-padded as
  the reference pads it); y, xq, meta and c.
* ``fused_gemm_epi_plain`` against ``gemm_epi_ref``: kinds qq, qi, ii;
  acts None, relu, gelu, silu_glu, gelu_glu (with an input whose logistic
  is sub-normal and whose tanh saturates); with and without a bias; the
  per-tensor out-quantize with ``m_true``; the GELU-GLU also against
  ``fused_gemm_epi_pallas`` (interpret mode) at an odd shape.
* ``decode_block_plain`` against ``decode_block_ref`` and
  ``fused_decode_block_pallas`` (interpret mode): one query head per KV
  head and groups of 4, a sliding window, ``pos`` mid-cache.
* The wrappers take the plain version for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order of the JAX package)
from repro.kernels import fused_chain as jfc
from repro.kernels import fused_linear as jfl
from repro_torch.kernels import fused_chain as tfc
from repro_torch.kernels import fused_linear as tfl


def _bits(shape, seed):
    return np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                      jnp.uint32))


def _t(a):
    if a is None:
        return None
    if a.dtype == np.uint32:
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# (M, n, Kp, N, center, beta, stochastic)
NORM_CASES = [(16, 100, 128, 37, False, False, True),
              (24, 100, 128, 40, True, True, True),
              (8, 64, 128, 64, True, False, False),
              (16, 200, 256, 70, False, True, False)]


@pytest.mark.parametrize("case", NORM_CASES)
def test_norm_gemm_plain_equals_pallas_and_ref(case):
    m, n, kp, nn, center, beta, sr = case
    rng = np.random.RandomState(n + nn)
    x = (rng.randn(m, kp) * 3).astype(np.float32)
    x[:, n:] = 0
    x[1] *= 2.0 ** -40                       # a tiny row
    rin, rout = (_bits((m, kp), 1), _bits((m, kp), 2)) if sr else (None, None)
    gm = rng.randint(1 << 13, 1 << 15, (1, kp)).astype(np.int32)
    gm[:, n:] = 0
    bm = None
    if beta:
        bm = rng.randint(-(1 << 14), 1 << 14, (1, kp)).astype(np.int32)
        bm[:, n:] = 0
    wm = rng.randint(-127, 128, (nn, kp)).astype(np.int8)
    se_w = rng.randint(-12, -5, (1, nn)).astype(np.int32)
    kw = dict(n=n, p=7, center=center)
    jargs = (_j(x), _j(rin), _j(rout), _j(gm), -15, _j(bm), -20, _j(wm),
             _j(se_w))
    got = tfc.norm_gemm_plain(_t(x), _t(rin), _t(rout), _t(gm), -15, _t(bm),
                              -20, _t(wm), _t(se_w), **kw)
    _equal(got, jfc.norm_gemm_ref(*jargs, **kw))
    _equal(got, jfc.fused_norm_gemm_pallas(*jargs, bm=8, stochastic=sr,
                                           interpret=True, **kw))
    wrapped = tfc.fused_norm_gemm(_t(x), _t(rin), _t(rout), _t(gm), -15,
                                  _t(bm), -20, _t(wm), _t(se_w), **kw)
    _equal(wrapped, [g.numpy() for g in got])


@pytest.mark.parametrize("kind", ["qq", "qi", "ii"])
@pytest.mark.parametrize("act", [None, "relu", "silu_glu", "gelu",
                                 "gelu_glu"])
def test_gemm_epi_plain_equals_ref(kind, act):
    rng = np.random.RandomState(7)
    m, k, n = 24, 40, 48
    if kind == "ii":
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
    else:
        a = rng.randn(m, k).astype(np.float32)
        a[3] *= 200.0                     # gate values past the logistic's
    b = (rng.randn(n, k).astype(np.float32) if kind == "qq"
         else rng.randint(-127, 128, (n, k)).astype(np.int8))
    ra, rb = _bits((m, k), 1), _bits((n, k), 2)
    n_out = n // 2 if (act or "").endswith("_glu") else n
    rq = _bits((m, n_out), 3)
    bias = rng.randn(1, n).astype(np.float32)
    ea, eb = np.int32(129 if kind != "ii" else 125), np.int32(128)
    for with_bias, out_q in ((False, False), (True, False), (True, True)):
        kw = dict(kind=kind, act=act, out_q=out_q,
                  m_true=20 if out_q else None)
        bi = bias if with_bias else None
        want = jfl.gemm_epi_ref(_j(a), _j(ra), _j(b), _j(rb), _j(bi), _j(rq),
                                ea, eb, **kw)
        got = tfl.fused_gemm_epi_plain(
            _t(a), _t(ra), _t(b), _t(rb), _t(bi), _t(rq),
            torch.tensor(int(ea)), torch.tensor(int(eb)), **kw)
        _equal(got, want)


def test_gemm_epi_wrapper_and_gelu():
    """On the CPU the wrapper is the plain version; the GELU-GLU equals the
    reference's."""
    rng = np.random.RandomState(8)
    a, b = rng.randn(8, 16).astype(np.float32), rng.randn(8, 16).astype(
        np.float32)
    args = (_t(a), None, _t(b), None, None, None, torch.tensor(129),
            torch.tensor(129))
    for act in ("silu_glu", "gelu_glu"):
        kw = dict(stochastic=False, act=act)
        got = tfl.fused_gemm_epi(*args, **kw)
        _equal(got, [x.numpy() for x in tfl.fused_gemm_epi_plain(*args, **kw)])
        _equal(got, jfl.gemm_epi_ref(_j(a), None, _j(b), None, None, None,
                                     np.int32(129), np.int32(129), **kw))


def test_gemm_epi_gelu_glu_plain_equals_pallas():
    """M 24 (three 8-row strips), K 37, N 58: an odd half width of 29."""
    rng = np.random.RandomState(9)
    m, k, n = 24, 37, 58
    a = (rng.randn(m, k) * 2).astype(np.float32)
    b = rng.randn(n, k).astype(np.float32)
    ra, rb = _bits((m, k), 4), _bits((n, k), 5)
    bias = rng.randn(1, n).astype(np.float32)
    ea, eb = np.int32(130), np.int32(128)
    kw = dict(kind="qq", act="gelu_glu")
    got = tfl.fused_gemm_epi_plain(_t(a), _t(ra), _t(b), _t(rb), _t(bias),
                                   None, torch.tensor(int(ea)),
                                   torch.tensor(int(eb)), **kw)
    _equal(got, jfl.fused_gemm_epi_pallas(
        _j(a), _j(ra), _j(b), _j(rb), _j(bias), None, ea, eb, bm=8,
        interpret=True, **kw))


def _decode_operands(seed, b, d, n_ff, hq, hkv, dh, t):
    rng = np.random.RandomState(seed)

    def i8(*s):
        return rng.randint(-127, 128, s).astype(np.int8)

    def se(n):
        return rng.randint(-14, -9, (1, n)).astype(np.int32)

    nqkv = (hq + 2 * hkv) * dh
    gains = [rng.randint(1 << 13, 1 << 15, (1, d)).astype(np.int32)
             for _ in range(2)]
    ang = rng.rand(dh // 2).astype(np.float32) * 3
    cossin = np.concatenate([np.cos(ang), np.cos(ang), np.sin(ang),
                             np.sin(ang)])[None].astype(np.float32)
    return [rng.randn(b, d).astype(np.float32), i8(nqkv, d), se(nqkv),
            i8(d, hq * dh), se(d), i8(2 * n_ff, d), se(2 * n_ff),
            i8(d, n_ff), se(d), *gains, i8(b, hkv, t, dh),
            rng.randint(118, 126, (b, hkv, t, 1)).astype(np.int32),
            i8(b, hkv, t, dh),
            rng.randint(118, 126, (b, hkv, t, 1)).astype(np.int32), cossin]


# (B, d, n_ff, hq, hkv, dh, T, pos, window)
DECODE_CASES = [(2, 64, 160, 8, 8, 8, 16, 9, 0),
                (3, 64, 96, 8, 2, 16, 40, 37, 0),
                (2, 128, 64, 4, 1, 32, 70, 50, 8)]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_block_plain_equals_ref_and_pallas(case):
    b, d, n_ff, hq, hkv, dh, t, pos, window = case
    ops = _decode_operands(t, b, d, n_ff, hq, hkv, dh, t)
    kw = dict(n_d=d, n_ff=n_ff, hq=hq, hkv=hkv, dh=dh, p=7, window=window,
              se_g1=-14, se_g2=-14)
    got = tfc.decode_block_plain(*map(_t, ops), pos, **kw)
    jops = [_j(o) for o in ops] + [jnp.int32(pos)]
    _equal(got, jfc.decode_block_ref(*jops, **kw))
    _equal(got, jfc.fused_decode_block_pallas(*jops, interpret=True, **kw))
    _equal(tfc.fused_decode_block(*map(_t, ops), pos, **kw),
           [g.numpy() for g in got])
