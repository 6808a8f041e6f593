"""Float32 math rounded the way the JAX package's CPU reference rounds it.

The reference runs its float ops under XLA on the CPU, which differs from
torch's kernels in three ways that move results by an ulp:

* a multiply feeding an add is contracted into one fused multiply-add
  (one rounding instead of two);
* ``exp`` and ``log`` are Cephes polynomials evaluated with fused
  multiply-adds, and the logistic is ``1 / (1 + exp(-x))`` on that ``exp``;
  ``tanh`` is Eigen's rational approximation, again with fused
  multiply-adds, and the tanh form of GELU and its pullback follow the
  fused loops XLA builds for ``jax.nn.gelu`` and its VJP;
* a sum whose reduced extent exceeds 32 is taken in windows of 32 (the
  padding split evenly before and after), and the window sums are summed
  again the same way; a short sum runs in index order, and a short sum of
  products contracts each product into its add.

An ulp in a float gradient can flip a later stochastic-rounding decision,
so the training path uses these functions on every device: the port then
computes what the reference computes, bit for bit, on the CPU and the card
alike.  ``exp``, ``fma`` and ``sum_windows`` are differentiable, with the
reference's gradients (``g * exp(x)``; ``g * b``, ``g * a``, ``g``; ``g``
broadcast).  ``fma`` is exact: the product of two float32 values is exact in
float64, the float64 sum's rounding error is recovered exactly (two-sum),
and it breaks the one tie that rounding the float64 sum to float32 can get
wrong.
"""

from __future__ import annotations

import math
import struct
from typing import Sequence

import torch

__all__ = ["fma", "exp", "log", "logistic", "tanh", "gelu", "gelu_pullback",
           "sum_windows", "sum_fused_2d", "sum_products_cols", "sum_rows_1d",
           "mean_hw"]

_WINDOW = 32


def _fma(a, b, c) -> torch.Tensor:
    # a Python float stays a scalar (already a float32 value): copying it
    # to the card would be a blocking host-to-device copy per call
    a64, b64, c64 = (t.to(torch.float32).double()
                     if isinstance(t, torch.Tensor) else _f(t)
                     for t in (a, b, c))
    p = a64 * b64                          # exact: 24 + 24 significant bits
    s = p + c64
    t = s - p
    err = (p - (s - t)) + (c64 - t)        # s + err == a * b + c exactly
    r = s.float()
    # s + err rounds as s does unless s is a float32 midpoint: then the
    # sign of err, not round-to-even, picks the neighbour
    toward = torch.where(err > 0, math.inf, -math.inf).float()
    nxt = torch.nextafter(r, toward)
    mid = (r.double() + nxt.double()) * 0.5
    return torch.where((err != 0) & (s == mid), nxt, r)


def _f(v: float) -> float:
    """A Python float rounded to float32."""
    return struct.unpack("f", struct.pack("f", v))[0]


_LOG2E = _f(1.44269504088896341)
_LN2_HI = _f(0.693359375)
_LN2_LO = _f(-2.12194440e-4)
_EXP_P = [_f(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)]
_LOG_P = [_f(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_SQRTHF = _f(0.707106781186547524)
_TINY = 2.0 ** -126              # the smallest normal float32


def _exp(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32).clamp(_f(-87.8), _f(88.8))
    n = torch.floor(_fma(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    a = _fma(-_LN2_HI, n, x)
    a = _fma(-_LN2_LO, n, a)
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = _fma(z, a, c)
    z = _fma(z, a * a, a)
    z = 1.0 + z
    ni = n.to(torch.int32)
    p2 = ((ni + 127) << 23).view(torch.float32)
    return z * torch.where(ni == -127, torch.zeros_like(p2), p2)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log of positive finite x (mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial, exponent added back in
    two parts; not differentiable)."""
    x = x.to(torch.float32).clamp(min=torch.finfo(torch.float32).tiny)
    m, e = torch.frexp(x)
    e = e.to(torch.float32)
    small = m < _SQRTHF
    t = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    t2 = t * t
    t3 = t2 * t
    y = _fma(t, _LOG_P[0], _LOG_P[1])
    y1 = _fma(t, _LOG_P[3], _LOG_P[4])
    y2 = _fma(t, _LOG_P[6], _LOG_P[7])
    y = _fma(y, t, _LOG_P[2])
    y1 = _fma(y1, t, _LOG_P[5])
    y2 = _fma(y2, t, _LOG_P[8])
    y = _fma(y, t3, y1)
    y = _fma(y, t3, y2)
    y = y * t3
    y = _fma(_LN2_LO, e, y)
    t = _fma(-0.5, t2, t)
    t = t + y
    return _fma(_LN2_HI, e, t)


def logistic(x: torch.Tensor) -> torch.Tensor:
    """float32 1 / (1 + e^-x) (not differentiable).  A sub-normal result
    (x below about -87.3) is 0: XLA's CPU build flushes it."""
    s = 1.0 / (1.0 + _exp(-x))
    return torch.where(s < _TINY, torch.zeros_like(s), s)


def _f_bits(h: str) -> float:
    """A float32 constant from the hex of its float64 value (as LLVM IR
    prints it)."""
    return struct.unpack(">d", bytes.fromhex(h))[0]


# Eigen's float tanh as XLA's CPU build lowers it (``xla.tanh.f32``):
# x * P(x^2) / Q(x^2) on x clamped to +-_TANH_CLAMP, x itself below
# _TANH_TINY, +-1 from 20 on.
_TANH_TINY = _f_bits("3F3A36E2E0000000")        # about 4e-4
_TANH_CLAMP = _f_bits("401FFEC880000000")       # 7.99881...
_TANH_P = [_f_bits(h) for h in (
    "BCB3E4B800000000", "3D4C266FC0000000", "BDD7A6FFE0000000",
    "3E6B800820000000", "3EEF286940000000", "3F44E1BDA0000000",
    "3F740B3B80000000")]
_TANH_Q = [_f_bits(h) for h in (
    "3EB41A7B00000000", "3F1F12BAC0000000", "3F629540A0000000",
    "3F740B3BA0000000")]
_GELU_A = _f(0.044715)
_GELU_S = _f(math.sqrt(2.0 / math.pi))
_GELU_AS = _f(_GELU_S * _GELU_A)   # the product XLA folds into one constant


def _horner(x2: torch.Tensor, coeffs) -> torch.Tensor:
    acc = _fma(x2, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        acc = _fma(x2, acc, c)
    return acc


def tanh(x: torch.Tensor) -> torch.Tensor:
    """float32 tanh (not differentiable): Eigen's rational form, each
    multiply-add of the two Horner chains fused, ``x * x`` and ``x * P``
    plain multiplies, an IEEE division."""
    x = x.to(torch.float32)
    c = x.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    x2 = c * c
    r = (c * _horner(x2, _TANH_P)) / _horner(x2, _TANH_Q)
    a = x.abs()
    r = torch.where(a < _TANH_TINY, x, r)
    return torch.where(a >= 20.0, torch.copysign(torch.ones_like(x), x), r)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return tanh(_GELU_S * _fma(_GELU_A, (x * x) * x, x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """float32 ``jax.nn.gelu`` (the tanh form; not differentiable):
    x * (0.5 * (1 + tanh(sqrt(2/pi) * fma(0.044715, x^3, x)))); a
    sub-normal result is a zero of its sign, as XLA's CPU build flushes
    it."""
    x = x.to(torch.float32)
    y = x * (0.5 * (1.0 + _gelu_tanh(x)))
    return torch.where(y.abs() < _TINY, y * 0.0, y)


def gelu_pullback(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``p * gelu'(x)`` as XLA's CPU build computes the VJP of ``gelu(x) *
    u`` (``p = ct * u``) or of ``gelu(x)`` (``p = ct``): one fused loop
    that recomputes t = tanh(...), rounds the chain rule's products in the
    jaxpr's order with sqrt(2/pi) * 0.044715 folded into one constant, and
    fuses three multiply-adds (not differentiable)."""
    x, p = x.to(torch.float32), p.to(torch.float32)
    t = _gelu_tanh(x)
    m = 0.5 * (1.0 + t)
    d = ((x * p) * 0.5) * (1.0 - t)
    v = _fma(d, t, d)
    return _fma(v * _GELU_AS, (x * x) * 3.0, _fma(p, m, v * _GELU_S))


def _unbroadcast(g: torch.Tensor, shape) -> torch.Tensor:
    """Sum a broadcast gradient back to ``shape`` (in the reference's
    order)."""
    lead = g.ndim - len(shape)
    dims = list(range(lead)) + [lead + i for i, n in enumerate(shape)
                                if n == 1 and g.shape[lead + i] != 1]
    return _sum_windows(g, dims).reshape(shape) if dims else g


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shape_c = c.shape
        return _fma(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return (_unbroadcast(g * b, a.shape), _unbroadcast(g * a, b.shape),
                _unbroadcast(g, ctx.shape_c))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, broadcasting; Python floats
    are constants."""
    if all(isinstance(t, torch.Tensor) for t in (a, b, c)):
        return _Fma.apply(a, b, c)
    return _fma(a, b, c)


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _exp(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * y


def exp(x: torch.Tensor) -> torch.Tensor:
    """float32 e^x: e^a * 2^n with n = floor(x log2(e) + 1/2), a degree-6
    polynomial on the reduced argument; 2^n below 2^-126 flushes to 0."""
    return _Exp.apply(x)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dims):
        ctx.shape, ctx.dims = x.shape, sorted(d % x.ndim for d in dims)
        return _sum_windows(x, dims)

    @staticmethod
    def backward(ctx, g):
        for d in ctx.dims:
            g = g.unsqueeze(d)
        return g.expand(ctx.shape), None


def sum_windows(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """Sum of float32 ``x`` over ``dims`` in the reference's order (see
    the module note).  The reduced dims are dropped."""
    return _Sum.apply(x, tuple(dims))


def _sum_products(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` of ``a * b`` as XLA's CPU build reduces a product
    (not differentiable): at most 32 terms contract each product into its
    add (a chain of fused multiply-adds from 0, in index order); more terms
    round each product and sum them in windows (``sum_windows``)."""
    a, b = torch.broadcast_tensors(a, b)
    n = a.shape[dim]
    if n > _WINDOW:
        return _sum_windows(a * b, (dim,))
    a, b = a.movedim(dim, 0), b.movedim(dim, 0)
    acc = torch.zeros_like(a[0])
    for i in range(n):
        acc = _fma(a[i], b[i], acc)
    return acc


# Row count -> (lanes, accumulators, epilogue lanes) of the loop LLVM
# vectorizes for a column of 16 to 32 products (measured; any other count
# in 20-31 takes (8, 1, 0)).
_COL_LOOPS = {16: (8, 1, 0), 17: (8, 1, 0), 18: (8, 2, 2), 19: (8, 2, 2),
              32: (8, 2, 0)}


def sum_products_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 of ``a * b`` as XLA's CPU build reduces a column of
    products computed in the same fusion (``qnorm_gemm``'s dgamma; not
    differentiable).  Below 16 rows and above 32 as ``_sum_products``.
    From 16 to 32 rows LLVM vectorizes the row loop: ``lanes`` rows at a
    time go into each of ``accumulators`` vectors with a fused
    multiply-add (the first vector's lane 0 starts at 0, every other lane
    at -0), the accumulators are added and their lanes combined by halves,
    an ``epilogue``-lane vector takes the next whole group of rows the same
    way, and the last rows are fused multiply-adds in order
    (``_COL_LOOPS``)."""
    a, b = torch.broadcast_tensors(a.to(torch.float32), b.to(torch.float32))
    m = a.shape[0]
    if not 16 <= m <= 32:
        return _sum_products(a, b, 0)
    lanes, n_acc, epi = _COL_LOOPS.get(m, (8, 1, 0))
    rest = a.shape[1:]
    accs = [torch.full((lanes,) + rest, -0.0, device=a.device)
            for _ in range(n_acc)]
    accs[0][0] = 0.0
    step = lanes * n_acc
    main = m - m % step
    for c in range(0, main, step):
        for u in range(n_acc):
            r = c + u * lanes
            accs[u] = _fma(a[r:r + lanes], b[r:r + lanes], accs[u])
    v = accs[0]
    for acc in accs[1:]:
        v = acc + v
    total = _lane_tree(v)
    r = main
    if epi and m - r >= epi:
        v = torch.cat([total[None], torch.full((epi - 1,) + rest, -0.0,
                                               device=a.device)])
        for c in range(r, m - (m - r) % epi, epi):
            v = _fma(a[c:c + epi], b[c:c + epi], v)
        total = _lane_tree(v)
        r = m - (m - r) % epi
    for c in range(r, m):
        total = _fma(a[c], b[c], total)
    return total


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 in index order, from a zero start."""
    acc = x[0] + 0.0
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _lane_tree(v: torch.Tensor) -> torch.Tensor:
    """A 2- to 8-lane vector's sum as the x86 horizontal reduction takes
    it: the high half onto the low half until one lane is left."""
    while v.shape[0] > 1:
        h = v.shape[0] // 2
        v = v[:h] + v[h:]
    return v[0]


def sum_fused_2d(x: torch.Tensor) -> torch.Tensor:
    """Sum of all of float32 ``x`` (B, S) as XLA's CPU build reduces it when
    the reduction is fused with the ops that compute ``x`` (the mean of
    ``softmax_xent``; not differentiable).  A dim over 32 is tree-rewritten
    into windows (``sum_windows`` over both dims).  Otherwise the sum runs
    in index order; LLVM may vectorize that loop into lanes, a cost-model
    choice the port does not follow (PERF.md §6)."""
    x = x.to(torch.float32)
    if max(x.shape) > _WINDOW:
        return _sum_windows(x, (0, 1))
    return _sum_in_order(x.reshape(-1))


def sum_rows_1d(x: torch.Tensor) -> torch.Tensor:
    """Sum of a float32 vector (B,) as XLA's CPU build reduces the fused
    gather-and-sum of the CNN loss's mean (not differentiable): below 16
    terms in index order; 16 to 32 as one 8-lane vector (lane 0 from 0,
    the others from -0) over each whole group of 8, its lanes combined by
    halves; at 20-23 terms the next 4 then as a 4-lane vector whose lane 0
    starts from that sum, combined by halves; then the rest in order; over
    32 in windows.  Measured at 4-128 terms (the fusion's
    ``ir-with-opt.ll``: a vectorized loop and, at 20-23, its 4-lane
    epilogue)."""
    x = x.to(torch.float32)
    n = x.shape[0]
    if n > _WINDOW:
        return _sum_windows(x, (0,))
    if n < 16:
        return _sum_in_order(x)
    main = n - n % 8
    total = _lane_tree(_lanes(x[:main].reshape(-1, 8)))
    if 20 <= n <= 23:
        v = torch.full((4,), -0.0, device=x.device)
        v[0] = total
        total = _lane_tree(v + x[main:main + 4])
        main += 4
    for c in range(main, n):
        total = total + x[c]
    return total


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """Lane accumulators of a vectorized loop: x (steps, lanes, ...) added
    step by step into lanes that start from 0 (lane 0) and -0 (the
    others)."""
    acc = torch.full(x.shape[1:], -0.0, dtype=x.dtype, device=x.device)
    acc[0] = 0.0
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc


def _sum_rows_lanes(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """Sum of (B, H, W, C) over H and W as a loop over H vectorized into
    ``lanes`` lanes: lane l adds rows l, l + lanes, ... of the whole
    groups, each row's W values in order; the lanes combined by halves;
    then the remaining rows in order."""
    b, h, w, c = x.shape
    main = h - h % lanes
    steps = x[:, :main].reshape(b, main // lanes, lanes, w, c)
    steps = steps.permute(1, 3, 2, 0, 4).reshape(-1, lanes, b, c)
    total = _lane_tree(_lanes(steps))
    for r in range(main, h):
        for j in range(w):
            total = total + x[:, r, j]
    return total


# Lanes of XLA's vectorized loop over the pool's rows at each H that
# LLVM's cost model vectorizes (the fusion's ``ir-with-opt.ll``; every
# other H of 1-32 keeps the loop scalar, in index order).
_POOL_LANES = {4: 4, 8: 8, 16: 8, 17: 8, 18: 8}


class _MeanHW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        h, w = x.shape[1:3]
        ctx.shape = x.shape
        ctx.r = r = _f(1.0 / (h * w))
        if h == w and _WINDOW < h <= 2 * _WINDOW:
            # a 2 x 2 grid of windows of 32 x 32, each in index order, is
            # summed as 2 lanes (a larger grid in order: _sum_windows)
            return _sum_rows_lanes(_window_sums_hw(x), 2) * r
        lanes = _POOL_LANES.get(h) if h == w else None
        if lanes is None:
            return _sum_windows(x, (1, 2)) * r
        return _sum_rows_lanes(x, lanes) * r

    @staticmethod
    def backward(ctx, g):
        b, h, w, c = ctx.shape
        return (g * ctx.r)[:, None, None, :].expand(b, h, w, c)


def mean_hw(x: torch.Tensor) -> torch.Tensor:
    """Mean of an NHWC float32 tensor over H and W -> (B, C), as XLA's CPU
    build reduces the CNN's fused ``relu(h + sc).mean(axis=(1, 2))`` (the
    global average pool), then times f32(1 / (H*W)).  A square pool of H
    in ``_POOL_LANES`` is a loop over H vectorized into 4 or 8 lanes (lane
    0 from 0, the others from -0), each lane adding its rows' W values in
    order, the lanes combined by halves, the rows past the last whole
    group in order; other H up to 32 in index order; over 32, windows of
    32 x 32 in index order, whose 2 x 2 grid (H 33-64) is then 2 lanes
    and a larger grid in order.  Measured at H 1-32, 40, 48, 56, 64, 72,
    96 and 128 (the fusions' ``ir-with-opt.ll``).  The gradient is g *
    f32(1 / (H*W)) at every position."""
    return _MeanHW.apply(x)


def _window_sums_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, nh, nw, C): each window of 32 x 32 of H and W
    (padded with zeros at both ends, as XLA's reduce-window) summed in
    index order from a zero start."""
    b, h, w, c = x.shape
    ph, pw = -h % _WINDOW, -w % _WINDOW
    x = torch.nn.functional.pad(
        x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    nh, nw = x.shape[1] // _WINDOW, x.shape[2] // _WINDOW
    x = x.reshape(b, nh, _WINDOW, nw, _WINDOW, c).permute(2, 4, 0, 1, 3, 5)
    return _sum_in_order(x.reshape(_WINDOW * _WINDOW, b, nh, nw, c))


def _sum_windows(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    dims = sorted(d % x.ndim for d in dims)
    keep = [d for d in range(x.ndim) if d not in dims]
    x = x.permute(*dims, *keep)
    sizes = [x.shape[i] for i in range(len(dims))]
    rest = x.shape[len(dims):]
    if max(sizes) <= _WINDOW:
        return _sum_in_order(x.reshape(-1, *rest))
    # windows of 32 along every reduced dim longer than 32 (a shorter dim
    # is one window); each window summed in index order from a zero start
    parts, wins = [], []
    for i, n in enumerate(sizes):
        if n > _WINDOW:
            pad = -n % _WINDOW
            widths = [0, 0] * (x.ndim - 1 - i) + [pad // 2, pad - pad // 2]
            x = torch.nn.functional.pad(x, widths)
            parts.append((n + pad) // _WINDOW)
            wins.append(_WINDOW)
        else:
            parts.append(1)
            wins.append(n)
    k = len(sizes)
    x = x.reshape(*[v for pw in zip(parts, wins) for v in pw], *rest)
    x = x.permute(*range(1, 2 * k, 2), *range(0, 2 * k, 2),
                  *range(2 * k, 2 * k + len(rest)))
    acc = _sum_in_order(x.reshape(math.prod(wins), *parts, *rest))
    return _sum_windows(acc, range(k))
