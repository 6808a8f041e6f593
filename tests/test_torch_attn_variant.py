"""The attention kernels' shape rules on the CPU: the decode cluster's split
of the band (``decode_split``, ``decode_smem_bytes``),
its row sum taken block by block in ``fmath.sum_windows``'s order, the
planner's decode band, the forward's and the backward's routes
(``attn_fwd_variant``, ``attn_bwd_variant``) and shared memory, and the
operands' alignment (``attn_misaligned``).  Small and quick: no kernel
runs and no JAX step is compiled."""

import pytest
import torch

from repro_torch.core import fmath
from repro_torch.core.bfp import QuantConfig
from repro_torch.kernels import dispatch as kd
from repro_torch.kernels import fused_attention as kfa

WINDOW_T = [31, 32, 33, 160, 1100, 5001, 32768]


def decode_ranges(t: int, n: int) -> list:
    """The positions [t0, t1) each block of an n-block cluster takes of a
    band of T (``csrc/fused_attention.cu`` DecLayout): ceil(m / n) whole
    windows of 32 a block, window 0 starting (32 m - T) // 2 positions
    before 0, the last block the rest."""
    m = -(-t // 32)
    before, w = (32 * m - t) // 2, -(-m // n)
    return [(max(0, 32 * b * w - before),
             min(t, 32 * min(m, (b + 1) * w) - before)) for b in range(n)]


@pytest.mark.parametrize("t", WINDOW_T)
def test_decode_split_cuts_on_the_sum_windows(t):
    """Every block's range starts and ends on a window boundary of the row
    sum (window 0 starts (32 m - T) // 2 positions before 0); the ranges
    tile the band in order, none empty; at most 8 blocks at qwen2's slice
    (GS 7, D 64), one for T <= 32."""
    n = kfa.decode_split(7, t, 64)
    assert 1 <= n <= 8
    if t <= 32:
        assert n == 1
    m = -(-t // 32)
    before = (32 * m - t) // 2
    ranges = decode_ranges(t, n)
    assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == t
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and (b0 + before) % 32 == 0
    assert all(t1 > t0 for t0, t1 in ranges)
    # as even as whole windows allow: every block but the last the same
    widths = [-(-(t1 + before) // 32) - (t0 + before) // 32
              for t0, t1 in ranges]
    assert len(set(widths[:-1])) <= 1 and widths[-1] <= widths[0]


def test_decode_split_sizes():
    """n = ceil(m / max(8, ceil(m / 8))) for the windows m: one block up to
    256 positions, then 8 windows a block up to 8 blocks; 16 blocks only
    where 8 blocks' shared memory is too small."""
    assert [kfa.decode_split(7, t, 64) for t in (19, 160, 256, 257, 600,
                                                 1000, 1100, 1500, 1700,
                                                 4096)] == \
        [1, 1, 1, 2, 3, 4, 5, 6, 7, 8]
    assert kfa.decode_split(7, 48000, 64) == 16
    assert kfa._decode_layout_bytes(7, 48000, 64, 8) > kfa.SMEM_LIMIT
    assert kfa.decode_split(56, 3622, 64) == 15
    for t in (33, 5001, 32768, 48000, 90000):
        assert kfa.decode_split(7, t, 64) <= 16


def _cluster_row_sum(v: torch.Tensor, n: int) -> torch.Tensor:
    """The decode kernel's row sum of v (T,) f32 on an n-block cluster:
    each block sums its windows (index order, from 0), then the window
    sums are summed in order, or windowed again past 32 of them."""
    t = v.numel()
    m = -(-t // 32)
    before = (32 * m - t) // 2
    pad = torch.zeros(32 * m, dtype=torch.float32)
    pad[before:before + t] = v
    sums = []
    for t0, t1 in decode_ranges(t, n):
        w0, w1 = (t0 + before) // 32, -(-(t1 + before) // 32)
        part = torch.zeros(w1 - w0, dtype=torch.float32)
        win = pad[32 * w0:32 * w1].view(-1, 32)
        for i in range(32):
            part = part + win[:, i]
        sums.append(part)
    cur = torch.cat(sums)
    while cur.numel() > 32:
        m2 = -(-cur.numel() // 32)
        b2 = (32 * m2 - cur.numel()) // 2
        nxt = torch.zeros(32 * m2, dtype=torch.float32)
        nxt[b2:b2 + cur.numel()] = cur
        win, cur = nxt.view(-1, 32), torch.zeros(m2, dtype=torch.float32)
        for i in range(32):
            cur = cur + win[:, i]
    tot = torch.zeros((), dtype=torch.float32)
    for x in cur:
        tot = tot + x
    return tot


@pytest.mark.parametrize("t", WINDOW_T)
def test_cluster_row_sum_is_fmath_order(t):
    """Block-wise window sums, gathered in window order, give
    ``fmath.sum_windows``'s sum bit for bit (T = 5001: the offset window
    split inside a block's range; 1100, 5001, 32768: summed again)."""
    g = torch.Generator().manual_seed(t)
    v = torch.rand(t, generator=g, dtype=torch.float32) * \
        torch.pow(2.0, torch.randint(-30, 5, (t,), generator=g).float())
    want = fmath._sum_windows(v[None, :], (-1,))[0]
    got = _cluster_row_sum(v, kfa.decode_split(7, t, 64))
    assert got.view(torch.int32) == want.view(torch.int32)


def test_decode_smem_and_plan_reach_the_32k_band():
    """qwen2-0.5b's decode slice (GS 7, D 64) fits a cluster up to its
    published 32768 positions and plans FUSED there; a band past what a
    16-block cluster holds plans the scan, with the reason."""
    cfg = QuantConfig()
    need = kfa.decode_smem_bytes(7, 32768, 64)
    assert need == kfa._decode_layout_bytes(7, 32768, 64, 8) <= kfa.SMEM_LIMIT
    dec = kd.plan_attention("attn_decode", 7, 32768, 64, cfg, s=1, kind="qi",
                            kernel_mode="fused", device="cuda")
    assert dec.path == kd.FUSED and "8-block cluster" in dec.reason
    dec = kd.plan_attention("attn_decode", 7, 131072, 64, cfg, s=1,
                            kind="qi", kernel_mode="fused", device="cuda")
    assert dec.path == kd.JNP and "16-block cluster" in dec.reason
    assert "shared memory" in dec.reason
    # the per-block need shrinks with the split: 8 blocks hold what 1 cannot
    assert kfa._decode_layout_bytes(7, 32768, 64, 1) > kfa.SMEM_LIMIT
    assert kfa.decode_smem_bytes(7, 1100, 64) < kfa.decode_smem_bytes(
        7, 4096, 64) < need


@pytest.mark.parametrize("d", [8, 12, 16, 32, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("bt", [128, 256, 512])
def test_attn_bwd_variant_and_shared_memory(d, bt):
    """wgmma for D of 32, 64, 96, 128 at any block (chunks of 128
    positions: one layout whatever bt), __dp4a for the rest and for
    unaligned operands; train_smem_bytes follows the route, and a FUSED
    forward still implies a backward that fits."""
    variant = kfa.attn_bwd_variant(64, 4 * bt, d, bt)
    assert variant == ("wgmma" if d in (32, 64, 96, 128) else "dp4a")
    assert kfa.attn_bwd_variant(64, 4 * bt, d, bt, aligned=False) == "dp4a"
    need = kfa.train_smem_bytes("attn_bwd", d, bt)
    if variant == "wgmma":
        assert need == 1024 + 3 * 128 * 128 + 4 * 64 * 128 + 896 * d + 128
        assert need <= kfa.SMEM_LIMIT
    else:
        assert need == kfa._bwd_smem(d, bt, kfa.bwd_strip(d, bt))
    t = {128: 1000, 256: 3000, 512: 5000}[bt]
    assert kd.attn_block_t(t) == bt
    fwd, bwd = (kd.plan_attention(op, 64, t, d, QuantConfig(), s=64,
                                  kernel_mode="fused", device="cuda")
                for op in ("attn_fwd", "attn_bwd"))
    assert bwd.path == (kd.FUSED if need <= kfa.SMEM_LIMIT else kd.JNP)
    assert fwd.path == kd.JNP or bwd.path == kd.FUSED


@pytest.mark.parametrize("bt", [128, 256, 512])
def test_attn_fwd_variant_over_head_dims(bt):
    """wgmma for D of 32, 64, 96 and 128 at every bt with aligned
    operands, __dp4a for every other D up to 300 and for unaligned
    operands; the route does not depend on GS or T."""
    for d in range(1, 301):
        want = "wgmma" if d in (32, 64, 96, 128) else "dp4a"
        for gs, t in ((7, 4 * bt), (896, bt), (130, 4100)):
            assert kfa.attn_fwd_variant(gs, t, d, bt) == want, (d, gs, t)
        assert kfa.attn_fwd_variant(64, 4 * bt, d, bt, aligned=False) == \
            "dp4a"


@pytest.mark.parametrize("d", [8, 12, 32, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("bt", [128, 256, 512])
def test_attn_fwd_shared_memory(d, bt):
    """train_smem_bytes('attn_fwd') follows the route: on wgmma its layout
    (the query tile, V^T of the block's chunks, the warpgroups' row stats,
    then one or two sets of K^ and V^ chunks, two only where they fit),
    always within SMEM_LIMIT; on __dp4a the packed strip's; a FUSED
    forward still implies a backward that fits."""
    need = kfa.train_smem_bytes("attn_fwd", d, bt)
    nch = bt // 128
    if kfa.attn_fwd_variant(64, 4 * bt, d, bt) == "wgmma":
        assert kfa.attn_fwd_tiles(d, bt) == 4
        fixed = -(-(64 * 128 + nch * d * 128 + 4 * (2 * 4 * 64 + 64 * 16))
                  // 1024) * 1024
        sets = 2 if 1024 + fixed + 2 * 2 * nch * 16384 <= kfa.SMEM_LIMIT \
            else 1
        assert (need, sets) == kfa._tc_fwd_layout(d, bt)
        assert need == 1024 + fixed + sets * 2 * nch * 16384
        assert need <= kfa.SMEM_LIMIT
        assert sets == (2 if bt < 512 else 1)
    else:
        dw, tw = -(-d // 4), bt // 4
        assert need == 4 * (16 * dw + bt * (dw | 1) + d * (tw | 1)
                            + 16 * bt + 16 * tw + 16 * d + 64)
    t = {128: 1000, 256: 3000, 512: 5000}[bt]
    fwd, bwd = (kd.plan_attention(op, 64, t, d, QuantConfig(), s=64,
                                  kernel_mode="fused", device="cuda")
                for op in ("attn_fwd", "attn_bwd"))
    assert fwd.path == kd.JNP or bwd.path == kd.FUSED
    if d in (32, 64, 96, 128):
        assert fwd.path == kd.FUSED and fwd.bt == bt


def test_attn_misaligned_forward_operands():
    """The forward's int8 tiles need 16 bytes (16-byte copies), its bits
    8 (two words a load), its exponents 4; bits not passed are not
    checked."""
    needs = {"qm": 16, "km": 16, "vm": 16, "rp": 8, "eq": 4, "ek": 4,
             "ev": 4}
    base = {name: 4096 for name in needs}
    assert kfa.attn_misaligned("attn_fwd", base) == ""
    assert kfa.attn_misaligned("attn_fwd", {**base, "rp": None}) == ""
    for name, need in needs.items():
        for off in (1, 2, 4, 8, 12):
            why = kfa.attn_misaligned("attn_fwd", {**base, name: 4096 + off})
            assert (name in why) == (off % need != 0), (name, off, why)
            assert why == "" or f"{need}-byte" in why


@pytest.mark.parametrize("op,names", [
    ("attn_decode", ["qm", "km", "vm"]),
    ("attn_bwd", ["qm", "gm", "km", "vm", "rs", "rp2"])])
def test_attn_misaligned_names_the_operand(op, names):
    base = {name: 4096 for name in names}
    assert kfa.attn_misaligned(op, base) == ""
    assert kfa.attn_misaligned(op, {**base, "rp": None, "rs": None}) == ""
    for name in names:
        for off in (1, 4, 8):
            need = 16
            why = kfa.attn_misaligned(op, {**base, name: 4096 + off})
            assert (name in why) == (off % need != 0), (name, off, why)
    assert "m at" in kfa.attn_misaligned("attn_bwd", {"m": 4098})
    assert kfa.attn_misaligned("attn_decode", {"ek_rows": 4100}) == ""


def test_every_attention_route_has_a_counter():
    names = set(kd.kernel_launches())
    assert {f"attn_decode_n{n}" for n in kfa.DECODE_SPLITS} <= names
    assert {f"attn_fwd_{v}" for v in kfa.ATTN_FWD_VARIANTS} <= names
    assert {f"attn_bwd_{v}" for v in kfa.ATTN_BWD_VARIANTS} <= names
    assert set(kfa.DECODE_SPLITS) == set(range(1, 17))


def test_dispatch_forward_keeps_cpu_operands_as_given():
    """The forward's dispatch on the CPU: the plain version on offset
    views as given (the copy of an unaligned operand is for the card)."""
    full = torch.randint(-127, 128, (1 + 3 * 2 * 6 * 32,), dtype=torch.int8)
    qm = full[1:1 + 2 * 6 * 32].view(2, 6, 32)
    km = full[3:3 + 2 * 6 * 32].view(2, 6, 32)
    vm = full[5:5 + 2 * 6 * 32].view(2, 6, 32)
    rp = torch.randint(0, 1 << 32, (1 + 2 * 6 * 6,), dtype=torch.int64)
    rp = rp[1:].view(2, 6, 6)
    eq, ek, ev = (torch.tensor(v, dtype=torch.int32) for v in (125, 124, 124))
    kw = dict(p=7, s=3, bt=128, causal=True, window=0, stochastic=True)
    got = kd.attn_fwd(qm, km, vm, rp, eq, ek, ev, 2, 6, **kw)
    want = kfa.attn_fwd_plain(qm.clone(), km.clone(), vm.clone(), rp.clone(),
                              eq, ek, ev, 2, 6, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_dispatch_keeps_cpu_operands_as_given():
    """On the CPU the dispatch runs the plain version on the operands as
    given (the copy of an unaligned operand is for the card only)."""
    full = torch.randint(-127, 128, (1 + 2 * 7 * 8,), dtype=torch.int8)
    qm = full[1:1 + 7 * 8].view(1, 7, 8)
    km = full[1:1 + 7 * 8].view(1, 7, 8)
    ek = torch.full((1, 7, 1), 120, dtype=torch.int32)
    eq = torch.tensor(122, dtype=torch.int32)
    kw = dict(p=7, s=1, causal=True, window=0, stochastic=False)
    got = kd.attn_decode(qm, km, km, ek, ek, None, eq, 6, 7, **kw)
    want = kfa.attn_decode_plain(qm.clone(), km.clone(), km.clone(), ek, ek,
                                 None, eq, 6, 7, **kw)
    assert torch.equal(got, want)
