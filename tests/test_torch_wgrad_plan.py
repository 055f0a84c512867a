"""The launch plan of the sparse conv's weight gradient K9
(``sparse_conv_wgrad``), held on the CPU.

``wgrad_plan`` (ops/sparse_conv.py) is what the wrapper hands to the kernel:
the channel tiles, the warps' split of a tile, the rows of an item and of a
block's span, the grid and the shared memory.  The C entry point
(csrc/sparse_conv.cu) refuses a plan whose tiles or layout disagree with its
own.  Here the plan is held at every K9 site of the flagship LiDAR branch
(bf16, as the train step runs it, on the H100's 132 SMs), at the edge
widths and on cards of other SM counts.  One test restates the kernel's
mappings (which thread stages which (row, channel) segment, which warp
multiplies which tiles, the ldmatrix.trans addresses, the C fragments each
lane adds into dW, the compaction of the live (tap, item) pairs); the exact
fragment test on the card (tests/test_torch_kernels.py) is what holds the
kernel to them.
"""

import numpy as np
import pytest

import chip_smoke
from unibev_tpu_torch.ops._build import MAX_SMEM_BYTES
from unibev_tpu_torch.ops.sparse_conv import (WGRAD_THREADS, WGRAD_WIDE_TILE,
                                              wgrad_plan, wgrad_smem_bytes,
                                              wgrad_warps)

SMS = 132   # the H100 SXM's

# site: (Vout, K, Cin, Cout) -> (kc, bn, (WM, WN, WK), (MT, NT), chunk,
# span, blocks, smem bytes)
SITE_PLANS = {
    "conv_input": ((120000, 27, 5, 16),
                   (16, 16, (1, 2, 4), (1, 1), 64, 128, 938, 27136)),
    "subm0": ((120000, 27, 16, 16),
              (16, 16, (1, 2, 4), (1, 1), 256, 256, 469, 65792)),
    "down0": ((90000, 27, 16, 32),
              (16, 32, (1, 4, 2), (1, 1), 256, 256, 352, 73984)),
    "subm1": ((90000, 27, 32, 32),
              (32, 32, (2, 4, 1), (1, 1), 256, 256, 352, 90368)),
    "down1": ((60000, 27, 32, 64),
              (32, 64, (2, 4, 1), (1, 2), 256, 256, 235, 106752)),
    "subm2": ((60000, 27, 64, 64),
              (64, 64, (4, 2, 1), (1, 4), 128, 256, 235, 102912)),
    "down2": ((40000, 27, 64, 128),
              (64, 128, (4, 2, 1), (1, 8), 128, 384, 105, 185088)),
    "subm3": ((40000, 27, 128, 128),
              (128, 128, (4, 2, 1), (2, 8), 128, 384, 105, 217856)),
    "conv_out": ((40000, 3, 128, 128),
                 (128, 128, (4, 2, 1), (2, 8), 128, 384, 105, 180352)),
}


def _flagship_sites():
    """(name, Vout, K, Cin, Cout) of each K9 launch site, from the encoder
    widths and capacities ``chip_smoke.lidar_sites`` builds with."""
    ch, cap = chip_smoke.ENCODER_CHANNELS, chip_smoke.CAPACITIES
    sites = [("conv_input", cap[0], 27, 5, ch[0][0]),
             ("subm0", cap[0], 27, ch[0][0], ch[0][0])]
    for i in range(3):
        sites += [(f"down{i}", cap[i + 1], 27, ch[i][1], ch[i][2]),
                  (f"subm{i + 1}", cap[i + 1], 27, ch[i][2], ch[i][2])]
    return sites + [("conv_out", cap[-1], 3, 128, 128)]


def test_sites_are_the_flagship_encoders():
    assert {n: s for n, *s in _flagship_sites()} == {
        n: list(v[0]) for n, v in SITE_PLANS.items()}


@pytest.mark.parametrize("site", list(SITE_PLANS))
def test_wgrad_plan_at_the_flagship_sites(site):
    (Vout, K, Cin, Cout), want = SITE_PLANS[site]
    plan = wgrad_plan(Vout, K, Cin, Cout, 2, SMS)
    kc, bn, warps, tiles, chunk, span, blocks, smem = want
    assert plan._asdict() == dict(
        kc=kc, bn=bn, warps=warps, tiles=tiles, chunk=chunk, span=span,
        grid=(blocks, 1, 1), smem_bytes=smem)
    assert plan.span % plan.chunk == 0 and plan.grid[0] * plan.span >= Vout
    assert plan.smem_bytes <= MAX_SMEM_BYTES
    if kc * bn >= WGRAD_WIDE_TILE:
        # one block per SM, each span as short as that allows
        assert plan.grid[0] <= SMS < -(-Vout // (plan.span - plan.chunk))
    elif Cin % 8:
        assert (plan.chunk, plan.span) == (64, 128)      # plain loads
    else:
        assert plan.span == 256 and plan.chunk == (256 if kc <= 32 else 128)


# (Cin, Cout) -> (kc, bn, input chunks, output tiles)
WIDTHS = {
    (5, 16): (16, 16, 1, 1), (16, 16): (16, 16, 1, 1),
    (17, 33): (32, 64, 1, 1), (32, 32): (32, 32, 1, 1),
    (64, 64): (64, 64, 1, 1), (128, 128): (128, 128, 1, 1),
    (129, 8): (128, 16, 2, 1), (40, 200): (64, 128, 1, 2),
    (256, 256): (128, 128, 2, 2),
}


@pytest.mark.parametrize("cin,cout", list(WIDTHS))
def test_wgrad_plan_widths(cin, cout):
    """Cin and Cout padded to 16, 32, 64 or 128; wider takes more blocks
    along the grid's y (output) and z (input) axes."""
    kc, bn, chunks, tiles = WIDTHS[(cin, cout)]
    plan = wgrad_plan(5000, 27, cin, cout, 2, SMS)
    assert (plan.kc, plan.bn, plan.grid[2], plan.grid[1]) == (kc, bn, chunks,
                                                              tiles)
    assert plan.kc * plan.grid[2] >= cin and plan.bn * plan.grid[1] >= cout
    (wm, wn, wk), (mt, nt) = plan.warps, plan.tiles
    assert wm * wn * wk == 8 and wk in (1, 2, 4)
    assert wm * mt * 16 == kc and wn * nt * 8 == bn
    assert nt in (1, 2, 4, 8) and plan.chunk % (16 * wk) == 0


@pytest.mark.parametrize("cin,cout,K", [(16, 16, 27), (128, 128, 27),
                                        (128, 128, 3), (32, 64, 27)])
def test_wgrad_plan_small_calls(cin, cout, K):
    """A call of fewer rows than a span takes one block."""
    plan = wgrad_plan(10, K, cin, cout, 2, SMS)
    assert plan.grid[0] == 1 and plan.span >= 10


@pytest.mark.parametrize("sms,span", [(132, 256), (114, 256), (78, 384)])
def test_wide_plan_follows_the_sm_count(sms, span):
    """A wide tile's span puts one block on each SM of the card it is given:
    the least span of whole items whose blocks fit one wave; narrow tiles do
    not depend on it."""
    plan = wgrad_plan(20000, 27, 128, 128, 2, sms)
    assert plan.span == span
    assert plan.grid[0] <= sms < -(-20000 // (plan.span - plan.chunk))
    assert wgrad_plan(120000, 27, 16, 16, 2, sms) == wgrad_plan(
        120000, 27, 16, 16, 2, SMS)


def test_wgrad_smem_is_the_kernels_layout():
    """WgradLayout of csrc/sparse_conv.cu, restated: index tile, flags per
    pair, item list and count, flag per row, 128-aligned g slice with 8
    elements of padding a row, two stages of gathered rows likewise."""
    K, span, chunk, kc, bn = 27, 320, 64, 128, 128
    pairs = span // chunk * K
    live = span * K * 4 + pairs * 4 + (pairs + 1) * 4
    g = -(-(live + span * 4) // 128) * 128
    assert wgrad_smem_bytes(K, span, chunk, kc, bn) == (
        g + span * (bn + 8) * 2 + 2 * chunk * (kc + 8) * 2)


@pytest.mark.parametrize("Vout,K,Cin,Cout", [(40000, 27, 16, 16),
                                             (90000, 27, 32, 32),
                                             (120000, 27, 5, 16)])
def test_wgrad_plan_f32(Vout, K, Cin, Cout):
    """float32 keeps the CUDA-core kernel: 16 / 32 / 64 channel tiles,
    64-row steps, a span halved from 4096 (not below 256) until the (span,
    tap, tile) grid reaches 1024 blocks; no dynamic shared memory."""
    plan = wgrad_plan(Vout, K, Cin, Cout, 4, SMS)
    assert plan.chunk == 64 and plan.smem_bytes == 0
    assert plan.kc == max(16, Cin) and plan.bn == max(16, Cout)
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= 1024 or plan.span == 256
    assert plan.span == 4096 or (-(-Vout // (2 * plan.span)) * K < 1024)


def _fragment(lane, q):
    """(channel, column) of C fragment element q of a lane in a 16 x 8
    tile."""
    return lane // 4 + 8 * (q >= 2), 2 * (lane % 4) + q % 2


def _items(idx, chunk, sentinel):
    """The kernel's item list: pairs p = k * chunks + r whose chunk r holds
    a row live in tap k, in order (tap by tap)."""
    span, K = idx.shape
    live = (idx >= 0) & (idx < sentinel)
    chunks = span // chunk
    flags = live.reshape(chunks, chunk, K).any(1)        # (chunk, tap)
    return [k * chunks + r for k in range(K) for r in range(chunks)
            if flags[r, k]]


def test_kernel_mappings_restated():
    """The bf16 kernel's index arithmetic (csrc/sparse_conv.cu), restated.

    Staging: thread t takes elements t, t + 256, ... of an item's (chunk x
    kc) gathered rows and of the span's (span x bn) g slice, as 16-byte
    segments of 8 bf16; each (row, segment) once.  Warps: warp w = wm + WM
    (wn + WN wk) owns m-tiles wm MT .. + MT, n-tiles wn NT .. + NT and the
    item's 16-row steps wk, wk + WK, ...: every product once.
    ldmatrix.x4.trans: A's lane l addresses row (l & 7) + 8 (l >> 4) at
    channel 8 ((l >> 3) & 1), so matrix j holds rows 8 (j >> 1) .. + 8 and
    channels 8 (j & 1) .. + 8 (the m16n8k16 A fragment a_j); B's lane l
    addresses row l & 15 at column 8 (l >> 4).  The flush: an even lane
    adds its c0, c1 and its odd neighbour's, the odd lane the even one's
    c2, c3 and its own, at channel l // 4 (+ 8 when odd) and columns 4 ((l
    & 3) >> 1) + 0..3, covering the 16 x 8 tile once.  Items: live (tap,
    item) pairs come tap by tap, so a block adds one partial per live tap,
    and a span with no live tap has no item and adds nothing."""
    for kc, bn, chunk in [(16, 16, 256), (16, 32, 256), (32, 16, 64),
                          (32, 64, 256), (64, 128, 128), (128, 128, 64)]:
        for rows, width in ((chunk, kc), (2 * chunk, bn)):
            segs = width // 8
            seen = {}
            for t in range(WGRAD_THREADS):
                for e in range(t, rows * segs, WGRAD_THREADS):
                    key = (e // segs, (e % segs) * 8)
                    seen[key] = seen.get(key, 0) + 1
            assert seen == {(r, 8 * s): 1 for r in range(rows)
                            for s in range(segs)}
        (WM, WN, WK), (MT, NT) = wgrad_warps(kc, bn)
        seen = {}
        for w in range(8):
            wm, wn, wk = w % WM, (w // WM) % WN, w // (WM * WN)
            for kk in range(wk * 16, chunk, 16 * WK):
                for i in range(MT):
                    for j in range(NT):
                        key = (wm * MT + i, wn * NT + j, kk // 16)
                        seen[key] = seen.get(key, 0) + 1
        assert seen == {(i, j, s): 1 for i in range(kc // 16)
                        for j in range(bn // 8) for s in range(chunk // 16)}

    for j in range(4):
        lanes = range(8 * j, 8 * j + 8)
        a = [((l & 7) + ((l >> 4) << 3), ((l >> 3) & 1) * 8) for l in lanes]
        assert [r for r, _ in a] == list(range(8 * (j >> 1), 8 * (j >> 1) + 8))
        assert {c for _, c in a} == {8 * (j & 1)}
        b = [(l & 15, 8 * (l >> 4)) for l in lanes]
        assert [r for r, _ in b] == list(range(8 * (j & 1), 8 * (j & 1) + 8))
        assert {c for _, c in b} == {8 * (j >> 1)}

    cover = {}
    for lane in range(32):
        odd, partner = lane & 1, lane ^ 1
        vals = ([(partner, 2), (partner, 3), (lane, 2), (lane, 3)] if odd else
                [(lane, 0), (lane, 1), (partner, 0), (partner, 1)])
        c, n = lane // 4 + (8 if odd else 0), 4 * ((lane & 3) >> 1)
        for q, (src, sq) in enumerate(vals):
            assert _fragment(src, sq) == (c, n + q)
            cover[(c, n + q)] = cover.get((c, n + q), 0) + 1
    assert cover == {(c, n): 1 for c in range(16) for n in range(8)}

    rng = np.random.RandomState(0)
    span, chunk, K, V = 512, 128, 27, 1000
    for density in (0.0, 0.002, 0.05, 1.0):
        idx = np.where(rng.rand(span, K) < density,
                       rng.randint(0, V, (span, K)), V)
        items = _items(idx, chunk, V)
        taps = [p // (span // chunk) for p in items]
        assert taps == sorted(taps)
        assert len(set(taps)) == int(((idx < V).any(0)).sum())
        if density == 0.0:
            assert items == []
        if density == 1.0:
            assert len(items) == K * span // chunk


def test_wide_span_is_capped_by_shared_memory():
    """Where one wave would need a span whose g slice and index tile do not
    fit, the span is the longest that fits and the blocks run in waves."""
    plan = wgrad_plan(200000, 27, 128, 128, 2, SMS)
    assert plan.smem_bytes <= MAX_SMEM_BYTES < wgrad_smem_bytes(
        27, plan.span + plan.chunk, plan.chunk, 128, 128)
    assert plan.grid[0] > SMS
