"""The launch plans of the sampling backwards K3 (``msda_bwd``) and K4
(``dcn_bwd``), held on the CPU.

``msda_bwd_plan`` (ops/msda.py) and ``dcn_bwd_plan`` (ops/deform_conv.py)
are what the wrappers hand to the kernels: the access width, the threads
that share one (b, q, head) or (output pixel, tap) item, and the grid.  The
C entry points refuse a plan whose lanes disagree with their own rule
(``group_lanes`` in csrc/bilinear.cuh), and an access width that a row or an
address does not allow.  Here each plan is held at every MSDA and DCN site
of ``chip_smoke.py`` (bf16, as the flagship runs them), with its f32 table
against the 50 MB L2, and at the widths that narrow: an unaligned value, x,
grad or d_cols, and an odd D or Cin.  The thread -> (item, chunk) mapping
of the kernels is restated and must cover every chunk of every item once,
within one warp per item.
"""

import pytest

import chip_smoke
from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.ops.deform_conv import dcn_bwd_plan
from unibev_tpu_torch.ops.msda import msda_bwd_plan

# site: (blocks, table bytes, map bytes, table and map fit the L2)
MSDA_SITE_PLANS = {
    "tsa": (5000, 40_960_000, 20_480_000, False),
    "camera_sca": (7680, 8_908_800, 4_454_400, True),
    "decoder_ca": (113, 40_960_000, 20_480_000, False),
    "pts_tsa": (5000, 40_960_000, 20_480_000, False),
    "pts_sca": (5000, 33_177_600, 16_588_800, True),
}
# site: (lanes, chunks a lane, blocks, table bytes, map bytes, fit the L2)
DCN_SITE_PLANS = {
    "stage3": (32, 2, 39150, 35_635_200, 17_817_600, False),
    "stage4": (32, 4, 9788, 17_817_600, 8_908_800, True),
}


def _msda_site(name):
    sites = chip_smoke.MSDA_SITES + chip_smoke.LIDAR_MSDA_SITES
    return next(s for s in sites if s[0] == name)


def test_sites_are_chip_smokes():
    names = [s[0] for s in chip_smoke.MSDA_SITES + chip_smoke.LIDAR_MSDA_SITES]
    assert sorted(names) == sorted(MSDA_SITE_PLANS)
    assert sorted(s[0] for s in chip_smoke.DCN_SITES) == sorted(DCN_SITE_PLANS)


@pytest.mark.parametrize("site", list(MSDA_SITE_PLANS))
def test_msda_bwd_plan_at_the_flagship_sites(site):
    """4 threads per (b, q, head), each two chunks of 4 bf16 channels
    (8-byte loads, one 16-byte f32 reduction each), one 256-thread block
    per 64 items."""
    _, _, B, V, Q, heads, D, _, _ = _msda_site(site)
    plan = msda_bwd_plan(B, V, Q, heads, D, 2)
    blocks, table, value, resident = MSDA_SITE_PLANS[site]
    assert plan._asdict() == dict(
        vec_bytes=8, lanes=4, chunks_per_lane=2, threads=256, blocks=blocks,
        table_bytes=table, map_bytes=value, l2_resident=resident)
    assert plan.blocks * plan.threads >= B * Q * heads * plan.lanes
    assert (plan.table_bytes + plan.map_bytes <= _build.L2_BYTES) == resident


@pytest.mark.parametrize("site", list(DCN_SITE_PLANS))
def test_dcn_bwd_plan_at_the_flagship_sites(site):
    """One warp per (pixel, tap) of 4-channel chunks (8-byte loads): two
    passes over Cin 256, four over Cin 512."""
    _, _, B, H, W, Cin, _ = next(s for s in chip_smoke.DCN_SITES
                                 if s[0] == site)
    plan = dcn_bwd_plan(B, H, W, Cin, H, W, 9, 2)
    lanes, per_lane, blocks, table, x, resident = DCN_SITE_PLANS[site]
    assert plan._asdict() == dict(
        vec_bytes=8, lanes=lanes, chunks_per_lane=per_lane, threads=256,
        blocks=blocks, table_bytes=table, map_bytes=x, l2_resident=resident)


# (D, itemsize, value address, grad address) -> (bytes an access, lanes,
# chunks a lane)
MSDA_WIDTHS = {
    "flagship_bf16": ((32, 2, 0, 0), (8, 4, 2)),
    "flagship_f32": ((32, 4, 0, 0), (16, 4, 2)),
    "d4_bf16": ((4, 2, 0, 0), (8, 1, 1)),
    "tiny_f32": ((4, 4, 0, 0), (16, 1, 1)),
    "unaligned_value": ((32, 2, 2, 0), (2, 16, 2)),
    "value_8_bytes_off": ((32, 2, 8, 0), (8, 4, 2)),
    "unaligned_grad": ((32, 2, 0, 4), (4, 8, 2)),
    "odd_d_f32": ((3, 4, 0, 0), (4, 2, 2)),
    "d6_bf16": ((6, 2, 0, 0), (4, 2, 2)),
    "d24_bf16": ((24, 2, 0, 0), (8, 4, 2)),
    "wide_d_f32": ((512, 4, 0, 0), (16, 32, 4)),
}


@pytest.mark.parametrize("case", list(MSDA_WIDTHS))
def test_msda_bwd_plan_widths(case):
    """At most 4 elements an access (16 bytes in f32, 8 in bf16); where D
    or an address does not allow it the access narrows (a misaligned grad
    too, which K1 never reads); the lanes are half the chunks (each lane
    two where there are two), rounded up to a power of two and capped at a
    warp."""
    (D, size, va, ga), want = MSDA_WIDTHS[case]
    plan = msda_bwd_plan(2, 63, 24, 4, D, size, va, ga)
    assert (plan.vec_bytes, plan.lanes, plan.chunks_per_lane) == want
    assert (D * size) % plan.vec_bytes == 0
    assert plan.blocks == -(-2 * 24 * 4 * plan.lanes // _build.BWD_THREADS)


# (Cin, itemsize, x address, d_cols address) -> (bytes, lanes, chunks a lane)
DCN_WIDTHS = {
    "conv_input_cin5_f32": ((5, 4, 0, 0), (4, 8, 1)),
    "cin5_bf16": ((5, 2, 0, 0), (2, 8, 1)),
    "cin40_bf16": ((40, 2, 0, 0), (8, 16, 1)),
    "stage3_f32": ((256, 4, 0, 0), (16, 32, 2)),
    "unaligned_x": ((256, 2, 2, 0), (2, 32, 8)),
    "unaligned_d_cols": ((256, 2, 0, 8), (8, 32, 2)),
}


@pytest.mark.parametrize("case", list(DCN_WIDTHS))
def test_dcn_bwd_plan_widths(case):
    (Cin, size, xa, da), want = DCN_WIDTHS[case]
    plan = dcn_bwd_plan(2, 11, 13, Cin, 6, 7, 9, size, xa, da)
    assert (plan.vec_bytes, plan.lanes, plan.chunks_per_lane) == want
    assert (Cin * size) % plan.vec_bytes == 0
    assert plan.blocks == -(-2 * 6 * 7 * 9 * plan.lanes // _build.BWD_THREADS)
    assert plan.table_bytes == 4 * 2 * 11 * 13 * Cin


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33,
                                    64, 65])
def test_group_lanes_is_the_least_power_of_two(chunks):
    lanes = _build.group_lanes(chunks)
    assert lanes & (lanes - 1) == 0 and 32 % lanes == 0
    assert lanes >= min(chunks, 32) and (lanes == 1 or lanes // 2 < chunks)


def _cover(items, groups, lanes, threads):
    """The kernels' mapping: thread t of the grid serves item t // lanes,
    lane t % lanes, chunks lane, lane + lanes, ...; returns {(item, chunk):
    count} and whether any item's lanes straddle two warps."""
    seen, straddles = {}, False
    n = items * lanes
    blocks = -(-n // threads)
    for t in range(blocks * threads):
        if t >= n:
            continue
        item, lane = t // lanes, t % lanes
        straddles |= (t // 32) != ((item * lanes) // 32)
        for ch in range(lane, groups, lanes):
            seen[(item, ch)] = seen.get((item, ch), 0) + 1
    return seen, straddles


@pytest.mark.parametrize("kind,shape", [
    ("msda", (2, 63, 24, 4, 32, 2)), ("msda", (1, 63, 7, 3, 3, 4)),
    ("msda", (1, 20, 5, 2, 512, 4)), ("dcn", (1, 9, 7, 40, 9, 7, 9, 2)),
    ("dcn", (1, 5, 4, 512, 5, 4, 9, 2)), ("dcn", (2, 5, 6, 5, 3, 3, 9, 4))])
def test_every_chunk_of_every_item_once(kind, shape):
    if kind == "msda":
        B, V, Q, heads, D, size = shape
        plan = msda_bwd_plan(*shape)
        items, groups = B * Q * heads, D * size // plan.vec_bytes
    else:
        B, H, W, Cin, Ho, Wo, taps, size = shape
        plan = dcn_bwd_plan(*shape)
        items, groups = B * Ho * Wo * taps, Cin * size // plan.vec_bytes
    seen, straddles = _cover(items, groups, plan.lanes, plan.threads)
    assert not straddles
    assert seen == {(i, c): 1 for i in range(items) for c in range(groups)}
    assert -(-items * plan.lanes // plan.threads) == plan.blocks
