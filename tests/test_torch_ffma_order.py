"""The float32 FFMA conv4d kernels' order of work, walked in numpy.

``csrc/conv4d_fwd.cu`` keeps every output of the C == 1 and O == 1 layers
on one ``fmaf`` chain in ``(di, dj, dk, dl, c)`` order, so the kernels are
bitwise equal to the chain oracle. No card runs here, so these tests walk
the kernels' loops as plain index arithmetic, over the tile plan that
`ncnet_tpu_torch.kernels.conv4d.ffma_plan` mirrors, and assert that

* each output receives every term whose input lies on the grid exactly
  once, with the weight of the same tap and channel as the staged
  activation it reads (the buffer slot the staging wrote for that input);
* those terms come in ascending chain order;
* every other term the walk applies reads a cell the staging never
  writes (the zeroed halo, or a zero-padded channel): only zero-halo taps
  are left out, and they add ``+0 * w``.

Index arithmetic only: no kernel, no JAX.
"""

import numpy as np
import pytest

from ncnet_tpu_torch.kernels.conv4d import FFMA_PLAN_KEYS, ffma_plan, float32_route

CASES = [
    # (x shape [b, i, j, k, l], ks, cin, cout)
    ((8, 25, 25, 25, 25), 5, 1, 16),   # PF-Pascal 1->16, and 16->1's dx
    ((8, 25, 25, 25, 25), 5, 16, 1),   # PF-Pascal 16->1
    ((4, 25, 25, 19, 25), 5, 1, 16),   # the 19 x 25 rectangle
    ((4, 25, 25, 19, 25), 5, 16, 1),
    ((4, 19, 25, 25, 25), 5, 16, 1),   # and its transpose
    ((16, 8, 8, 8, 8), 3, 1, 16),      # the synthetic run
    ((16, 8, 8, 8, 8), 3, 16, 1),
    ((2, 5, 4, 6, 7), 3, 1, 1),        # ragged edges: C = 1 and O = 1
    ((2, 6, 5, 7, 9), 5, 9, 1),        # C not a multiple of 4
    ((2, 5, 6, 7, 5), 3, 1, 9),        # O not a multiple of 4, two o tiles
    ((1, 5, 4, 30, 3), 5, 16, 1),      # a narrow row (L = 3)
    ((2, 4, 3, 5, 6), 3, 3, 1),
    ((1, 2, 3, 2, 4), 5, 1, 3),        # grid smaller than the kernel
    ((1, 1, 2, 4, 150), 5, 1, 16),     # a wide row
    ((1, 3, 4, 3, 5), 5, 33, 1),       # C > 16: weights from shared memory
    ((1, 3, 3, 4, 9), 7, 1, 5),        # ks 7: loops not unrolled
    ((1, 3, 3, 9, 4), 7, 6, 1),
]

#: the H100 plans of the serving and synthetic layers, as the card's
#: launcher reports them (tests/test_torch_cuda.py holds the two equal)
SERVING_PLANS = {
    ((8, 25, 25, 25, 25), 5, 1, 16): dict(o1=0, KS=5, R=5, W=29, tile=25,
                                          S=125, G=1, n_seg=5, OT=16,
                                          threads=128, blocks=5000,
                                          smem=9952),
    ((8, 25, 25, 25, 25), 5, 16, 1): dict(o1=1, KS=5, R=5, W=29, rec=16,
                                          tile=25, S=125, G=1, n_seg=5,
                                          threads=128, blocks=5000,
                                          smem=55424),
    ((16, 8, 8, 8, 8), 3, 1, 16): dict(o1=0, KS=3, R=4, S=16, G=8,
                                       threads=128, blocks=128),
    ((16, 8, 8, 8, 8), 3, 16, 1): dict(o1=1, KS=3, R=4, S=16, G=8,
                                       threads=128, blocks=128),
}


def o1_slot(c4, hk):
    """Where 4-channel chunk ``c4`` of a position of halo row ``hk`` is
    staged (``o1_slot`` in the source)."""
    return (c4 & ~3) | ((c4 ^ (hk >> 1)) & 3)


def cells(nrows, m, t, s):
    """The (row, column) cells thread ``t`` of a group of ``s`` copies
    (``ffma_cells``)."""
    if s >= m:
        step = s // m
        if t >= step * m:
            return []
        return [(r, t % m) for r in range(t // m, nrows, step)]
    return [divmod(e, m) for e in range(t, nrows * m, s)]


def staged(plan, shape, ks, cin, k_range):
    """The halo buffer of one group's tile as the staging leaves it: a dict
    from buffer index to the input (kk, ll, c) copied there, each cell
    written once by some thread of the group. ``k_range``: the on-grid
    input k rows of the tile's halo and the k row of halo row 0."""
    _, _, _, nk, nl = shape
    p = ks // 2
    k_lo, k_hi, k_top = k_range
    written = {}
    if plan["o1"]:
        vec = cin % 4 == 0
        per = cin // 4 if vec else cin
        for t in range(plan["S"]):
            for r, q in cells(k_hi - k_lo, nl * per, t, plan["S"]):
                ll, cc = divmod(q, per)
                hk = k_lo + r - k_top
                chans = range(4 * cc, 4 * cc + 4) if vec else [cc]
                for c in chans:
                    idx = ((hk * plan["W"] + p + ll) * plan["rec"]
                           + 4 * o1_slot(c >> 2, hk) + (c & 3))
                    assert idx not in written
                    written[idx] = (k_lo + r, ll, c)
    else:
        for t in range(plan["S"]):
            for r, c in cells(k_hi - k_lo, nl, t, plan["S"]):
                idx = (k_lo + r - k_top) * plan["W"] + p + c
                assert idx not in written
                written[idx] = (k_lo + r, c, 0)
    assert all(0 <= i < plan["x_floats"] for i in written)
    assert len(written) == (k_hi - k_lo) * nl * cin
    return written


def lookup(written, idx):
    """(kk, ll, c) staged at each index, (-1, -1, -1) where nothing is."""
    keys = np.array(sorted(written), dtype=np.int64)
    vals = np.array([written[k] for k in keys], dtype=np.int64)
    pos = np.searchsorted(keys, idx)
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = keys[pos_c] == idx
    out = np.where(hit[..., None], vals[pos_c], -1)
    return hit, out


def check_chains(out_id, order, key, real, n_out, want_count):
    """Every output's real terms: ascending ``key`` in execution ``order``,
    as many as ``want_count[out]``."""
    out_id, order, key = out_id[real], order[real], key[real]
    idx = np.lexsort((order, out_id))
    out_id, key = out_id[idx], key[idx]
    same = out_id[1:] == out_id[:-1]
    assert np.all(key[1:][same] > key[:-1][same]), "a chain out of order"
    counts = np.bincount(out_id, minlength=n_out)
    assert np.array_equal(counts, want_count), "a term missing or repeated"


def valid_taps(n, ks):
    p = ks // 2
    return np.array([min(n, i + p + 1) - max(0, i - p) for i in range(n)])


def walk_c1_tile(plan, shape, ks, tile_idx):
    """One step of a C == 1 group: the kernel's (thread, dk, dl, r) loop
    over its input window (each output channel takes the same order)."""
    _, _, _, nk, nl = shape
    p = ks // 2
    r_ = plan["R"]
    k0 = tile_idx * plan["tile"]
    written = staged(plan, shape, ks, 1,
                     (max(0, k0 - p), min(nk, k0 + plan["tile"] + p), k0 - p))
    t, dk, dl, r = np.meshgrid(np.arange(plan["S"]), np.arange(ks),
                               np.arange(ks), np.arange(r_), indexing="ij")
    kl, seg = t % plan["tile"], t // plan["tile"]
    k, l = k0 + kl, seg * r_ + r
    valid = (k < nk) & (l < nl)
    order = (dk * ks + dl) * r_ + r
    idx = (kl + dk) * plan["W"] + seg * r_ + r + dl  # window entry r + dl
    assert idx.max() < plan["x_floats"]
    hit, src = lookup(written, np.where(valid, idx, 0))
    kk, lin = k + dk - p, l + dl - p
    on = (kk >= 0) & (kk < nk) & (lin >= 0) & (lin < nl)
    # a read is a staged input exactly where the tap's input is on the grid,
    # and then it is that input
    assert np.array_equal(hit[valid], on[valid])
    both = valid & on
    assert np.all(src[..., 0][both] == kk[both])
    assert np.all(src[..., 1][both] == lin[both])
    rows = min(nk, k0 + plan["tile"]) - k0
    out_id = np.where(valid, (k - k0) * nl + l, 0)
    want = (valid_taps(nk, ks)[k0:k0 + rows, None]
            * valid_taps(nl, ks)[None, :]).reshape(-1)
    check_chains(out_id.ravel(), order.ravel(), (dk * ks + dl).ravel(),
                 both.ravel(), rows * nl, want)
    # every output of the tile is one thread's, once
    owner = (k < nk) & (l < nl)
    ids = ((k - k0) * nl + l)[:, 0, 0, :][owner[:, 0, 0, :]]
    assert np.array_equal(np.sort(ids), np.arange(rows * nl))


def walk_o1_tile(plan, shape, ks, cin, tile_idx):
    """One step of an O == 1 group: the kernel's (thread, dk, ll, c4, r,
    lane) loop."""
    _, _, _, nk, nl = shape
    p = ks // 2
    r_, c4p = plan["R"], plan["C4p"]
    k0 = tile_idx * plan["tile"]
    written = staged(plan, shape, ks, cin,
                     (max(0, k0 - p), min(nk, k0 + plan["tile"] + p), k0 - p))
    t, dk, ll, c4, r, e = np.meshgrid(
        np.arange(plan["S"]), np.arange(ks), np.arange(r_ + ks - 1),
        np.arange(c4p), np.arange(r_), np.arange(4), indexing="ij")
    dl = ll - r
    kl, seg = t % plan["tile"], t // plan["tile"]
    k, l = k0 + kl, seg * r_ + r
    valid = (dl >= 0) & (dl < ks) & (k < nk) & (l < nl)
    order = ((((dk * (r_ + ks - 1) + ll) * c4p + c4) * r_ + r) * 4 + e)
    hk = kl + dk
    idx = ((hk * plan["W"] + seg * r_ + ll) * plan["rec"]
           + 4 * o1_slot(c4, hk) + e)
    assert idx[valid].max() < plan["x_floats"]
    hit, src = lookup(written, np.where(valid, idx, 0))
    c = 4 * c4 + e  # the weight's channel: w[dk, dl, 4 c4 + e]
    kk, lin = k + dk - p, l + dl - p
    on = (kk >= 0) & (kk < nk) & (lin >= 0) & (lin < nl) & (c < cin)
    assert np.array_equal(hit[valid], on[valid])
    both = valid & on
    assert np.all(src[..., 0][both] == kk[both])
    assert np.all(src[..., 1][both] == lin[both])
    assert np.all(src[..., 2][both] == c[both])
    rows = min(nk, k0 + plan["tile"]) - k0
    out_id = np.where(valid, (k - k0) * nl + l, 0)
    key = (dk * ks + dl) * 4 * c4p + c
    want = (valid_taps(nk, ks)[k0:k0 + rows, None]
            * valid_taps(nl, ks)[None, :]).reshape(-1) * cin
    check_chains(out_id.ravel(), order.ravel(), key.ravel(), both.ravel(),
                 rows * nl, want)
    # every output of the tile is one thread's, once
    owner = (k < nk) & (l < nl)
    ids = ((k - k0) * nl + l)[..., 0, 0, 0, :, 0][owner[..., 0, 0, 0, :, 0]]
    assert np.array_equal(np.sort(ids), np.arange(rows * nl))


def walk_rows(plan, shape, ks):
    """The block's (di, dj) steps (``ffma_steps``): each group computes the
    steps whose input row lies on the grid, in ascending order; items of
    every (b, i, j) row and tile, once."""
    b, ni, nj, _, _ = shape
    p, taps, g = ks // 2, ks * ks, plan["G"]
    n_items = b * ni * nj * plan["n_tiles"]
    assert n_items == plan["n_items"]

    def row(item):
        n = item // plan["n_tiles"]
        return n // nj % ni, n % nj

    def on(item, v):
        i, j = row(item)
        ii, jj = i + v // ks - p, j + v % ks - p
        return 0 <= ii < ni and 0 <= jj < nj

    seen = []
    for first in range(0, n_items, g):
        steps = [v for v in range(taps) if g > 1 or on(first, v)]
        for item in range(first, min(first + g, n_items)):
            seen.append(item)
            done = [v for v in steps if on(item, v)]
            i, j = row(item)
            want = [di * ks + dj for di in range(ks) for dj in range(ks)
                    if 0 <= i + di - p < ni and 0 <= j + dj - p < nj]
            assert done == want
    assert seen == list(range(n_items))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_ffma_chain_order(case):
    shape, ks, cin, cout = CASES[case]
    assert float32_route(cin, cout) == "ffma"
    plan = ffma_plan(shape, ks, cin, cout)
    assert set(plan) == set(FFMA_PLAN_KEYS)
    assert plan["o1"] == (cin >= 2)
    assert plan["threads"] <= 256 and plan["smem"] <= 232448
    assert plan["threads"] >= plan["G"] * plan["S"]
    walk_rows(plan, shape, ks)
    for tile_idx in range(plan["n_tiles"]):
        if plan["o1"]:
            walk_o1_tile(plan, shape, ks, cin, tile_idx)
        else:
            walk_c1_tile(plan, shape, ks, tile_idx)


@pytest.mark.parametrize("case", sorted(SERVING_PLANS, key=str))
def test_ffma_plan_at_the_slice_shapes(case):
    plan = ffma_plan(*case)
    want = SERVING_PLANS[case]
    assert {k: plan[k] for k in want} == want


def test_ffma_plan_tiles_past_shared_memory():
    """Rows too wide for one block's threads or shared memory take
    several k-row tiles, and a limit too small raises."""
    c1 = ffma_plan((1, 2, 2, 40, 400), 5, 1, 16)
    assert c1["n_tiles"] > 1 and c1["smem"] <= 232448
    # 768 px: 12 segments of 4 a k row, so at most 21 k rows a tile
    o1 = ffma_plan((1, 2, 2, 48, 48), 5, 16, 1)
    assert (o1["R"], o1["n_tiles"], o1["tile"]) == (4, 3, 16)
    o1 = ffma_plan((1, 2, 2, 150, 150), 5, 16, 1)
    assert o1["n_tiles"] > 1 and o1["smem"] <= 232448
    walk_o1_tile(o1, (1, 2, 2, 150, 150), 5, 16, o1["n_tiles"] - 1)
    with pytest.raises(ValueError, match="shared memory"):
        ffma_plan((1, 2, 2, 25, 25), 5, 16, 1, max_smem=10000)
    with pytest.raises(ValueError, match="not on the FFMA route"):
        ffma_plan((1, 2, 2, 25, 25), 5, 16, 16)


def test_o1_quarter_warps_read_distinct_bank_groups():
    """At the PF-Pascal 16->1 layer, the 8 lanes of a quarter-warp (8
    consecutive k rows of one segment) read 8 distinct 16-byte bank groups
    for each (dk, ll, c4), except where a warp wraps to the next segment."""
    shape, ks = (8, 25, 25, 25, 25), 5
    plan = ffma_plan(shape, ks, 16, 1)
    worst, clean = 0, 0
    for lane0 in range(0, plan["S"] - 7, 8):
        t = np.arange(lane0, lane0 + 8)
        kl, seg = t % plan["tile"], t // plan["tile"]
        for dk in range(ks):
            for ll in range(plan["R"] + ks - 1):
                for c4 in range(4):
                    hk = kl + dk
                    idx = ((hk * plan["W"] + seg * plan["R"] + ll) * 16
                           + 4 * o1_slot(c4, hk))
                    ways = np.bincount((idx // 4) % 8).max()
                    worst = max(worst, ways)
                    clean += ways == 1
    assert worst <= 2
    # all but the quarter-warps that straddle two segments are conflict-free
    assert clean >= 0.75 * (plan["S"] // 8) * ks * (plan["R"] + ks - 1) * 4
