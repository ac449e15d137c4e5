"""The float32 dw kernel's GEMM walk (``csrc/conv4d_dw.cu``,
``conv4d_dw_tf32x3_tc``), mirrored on the CPU in float64 and held against
the plain dw.

Per (di, dj) tap pair, (b, i, j) row and window of kwin k-rows the kernel
stages the window's zero-padded halo X (kwin + 2p rows at the pitch L + 2p,
a tail of zeros) and its g rows G (the same pitch, zeros in the pad columns,
2p zero positions ahead in the channel mode) and adds

    D[m][n] += sum_u X[u + ax(m)][ac(m)] * G[u + bx(n)][bc(n)]

over u < 8 * ceil(kwin * (L + 2p) / 8): the channel mode (C >= 2) with m =
(dk, c), ax = dk * (L + 2p), n = (dl, o), bx = 2p - dl; the taps mode (C ==
1) with m = (dk, dl), ax = dk * (L + 2p) + dl, n = o, bx = 0. The walk
below stages and indexes exactly so; the card tests hold the kernel itself
against the plain dw. Also here: the staged records' channel swizzle, a
bijection that keeps each 16-byte channel pair whole and spreads a
half-warp's 8-byte fragment loads over distinct bank pairs; and the cut of
a batch into groups of samples whose split copies fit the route's budget,
with the g copy 16-byte aligned. This file imports neither JAX nor the JAX
package.
"""

import os
import re

import numpy as np
import pytest
import torch

from ncnet_tpu_torch.kernels import _build
from ncnet_tpu_torch.kernels.conv4d_dw import DW_SPLIT_BYTES
from ncnet_tpu_torch.ops.conv4d import conv4d_dw_plain


def walk(x, g, ks, kwin):
    """The kernel's dw on float64 numpy ``x`` [B,I,J,K,L,C], ``g``
    [B,I,J,K,L,O] with windows of ``kwin`` k-rows."""
    B, I, J, K, L, C = x.shape
    O = g.shape[-1]
    p, T = ks // 2, ks * ks
    cols = L + 2 * p
    taps = C == 1
    glead = 0 if taps else 2 * p
    n_steps = (kwin * cols + 7) // 8
    # the kernel's staged sizes: the reads below stay inside them
    hpa = ((kwin + 2 * p) * cols + 8 + 2 * p + 1) & ~1
    gpa = (glead + kwin * cols + 8 + 1) & ~1
    if taps:
        m_pos = np.array([(t // ks) * cols + t % ks for t in range(T)])
        m_ch = np.zeros(T, int)
        n_pos, n_ch = np.zeros(O, int), np.arange(O)
    else:
        m_pos = np.repeat(np.arange(ks) * cols, C)
        m_ch = np.tile(np.arange(C), ks)
        n_pos = np.repeat(glead - np.arange(ks), O)
        n_ch = np.tile(np.arange(O), ks)
    u = np.arange(n_steps * 8)
    assert (u[-1] + m_pos.max()) < hpa and (u[-1] + n_pos.max()) < gpa
    assert n_pos.min() >= 0
    dw = np.zeros((ks, ks, ks, ks, C, O))
    for di in range(ks):
        for dj in range(ks):
            D = np.zeros((len(m_pos), len(n_pos)))
            for b in range(B):
                for i in range(I):
                    for j in range(J):
                        ii, jj = i + di - p, j + dj - p
                        if not (0 <= ii < I and 0 <= jj < J):
                            continue
                        for k0 in range(0, K, kwin):
                            X = np.zeros((hpa, C))
                            G = np.zeros((gpa, O))
                            for hr in range(kwin + 2 * p):
                                if 0 <= k0 + hr - p < K:
                                    X[hr * cols + p:hr * cols + p + L] = x[b, ii, jj, k0 + hr - p]
                            for kl in range(kwin):
                                if k0 + kl < K:
                                    G[glead + kl * cols:glead + kl * cols + L] = g[b, i, j, k0 + kl]
                            A = X[u[None, :] + m_pos[:, None], m_ch[:, None]]
                            Bm = G[u[:, None] + n_pos[None, :], n_ch[None, :]]
                            D += A @ Bm
            if taps:
                dw[di, dj] = D.reshape(ks, ks, 1, O)
            else:
                dw[di, dj] = D.reshape(ks, C, ks, O).transpose(0, 2, 1, 3)
    return dw


WALK_CASES = [
    # (x shape [b, i, j, k, l], ks, cin, cout, kwin)
    ((1, 3, 4, 5, 6), 3, 1, 3, 2),     # taps mode, a ragged last window
    ((2, 3, 3, 4, 5), 5, 1, 16, 4),    # the 1->16 layer's form
    ((1, 3, 3, 5, 4), 3, 2, 1, 5),     # O == 1: N = dl only
    ((2, 3, 3, 4, 5), 5, 16, 1, 3),    # the 16->1 layer's form
    ((2, 3, 3, 4, 5), 5, 3, 2, 3),     # odd channel counts
    ((1, 2, 3, 7, 3), 3, 2, 3, 3),     # L smaller than 2p + 1
    ((1, 2, 2, 3, 4), 7, 2, 2, 1),     # ks 7, one k-row a window
    ((1, 3, 2, 4, 3), 1, 3, 2, 2),     # ks 1
    ((1, 2, 3, 6, 5), 5, 16, 16, 6),   # the 16->16 layer's form, one window
]


@pytest.mark.parametrize("case", range(len(WALK_CASES)))
def test_walk_is_the_dw(case):
    shape, ks, cin, cout, kwin = WALK_CASES[case]
    rng = np.random.default_rng(case)
    x = rng.random(shape + (cin,))
    g = rng.standard_normal(shape + (cout,))
    want = conv4d_dw_plain(torch.from_numpy(x), torch.from_numpy(g), ks)
    # the plain dw computes in float32: its own rounding is the tolerance
    np.testing.assert_allclose(walk(x, g, ks, kwin), want.double().numpy(),
                               rtol=0, atol=1e-5 * float(want.abs().max()))


def swz(ch, pos, rec):
    """``swz`` of the kernel: where channel ``ch`` of staged position
    ``pos`` sits in its record of ``rec`` float2 (hi, lo)."""
    return ch ^ ((pos & 3) << 2) if rec >= 16 else ch


@pytest.mark.parametrize("rec", [1, 16, 32, 64])
def test_swizzle_keeps_records_whole_and_channel_pairs_together(rec):
    for pos in range(8):
        slots = [swz(ch, pos, rec) for ch in range(rec)]
        assert sorted(slots) == list(range(rec))
        # a 16-byte copy of channels (2q, 2q + 1) lands in one aligned chunk
        for q in range(rec // 2):
            assert swz(2 * q, pos, rec) % 2 == 0
            assert swz(2 * q + 1, pos, rec) == swz(2 * q, pos, rec) + 1


@pytest.mark.parametrize("base", [0, 3, 29, 58])
def test_fragment_loads_hit_distinct_bank_pairs(base):
    """An 8-byte load of a fragment (lane = 4 g + c reads channel g (or g +
    8, or of an n8 tile) of position base + c) is served in two phases of
    16 lanes; within each the 16 float2 fall in 16 distinct 8-byte bank
    pairs (128 bytes), for any first position."""
    rec = 16
    for ch0 in (0, 8):
        for phase in range(2):
            pairs = set()
            for lane in range(16 * phase, 16 * phase + 16):
                gq, cq = lane >> 2, lane & 3
                pos = base + cq
                pairs.add((pos * rec + swz(ch0 + gq, pos, rec)) % 16)
            assert len(pairs) == 16


def split_groups(b, sample_pos, cin, cout, budget):
    """``make_f32_plan``'s cut of a batch of ``b`` samples (``sample_pos``
    positions each) into groups whose split copies (8 bytes a value, channel
    counts past 1 padded to even) fit ``budget`` bytes, one sample at least:
    ``(groups, samples a group)``."""
    stride = [c if c == 1 else (c + 1) & ~1 for c in (cin, cout)]
    most = max(1, budget // (8 * sample_pos * sum(stride)))
    groups = -(-b // most)
    return groups, -(-b // groups)


def test_split_budget_is_the_wrappers():
    """The source's kSplitBytes is the wrapper's DW_SPLIT_BYTES."""
    src = open(os.path.join(_build.CSRC, "conv4d_dw.cu")).read()
    found = re.findall(r"constexpr int64_t kSplitBytes = int64_t\(1\) << (\d+);", src)
    assert [1 << int(e) for e in found] == [DW_SPLIT_BYTES], found


SPLIT_CASES = [
    # (b, grid [i, j, k, l], cin, cout, groups): the --no-bf16 pipeline
    # call's layers at 32 samples on 25^4 (100 MB a sample at 16->16), the
    # gradient check's 2, the synthetic run's 16 on 8^4, one 48^4 sample
    # past the budget, and odd position counts
    (32, (25, 25, 25, 25), 16, 16, 4),
    (32, (25, 25, 25, 25), 1, 16, 2),
    (32, (25, 25, 25, 25), 16, 1, 2),
    (11, (25, 25, 25, 25), 16, 16, 2),
    (2, (25, 25, 25, 25), 16, 16, 1),
    (16, (8, 8, 8, 8), 1, 16, 1),
    (1, (48, 48, 48, 48), 16, 16, 1),
    (1, (5, 5, 5, 5), 1, 16, 1),
    (3, (3, 5, 7, 3), 1, 3, 1),
]


@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_split_groups_cover_the_batch_and_align_the_g_copy(case):
    b, grid, cin, cout, want = SPLIT_CASES[case]
    sample_pos = int(np.prod(grid))
    groups, group = split_groups(b, sample_pos, cin, cout, DW_SPLIT_BYTES)
    assert groups == want
    sizes = [min(group, b - g0) for g0 in range(0, b, group)]
    assert len(sizes) == groups and sum(sizes) == b and min(sizes) >= 1
    stride = [c if c == 1 else (c + 1) & ~1 for c in (cin, cout)]
    if group > 1:
        assert 8 * group * sample_pos * sum(stride) <= DW_SPLIT_BYTES
    # the x copy starts the workspace's copies on 16 bytes (the partials
    # are rounded up to 4 floats); its float2 are rounded up to even, so
    # the g copy after it starts on 16 bytes too, at any position count
    xs_f2 = (group * sample_pos * stride[0] + 1) & ~1
    assert (8 * xs_f2) % 16 == 0
