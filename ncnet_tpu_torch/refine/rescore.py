"""Re-scoring of the coarse band's neighbourhoods at full resolution
(``ncnet_tpu/refine/rescore.py``).

Per coarse A-cell the coarse band holds K B-candidates. Each of the r^2
fine A-cells under it reads the window of ``win = (r * (2*radius + 1))^2``
fine B-cells under each candidate (radius 0: the r x r block), scores them
with one contraction ``[.., r^2, c] x [.., K, win, c]``, and keeps the
candidate's consensus score, moved to the window's best cell and scaled by
that cell's softmax weight over the window. A window of one entry (factor
1, radius 0) has weight exactly 1.0 and ``v * 1.0 == v``, so the refined
band is then the coarse band bit for bit. Off-grid window slots point at
an appended zero row (the null index ``hB*wB``) and score ``-inf``.
"""

import torch


def refine_window_indices(indices, grid_b_lo, grid_b_hi, factor, radius=0):
    """Fine-grid window pointers of each coarse candidate.

    ``indices`` ``[b, hA, wA, K]`` are flat coarse B indices. Returns
    ``(widx, valid)``, ``[b, hA, wA, K, win]``: int32 flat fine B indices,
    the null index ``hB_hi * wB_hi`` on off-grid slots, and the bool mask
    of the slots on the grid."""
    h_lo, w_lo = int(grid_b_lo[0]), int(grid_b_lo[1])
    h_hi, w_hi = int(grid_b_hi[0]), int(grid_b_hi[1])
    r = int(factor)
    if (h_lo * r, w_lo * r) != (h_hi, w_hi):
        raise ValueError(
            f"fine grid {h_hi}x{w_hi} is not the coarse grid {h_lo}x{w_lo} "
            f"times the factor {r}"
        )
    side = r * (2 * int(radius) + 1)
    idx = indices.long()
    off = torch.arange(side, device=idx.device) - int(radius) * r
    fi = (idx // w_lo)[..., None] * r + off  # [b, hA, wA, K, side]
    fj = (idx % w_lo)[..., None] * r + off
    valid = (((fi >= 0) & (fi < h_hi))[..., :, None]
             & ((fj >= 0) & (fj < w_hi))[..., None, :])
    flat = fi[..., :, None] * w_hi + fj[..., None, :]
    widx = torch.where(valid, flat, h_hi * w_hi).to(torch.int32)
    b, ha, wa, k = indices.shape
    return (widx.reshape(b, ha, wa, k, side * side),
            valid.reshape(b, ha, wa, k, side * side))


def refine_rescore(values, indices, grid_b_lo, feat_a_hi, feat_b_hi, factor,
                   radius=0):
    """Coarse band + full-resolution features -> the band on the fine grids.

    ``values`` / ``indices`` ``[b, hA_lo, wA_lo, K]`` are the filtered
    coarse band over ``grid_b_lo``; ``feat_a_hi`` / ``feat_b_hi`` ``[b,
    h*r, w*r, c]``. Returns ``(values_f, indices_f, grid_b_hi)`` with
    ``[b, hA_hi, wA_hi, K]`` tensors, the representation the band
    consumers read (`sparse_corr_to_dense`, `band_match_score_per_sample`).
    """
    b, ha_lo, wa_lo, k = values.shape
    _, ha_hi, wa_hi, c = feat_a_hi.shape
    _, hb_hi, wb_hi, _ = feat_b_hi.shape
    r = int(factor)
    if (ha_lo * r, wa_lo * r) != (ha_hi, wa_hi):
        raise ValueError(
            f"fine A grid {ha_hi}x{wa_hi} is not the coarse band grid "
            f"{ha_lo}x{wa_lo} times the factor {r}"
        )
    widx, valid = refine_window_indices(indices, grid_b_lo, (hb_hi, wb_hi), r,
                                        radius)
    win = widx.shape[-1]
    n = ha_lo * wa_lo
    # window features: the null pointer reads the appended zero row
    fb_pad = torch.cat([feat_b_hi.reshape(b, hb_hi * wb_hi, c),
                        feat_b_hi.new_zeros(b, 1, c)], dim=1)
    rows = torch.arange(b, device=widx.device)[:, None]
    fb_win = fb_pad[rows, widx.reshape(b, n * k * win).long()]
    fb_win = fb_win.reshape(b * n, k * win, c)
    # the r^2 fine A-cells under each coarse A-cell
    fa = (feat_a_hi.reshape(b, ha_lo, r, wa_lo, r, c)
          .permute(0, 1, 3, 2, 4, 5).reshape(b * n, r * r, c))
    # the one contraction of refinement: 2 * nA_hi * K * win * c
    s = torch.bmm(fa, fb_win.transpose(1, 2)).reshape(b, ha_lo, wa_lo, r * r,
                                                      k, win)
    s = torch.where(valid[:, :, :, None], s, float("-inf"))
    # a one-entry window's softmax is exactly 1.0: the bitwise anchor
    gain = torch.softmax(s, dim=-1)
    best = torch.argmax(s, dim=-1, keepdim=True)  # the first maximum
    g = gain.gather(-1, best)[..., 0]
    idx_f = widx[:, :, :, None].expand(s.shape).gather(-1, best)[..., 0]
    vals_f = values[:, :, :, None, :] * g

    def to_fine(x):  # [b, hA_lo, wA_lo, r^2, K] -> [b, hA_hi, wA_hi, K]
        return (x.reshape(b, ha_lo, wa_lo, r, r, k).permute(0, 1, 3, 2, 4, 5)
                .reshape(b, ha_hi, wa_hi, k))

    return to_fine(vals_f), to_fine(idx_f), (hb_hi, wb_hi)
