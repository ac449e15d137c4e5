"""Correlation readout: dense hard-argmax matches and keypoint transfer
(``ncnet_tpu/ops/matches.py``; reference lib/point_tnf.py:12-148).

Every function is batched: the reference's gathers assume batch size 1.
"""

import torch


def _lin(scale, n, device):
    if scale == "centered":
        return torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)
    if scale == "positive":
        return torch.linspace(0.0, 1.0, n, dtype=torch.float32, device=device)
    raise ValueError(f"unknown scale {scale!r}")


def corr_to_matches(
    corr,
    delta4d=None,
    k_size=1,
    do_softmax=False,
    scale="centered",
    invert_matching_direction=False,
    return_indices=False,
):
    """Hard-argmax match readout from ``corr [b, iA, jA, iB, jB]``.

    The default direction finds, for every B cell, the best A cell (softmax
    over the A cells); ``invert_matching_direction`` finds, for every A
    cell, the best B cell. Ties take the first maximum. ``delta4d``, the
    ``(di, dj, dk, dl)`` offsets of `maxpool4d` / `correlation_maxpool4d`,
    restores fine-grid indices ``index * k_size + offset``; the coordinate
    grids span ``fs * k_size`` cells. Returns ``(xA, yA, xB, yB, score)``,
    each ``[b, N]``, plus the grid indices ``(iA, jA, iB, jB)`` with
    ``return_indices``.
    """
    b, fs1, fs2, fs3, fs4 = corr.shape
    flat = corr.reshape(b, fs1 * fs2, fs3 * fs4)
    dev = corr.device
    if invert_matching_direction:
        if do_softmax:
            flat = torch.softmax(flat, dim=2)
        score = torch.amax(flat, dim=2)
        idx = torch.argmax(flat, dim=2)
        i_b, j_b = idx // fs4, idx % fs4
        n = fs1 * fs2
        ar = torch.arange(n, device=dev)
        i_a = (ar // fs2).expand(b, n)
        j_a = (ar % fs2).expand(b, n)
    else:
        if do_softmax:
            flat = torch.softmax(flat, dim=1)
        score = torch.amax(flat, dim=1)
        idx = torch.argmax(flat, dim=1)
        i_a, j_a = idx // fs2, idx % fs2
        n = fs3 * fs4
        ar = torch.arange(n, device=dev)
        i_b = (ar // fs4).expand(b, n)
        j_b = (ar % fs4).expand(b, n)

    if delta4d is not None:  # relocalization: fine-grid indices
        flat_idx = ((i_a * fs2 + j_a) * fs3 + i_b) * fs4 + j_b
        d_ia, d_ja, d_ib, d_jb = (
            torch.gather(d.reshape(b, -1), 1, flat_idx) for d in delta4d
        )
        i_a = i_a * k_size + d_ia
        j_a = j_a * k_size + d_ja
        i_b = i_b * k_size + d_ib
        j_b = j_b * k_size + d_jb
    elif k_size != 1:
        i_a, j_a = i_a * k_size, j_a * k_size
        i_b, j_b = i_b * k_size, j_b * k_size

    x_a = _lin(scale, fs2 * k_size, dev)[j_a]
    y_a = _lin(scale, fs1 * k_size, dev)[i_a]
    x_b = _lin(scale, fs4 * k_size, dev)[j_b]
    y_b = _lin(scale, fs3 * k_size, dev)[i_b]

    if return_indices:
        return x_a, y_a, x_b, y_b, score, i_a, j_a, i_b, j_b
    return x_a, y_a, x_b, y_b, score


def _bilinear_transfer(x_a, y_a, x_b, y_b, target_points, grid_shape):
    """Batched ``_bilinear_transfer_single`` of the JAX package: each target
    point is interpolated from the four match-grid corners around it,
    each weighted by the area of the opposite sub-rectangle. Points off
    the grid use the nearest edge cell (the weights then extrapolate)."""
    h, w = grid_shape
    dev, dt = x_a.device, x_a.dtype
    grid_x = torch.linspace(-1.0, 1.0, w, dtype=dt, device=dev)
    grid_y = torch.linspace(-1.0, 1.0, h, dtype=dt, device=dev)
    tx, ty = target_points[:, 0], target_points[:, 1]  # [b, Np]

    def lower_idx(coord, grid, n):
        cnt = torch.sum(coord[:, None, :] > grid[None, :, None], dim=1) - 1
        return torch.clamp(cnt, 0, n - 2)

    x_minus = lower_idx(tx, grid_x, w)
    y_minus = lower_idx(ty, grid_y, h)
    x_plus = x_minus + 1
    y_plus = y_minus + 1

    def at(v, idx):
        return torch.gather(v, 1, idx)

    def area(idx):  # |t - p| over both axes at the matched-grid corner p
        return torch.abs(tx - at(x_b, idx)) * torch.abs(ty - at(y_b, idx))

    def q_at(idx):  # the warped (A) coordinates at that corner
        return torch.stack([at(x_a, idx), at(y_a, idx)], dim=1)

    idx_mm = y_minus * w + x_minus
    idx_pp = y_plus * w + x_plus
    idx_pm = y_minus * w + x_plus
    idx_mp = y_plus * w + x_minus
    f_pp = area(idx_mm)[:, None]
    f_mm = area(idx_pp)[:, None]
    f_mp = area(idx_pm)[:, None]
    f_pm = area(idx_mp)[:, None]
    num = (
        q_at(idx_mm) * f_mm
        + q_at(idx_pp) * f_pp
        + q_at(idx_mp) * f_mp
        + q_at(idx_pm) * f_pm
    )
    return num / (f_pp + f_mm + f_mp + f_pm)


def bilinear_point_transfer(matches, target_points_norm, grid_shape=None):
    """Warp target keypoints into the source image through the match grid.

    Args:
      matches: ``(xA, yA, xB, yB)`` from `corr_to_matches` in the default
        (B -> A) direction, each ``[b, N]`` over ``N = h*w`` match-grid
        cells in row-major order.
      target_points_norm: ``[b, 2, Np]`` in [-1, 1].
      grid_shape: ``(h, w)`` of the match grid; square by default (the
        reference's ``int(sqrt(N))``), required for rectangular grids.

    Returns:
      ``[b, 2, Np]`` warped points in [-1, 1] (source-image frame).
    """
    x_a, y_a, x_b, y_b = matches
    n = x_b.shape[-1]
    if grid_shape is None:
        side = int(round(n**0.5))
        if side * side != n:
            raise ValueError(
                f"match grid is not square: N={n}; pass grid_shape=(h, w) "
                "matching the correlation output_size"
            )
        grid_shape = (side, side)
    if grid_shape[0] * grid_shape[1] != n:
        raise ValueError(f"grid_shape {grid_shape} does not factor N={n}")
    return _bilinear_transfer(x_a, y_a, x_b, y_b, target_points_norm, grid_shape)


def nearest_point_transfer(matches, target_points_norm):
    """Warp target keypoints through the nearest match (reference
    nearestNeighPointTnf, lib/point_tnf.py:82-94); ties take the first
    match."""
    x_a, y_a, x_b, y_b = matches
    t = target_points_norm
    d2 = torch.square(t[:, 0, :, None] - x_b[:, None, :]) + torch.square(
        t[:, 1, :, None] - y_b[:, None, :]
    )
    idx = torch.argmin(d2, dim=2)
    return torch.stack(
        [torch.gather(x_a, 1, idx), torch.gather(y_a, 1, idx)], dim=1
    )
