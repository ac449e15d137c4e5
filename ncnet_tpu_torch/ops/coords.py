"""Pixel <-> normalized [-1, 1] coordinates (``ncnet_tpu/ops/coords.py``).

The reference's 1-indexed pixel convention (lib/point_tnf.py:6-10,151-167):
``normalize_axis(x, L) = (x - 1 - (L-1)/2) * 2 / (L-1)``. Points are
``[b, 2, N]`` with row 0 = x and row 1 = y; image sizes are ``[b, 2+]``
ordered ``(h, w, ...)``.
"""

import torch


def normalize_axis(x, length):
    """Pixel coordinate (1-indexed) -> [-1, 1]."""
    return (x - 1 - (length - 1) / 2) * 2 / (length - 1)


def unnormalize_axis(x, length):
    """[-1, 1] -> pixel coordinate (1-indexed)."""
    return x * (length - 1) / 2 + 1 + (length - 1) / 2


def points_to_unit_coords(points, im_size):
    """``[b, 2, N]`` pixel points -> [-1, 1], x against the width and y
    against the height."""
    h = im_size[:, 0][:, None]
    w = im_size[:, 1][:, None]
    return torch.stack(
        [normalize_axis(points[:, 0, :], w), normalize_axis(points[:, 1, :], h)],
        dim=1,
    )


def points_to_pixel_coords(points, im_size):
    """``[b, 2, N]`` [-1, 1] points -> pixel coordinates."""
    h = im_size[:, 0][:, None]
    w = im_size[:, 1][:, None]
    return torch.stack(
        [unnormalize_axis(points[:, 0, :], w), unnormalize_axis(points[:, 1, :], h)],
        dim=1,
    )
