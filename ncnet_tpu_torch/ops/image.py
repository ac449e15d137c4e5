"""Image ops on the device (``ncnet_tpu/ops/image.py``), channels-last.

The reference resizes with an identity-affine ``F.grid_sample`` and
``F.upsample(mode='bilinear')`` under PyTorch 0.3, both with
align-corners semantics: output pixel ``o`` samples input position ``o *
(L_in - 1) / (L_out - 1)``. `resize_bilinear_align_corners` computes those
positions as the JAX package does (``linspace(0, L_in - 1, L_out)``, the
taps at ``floor`` and ``floor + 1`` clipped to the edge) rather than
through ``F.interpolate``, whose rounding differs. `affine_grid` +
`grid_sample` are the reference's ``AffineGridGen`` / ``AffineTnf``
(lib/transformation.py:15-63): align-corners grids, zeros padding tap by
tap. All of it is plain PyTorch, as it is plain XLA in the JAX package.
"""

import torch

from ncnet_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD, imagenet_normalize

__all__ = [
    "affine_grid",
    "affine_transform",
    "device_normalize",
    "grid_sample",
    "imagenet_normalize",
    "imagenet_unnormalize",
    "resize_bilinear_align_corners",
]


def imagenet_unnormalize(image):
    """Inverse of `imagenet_normalize` without the 255 scale:
    ``image * std + mean``."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
    return image * std + mean


def device_normalize(image):
    """A uint8 ``[..., 3]`` image on its device -> ImageNet-normalized
    float32 (``make_match_fn(device_preprocess=True)``'s input step)."""
    return imagenet_normalize(image.to(torch.float32))


def _linspace(start, stop, n, dtype, device):
    # the float32 positions of jnp.linspace(start, stop, n) with constant
    # bounds under jit, as XLA folds them: r = 1 / (n - 1) rounded, then
    # start * (1 - i * r) + i * (stop * r), and stop itself last
    if n == 1:
        return torch.full((1,), float(start), dtype=dtype, device=device)
    i = torch.arange(n - 1, dtype=dtype)
    r = torch.tensor(1.0 / (n - 1), dtype=dtype)
    c = torch.tensor(stop, dtype=dtype) * r
    pos = torch.tensor(start, dtype=dtype) * (1 - i * r) + i * c
    return torch.cat([pos, torch.tensor([stop], dtype=dtype)]).to(device)


def affine_grid(theta, out_h, out_w):
    """``[b, 2, 3]`` affine matrices (output normalized ``(x, y, 1)`` ->
    input normalized position) -> ``[b, out_h, out_w, 2]`` ``(x, y)``
    sample positions in [-1, 1], the base grid spanning [-1, 1] inclusive
    (align corners)."""
    xs = _linspace(-1.0, 1.0, out_w, theta.dtype, theta.device)
    ys = _linspace(-1.0, 1.0, out_h, theta.dtype, theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # [h, w, 3]
    return torch.einsum("hwk,bik->bhwi", base, theta)


def grid_sample(image, grid):
    """Bilinear sampling of ``image`` ``[b, h, w, c]`` at ``grid`` ``[b, gh,
    gw, 2]`` ``(x, y)`` in [-1, 1] (align corners); each of the four taps
    outside the image counts zero (torch's ``'zeros'`` padding). Returns
    ``[b, gh, gw, c]``."""
    b, h, w, c = image.shape
    gx = (grid[..., 0] + 1.0) * 0.5 * (w - 1)
    gy = (grid[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    rows = torch.arange(b, device=image.device)[:, None, None]

    def tap(xi, yi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = torch.clamp(xi, 0, w - 1).long()
        yc = torch.clamp(yi, 0, h - 1).long()
        return image[rows, yc, xc] * inb[..., None].to(image.dtype)

    wx1 = (gx - x0).to(image.dtype)[..., None]
    wy1 = (gy - y0).to(image.dtype)[..., None]
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    return (tap(x0, y0) * wx0 * wy0 + tap(x0 + 1, y0) * wx1 * wy0
            + tap(x0, y0 + 1) * wx0 * wy1 + tap(x0 + 1, y0 + 1) * wx1 * wy1)


def affine_transform(image, theta, out_h, out_w):
    """Warp ``image`` by ``theta`` (the reference's ``AffineTnf`` forward);
    the identity theta is `resize_bilinear_align_corners`."""
    return grid_sample(image, affine_grid(theta, out_h, out_w))


def _interp(x, dim, out_n, in_n):
    if out_n == in_n:
        return x
    pos = _linspace(0.0, in_n - 1.0, out_n, torch.float32, x.device)
    lo = torch.floor(pos).long()
    hi = torch.clamp(lo + 1, max=in_n - 1)
    frac = (pos - lo).to(x.dtype)
    shape = [1] * x.dim()
    shape[dim] = out_n
    frac = frac.reshape(shape)
    lo = torch.clamp(lo, 0, in_n - 1)
    return (torch.index_select(x, dim, lo) * (1 - frac)
            + torch.index_select(x, dim, hi) * frac)


def resize_bilinear_align_corners(image, out_h, out_w):
    """Separable bilinear resize of ``[..., h, w, c]`` with align-corners
    sample positions (rows first, then columns, as the JAX package)."""
    h, w = image.shape[-3], image.shape[-2]
    image = _interp(image, image.dim() - 3, out_h, h)
    return _interp(image, image.dim() - 2, out_w, w)
