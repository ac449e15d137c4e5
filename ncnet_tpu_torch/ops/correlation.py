"""All-pairs 4D feature correlation, plain and fused with 4D max-pooling,
and the reference's 3D-shaped correlation (``ncnet_tpu/ops/correlation.py``)."""

import torch

from ncnet_tpu_torch.ops.matching import _decode_offsets
from ncnet_tpu_torch.ops.norm import feature_l2norm


def correlation_4d(feature_a, feature_b, normalization=False, relu=True):
    """``corr[b, iA, jA, iB, jB] = <fA[b, iA, jA, :], fB[b, iB, jB, :]>``.

    One batched GEMM over channels-last ``[b, h, w, c]`` feature maps.
    With ``normalization`` the (optionally ReLU'd) correlation is
    L2-normalized over the flattened B grid.
    """
    corr = torch.einsum("bijc,bklc->bijkl", feature_a, feature_b)
    if normalization:
        if relu:
            corr = torch.relu(corr)
        b, ha, wa, hb, wb = corr.shape
        corr = feature_l2norm(corr.reshape(b, ha, wa, hb * wb), dim=-1)
        corr = corr.reshape(b, ha, wa, hb, wb)
    return corr


def correlation_3d(feature_a, feature_b, normalization=True, relu=True):
    """The reference's ``FeatureCorrelation(shape='3D')`` (lib/model.py:
    97-105): A's grid flattened into a channel axis, channels-last ``[b,
    hB, wB, hA*wA]`` with channel ``iA + hA*jA`` (column-major over A's
    grid). Both maps share one grid; with ``normalization`` (the
    reference's default) the correlation is ReLU'd (``relu``) and
    L2-normalized over that channel axis."""
    b, h, w, _ = feature_a.shape
    # [b, iB, jB, jA, iA]: (jA, iA) row-major flattens to iA + h*jA
    corr = torch.einsum("bijc,bklc->bklji", feature_a, feature_b)
    corr = corr.reshape(b, h, w, h * w)
    if normalization:
        if relu:
            corr = torch.relu(corr)
        corr = feature_l2norm(corr, dim=-1)
    return corr


def _sub_grids(feature, k):
    """``[b, h, w, c]`` -> its ``k*k`` k-strided sub-grids, ``[k*k, b, h/k,
    w/k, c]``, sub-grid ``di*k + dj`` holding the cells ``(k*i + di, k*j +
    dj)``."""
    b, h, w, c = feature.shape
    sub = feature.reshape(b, h // k, k, w // k, k, c)
    return sub.permute(2, 4, 0, 1, 3, 5).reshape(k * k, b, h // k, w // k, c)


def correlation_maxpool4d(feature_a, feature_b, k_size):
    """``maxpool4d(correlation_4d(fA, fB), k_size)`` without the pre-pool
    tensor ("relocalization", reference lib/model.py:269-272, 177-191).

    The ``k^4`` sub-correlations of the k-strided sub-grids are computed
    one at a time (one batched GEMM each) and max-accumulated, so the
    largest tensor is the pooled one, ``k^4`` times smaller than the full
    correlation. Each starts from ``finfo(dtype).min``; A's offset pair is
    the slow one of the combined offset ``idx_a * k*k + idx_b``, and a
    strict ``>`` keeps the first maximum.

    Args:
      feature_a: ``[b, hA, wA, c]``, hA and wA divisible by ``k_size``.
      feature_b: ``[b, hB, wB, c]``, hB and wB divisible by ``k_size``.

    Returns:
      ``(corr, (di, dj, dk, dl))``: the pooled ``[b, hA/k, wA/k, hB/k,
      wB/k]`` correlation and the int32 within-cell offsets of its maxima.
    """
    k = int(k_size)
    b, ha, wa, _ = feature_a.shape
    _, hb, wb, _ = feature_b.shape
    sub_a = _sub_grids(feature_a, k)
    sub_b = _sub_grids(feature_b, k)
    pooled_shape = (b, ha // k, wa // k, hb // k, wb // k)
    dev = feature_a.device
    best = torch.full(pooled_shape, torch.finfo(feature_a.dtype).min,
                      dtype=feature_a.dtype, device=dev)
    best_idx = torch.zeros(pooled_shape, dtype=torch.int32, device=dev)
    for idx_a in range(k * k):
        for idx_b in range(k * k):
            corr = correlation_4d(sub_a[idx_a], sub_b[idx_b])
            take = corr > best
            best = torch.where(take, corr, best)
            best_idx = torch.where(take, idx_a * k * k + idx_b, best_idx)
    return best, _decode_offsets(best_idx, k)
