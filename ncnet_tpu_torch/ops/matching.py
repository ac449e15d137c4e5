"""Soft mutual-nearest-neighbour filtering (``ncnet_tpu/ops/matching.py``)."""

import torch


def mutual_matching(corr, eps=1e-5):
    """``corr * (corr / (max_over_B + eps)) * (corr / (max_over_A + eps))``
    on ``[b, iA, jA, iB, jB]``; the two ratios are multiplied first so the
    output is symmetric in A and B."""
    max_over_a = torch.amax(corr, dim=(1, 2), keepdim=True)
    max_over_b = torch.amax(corr, dim=(3, 4), keepdim=True)
    ratio_b = corr / (max_over_a + eps)
    ratio_a = corr / (max_over_b + eps)
    return corr * (ratio_a * ratio_b)


def _decode_offsets(best_idx, k):
    """Combined offset ``((di*k + dj)*k + dk)*k + dl`` -> ``(di, dj, dk,
    dl)``, di slowest (the reference's fmod/div decode, lib/model.py:185-189)."""
    dl = best_idx % k
    dk = (best_idx // k) % k
    dj = (best_idx // (k * k)) % k
    di = best_idx // (k * k * k)
    return di, dj, dk, dl


def maxpool4d(corr, k_size):
    """4D max-pool with stride ``k_size`` over all four dims, with offsets.

    Returns ``(pooled, (di, dj, dk, dl))``: ``pooled`` is ``[b, iA/k, jA/k,
    iB/k, jB/k]`` and the offsets, int32 of the same shape, locate each
    maximum inside its cell (reference ``maxpool4d``, lib/model.py:177-191).
    The ``k^4`` strided slices are max-accumulated in ascending combined
    offset order with a strict ``>`` from -inf, so a tie keeps the first
    maximum, as the argmax over the reference's slice enumeration does.
    All four dims must divide by ``k_size``.
    """
    k = int(k_size)
    b, d1, d2, d3, d4 = corr.shape
    pooled_shape = (b, d1 // k, d2 // k, d3 // k, d4 // k)
    lowest = (float("-inf") if corr.dtype.is_floating_point
              else torch.iinfo(corr.dtype).min)
    best = torch.full(pooled_shape, lowest, dtype=corr.dtype, device=corr.device)
    best_idx = torch.zeros(pooled_shape, dtype=torch.int32, device=corr.device)
    for combo in range(k**4):
        di, rem = divmod(combo, k * k * k)
        dj, rem = divmod(rem, k * k)
        dk, dl = divmod(rem, k)
        sub = corr[:, di::k, dj::k, dk::k, dl::k]
        take = sub > best
        best = torch.where(take, sub, best)
        best_idx = torch.where(take, combo, best_idx)
    return best, _decode_offsets(best_idx, k)
