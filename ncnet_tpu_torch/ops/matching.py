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
