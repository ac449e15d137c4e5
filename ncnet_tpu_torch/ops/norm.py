"""Feature normalization (counterpart of ``ncnet_tpu/ops/norm.py``)."""

import torch


def feature_l2norm(x, dim=-1, eps=1e-6):
    """``x / sqrt(sum(x**2, dim) + eps)``: eps inside the square root, as
    the reference ``featureL2Norm``; channels-last by default."""
    return x / torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)
