"""All-pairs 4D feature correlation (``ncnet_tpu/ops/correlation.py``)."""

import torch

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
