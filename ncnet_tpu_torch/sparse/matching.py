"""Soft mutual-NN filtering on a correlation band
(``ncnet_tpu/sparse/matching.py``): scatter the band into the 1-channel
dense tensor (off-band cells are exact zeros), apply the dense
`mutual_matching`, gather the band entries back."""

from ncnet_tpu_torch.ops.band import band_to_dense
from ncnet_tpu_torch.ops.matching import mutual_matching


def band_mutual_matching(values, indices, grid_b, eps=1e-5):
    """Mutual-matching gate on band values ``[b, hA, wA, K]`` with sorted
    B-indices; returns the gated band on the same support."""
    b, ha, wa, _ = values.shape
    hb, wb = grid_b
    dense = band_to_dense(values, indices, grid_b, fill=0.0)
    gated = mutual_matching(dense, eps=eps)
    return gated.reshape(b, ha, wa, hb * wb).gather(-1, indices.long())
