"""Weak-supervision match scores (``ncnet_tpu/sparse/score.py``): the score
normalization shared by the dense loss (`ncnet_tpu_torch.train.loss`) and
the band scorer, and `band_match_score_per_sample`, the band variant of
``train.loss.match_score_per_sample``.

On the band, off-band cells carry no probability mass (softmax), no L1
mass and no max candidate, and the per-B direction averages over the B
cells some entry covers only. The band is expanded to the dense ``[b, nA,
nB]`` score tensor at this boundary, one scatter of a one-channel tensor
the size of the correlation the selection already made, so the score
math is the dense expression's. At ``K = hB*wB`` every cell is covered and
both directions are the dense score.
"""

import torch

from ncnet_tpu_torch.ops.band import band_coverage, band_to_dense


def normalize_scores(x, dim, normalization):
    """The reference's softmax / l1 / none choice (train.py:110-134) over
    ``dim``."""
    if normalization is None or normalization == "none":
        return x
    if normalization == "softmax":
        return torch.softmax(x, dim=dim)
    if normalization == "l1":
        return x / (torch.sum(x, dim=dim, keepdim=True) + 1e-4)
    raise ValueError(f"unknown score normalization {normalization!r}")


def band_match_score_per_sample(values, indices, grid_b,
                                normalization="softmax"):
    """Per-sample best normalized match score, both directions averaged.

    Args:
      values: ``[b, hA, wA, K]`` filtered band (float32, after the band's
        mutual matching).
      indices: ``[b, hA, wA, K]`` int32 sorted B-indices.
      grid_b: ``(hB, wB)``.
      normalization: ``'softmax'`` (the reference's default), ``'l1'`` or
        ``'none'``.

    Returns:
      ``[b]`` scores, the band counterpart of ``match_score_per_sample``.

    Under softmax an uncovered B cell's column is all ``-inf``, so its
    softmax and max are NaN; the mask takes them out of the forward, and
    their gradient never reaches ``values``: the expansion's backward
    gathers the band's own cells only.
    """
    b, ha, wa, _ = values.shape
    hb, wb = grid_b
    # softmax needs off-band cells at -inf (exp(-inf) == 0 exactly); the
    # additive l1 and none statistics need them at 0
    fill = float("-inf") if normalization == "softmax" else 0.0
    dense = band_to_dense(values, indices, grid_b, fill=fill)
    covered = band_coverage(indices, grid_b)

    b_avec = dense.reshape(b, ha * wa, hb, wb)  # scores over A per B cell
    a_bvec = dense.reshape(b, ha, wa, hb * wb)  # scores over B per A cell
    scores_b = torch.amax(normalize_scores(b_avec, 1, normalization), dim=1)
    scores_a = torch.amax(normalize_scores(a_bvec, 3, normalization), dim=3)

    # every A cell holds K >= 1 entries: a plain mean. B cells average where
    # covered: the mean of the zero-filled scores times nB / count, which
    # is exactly 1 at full coverage (count >= 1: K >= 1 entries cover a
    # cell)
    count = covered.sum(dim=(1, 2)).to(scores_b.dtype)
    scores_b = torch.where(covered, scores_b, 0.0)
    mean_b = scores_b.mean(dim=(1, 2)) * (float(hb * wb) / count)
    return (scores_a.mean(dim=(1, 2)) + mean_b) / 2
