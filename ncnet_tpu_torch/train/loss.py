"""Weakly supervised matching loss (``ncnet_tpu/train/loss.py``).

Reference ``weak_loss`` (train.py:110-156): normalize match scores over the
source dimension (softmax by default), take the per-cell max in both
matching directions, average, and subtract the same quantity computed on
negative pairs formed by rolling the source batch by one:
``loss = score_neg - score_pos``. The roll is applied to the extracted
source features (the trunk is frozen and deterministic).

Mixed precision (``config.half_precision``): features, correlation and
the NC stack are bfloat16; both pipelines return float32 at the post-NC
mutual matching, so the score normalization, the per-sample means and the
final ``neg - pos`` run in float32.

``config.loss_chunk`` / ``loss_chunk_remat`` / ``nc_remat`` are carried
and not read: in the JAX package they only trade memory for recompute
with identical math, and the memory they save is not needed on an
80 GB card (a 16-channel activation of one pipeline call at batch 16 and
400 px is 800 MB in float32).
"""

import torch

from ncnet_tpu_torch.data.images import imagenet_normalize
from ncnet_tpu_torch.models.immatchnet import extract_features, match_pipeline
from ncnet_tpu_torch.sparse.score import normalize_scores


def match_score_per_sample(corr, normalization="softmax"):
    """Per-sample best normalized match score, both directions averaged.

    ``corr``: ``[b, fs1, fs2, fs3, fs4]``. Returns ``[b]``. The maxima are
    ``torch.amax``, which splits a max's gradient evenly among ties as
    JAX's ``jnp.max`` does.
    """
    b, fs1, fs2, fs3, fs4 = corr.shape
    b_avec = corr.reshape(b, fs1 * fs2, fs3, fs4)  # scores over A per B cell
    a_bvec = corr.reshape(b, fs1, fs2, fs3 * fs4)  # scores over B per A cell
    scores_b = torch.amax(normalize_scores(b_avec, 1, normalization), dim=1)
    scores_a = torch.amax(normalize_scores(a_bvec, 3, normalization), dim=3)
    return (scores_a.mean(dim=(1, 2)) + scores_b.mean(dim=(1, 2))) / 2


def match_score(corr, normalization="softmax"):
    """Mean of the best normalized match score, both directions (scalar)."""
    return match_score_per_sample(corr, normalization).mean()


def _check_dense(config):
    if config.relocalization_k_size > 1:
        raise ValueError(
            "weak_loss does not support relocalization configs "
            "(the reference trains with relocalization_k_size=0; "
            "relocalization is an eval-time memory optimization)"
        )
    if config.refine_factor > 0:
        raise NotImplementedError(
            "the weak loss of refine_factor > 0 (coarse-to-fine refinement) "
            "is not ported yet (ROADMAP A10)"
        )
    if config.nc_topk > 0:
        raise NotImplementedError(
            "the weak loss of nc_topk > 0 (band training: band_coverage and "
            "band_match_score_per_sample) is not ported yet (ROADMAP A8)"
        )


def weak_loss(model, config, batch, normalization="softmax"):
    """Positive-vs-rolled-negative weak supervision loss (float32 scalar).

    ``model``: an `ImMatchNet` (trunk + NC head); ``batch``:
    ``source_image`` / ``target_image`` ``[b, h, w, 3]`` tensors on the
    model's device, ImageNet-normalized float or uint8 (normalized here,
    each image keyed on its own dtype).
    """
    src, tgt = batch["source_image"], batch["target_image"]
    if src.dtype == torch.uint8:
        src = imagenet_normalize(src.float())
    if tgt.dtype == torch.uint8:
        tgt = imagenet_normalize(tgt.float())
    feat_a = extract_features(model, config, src)
    feat_b = extract_features(model, config, tgt)
    return weak_loss_core(model.neigh_consensus, config, feat_a, feat_b,
                          normalization)


def weak_loss_from_features(model, config, batch, normalization="softmax"):
    """`weak_loss` from precomputed trunk features ``source_features`` /
    ``target_features`` ``[b, fh, fw, c]`` (a frozen trunk only); cast to
    bfloat16 under ``half_precision`` as `extract_features` would."""
    feat_a = batch["source_features"]
    feat_b = batch["target_features"]
    if config.half_precision:
        feat_a = feat_a.to(torch.bfloat16)
        feat_b = feat_b.to(torch.bfloat16)
    return weak_loss_core(model.neigh_consensus, config, feat_a, feat_b,
                          normalization)


def weak_loss_core(neigh_consensus, config, feat_a, feat_b,
                   normalization="softmax"):
    """The shared post-trunk loss: rolled negatives, then the positive and
    the negative pipeline as two separate `match_pipeline` calls (as the
    JAX package runs them), then ``mean(neg) - mean(pos)``."""
    _check_dense(config)
    feat_a_neg = torch.roll(feat_a, -1, 0)
    corr_pos = match_pipeline(neigh_consensus, config, feat_a, feat_b)
    score_pos = match_score_per_sample(corr_pos, normalization)
    corr_neg = match_pipeline(neigh_consensus, config, feat_a_neg, feat_b)
    score_neg = match_score_per_sample(corr_neg, normalization)
    return score_neg.mean() - score_pos.mean()
