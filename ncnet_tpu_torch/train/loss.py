"""Weakly supervised matching loss (``ncnet_tpu/train/loss.py``).

Reference ``weak_loss`` (train.py:110-156): normalize match scores over the
source dimension (softmax by default), take the per-cell max in both
matching directions, average, and subtract the same quantity computed on
negative pairs formed by rolling the source batch by one:
``loss = score_neg - score_pos``. The roll is applied to the extracted
source features (the trunk, frozen or not, is deterministic).

With ``config.nc_topk > 0`` (sparse-band training) each pair is scored
on its own top-K band: `sparse_match_pipeline` (correlation, MM, top-K,
the band NC stack, band MM) and `band_match_score_per_sample`; the NC
stack never sees the dense correlation, and its backward runs through the
band layer's gradient kernels on the card
(`ncnet_tpu_torch.ops.band.BandLayerFunction`). With a trainable trunk
the band's gradient goes on into the correlation through `topk_band`'s
gather, whose backward is a scatter-add (the JAX package's gather VJP;
a row's K indices are distinct, so no two sums collide), and from there
into the trunk's tail. ``corr_impl='stream'`` selects the same band from
slabs (`ncnet_tpu_torch.ops.corr_stream`), whose backward routes the
band's gradient to the trunk without the volume.

With ``config.refine_factor > 0`` (coarse-to-fine, which takes precedence
over ``nc_topk`` as in `match_pipeline`) each pair is scored on its
refined fine-grid band (`refine_match_pipeline`) by the same band scorer;
at factor 1 and radius 0 the loss is the band loss bit for bit.

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
from ncnet_tpu_torch.models.immatchnet import (
    check_supported,
    extract_features,
    match_pipeline,
)
from ncnet_tpu_torch.refine.pipeline import refine_match_pipeline
from ncnet_tpu_torch.sparse.pipeline import sparse_match_pipeline
from ncnet_tpu_torch.sparse.score import (
    band_match_score_per_sample,
    normalize_scores,
)


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


def _check(config):
    if config.relocalization_k_size > 1:
        raise ValueError(
            "weak_loss does not support relocalization configs "
            "(the reference trains with relocalization_k_size=0; "
            "relocalization is an eval-time memory optimization)"
        )
    check_supported(config)


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


def pair_score(neigh_consensus, config, feat_a, feat_b,
               normalization="softmax"):
    """``[b]`` best-match scores of the pairs ``(feat_a, feat_b)``: the
    dense pipeline and `match_score_per_sample`, or with ``refine_factor >
    0`` the refined band and with ``nc_topk > 0`` the band, each scored by
    `band_match_score_per_sample`."""
    band_pipeline = (refine_match_pipeline if config.refine_factor > 0
                     else sparse_match_pipeline if config.nc_topk > 0 else None)
    if band_pipeline is not None:
        band, indices, grid_b = band_pipeline(
            neigh_consensus.params(), config, feat_a, feat_b,
            layer=neigh_consensus.band_layer)
        return band_match_score_per_sample(band, indices, grid_b, normalization)
    corr = match_pipeline(neigh_consensus, config, feat_a, feat_b)
    return match_score_per_sample(corr, normalization)


def weak_loss_core(neigh_consensus, config, feat_a, feat_b,
                   normalization="softmax"):
    """The shared post-trunk loss: rolled negatives, then the positive and
    the negative pair scored by two separate pipeline calls (as the JAX
    package runs them), then ``mean(neg) - mean(pos)``."""
    _check(config)
    feat_a_neg = torch.roll(feat_a, -1, 0)
    score_pos = pair_score(neigh_consensus, config, feat_a, feat_b,
                           normalization)
    score_neg = pair_score(neigh_consensus, config, feat_a_neg, feat_b,
                           normalization)
    return score_neg.mean() - score_pos.mean()
