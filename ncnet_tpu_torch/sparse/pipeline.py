"""End-to-end sparse-band matching pipeline (``ncnet_tpu/sparse/pipeline.py``).

  dense:  corr -> MM -> NC -> MM
  band:   corr -> MM -> top-K band -> submanifold NC -> band MM

Selection runs on the raw correlation; the band values carry the
mutual-matching-gated correlation, the tensor the dense NC stack consumes.
With ``K = hB*wB`` the band is complete and the pipeline equals the dense
one. ``corr_impl='stream'`` selects the same band from B-tile slabs of the
correlation (`ncnet_tpu_torch.ops.corr_stream`) and never holds the
volume: O(hA*wA*(K + tile)) peak memory instead of O(hA*wA*hB*wB).
"""

import torch

from ncnet_tpu_torch.ops.band import band_layer, band_to_dense, topk_band
from ncnet_tpu_torch.ops.corr_stream import corr_stream_band
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.matching import mutual_matching
from ncnet_tpu_torch.sparse.matching import band_mutual_matching
from ncnet_tpu_torch.sparse.nc import sparse_neigh_consensus_apply

#: correlation->band implementations the config may name
CORR_IMPLS = ("dense", "stream")


def resolve_corr_impl(config):
    """Validate and return ``config.corr_impl``."""
    impl = config.corr_impl
    if impl not in CORR_IMPLS:
        raise ValueError(
            f"corr_impl={impl!r} is not one of {CORR_IMPLS}: 'dense' "
            "materializes the full correlation volume, 'stream' tiles B's "
            "grid and selects the band with O(hA*wA*(K+tile)) peak memory"
        )
    return impl


def resolve_band_width(nc_topk, grid_b):
    """``nc_topk`` clamped to the B-grid size (``K >= hB*wB`` runs the
    complete band); a band width <= 0 raises."""
    nb = int(grid_b[0]) * int(grid_b[1])
    k = int(nc_topk)
    if k <= 0:
        raise ValueError(
            f"nc_topk={nc_topk}: the sparse pipeline needs a positive "
            "band width (0 selects the dense path upstream)"
        )
    return min(k, nb)


def sparse_match_pipeline(params, config, feat_a, feat_b,
                          layer=band_layer):
    """Features -> filtered correlation band.

    ``params`` is the NC stack's ``[{'kernel', 'bias'}, ...]``; ``layer``
    the band NC layer (`sparse_neigh_consensus_apply`'s). Returns ``(values,
    indices, grid_b)``: the post-NC, post-MM band in float32 on the top-K
    support.
    """
    if config.relocalization_k_size > 1:
        raise ValueError(
            "sparse NC (nc_topk > 0) does not support relocalization "
            "configs: the 4D max-pool offsets are a dense-readout "
            "construct (set relocalization_k_size to 0)"
        )
    grid_b = (feat_b.shape[1], feat_b.shape[2])
    k = resolve_band_width(config.nc_topk, grid_b)
    if resolve_corr_impl(config) == "stream":
        values, indices = corr_stream_band(
            feat_a, feat_b, k, mutual=config.nc_topk_mutual,
            tile=config.corr_stream_tile)
    else:
        corr = correlation_4d(feat_a, feat_b)
        gated = mutual_matching(corr)
        values, indices = topk_band(corr, k, values_from=gated,
                                    mutual=config.nc_topk_mutual)
    if config.half_precision:
        values = values.to(torch.bfloat16)
    band = sparse_neigh_consensus_apply(
        params, values, indices, grid_b, symmetric=config.symmetric_mode,
        band_impl=config.band_impl, layer=layer,
    )
    band = band_mutual_matching(band, indices, grid_b).float()
    return band, indices, grid_b


def sparse_corr_to_dense(values, indices, grid_b):
    """The filtered band as a dense ``[b, hA, wA, hB, wB]`` tensor, exact
    zeros off-band, for the dense readout (`corr_to_matches`)."""
    return band_to_dense(values, indices, grid_b, fill=0.0)
