"""The coarse-to-fine pipeline (``ncnet_tpu/refine/pipeline.py``):

  full-resolution trunk features
    -> r x r mean + L2 norm            (`pool_features`)
    -> sparse band at K = refine_topk  (`sparse_match_pipeline`, coarse)
    -> window re-score                 (`refine_rescore`)
    -> the band on the fine grids, read by the band consumers

With ``refine_factor == 1`` and ``refine_radius == 0`` the pool is the
identity and every window holds its own candidate, so the refined band is
the coarse band bit for bit; with ``refine_topk >= hB*wB`` as well it is
the dense pipeline's.
"""

from ncnet_tpu_torch.ops.band import band_layer
from ncnet_tpu_torch.refine.pool import pool_features
from ncnet_tpu_torch.refine.rescore import refine_rescore
from ncnet_tpu_torch.sparse.pipeline import resolve_corr_impl, sparse_match_pipeline


def check_refine_config(config):
    """Raise `ValueError` on refine settings the pipeline cannot run, before
    any tensor is touched (the coarse tier inherits ``corr_impl``)."""
    resolve_corr_impl(config)
    factor = int(config.refine_factor)
    if factor < 0:
        raise ValueError(
            f"refine_factor={factor} is negative; use 0 to disable refinement "
            "or a positive pool factor"
        )
    if not factor:
        return
    if int(config.refine_topk) <= 0:
        raise ValueError(
            f"refine_topk={config.refine_topk}: the coarse pass needs a "
            "positive band width"
        )
    if int(config.refine_radius) < 0:
        raise ValueError(f"refine_radius={config.refine_radius} is negative")
    if config.relocalization_k_size > 1:
        raise ValueError(
            "refinement does not support relocalization configs: the 4D "
            "max-pool offsets are a dense-readout construct and the refined "
            "band already reads out at the fine grid (set "
            "relocalization_k_size to 0)"
        )


def refine_grid_error(factor, image_size):
    """The CLIs' refusal of a pool factor that does not divide the
    ``image_size / 16`` feature grid (the trunk's stride; the JAX CLIs'
    check), as a message, or None where it divides or refinement is off."""
    grid = max(int(image_size) // 16, 1)
    if factor and grid % int(factor):
        return (f"image size {image_size} gives a {grid}x{grid} feature "
                f"grid, which does not divide by --refine {factor}")
    return None


def refine_match_pipeline(params, config, feat_a, feat_b, layer=band_layer):
    """Full-resolution features -> ``(values, indices, grid_b)``, the
    refined band on the fine grids. ``params`` / ``layer`` are the band NC
    stack's (`sparse_match_pipeline`). The coarse tier is pooled here, so
    one trunk forward serves both resolutions."""
    check_refine_config(config)
    factor = int(config.refine_factor)
    fa_lo = pool_features(feat_a, factor, normalize=config.normalize_features)
    fb_lo = pool_features(feat_b, factor, normalize=config.normalize_features)
    # the coarse tier is the sparse band at refine_topk (nc_topk stays the
    # standard tier's); corr_impl carries over, so 'stream' materializes
    # no coarse volume either
    coarse = config.replace(refine_factor=0, nc_topk=int(config.refine_topk))
    values, indices, grid_b_lo = sparse_match_pipeline(
        params, coarse, fa_lo, fb_lo, layer=layer)
    return refine_rescore(values, indices, grid_b_lo, feat_a, feat_b, factor,
                          radius=int(config.refine_radius))
