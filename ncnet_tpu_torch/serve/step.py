"""The serving forward: images -> both-direction matches
(``ncnet_tpu/serve/engine.py::make_serve_match_step``, which wraps the
InLoc dump's ``make_match_fn(concat_directions=True)``)."""

from ncnet_tpu_torch.models import immatchnet


def make_match_fn(config, softmax=True):
    """``fn(model, src, tgt) -> [5, b, n_fwd + n_rev]``: the forward (dense,
    the top-K band densified when ``config.nc_topk > 0``, the refined band
    densified on the fine grid when ``config.refine_factor > 0``, or pooled
    with ``relocalization_k_size > 1``), then `corr_to_matches` in both
    directions (positive coordinates), stacked as ``(xA, yA, xB, yB,
    score)`` and concatenated along the match axis."""
    return immatchnet.make_match_fn(config, softmax=softmax, concat_directions=True)


def make_serve_match_step(config, softmax=True):
    """``apply(model, batch) -> {'matches': [b, 5, n]}`` with ``batch``
    ``{'source_image', 'target_image'}`` of ``[b, h, w, 3]`` tensors; the
    batch axis comes first so readout slices one ``[5, n]`` block per
    request. The degraded serving program is this same constructor at a
    band geometry, ``make_serve_match_step(config.replace(nc_topk=K))``,
    and the refined one at a refine geometry,
    ``make_serve_match_step(config.replace(refine_factor=R,
    refine_topk=K, refine_radius=r))``."""
    fn = make_match_fn(config, softmax=softmax)

    def apply(model, batch):
        out = fn(model, batch["source_image"], batch["target_image"])
        return {"matches": out.permute(1, 0, 2)}

    return apply
