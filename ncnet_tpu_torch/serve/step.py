"""The serving forward: images -> both-direction matches
(``ncnet_tpu/eval/inloc.py::make_match_fn(concat_directions=True)`` wrapped
by ``ncnet_tpu/serve/engine.py::make_serve_match_step``)."""

import torch

from ncnet_tpu_torch.models.immatchnet import check_supported, immatchnet_apply
from ncnet_tpu_torch.ops.matches import corr_to_matches


def make_match_fn(config, softmax=True):
    """``fn(model, src, tgt) -> [5, b, n_fwd + n_rev]``: the forward (dense,
    or the top-K band densified when ``config.nc_topk > 0``), then `corr_to_matches` in both directions (positive coordinates),
    stacked as ``(xA, yA, xB, yB, score)`` and concatenated along the
    match axis."""
    check_supported(config)

    def fn(model, src, tgt):
        corr = immatchnet_apply(model, config, src, tgt)
        kw = dict(scale="positive", do_softmax=softmax)
        fwd = corr_to_matches(corr, **kw)
        rev = corr_to_matches(corr, invert_matching_direction=True, **kw)
        return torch.cat([torch.stack(fwd), torch.stack(rev)], dim=2)

    return fn


def make_serve_match_step(config, softmax=True):
    """``apply(model, batch) -> {'matches': [b, 5, n]}`` with ``batch``
    ``{'source_image', 'target_image'}`` of ``[b, h, w, 3]`` tensors; the
    batch axis comes first so readout slices one ``[5, n]`` block per
    request. The degraded serving program is this same constructor at a
    band geometry: ``make_serve_match_step(config.replace(nc_topk=K))``."""
    fn = make_match_fn(config, softmax=softmax)

    def apply(model, batch):
        out = fn(model, batch["source_image"], batch["target_image"])
        return {"matches": out.permute(1, 0, 2)}

    return apply
