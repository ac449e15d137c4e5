"""ImMatchNet, the matching model (``ncnet_tpu/models/immatchnet.py``).

  feature extraction (trunk, frozen or with a trainable tail; L2 norm)
  [source and target]
  -> all-pairs 4D correlation (with ``relocalization_k_size > 1``: fused
     with a 4D max-pool, which also returns the offsets of the maxima)
  -> soft mutual-NN filtering
  -> symmetric neighbourhood-consensus 4D convolutions (the hand kernel)
  -> soft mutual-NN filtering

or, with ``nc_topk > 0``, the same chain on the top-K correlation band
(`ncnet_tpu_torch.sparse`, the band hand kernel; ``corr_impl='stream'``
selects it without the correlation volume), densified for readout; or,
with ``refine_factor > 0``, a coarse band on pooled features re-scored at
full resolution (`ncnet_tpu_torch.refine`), densified on the fine grid.

`ImMatchNetConfig` carries every field of the JAX config, so one dict
builds both models.
"""

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.models.feature_extraction import (
    feature_extraction_apply,
    make_trunk,
)
from ncnet_tpu_torch.models.neigh_consensus import NeighConsensus
from ncnet_tpu_torch.ops.correlation import correlation_4d, correlation_maxpool4d
from ncnet_tpu_torch.ops.matches import corr_to_matches
from ncnet_tpu_torch.ops.matching import mutual_matching
from ncnet_tpu_torch.refine.pipeline import (
    check_refine_config,
    refine_match_pipeline,
)
from ncnet_tpu_torch.sparse.pipeline import (
    resolve_corr_impl,
    sparse_corr_to_dense,
    sparse_match_pipeline,
)


@dataclasses.dataclass(frozen=True)
class ImMatchNetConfig:
    """Architecture and numerics config; field for field the JAX
    ``ImMatchNetConfig``. Training-only fields (``nc_remat``,
    ``loss_chunk``, ``loss_chunk_remat``) are carried but not read, and
    ``conv4d_impl`` / ``band_impl`` name JAX lowerings: every value (of
    ``band_impl``, ``'xla'`` or ``'pallas'``) computes the same function
    here."""

    feature_extraction_cnn: str = "resnet101"
    ncons_kernel_sizes: Tuple[int, ...] = (3, 3, 3)
    ncons_channels: Tuple[int, ...] = (10, 10, 1)
    normalize_features: bool = True
    symmetric_mode: bool = True
    relocalization_k_size: int = 0
    half_precision: bool = False  # bf16 features / correlation / NC
    conv4d_impl: str = "xla"
    nc_remat: bool = False
    symmetric_batch: bool = True
    loss_chunk: int = 0
    loss_chunk_remat: bool = True
    center_features: bool = False
    nc_init: str = "reference"
    nc_topk: int = 0
    nc_topk_mutual: bool = True
    band_impl: str = "xla"
    refine_factor: int = 0
    refine_topk: int = 16
    refine_radius: int = 0
    corr_impl: str = "dense"
    corr_stream_tile: int = 128

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["ncons_kernel_sizes"] = list(d["ncons_kernel_sizes"])
        d["ncons_channels"] = list(d["ncons_channels"])
        return d

    @classmethod
    def from_dict(cls, d):
        d = dict(d)
        d["ncons_kernel_sizes"] = tuple(d["ncons_kernel_sizes"])
        d["ncons_channels"] = tuple(d["ncons_channels"])
        return cls(**d)


def check_sparse_config(config):
    """The JAX package's ``train/step.py::check_sparse_config``: a negative
    band width, relocalization with a band, an unknown ``corr_impl`` and a
    streamed correlation without a band path raise `ValueError`."""
    if config.nc_topk < 0:
        raise ValueError(
            f"nc_topk={config.nc_topk} is negative; use 0 for the dense path "
            "or a positive top-K band width (ncnet_tpu_torch.sparse)"
        )
    if config.nc_topk and config.relocalization_k_size > 1:
        raise ValueError(
            f"nc_topk={config.nc_topk} with relocalization_k_size="
            f"{config.relocalization_k_size}: the sparse band path does not "
            "support relocalization (use relocalization_k_size=0, as the "
            "reference does)"
        )
    impl = resolve_corr_impl(config)  # raises on unknown values
    if impl != "dense" and not (config.nc_topk or config.refine_factor):
        raise ValueError(
            f"corr_impl={impl!r} requires a band path (nc_topk > 0 or "
            "refine_factor > 0): the dense NC stack consumes the full "
            "correlation volume, so there is nothing to stream"
        )


def check_supported(config):
    """`check_sparse_config` and `check_refine_config`: a configuration
    either runs as the JAX package runs it or raises here."""
    check_sparse_config(config)
    check_refine_config(config)


def _compute_dtype(config):
    return torch.bfloat16 if config.half_precision else None


def trunk_trains(model):
    """True when some trunk tensor is marked trainable (``train_fe`` or a
    fine-tuned tail)."""
    return any(p.requires_grad for p in model.feature_extraction.parameters())


def extract_features(model, config, image):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, c]``.

    A frozen trunk runs wholly under ``torch.no_grad()``: training then
    differentiates the NC stack only and keeps no trunk activations. With
    trainable trunk tensors the trunk itself runs its frozen front under
    ``no_grad`` and the tail from its first trainable stage with grad
    (`ncnet_tpu_torch.models.resnet.StagedTrunk`)."""
    def apply():
        return feature_extraction_apply(
            model.feature_extraction,
            image,
            normalize=config.normalize_features,
            dtype=_compute_dtype(config),
            center=config.center_features,
        )

    if trunk_trains(model):
        return apply()
    with torch.no_grad():
        return apply()


def match_pipeline(neigh_consensus, config, feat_a, feat_b):
    """Features -> filtered correlation: corr -> MM -> NC -> MM, returned
    in float32. With ``config.nc_topk > 0`` the chain runs on the top-K band
    (`ncnet_tpu_torch.sparse`) and the filtered band is densified here,
    exact zeros off-band. With ``config.refine_factor > 0`` (which takes
    precedence) the coarse band runs on pooled features and is re-scored
    at full resolution (`ncnet_tpu_torch.refine`); the result is the
    refined band densified on the fine grid. With ``config.relocalization_k_size = k > 1``
    the correlation is max-pooled by k in all four dims on the way
    (`correlation_maxpool4d`) and the result is ``(corr, delta4d)``, the
    offsets `corr_to_matches` takes to restore fine-grid matches.

    Differentiable in the NC parameters (dense path). With
    ``half_precision`` the features (from `extract_features`), the
    correlation and the NC stack are bfloat16, and the output goes back
    to float32 at the post-NC mutual matching (the JAX package's
    ``train/loss.py`` contract)."""
    check_supported(config)
    if config.refine_factor > 0:
        values, indices, grid_b = refine_match_pipeline(
            neigh_consensus.params(), config, feat_a, feat_b,
            layer=neigh_consensus.band_layer,
        )
        return sparse_corr_to_dense(values, indices, grid_b)
    if config.nc_topk > 0:
        band, indices, grid_b = sparse_match_pipeline(
            neigh_consensus.params(), config, feat_a, feat_b,
            layer=neigh_consensus.band_layer,
        )
        return sparse_corr_to_dense(band, indices, grid_b)
    dtype = _compute_dtype(config)
    k = config.relocalization_k_size
    delta4d = None
    if k > 1:
        corr, delta4d = correlation_maxpool4d(feat_a, feat_b, k)
    else:
        corr = correlation_4d(feat_a, feat_b)
    corr = mutual_matching(corr)
    corr = neigh_consensus(corr.to(dtype) if dtype else corr)
    corr = mutual_matching(corr).float()
    return (corr, delta4d) if k > 1 else corr


def immatchnet_apply(model, config, source_image, target_image):
    """Forward pass: ``[b, h, w, 3]`` ImageNet-normalized images ->
    ``corr4d [b, iA, jA, iB, jB]`` in float32, or ``(corr4d, delta4d)``
    with ``relocalization_k_size > 1``."""
    feat_a = extract_features(model, config, source_image)
    feat_b = extract_features(model, config, target_image)
    return match_pipeline(model.neigh_consensus, config, feat_a, feat_b)


def make_match_fn(config, softmax=True, concat_directions=False,
                  from_features=False):
    """``fn(model, src, tgt)`` -> both directions' matches of one pair
    batch: ``(fwd, rev)``, each a stacked ``[5, b, n]`` tensor ``(xA, yA,
    xB, yB, score)`` in positive [0, 1] coordinates, or with
    ``concat_directions`` one ``[5, b, n_fwd + n_rev]`` tensor. The
    forward is dense, the top-K band densified (``nc_topk > 0``), the
    refined band densified on the fine grid (``refine_factor > 0``), or
    pooled (``relocalization_k_size > 1``, whose readout restores
    fine-grid matches from the pooled correlation's offsets). Serving and
    the InLoc dump both read out through it. ``from_features``: ``src`` /
    ``tgt`` are ``[b, fh, fw, c]`` trunk features (a feature store's) and
    the forward is `match_pipeline` alone, no trunk op."""
    check_supported(config)
    k = config.relocalization_k_size

    def forward(model, src, tgt):
        if from_features:
            return match_pipeline(model.neigh_consensus, config, src, tgt)
        return immatchnet_apply(model, config, src, tgt)

    def fn(model, src, tgt):
        out = forward(model, src, tgt)
        corr, delta4d = out if k > 1 else (out, None)
        kw = dict(scale="positive", do_softmax=softmax, delta4d=delta4d,
                  k_size=max(k, 1))
        fwd = torch.stack(corr_to_matches(corr, **kw))
        rev = torch.stack(corr_to_matches(corr, invert_matching_direction=True, **kw))
        if concat_directions:
            return torch.cat([fwd, rev], dim=2)
        return fwd, rev

    return fn


class ImMatchNet(nn.Module):
    """Config + trunk + NC stack on one device, random weights from
    ``generator`` (weights from the JAX package come in through
    `ncnet_tpu_torch.bridge.from_jax_params`)."""

    def __init__(self, config=None, device=None, generator=None):
        super().__init__()
        config = config if config is not None else ImMatchNetConfig()
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.feature_extraction = make_trunk(
            config.feature_extraction_cnn, device=self.device, generator=gen
        )
        self.neigh_consensus = NeighConsensus(
            config.ncons_kernel_sizes,
            config.ncons_channels,
            symmetric=config.symmetric_mode,
            symmetric_batch=config.symmetric_batch,
            scheme=config.nc_init,
            device=self.device,
            generator=gen,
        )

    def forward(self, source_image, target_image):
        return immatchnet_apply(self, self.config, source_image, target_image)
