"""ImMatchNet, the matching model (``ncnet_tpu/models/immatchnet.py``).

  feature extraction (frozen trunk, L2 norm)  [source and target]
  -> all-pairs 4D correlation
  -> soft mutual-NN filtering
  -> symmetric neighbourhood-consensus 4D convolutions (the hand kernel)
  -> soft mutual-NN filtering

or, with ``nc_topk > 0``, the same chain on the top-K correlation band
(`ncnet_tpu_torch.sparse`, the band hand kernel), densified for readout.

`ImMatchNetConfig` carries every field of the JAX config, so one dict
builds both models; the configurations this port does not implement yet
raise `NotImplementedError` naming their ROADMAP item.
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
from ncnet_tpu_torch.ops.correlation import correlation_4d
from ncnet_tpu_torch.ops.matching import mutual_matching
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
    """`check_sparse_config`, then raise `NotImplementedError` for
    configurations the port does not implement yet; they never fall back
    to another path."""
    check_sparse_config(config)
    if config.refine_factor > 0:
        raise NotImplementedError(
            "refine_factor > 0 (coarse-to-fine refinement) is not ported yet "
            "(ROADMAP A10)"
        )
    if config.corr_impl != "dense":
        raise NotImplementedError(
            f"corr_impl={config.corr_impl!r} (streamed correlation) is not "
            "ported yet (ROADMAP A9)"
        )
    if config.relocalization_k_size > 1:
        raise NotImplementedError(
            "relocalization_k_size > 1 needs maxpool4d, which is not ported "
            "yet (ROADMAP A2)"
        )


def _compute_dtype(config):
    return torch.bfloat16 if config.half_precision else None


def extract_features(model, config, image):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, c]``.

    The trunk is frozen: it runs under ``torch.no_grad()``, so training
    differentiates the NC stack only and keeps no trunk activations."""
    with torch.no_grad():
        return feature_extraction_apply(
            model.feature_extraction,
            image,
            normalize=config.normalize_features,
            dtype=_compute_dtype(config),
            center=config.center_features,
        )


def match_pipeline(neigh_consensus, config, feat_a, feat_b):
    """Features -> filtered correlation: corr -> MM -> NC -> MM, returned
    in float32. With ``config.nc_topk > 0`` the chain runs on the top-K band
    (`ncnet_tpu_torch.sparse`) and the filtered band is densified here,
    exact zeros off-band.

    Differentiable in the NC parameters (dense path). With
    ``half_precision`` the features (from `extract_features`), the
    correlation and the NC stack are bfloat16, and the output goes back
    to float32 at the post-NC mutual matching (the JAX package's
    ``train/loss.py`` contract)."""
    check_supported(config)
    if config.nc_topk > 0:
        band, indices, grid_b = sparse_match_pipeline(
            neigh_consensus.params(), config, feat_a, feat_b,
            layer=neigh_consensus.band_layer,
        )
        return sparse_corr_to_dense(band, indices, grid_b)
    dtype = _compute_dtype(config)
    corr = mutual_matching(correlation_4d(feat_a, feat_b))
    corr = neigh_consensus(corr.to(dtype) if dtype else corr)
    return mutual_matching(corr).float()


def immatchnet_apply(model, config, source_image, target_image):
    """Forward pass: ``[b, h, w, 3]`` ImageNet-normalized images ->
    ``corr4d [b, iA, jA, iB, jB]`` in float32."""
    feat_a = extract_features(model, config, source_image)
    feat_b = extract_features(model, config, target_image)
    return match_pipeline(model.neigh_consensus, config, feat_a, feat_b)


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
