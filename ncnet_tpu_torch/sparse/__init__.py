"""Sparse-band neighbourhood consensus (counterpart of ``ncnet_tpu/sparse``,
forward): the top-K B-candidates per A-cell, filtered by the NC stack
with submanifold semantics (Sparse-NCNet, arXiv:2004.10566). Enable with
``ImMatchNetConfig(nc_topk=K)`` (0 = dense)."""

from ncnet_tpu_torch.sparse.matching import band_mutual_matching
from ncnet_tpu_torch.sparse.nc import sparse_neigh_consensus_apply
from ncnet_tpu_torch.sparse.pipeline import (
    resolve_band_width,
    resolve_corr_impl,
    sparse_corr_to_dense,
    sparse_match_pipeline,
)

__all__ = [
    "band_mutual_matching",
    "resolve_band_width",
    "resolve_corr_impl",
    "sparse_corr_to_dense",
    "sparse_match_pipeline",
    "sparse_neigh_consensus_apply",
]
