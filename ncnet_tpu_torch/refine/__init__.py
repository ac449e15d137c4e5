"""Coarse-to-fine correspondence (``ncnet_tpu/refine``): a sparse band on
pooled features, then a re-score of the surviving neighbourhoods against
the full-resolution features. Served as the rung above the standard and
degraded programs (``python -m ncnet_tpu_torch.serve --refine R``),
trained and evaluated through the band consumers."""

from ncnet_tpu_torch.refine.pipeline import (
    check_refine_config,
    refine_grid_error,
    refine_match_pipeline,
)
from ncnet_tpu_torch.refine.pool import pool_features
from ncnet_tpu_torch.refine.rescore import refine_rescore, refine_window_indices

__all__ = [
    "check_refine_config",
    "pool_features",
    "refine_grid_error",
    "refine_match_pipeline",
    "refine_rescore",
    "refine_window_indices",
]
