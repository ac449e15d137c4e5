"""Score normalization of the weak-supervision loss
(``ncnet_tpu/sparse/score.py::normalize_scores``), shared by the dense loss
(`ncnet_tpu_torch.train.loss`) and, once ported, the band scorer."""

import torch


def normalize_scores(x, dim, normalization):
    """The reference's softmax / l1 / none choice (train.py:110-134) over
    ``dim``."""
    if normalization is None or normalization == "none":
        return x
    if normalization == "softmax":
        return torch.softmax(x, dim=dim)
    if normalization == "l1":
        return x / (torch.sum(x, dim=dim, keepdim=True) + 1e-4)
    raise ValueError(f"unknown score normalization {normalization!r}")
