"""Evaluation metrics (``ncnet_tpu/ops/metrics.py``)."""

import torch


def pck(source_points, warped_points, l_pck, alpha=0.1):
    """Percentage of Correct Keypoints, ``[b]`` in [0, 1].

    The share of valid keypoints whose warped position lies within
    ``alpha * L_pck`` of the ground-truth source position (reference
    lib/eval_util.py:12-24). A keypoint is valid unless the source points
    hold the -1 padding in both coordinates; a NaN warped point is never
    correct; a sample with no valid keypoint scores 0.

    Args:
      source_points, warped_points: ``[b, 2, N]``.
      l_pck: ``[b]`` or ``[b, 1]`` per-sample reference length.
    """
    l_pck = l_pck.reshape(-1)
    valid = (source_points[:, 0, :] != -1) & (source_points[:, 1, :] != -1)
    dist = torch.sqrt(torch.sum(torch.square(source_points - warped_points), dim=1))
    correct = (dist <= l_pck[:, None] * alpha) & valid
    n_valid = torch.sum(valid, dim=1)
    return torch.sum(correct, dim=1) / torch.clamp(n_valid, min=1)
