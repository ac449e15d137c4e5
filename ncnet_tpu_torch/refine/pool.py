"""Feature pooling for the coarse tier (``ncnet_tpu/refine/pool.py``): one
trunk forward serves both resolutions; the coarse map is the fine map's
``r x r`` mean, L2-normalized again."""

import torch

from ncnet_tpu_torch.ops.norm import feature_l2norm


def pool_features(feats, factor, normalize=True):
    """``[b, h, w, c]`` -> ``[b, h/r, w/r, c]``.

    ``factor == 1`` returns ``feats`` itself: normalizing again would
    divide by a norm of about 1.0 and move the last bit, and the factor-1
    pipeline is refinement's bitwise anchor. A grid that does not divide by
    the factor raises (an edge cell would pool another support)."""
    r = int(factor)
    if r < 1:
        raise ValueError(f"pool factor must be >= 1, got {factor}")
    if r == 1:
        return feats
    b, h, w, c = feats.shape
    if h % r or w % r:
        raise ValueError(
            f"feature grid {h}x{w} does not divide by the refine factor {r}; "
            "pick an image size whose feature grid is a multiple of the factor"
        )
    pooled = torch.mean(feats.reshape(b, h // r, r, w // r, r, c), dim=(2, 4))
    return feature_l2norm(pooled) if normalize else pooled
