"""Feature-extraction front end: trunk + per-location L2 norm
(``ncnet_tpu/models/feature_extraction.py``)."""

import torch

from ncnet_tpu_torch.models.densenet import DenseNet201Trunk
from ncnet_tpu_torch.models.patch import PatchTrunk
from ncnet_tpu_torch.models.resnet import ResNet101Trunk
from ncnet_tpu_torch.models.vgg import VGG16Trunk
from ncnet_tpu_torch.ops.norm import feature_l2norm

BACKBONES = {"resnet101": ResNet101Trunk, "vgg": VGG16Trunk,
             "densenet201": DenseNet201Trunk, "patch16": PatchTrunk}


def make_trunk(cnn, device=None, generator=None):
    """The trunk module named ``cnn`` (a key of `BACKBONES`)."""
    if cnn not in BACKBONES:
        raise ValueError(f"unknown backbone {cnn!r}; have {sorted(BACKBONES)}")
    return BACKBONES[cnn](device=device, generator=generator)


def feature_extraction_apply(trunk, image, normalize=True, dtype=None,
                             center=False):
    """``[b, h, w, 3]`` normalized image -> (L2-normalized) feature map.

    ``dtype`` (e.g. ``torch.bfloat16``) is the compute dtype of the image
    and the trunk's weights; ``center`` subtracts the per-image spatial
    mean before the norm.
    """
    if dtype is not None:
        image = image.to(dtype)
    feats = trunk(image)
    if center:
        feats = feats - torch.mean(feats, dim=(1, 2), keepdim=True)
    if normalize:
        feats = feature_l2norm(feats, dim=-1)
    return feats

