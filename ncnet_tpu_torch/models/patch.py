"""Patch-embedding trunk: one 16x16/stride-16 projection with orthonormal
columns (``ncnet_tpu/models/patch.py``). Needs no pretrained weights and
preserves patch inner products, which makes it the cheap discriminative
trunk of the tests."""

import torch
import torch.nn.functional as F
from torch import nn

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.models.resnet import StagedTrunk

PATCH = 16
CHANNELS = 256


class PatchTrunk(StagedTrunk):
    """``[b, h, w, 3]`` -> ``[b, h/16, w/16, 256]`` patch projections; the
    weight is OIHW ``[256, 3, 16, 16]`` (the JAX kernel is HWIO). It has no
    fine-tunable tail (`tail_units` raises, as the JAX package's unit rule
    does); ``train_fe`` trains the projection."""

    name = "patch16"

    stride = PATCH
    channels = CHANNELS

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        flat = torch.randn((PATCH * PATCH * 3, CHANNELS), generator=gen)
        q, _ = torch.linalg.qr(flat)  # [768, 256], orthonormal columns
        kernel = q.reshape(PATCH, PATCH, 3, CHANNELS).permute(3, 2, 0, 1)
        self.weight = nn.Parameter(kernel.contiguous().to(device),
                                   requires_grad=False)

    def _project(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=PATCH)

    def stages(self):
        return [((self,), self._project)]
