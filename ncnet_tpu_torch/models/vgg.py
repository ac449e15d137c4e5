"""VGG-16 feature trunk cut at ``pool4`` (``ncnet_tpu/models/vgg.py``).

The reference's ``feature_extraction_cnn='vgg'`` truncates torchvision
VGG-16 at ``pool4`` (lib/model.py:24-35): stride-16 output with 512
channels, no BatchNorm. The trunk's children are its ten convs, named
``0`` to ``9`` in torchvision ``features`` order, so the state dict is
the JAX package's flat conv list (``<i>.weight`` OIHW, ``<i>.bias``).
"""

import torch
import torch.nn.functional as F

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.models.resnet import Conv2d, StagedTrunk

# torchvision vgg16.features up to pool4: output channels of each 3x3 conv,
# 'M' a 2x2/2 max-pool
VGG16_TO_POOL4 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
                  512, "M")


def max_pool_2x2(x):
    return F.max_pool2d(x, kernel_size=2, stride=2)


class VGG16Trunk(StagedTrunk):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, 512]``."""

    name = "vgg"
    stride = 16
    channels = 512

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        cin, i = 3, 0
        for c in VGG16_TO_POOL4:
            if c == "M":
                continue
            self.add_module(str(i), Conv2d(cin, c, 3, padding=1, generator=gen,
                                           device=device, bias=True,
                                           init="uniform"))
            cin, i = c, i + 1

    def convs(self):
        return [self.get_submodule(str(i)) for i in range(len(self._modules))]

    def stages(self):
        convs = iter(self.convs())
        out = []
        for c in VGG16_TO_POOL4:
            if c == "M":
                out.append(((), max_pool_2x2))
            else:
                conv = next(convs)
                out.append(((conv,), lambda x, conv=conv: torch.relu(conv(x))))
        return out

    def tail_units(self):
        """The flat conv list (the JAX package's unit rule for vgg)."""
        return self.convs()
