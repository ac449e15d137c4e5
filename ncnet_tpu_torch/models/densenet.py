"""DenseNet-201 feature trunk cut after ``transition2``
(``ncnet_tpu/models/densenet.py``).

The torchvision DenseNet-201 front that the reference keeps with
``features.children()[:-4]`` (lib/model.py:69-74): conv0 / norm0 / relu /
pool0, denseblock1 (6 layers), transition1, denseblock2 (12 layers),
transition2. Stride 16, 256 channels, BatchNorm a frozen affine from its
statistics. Names follow the JAX tree (``conv0``, ``norm0``,
``denseblock<n>.<i>.{norm1,conv1,norm2,conv2}``,
``transition<n>.{norm,conv}``), so the bridge is a rename plus HWIO ->
OIHW.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.models.resnet import (
    Conv2d,
    FrozenBatchNorm,
    StagedTrunk,
    max_pool_3x3_s2,
)

GROWTH_RATE = 32
BN_SIZE = 4
NUM_INIT_FEATURES = 64
# denseblock sizes up to the cut (DenseNet-201 has 6, 12, 48, 32)
TRUNK_BLOCKS = (6, 12)


class DenseLayer(nn.Module):
    """torchvision ``_DenseLayer``: BN, ReLU, 1x1 to 128, BN, ReLU, 3x3 to
    32 (pad 1); the 32 new channels are concatenated onto the input."""

    def __init__(self, cin, generator=None, device=None):
        super().__init__()
        kw = dict(generator=generator, device=device, init="fan_in")
        width = BN_SIZE * GROWTH_RATE
        self.norm1 = FrozenBatchNorm(cin, device)
        self.conv1 = Conv2d(cin, width, 1, **kw)
        self.norm2 = FrozenBatchNorm(width, device)
        self.conv2 = Conv2d(width, GROWTH_RATE, 3, padding=1, **kw)

    def forward(self, x):
        out = self.conv1(torch.relu(self.norm1(x)))
        out = self.conv2(torch.relu(self.norm2(out)))
        return torch.cat([x, out], dim=1)


class Transition(nn.Module):
    """torchvision ``_Transition``: BN, ReLU, 1x1 halving the channels,
    2x2/2 average pool."""

    def __init__(self, cin, cout, generator=None, device=None):
        super().__init__()
        self.norm = FrozenBatchNorm(cin, device)
        self.conv = Conv2d(cin, cout, 1, generator=generator, device=device,
                           init="fan_in")

    def forward(self, x):
        return F.avg_pool2d(self.conv(torch.relu(self.norm(x))), 2, 2)


class DenseNet201Trunk(StagedTrunk):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, 256]``."""

    name = "densenet201"
    stride = 16
    channels = 256

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        kw = dict(generator=gen, device=device)
        self.conv0 = Conv2d(3, NUM_INIT_FEATURES, 7, stride=2, padding=3,
                            init="fan_in", **kw)
        self.norm0 = FrozenBatchNorm(NUM_INIT_FEATURES, device)
        cin = NUM_INIT_FEATURES
        for bi, n_layers in enumerate(TRUNK_BLOCKS):
            layers = []
            for _ in range(n_layers):
                layers.append(DenseLayer(cin, **kw))
                cin += GROWTH_RATE
            setattr(self, f"denseblock{bi + 1}", nn.ModuleList(layers))
            setattr(self, f"transition{bi + 1}", Transition(cin, cin // 2, **kw))
            cin //= 2

    def _stem(self, x):
        return max_pool_3x3_s2(torch.relu(self.norm0(self.conv0(x))))

    def stages(self):
        out = [((self.conv0, self.norm0), self._stem)]
        for bi in range(len(TRUNK_BLOCKS)):
            out += [((la,), la) for la in getattr(self, f"denseblock{bi + 1}")]
            t = getattr(self, f"transition{bi + 1}")
            out.append(((t,), t))
        return out

    def tail_units(self):
        """denseblock2's 12 layers, then transition2 as the last unit (the
        JAX package's unit rule for densenet201)."""
        return list(self.denseblock2) + [self.transition2]
