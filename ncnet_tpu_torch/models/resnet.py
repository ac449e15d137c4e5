"""ResNet-101 feature trunk cut after ``layer3`` (``ncnet_tpu/models/resnet.py``).

Stride-16 output with 1024 channels; BatchNorm is frozen in eval mode and
computed as a per-channel affine from stored statistics (eps 1e-5). The
public layout is channels-last ``[b, h, w, c]`` like the JAX trunk; inside,
the module permutes to NCHW for ``F.conv2d``. Parameter names follow the
JAX tree (``conv1``, ``bn1``, ``layer1.0.conv2``, ``downsample_conv``...),
so the weight bridge is a rename plus HWIO -> OIHW.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ncnet_tpu_torch.device import resolve_device

BN_EPS = 1e-5

# (n_blocks, planes, stride) per stage; the trunk stops after layer3.
RESNET101_STAGES = ((3, 64, 1), (4, 128, 2), (23, 256, 2))
EXPANSION = 4


class Conv2d(nn.Module):
    """Bias-free conv with an OIHW weight cast to the input's dtype."""

    def __init__(self, cin, cout, k, stride=1, padding=0, generator=None,
                 device=None):
        super().__init__()
        # He-normal fan-out (torchvision's ResNet conv init)
        std = (2.0 / (k * k * cout)) ** 0.5
        w = torch.randn((cout, cin, k, k), generator=generator) * std
        self.weight = nn.Parameter(w.to(device), requires_grad=False)
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                        padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BN: ``x * inv + (offset - mean * inv)``,
    ``inv = scale / sqrt(var + eps)``, on NCHW."""

    def __init__(self, c, device=None):
        super().__init__()
        self.register_buffer("scale", torch.ones(c, device=device))
        self.register_buffer("offset", torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x):
        dt = x.dtype
        inv = self.scale.to(dt) * torch.rsqrt(self.var.to(dt) + BN_EPS)
        shift = self.offset.to(dt) - self.mean.to(dt) * inv
        return x * inv[:, None, None] + shift[:, None, None]


class Bottleneck(nn.Module):
    """torchvision v1.5 bottleneck: the stride sits on the 3x3 conv2, with
    symmetric (1, 1) padding."""

    def __init__(self, cin, planes, stride, downsample, generator=None,
                 device=None):
        super().__init__()
        cout = planes * EXPANSION
        kw = dict(generator=generator, device=device)
        self.conv1 = Conv2d(cin, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device)
        self.conv3 = Conv2d(planes, cout, 1, **kw)
        self.bn3 = FrozenBatchNorm(cout, device)
        if downsample:
            self.downsample_conv = Conv2d(cin, cout, 1, stride=stride, **kw)
            self.downsample_bn = FrozenBatchNorm(cout, device)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            shortcut = self.downsample_bn(self.downsample_conv(x))
        else:
            shortcut = x
        return torch.relu(out + shortcut)


class ResNet101Trunk(nn.Module):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, 1024]``."""

    stride = 16
    channels = 1024

    def __init__(self, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, generator=gen,
                            device=device)
        self.bn1 = FrozenBatchNorm(64, device)
        cin = 64
        for si, (n_blocks, planes, stride) in enumerate(RESNET101_STAGES):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(
                    cin, planes, stride if bi == 0 else 1, downsample=(bi == 0),
                    generator=gen, device=device,
                ))
                cin = planes * EXPANSION
            setattr(self, f"layer{si + 1}", nn.ModuleList(blocks))

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        # max-pool 3x3/s2 with pad 1; PyTorch pads with -inf
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for layer in (self.layer1, self.layer2, self.layer3):
            for block in layer:
                x = block(x)
        return x.permute(0, 2, 3, 1)
