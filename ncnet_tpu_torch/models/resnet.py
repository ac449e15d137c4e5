"""ResNet-101 feature trunk cut after ``layer3`` (``ncnet_tpu/models/resnet.py``).

Stride-16 output with 1024 channels; BatchNorm is frozen in eval mode and
computed as a per-channel affine from stored statistics (eps 1e-5). The
public layout is channels-last ``[b, h, w, c]`` like the JAX trunk; inside,
the module permutes to NCHW for ``F.conv2d``. Parameter names follow the
JAX tree (``conv1``, ``bn1``, ``layer1.0.conv2``, ``downsample_conv``...),
so the weight bridge is a rename plus HWIO -> OIHW.

Every trunk tensor (conv weights and the four BN tensors) is a parameter
that does not require a gradient until training marks it (the trunk's
tail, ``fe_finetune_blocks``, or all of it, ``train_fe``): the JAX package
trains a tail unit's whole param dict, BN ``mean`` and ``var`` included.
`StagedTrunk` runs the stages before the first trainable one under
``torch.no_grad()``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ncnet_tpu_torch.device import resolve_device

BN_EPS = 1e-5

# (n_blocks, planes, stride) per stage; the trunk stops after layer3.
RESNET101_STAGES = ((3, 64, 1), (4, 128, 2), (23, 256, 2))
EXPANSION = 4


def _frozen(t, device):
    return nn.Parameter(t.to(device), requires_grad=False)


class Conv2d(nn.Module):
    """Conv with an OIHW weight (and optional bias) cast to the input's
    dtype. ``init``: ``'fan_out'`` He-normal (torchvision's ResNet),
    ``'fan_in'`` He-normal (its DenseNet), ``'uniform'`` +-1/sqrt(fan_in)
    on weight and bias (its VGG)."""

    def __init__(self, cin, cout, k, stride=1, padding=0, generator=None,
                 device=None, bias=False, init="fan_out"):
        super().__init__()
        fan_in, fan_out = k * k * cin, k * k * cout
        bound = (1.0 / fan_in) ** 0.5
        if init == "uniform":
            w = (torch.rand((cout, cin, k, k), generator=generator) * 2 - 1) * bound
        else:
            std = (2.0 / (fan_out if init == "fan_out" else fan_in)) ** 0.5
            w = torch.randn((cout, cin, k, k), generator=generator) * std
        self.weight = _frozen(w, device)
        if bias:
            b = (torch.rand((cout,), generator=generator) * 2 - 1) * bound
            self.bias = _frozen(b, device)
        else:
            self.bias = None
        self.stride = stride
        self.padding = padding

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, stride=self.stride,
                        padding=self.padding)


class FrozenBatchNorm(nn.Module):
    """Eval-mode BN: ``x * inv + (offset - mean * inv)``,
    ``inv = scale / sqrt(var + eps)``, on NCHW. The four tensors are
    parameters, differentiable once marked trainable, as the JAX package's
    ``_bn_apply`` is in all four."""

    def __init__(self, c, device=None):
        super().__init__()
        self.scale = _frozen(torch.ones(c), device)
        self.offset = _frozen(torch.zeros(c), device)
        self.mean = _frozen(torch.zeros(c), device)
        self.var = _frozen(torch.ones(c), device)

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


def max_pool_3x3_s2(x):
    # max-pool 3x3/s2 with pad 1; PyTorch pads with -inf
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _trains(modules):
    return any(p.requires_grad for m in modules for p in m.parameters())


class StagedTrunk(nn.Module):
    """A trunk as an ordered list of stages on NCHW, ``stages() ->
    [(modules holding the stage's tensors, fn), ...]``, and the units its
    ``fe_finetune_blocks`` count backwards over (`tail_units`).

    ``forward`` takes and returns channels-last tensors. The stages before
    the first one with a trainable tensor run under ``torch.no_grad()``, so
    a fine-tuned tail keeps no activations of the frozen front."""

    name = None

    def stages(self):
        raise NotImplementedError

    def tail_units(self):
        """The trunk's fine-tunable units, shallowest first (the JAX
        package's ``train/step.py::_finetune_tail_blocks``)."""
        raise ValueError(f"no finetune tail defined for backbone {self.name!r}")

    def forward(self, image):
        x = image.permute(0, 3, 1, 2)
        stages = self.stages()
        first = next((i for i, (mods, _) in enumerate(stages) if _trains(mods)),
                     len(stages))
        with torch.no_grad():
            for _, fn in stages[:first]:
                x = fn(x)
        for _, fn in stages[first:]:
            x = fn(x)
        return x.permute(0, 2, 3, 1)


class ResNet101Trunk(StagedTrunk):
    """``[b, h, w, 3]`` normalized image -> ``[b, h/16, w/16, 1024]``."""

    name = "resnet101"

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

    def _stem(self, x):
        return max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))

    def stages(self):
        blocks = [*self.layer1, *self.layer2, *self.layer3]
        return [((self.conv1, self.bn1), self._stem)] + [((b,), b) for b in blocks]

    def tail_units(self):
        """layer3's 23 bottlenecks (the reference's ``model[-1][-(i+1)]``)."""
        return list(self.layer3)
