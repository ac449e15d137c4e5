"""Learned 4D neighbourhood-consensus filter
(``ncnet_tpu/models/neigh_consensus.py``).

A stack of ``Conv4d + ReLU`` layers on the correlation tensor, optionally
symmetric: ``net(x) + T(net(T(x)))`` where ``T`` swaps the (iA, jA) and
(iB, jB) index pairs. Activations stay channels-last ``[b, i, j, k, l, c]``
between layers, the same memory as the JAX package's packed
``[b, i, j, k*l*c]``, and every layer runs through
`ncnet_tpu_torch.ops.conv4d.conv4d` (the hand kernel on the card).
"""

import torch
from torch import nn

from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.ops.band import band_layer
from ncnet_tpu_torch.ops.conv4d import conv4d


def init_neigh_consensus(kernel_sizes=(3, 3, 3), channels=(10, 10, 1),
                         scheme="reference", identity_noise=0.02,
                         generator=None):
    """Per-layer ``{'kernel': [k,k,k,k,cin,cout], 'bias': [cout]}`` float32
    CPU tensors drawn from ``generator``.

    ``'reference'``: uniform in +-1/sqrt(fan_in) (torch ``_ConvNd``'s
    default, as the reference Conv4d). ``'identity'``: a centre-tap
    channel-0 pass-through plus ``identity_noise`` Gaussian noise.
    """
    if len(kernel_sizes) != len(channels):
        raise ValueError(
            f"kernel_sizes {tuple(kernel_sizes)} and channels "
            f"{tuple(channels)} must have one entry per NC layer"
        )
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    params = []
    cin = 1
    for k, cout in zip(kernel_sizes, channels):
        shape = (k, k, k, k, cin, cout)
        if scheme == "identity":
            kern = identity_noise * torch.randn(shape, generator=gen)
            c = k // 2
            kern[c, c, c, c, 0, 0] += 1.0
            bias = torch.zeros(cout)
        elif scheme == "reference":
            bound = (1.0 / (cin * k**4)) ** 0.5
            kern = (torch.rand(shape, generator=gen) * 2 - 1) * bound
            bias = (torch.rand((cout,), generator=gen) * 2 - 1) * bound
        else:
            raise ValueError(f"unknown NC init scheme {scheme!r}")
        params.append({"kernel": kern, "bias": bias})
        cin = cout
    return params


def _swap_ab(x):
    """Swap the A and B index pairs of ``[b, iA, jA, iB, jB, c]``."""
    return x.permute(0, 3, 4, 1, 2, 5).contiguous()


def neigh_consensus_apply(params, corr, symmetric=True, symmetric_batch=True,
                          conv=conv4d):
    """Filter ``corr [b, iA, jA, iB, jB]``; returns the same shape.

    ``params``: ``[{'kernel', 'bias'}, ...]`` tensors, cast to the activation
    dtype (the reference casts NC weights with the activations). ReLU
    follows every layer. The symmetric pass runs as ONE net application on
    ``cat([x, T(x)])`` when the A and B grids have the same shape and
    ``symmetric_batch`` is set; otherwise the net runs twice. ``conv`` is
    the 4D convolution (the dispatching `conv4d` by default).
    """
    dtype = corr.dtype

    def net(x):
        for p in params:
            kernel = p["kernel"].to(dtype).contiguous()
            x = torch.relu(conv(x, kernel, p["bias"].to(dtype)))
        return x

    x = corr.unsqueeze(-1).contiguous()
    if symmetric:
        xt = _swap_ab(x)
        if x.shape == xt.shape and symmetric_batch:
            b = x.shape[0]
            y = net(torch.cat([x, xt], dim=0))
            out = y[:b] + _swap_ab(y[b:])
        else:
            out = net(x) + _swap_ab(net(xt))
    else:
        out = net(x)
    if out.shape[-1] != 1:
        raise ValueError("last NeighConsensus layer must have 1 output channel")
    return out[..., 0]


class NeighConsensus(nn.Module):
    """The NC stack as a module; parameters keep the JAX layout
    ``kernel [k,k,k,k,cin,cout]`` / ``bias [cout]``.

    ``conv`` is the 4D convolution the stack calls and ``band_layer`` the
    band NC layer the sparse path calls (`ncnet_tpu_torch.sparse`); they
    default to the dispatching `conv4d` and `band_layer`, and a
    check may set the plain versions to hold the kernel paths against them.

    The parameters are created frozen (serving builds no autograd graph);
    `trainable` makes them trainable on request.
    """

    def __init__(self, kernel_sizes=(3, 3, 3), channels=(10, 10, 1),
                 symmetric=True, symmetric_batch=True, scheme="reference",
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.symmetric = symmetric
        self.symmetric_batch = symmetric_batch
        self.conv = conv4d
        self.band_layer = band_layer
        self.layers = nn.ModuleList()
        for p in init_neigh_consensus(kernel_sizes, channels, scheme,
                                      generator=generator):
            layer = nn.Module()
            layer.kernel = nn.Parameter(p["kernel"].to(device), requires_grad=False)
            layer.bias = nn.Parameter(p["bias"].to(device), requires_grad=False)
            self.layers.append(layer)

    def trainable(self):
        """Mark the NC parameters trainable and return them in layer order,
        ``[kernel_0, bias_0, kernel_1, bias_1, ...]``: the list the
        optimizer takes."""
        leaves = [t for layer in self.layers for t in (layer.kernel, layer.bias)]
        for t in leaves:
            t.requires_grad_(True)
        return leaves

    def params(self):
        """The layers as ``[{'kernel', 'bias'}, ...]`` (the JAX layout)."""
        return [{"kernel": layer.kernel, "bias": layer.bias}
                for layer in self.layers]

    def forward(self, corr):
        return neigh_consensus_apply(
            self.params(),
            corr,
            symmetric=self.symmetric, symmetric_batch=self.symmetric_batch,
            conv=self.conv,
        )
