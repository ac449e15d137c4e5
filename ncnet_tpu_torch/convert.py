"""Load the reference's PyTorch checkpoints (``.pth.tar``) into the port
(counterpart of ``ncnet_tpu/utils/convert_torch.py``).

The reference schema (train.py:197-205) is ``{epoch, args, state_dict,
best_test_loss, optimizer, train_loss, test_loss}``; the state dict holds
``FeatureExtraction.model.<idx>...`` (torchvision Sequential indices of
the truncated ResNet-101: 0 = conv1, 1 = bn1, 4/5/6 = layer1/2/3) and
``NeighConsensus.conv.<2*i>.{weight,bias}``, whose Conv4d weights are
stored pre-permuted by the reference constructor (lib/conv4d.py:72-77):
``[k1, c_out, c_in, k2, k3, k4]``.

The mapping goes to the JAX package's param tree (numpy; HWIO trunk
kernels, NC ``[k1,k2,k3,k4,cin,cout]``), which `bridge.from_jax_params`
loads into an `ImMatchNet`; ``args`` gives the architecture.
"""

import numpy as np
import torch

from ncnet_tpu_torch.bridge import from_jax_params
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.models.resnet import RESNET101_STAGES

RESNET_SEQUENTIAL = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                     "6": "layer3"}


def _np(t):
    return np.asarray(t.detach().cpu().numpy(), dtype=np.float32)


def _conv2d_kernel(t):
    return _np(t).transpose(2, 3, 1, 0)  # [cout, cin, kh, kw] -> HWIO


def _bn(sd, prefix):
    return {
        "scale": _np(sd[prefix + ".weight"]),
        "offset": _np(sd[prefix + ".bias"]),
        "mean": _np(sd[prefix + ".running_mean"]),
        "var": _np(sd[prefix + ".running_var"]),
    }


def _strip_prefix(state_dict, prefix, seq_map):
    """Keys under ``prefix`` with it stripped and leading Sequential
    indices renamed by ``seq_map`` (raw torchvision state dicts use the
    attribute names already)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not sd:
        raise ValueError(f"no keys under prefix {prefix!r}")
    out = {}
    for k, v in sd.items():
        head, _, rest = k.partition(".")
        if head in seq_map:
            k = seq_map[head] + ("." + rest if rest else "")
        out[k] = v
    return out


def convert_resnet101_trunk(state_dict, prefix="FeatureExtraction.model."):
    """A torchvision-style ResNet-101 state dict (Sequential-index or
    attribute keys) -> the trunk's param tree, ``conv1``, ``bn1`` and
    ``layer1..3`` lists of bottleneck blocks."""
    sd = _strip_prefix(state_dict, prefix, RESNET_SEQUENTIAL)
    params = {
        "conv1": {"kernel": _conv2d_kernel(sd["conv1.weight"])},
        "bn1": _bn(sd, "bn1"),
    }
    for si, (n_blocks, _, _) in enumerate(RESNET101_STAGES):
        layer = f"layer{si + 1}"
        blocks = []
        for bi in range(n_blocks):
            p = f"{layer}.{bi}."
            block = {}
            for ci in (1, 2, 3):
                block[f"conv{ci}"] = {
                    "kernel": _conv2d_kernel(sd[p + f"conv{ci}.weight"])
                }
                block[f"bn{ci}"] = _bn(sd, p + f"bn{ci}")
            if p + "downsample.0.weight" in sd:
                block["downsample_conv"] = {
                    "kernel": _conv2d_kernel(sd[p + "downsample.0.weight"])
                }
                block["downsample_bn"] = _bn(sd, p + "downsample.1")
            blocks.append(block)
        params[layer] = blocks
    return params


def convert_neigh_consensus(state_dict, prefix="NeighConsensus.conv.",
                            pre_permuted=True):
    """The Conv4d stack -> ``[{'kernel': [k,k,k,k,cin,cout], 'bias':
    [cout]}, ...]`` in layer order. ``pre_permuted``: the weights are in
    the reference constructor's ``[k1, cout, cin, k2, k3, k4]``, else
    torch's ``[cout, cin, k1, k2, k3, k4]``."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    params = []
    for idx in sorted({int(k.split(".")[0]) for k in sd}):
        w = _np(sd[f"{idx}.weight"])
        if pre_permuted:
            w = w.transpose(1, 2, 0, 3, 4, 5)
        params.append({"kernel": w.transpose(2, 3, 4, 5, 1, 0),
                       "bias": _np(sd[f"{idx}.bias"])})
    return params


def convert_checkpoint(path):
    """A reference ``.pth.tar`` -> ``(config, params)``: the config from
    the checkpoint's ``args`` (the reference's own record of its
    architecture), the params as the JAX param tree. The legacy key
    rename ``'vgg' -> 'model'`` (lib/model.py:214) is applied."""
    # the checkpoint pickles an argparse Namespace: not a weights-only file
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k.replace("vgg", "model"): v for k, v in ckpt["state_dict"].items()}
    args = ckpt.get("args")
    cnn = getattr(args, "fe_arch", None) or getattr(
        args, "feature_extraction_cnn", "resnet101"
    )
    if cnn in ("vgg", "densenet201"):
        raise NotImplementedError(
            f"checkpoint trunk {cnn!r} is not ported yet (ROADMAP A4); the "
            "port loads ResNet-101 checkpoints"
        )
    if cnn != "resnet101":
        raise ValueError(f"unsupported backbone in checkpoint: {cnn!r}")
    config = ImMatchNetConfig(
        feature_extraction_cnn=cnn,
        ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
        ncons_channels=tuple(args.ncons_channels),
    )
    params = {
        "feature_extraction": convert_resnet101_trunk(sd),
        "neigh_consensus": convert_neigh_consensus(sd),
    }
    return config, params


def load_reference_checkpoint(path, device=None):
    """A reference ``.pth.tar`` -> ``(config, ImMatchNet)`` on ``device``
    (None: the card)."""
    config, params = convert_checkpoint(path)
    return config, from_jax_params(params, config, device=device)


def load_model(path, device=None):
    """``(config, ImMatchNet)`` from a checkpoint an eval CLI is given: a
    reference ``.pth.tar`` / ``.pth``, or the port's training ``.npz``.
    The JAX package's msgpack checkpoints raise: their reader is not
    ported (ROADMAP A6)."""
    if path.endswith((".pth.tar", ".pth")):
        return load_reference_checkpoint(path, device=device)
    if path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: the JAX package's msgpack checkpoints cannot be read by "
            "the port yet (ROADMAP A6: a reader of their bytes, or a "
            "converter to the port's .npz)"
        )
    if path.endswith(".npz"):
        from ncnet_tpu_torch.train.checkpoint import load_checkpoint

        ck = load_checkpoint(path)
        return ck.config, from_jax_params(ck.params, ck.config, device=device)
    raise ValueError(f"{path}: expected a .pth.tar, .pth or .npz checkpoint")
