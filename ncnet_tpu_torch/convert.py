"""Load the reference's PyTorch checkpoints (``.pth.tar``) into the port
(counterpart of ``ncnet_tpu/utils/convert_torch.py``).

The reference schema (train.py:197-205) is ``{epoch, args, state_dict,
best_test_loss, optimizer, train_loss, test_loss}``; the state dict holds
``FeatureExtraction.model.<idx>...`` (torchvision Sequential indices of
the truncated trunk: ResNet-101's 0 = conv1, 1 = bn1, 4/5/6 =
layer1/2/3; VGG-16's conv indices of ``features``; DenseNet-201's 0 =
conv0, 1 = norm0, 4..7 = denseblock1, transition1, denseblock2,
transition2) and
``NeighConsensus.conv.<2*i>.{weight,bias}``, whose Conv4d weights are
stored pre-permuted by the reference constructor (lib/conv4d.py:72-77):
``[k1, c_out, c_in, k2, k3, k4]``.

The mapping goes to the JAX package's param tree (numpy; HWIO trunk
kernels, NC ``[k1,k2,k3,k4,cin,cout]``), which `bridge.from_jax_params`
loads into an `ImMatchNet`; ``args`` gives the architecture.
"""

import re

import numpy as np
import torch

from ncnet_tpu_torch.bridge import from_jax_params
from ncnet_tpu_torch.models.densenet import TRUNK_BLOCKS
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig
from ncnet_tpu_torch.models.resnet import RESNET101_STAGES
from ncnet_tpu_torch.models.vgg import VGG16_TO_POOL4

RESNET_SEQUENTIAL = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                     "6": "layer3"}
DENSENET_SEQUENTIAL = {"0": "conv0", "1": "norm0", "4": "denseblock1",
                       "5": "transition1", "6": "denseblock2",
                       "7": "transition2"}


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


def convert_vgg16_trunk(state_dict, prefix="FeatureExtraction.model."):
    """A torchvision ``vgg16.features`` state dict (its conv layers, in
    Sequential index order) -> the trunk's flat conv list of ``{'kernel',
    'bias'}``."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    weights = sorted((int(k.split(".")[0]), k) for k in sd if k.endswith(".weight"))
    return [{"kernel": _conv2d_kernel(sd[k]), "bias": _np(sd[f"{idx}.bias"])}
            for idx, k in weights]


def convert_densenet201_trunk(state_dict, prefix="FeatureExtraction.model."):
    """A torchvision-style DenseNet-201 state dict -> the trunk's param
    tree (``conv0``, ``norm0``, ``denseblock1..2`` lists of layers,
    ``transition1..2``). Takes the reference's Sequential-index keys (``0``
    = conv0 .. ``7`` = transition2, lib/model.py:74) or torchvision's
    attribute keys, including the legacy zoo names
    ``denselayer<i>.norm.1`` / ``conv.2`` that torchvision remaps."""
    sd = _strip_prefix(state_dict, prefix, DENSENET_SEQUENTIAL)
    sd = {re.sub(r"(denselayer\d+\.(?:norm|conv))\.(\d)\.", r"\1\2.", k): v
          for k, v in sd.items()}
    params = {"conv0": {"kernel": _conv2d_kernel(sd["conv0.weight"])},
              "norm0": _bn(sd, "norm0")}
    for bi, n_layers in enumerate(TRUNK_BLOCKS):
        block = []
        for li in range(n_layers):
            p = f"denseblock{bi + 1}.denselayer{li + 1}."
            block.append({
                "norm1": _bn(sd, p + "norm1"),
                "conv1": {"kernel": _conv2d_kernel(sd[p + "conv1.weight"])},
                "norm2": _bn(sd, p + "norm2"),
                "conv2": {"kernel": _conv2d_kernel(sd[p + "conv2.weight"])},
            })
        params[f"denseblock{bi + 1}"] = block
        t = f"transition{bi + 1}."
        params[f"transition{bi + 1}"] = {
            "norm": _bn(sd, t + "norm"),
            "conv": {"kernel": _conv2d_kernel(sd[t + "conv.weight"])},
        }
    return params


TRUNK_CONVERTERS = {"resnet101": convert_resnet101_trunk,
                    "vgg": convert_vgg16_trunk,
                    "densenet201": convert_densenet201_trunk}


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
    rename ``'vgg' -> 'model'`` (lib/model.py:214) is applied to every
    key first: an old checkpoint's ``FeatureExtraction.vgg.<i>`` becomes
    ``FeatureExtraction.model.<i>``, and a VGG trunk's own keys (``<i>.
    weight`` / ``<i>.bias``) hold no ``vgg`` to rename."""
    # the checkpoint pickles an argparse Namespace: not a weights-only file
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(ckpt, dict) and "state_dict" in ckpt):
        # a raw torchvision state dict has no 'state_dict' / 'args' envelope
        raise ValueError(
            f"{path} is not a full reference training checkpoint (no "
            "'state_dict' key); for trunk-only weights (e.g. a raw "
            "torchvision .pth) use --fe_weights")
    sd = {k.replace("vgg", "model"): v for k, v in ckpt["state_dict"].items()}
    args = ckpt.get("args")
    cnn = getattr(args, "fe_arch", None) or getattr(
        args, "feature_extraction_cnn", "resnet101"
    )
    if cnn not in TRUNK_CONVERTERS:
        raise ValueError(f"unsupported backbone in checkpoint: {cnn!r}")
    config = ImMatchNetConfig(
        feature_extraction_cnn=cnn,
        ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
        ncons_channels=tuple(args.ncons_channels),
    )
    params = {
        "feature_extraction": TRUNK_CONVERTERS[cnn](sd),
        "neigh_consensus": convert_neigh_consensus(sd),
    }
    return config, params


def load_trunk_weights(path, cnn="resnet101"):
    """Trunk weights from a file -> the trunk's param tree for ``cnn`` (the
    JAX layout, the ``feature_extraction`` entry of the param tree; load it
    through `ncnet_tpu_torch.bridge`). The counterpart of
    ``ncnet_tpu/utils/convert_torch.py::load_trunk_weights``. Takes:

    * a reference ``.pth.tar`` training checkpoint (keys under
      ``FeatureExtraction.model.``, a legacy ``vgg`` renamed ``model``);
    * a raw torchvision state dict (``.pth``: ``conv1.weight``,
      ``layer1.0.conv1.weight``, ``features.N.weight``), ResNet-101, VGG-16
      or DenseNet-201; keys past the trunk are ignored (``layer4.*``,
      ``fc.*``, ``classifier.*``, ``num_batches_tracked``, VGG-16's convs
      past pool4);
    * the JAX package's ``.msgpack`` or the port's ``.npz`` checkpoint
      (their ``params['feature_extraction']``).
    """
    if path.endswith((".msgpack", ".npz")):
        from ncnet_tpu_torch.train.checkpoint import load_checkpoint

        tree = load_checkpoint(path).params["feature_extraction"]
    else:
        if cnn not in TRUNK_CONVERTERS:
            raise ValueError(f"unsupported backbone for trunk conversion: {cnn!r}")
        # a reference checkpoint pickles an argparse Namespace beside the dict
        blob = torch.load(path, map_location="cpu", weights_only=False)
        sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
        sd = {k.replace("vgg", "model"): v for k, v in sd.items()}
        prefix = ("FeatureExtraction.model."
                  if any(k.startswith("FeatureExtraction.model.") for k in sd)
                  else "")
        if cnn != "resnet101" and not prefix and any(
                k.startswith("features.") for k in sd):
            prefix = "features."
        tree = TRUNK_CONVERTERS[cnn](sd, prefix=prefix)
    if cnn == "vgg":  # torchvision's features go on past pool4
        tree = tree[:sum(c != "M" for c in VGG16_TO_POOL4)]
    return tree


def load_reference_checkpoint(path, device=None):
    """A reference ``.pth.tar`` -> ``(config, ImMatchNet)`` on ``device``
    (None: the card)."""
    config, params = convert_checkpoint(path)
    return config, from_jax_params(params, config, device=device)


def load_model(path, device=None):
    """``(config, ImMatchNet)`` from a checkpoint an eval CLI is given: a
    reference ``.pth.tar`` / ``.pth``, the port's training ``.npz``, or
    the JAX package's ``.msgpack`` (`ncnet_tpu_torch.train.jax_checkpoint`,
    its sidecar digest checked where there is one)."""
    if path.endswith((".pth.tar", ".pth")):
        return load_reference_checkpoint(path, device=device)
    if path.endswith((".npz", ".msgpack")):
        from ncnet_tpu_torch.train.checkpoint import load_checkpoint

        ck = load_checkpoint(path)
        return ck.config, from_jax_params(ck.params, ck.config, device=device)
    raise ValueError(
        f"{path}: expected a .pth.tar, .pth, .npz or .msgpack checkpoint")
