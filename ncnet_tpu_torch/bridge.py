"""Carry weights from the JAX package's param tree into the port.

The JAX tree (numpy arrays; ``init_immatchnet`` or a converted checkpoint)
is ``{'feature_extraction': trunk, 'neigh_consensus': [{'kernel',
'bias'}, ...]}``. This module maps it onto `ImMatchNet`'s state dict:

* trunk conv kernels HWIO -> OIHW (``conv1``, ``layer<s>.<b>.conv<n>``,
  ``downsample_conv``; the patch16 kernel ``[16,16,3,256]``);
* BN ``{scale, offset, mean, var}`` -> buffers of the same names;
* NC ``kernel [ki,kj,kk,kl,cin,cout]`` / ``bias`` unchanged (the layout
  the hand kernel takes).

It is the inverse direction of ``ncnet_tpu/utils/convert_torch.py``;
`to_jax_params` maps a port model back to the JAX tree, so a head trained
in the port can be evaluated by the JAX package.
`flatten` / `unflatten` give the ``.npz`` key scheme: tree paths joined by
``/`` with list positions as integers, e.g.
``feature_extraction/layer1/0/conv2/kernel``.
"""

import numpy as np
import torch

from ncnet_tpu_torch.models.immatchnet import ImMatchNet

SEP = "/"


def flatten(tree, prefix=""):
    """Nested dicts/lists of arrays -> ``{path: np.ndarray}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}{SEP}{key}" if prefix else str(key)))
    return out


def unflatten(flat):
    """Inverse of `flatten`: a level whose keys are all integers becomes a
    list."""
    root = {}
    for path, value in flat.items():
        node = root
        parts = path.split(SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value)

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def _trunk_state(tree):
    """JAX trunk tree -> ``{state-dict name: array}`` (module-relative)."""
    state = {}
    for path, arr in flatten(tree).items():
        name = path.replace(SEP, ".")
        if name == "kernel":  # patch16: [16, 16, 3, 256] HWIO
            state["weight"] = arr.transpose(3, 2, 0, 1)
        elif name.endswith(".kernel"):  # resnet conv HWIO
            state[name[: -len(".kernel")] + ".weight"] = arr.transpose(3, 2, 0, 1)
        else:  # BN scale / offset / mean / var
            state[name] = arr
    return state


def state_dict_from_jax(tree):
    """The JAX param tree -> a state dict for `ImMatchNet` (numpy values)."""
    state = {
        f"feature_extraction.{k}": v
        for k, v in _trunk_state(tree["feature_extraction"]).items()
    }
    for li, layer in enumerate(tree["neigh_consensus"]):
        state[f"neigh_consensus.layers.{li}.kernel"] = np.asarray(layer["kernel"])
        state[f"neigh_consensus.layers.{li}.bias"] = np.asarray(layer["bias"])
    return state


def load_jax_params(model, tree):
    """Copy the JAX param tree into ``model`` (an `ImMatchNet`) in place.
    Every entry of the model's state dict must be covered, with its
    shape."""
    state = state_dict_from_jax(tree)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(
            f"param tree does not match the model: missing {missing[:5]}, "
            f"unexpected {extra[:5]}"
        )
    with torch.no_grad():
        for name, value in state.items():
            target = own[name]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(
                    f"{name}: shape {tuple(value.shape)} does not fit "
                    f"{tuple(target.shape)}"
                )
            target.copy_(torch.tensor(np.asarray(value)))
    return model


def to_jax_params(model):
    """An `ImMatchNet`'s weights as the JAX param tree (float32 numpy on
    the host): the inverse of `load_jax_params`, OIHW -> HWIO."""
    flat = {}
    for name, value in model.state_dict().items():
        arr = value.detach().cpu().numpy()
        head, _, rel = name.partition(".")
        if head == "feature_extraction":
            if rel == "weight" or rel.endswith(".weight"):
                rel = rel[: -len("weight")] + "kernel"
                arr = arr.transpose(2, 3, 1, 0)
            flat[f"feature_extraction{SEP}{rel.replace('.', SEP)}"] = arr
        elif head == "neigh_consensus" and rel.startswith("layers."):
            li, leaf = rel[len("layers."):].split(".")
            flat[f"neigh_consensus{SEP}{li}{SEP}{leaf}"] = arr
        else:
            raise ValueError(f"state entry {name!r} has no place in the JAX tree")
    return unflatten({k: np.ascontiguousarray(v) for k, v in flat.items()})


def from_jax_params(tree, config, device=None):
    """Build an `ImMatchNet` for ``config`` on ``device`` (None: the card)
    carrying the JAX param tree's weights."""
    return load_jax_params(ImMatchNet(config, device=device), tree)


def load_npz(path):
    """A ``.npz`` written with `flatten`'s keys -> the JAX param tree."""
    with np.load(path) as f:
        return unflatten({k: f[k] for k in f.files})
