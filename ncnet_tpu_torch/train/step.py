"""Training and eval steps: the NC head, and optionally the trunk's tail or
the whole trunk (``ncnet_tpu/train/step.py``).

The reference trains only the NeighConsensus head by default (trunk
frozen, train.py:60-71, Adam lr 5e-4); ``fe_finetune_params`` also trains
the last N units of the trunk's tail (train.py:60-63) and ``train_fe``
the whole trunk. The trainable set is the NC head's parameter list, then
the trunk tensors that train; the optimizer keeps state for nothing else.
The unit rules are the JAX package's (`tail_units`): ResNet-101 counts
layer3's bottlenecks, VGG-16 its flat conv list, DenseNet-201 denseblock2's
layers and then transition2 as the last unit. A unit trains whole: its
conv weights (and VGG's biases) and its BatchNorm ``scale``, ``offset``,
``mean`` and ``var``, as the JAX package's Adam updates the unit's param
dict.

Mixed precision (``config.half_precision``, the CLI's default): features,
correlation and the NC stack compute in bfloat16 while the master
parameters, the loss reduction, the gradients as applied and the Adam
state stay float32. The NC weights and the trunk's tensors are cast to
bfloat16 where they are used; autograd carries their bfloat16 gradients
back through that cast to the float32 masters, where Adam accumulates and
applies them in float32, so repeated small updates are not swallowed by
bfloat16's 8-bit mantissa. Checkpoints therefore always hold float32
weights.
"""

import numpy as np
import torch

from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import check_sparse_config
from ncnet_tpu_torch.train.loss import weak_loss, weak_loss_from_features

__all__ = [
    "TrainState",
    "check_from_features_frozen",
    "check_sparse_config",
    "create_train_state",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "merge_trainable",
    "tail_units",
    "trainable_subset",
    "trainable_tensors",
]


class TrainState:
    """The model (trunk + NC head, parameters updated in place), its Adam
    optimizer over the trainable tensors, their paths in the JAX package's
    trainable tree (`trainable_tensors`, the optimizer's order), the
    trunk-training mode and the number of steps taken."""

    def __init__(self, model, optimizer, step=0, paths=(), train_fe=False,
                 fe_finetune_blocks=0):
        self.model = model
        self.optimizer = optimizer
        self.step = int(step)
        self.paths = list(paths)
        self.train_fe = bool(train_fe)
        self.fe_finetune_blocks = int(fe_finetune_blocks)


def check_from_features_frozen(train_fe, fe_finetune_blocks):
    """Cached features are only correct for a fully frozen trunk: any trunk
    training makes them stale after one optimizer step."""
    if train_fe or fe_finetune_blocks > 0:
        raise ValueError(
            "from_features (the feature cache) requires a fully frozen "
            f"trunk, but train_fe={train_fe} and fe_finetune_blocks="
            f"{fe_finetune_blocks}: the trunk would train while the loss "
            "reads features extracted from its pre-training weights"
        )


def _finetune_tail_blocks(fe_params, cnn):
    """The JAX tree's tail units and their writer (the JAX package's rule,
    on the numpy tree): ``(blocks, write)``, ``write(fe, new_blocks)`` a new
    trunk tree with the unit list replaced."""
    if isinstance(fe_params, list):  # vgg: flat conv list
        return list(fe_params), lambda fe, new: list(new)
    if cnn == "resnet101":
        def write_resnet(fe, new):
            return dict(fe, layer3=list(new))

        return list(fe_params["layer3"]), write_resnet
    if cnn == "densenet201":
        def write_densenet(fe, new):
            return dict(fe, denseblock2=list(new[:-1]), transition2=new[-1])

        return (list(fe_params["denseblock2"]) + [fe_params["transition2"]],
                write_densenet)
    raise ValueError(f"no finetune tail defined for backbone {cnn!r}")


def _too_many(n, units, cnn):
    if n > len(units):
        # the reference would IndexError past model[-1]'s children; a
        # silent clamp would train a different set than asked
        raise ValueError(
            f"fe_finetune_blocks={n} exceeds the {len(units)} tail units of "
            f"the {cnn} trunk"
        )


def tail_units(model, fe_finetune_blocks):
    """The trunk modules of the last ``fe_finetune_blocks`` tail units,
    shallowest first; past the trunk's unit count raises `ValueError`."""
    trunk = model.feature_extraction
    units = trunk.tail_units()
    _too_many(fe_finetune_blocks, units, trunk.name)
    return units[-fe_finetune_blocks:]


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def trainable_subset(model, train_fe=False, fe_finetune_blocks=0):
    """The trainable tree in the JAX package's layout (float32 numpy on the
    host): ``{'neigh_consensus': [{'kernel', 'bias'}, ...]}``, plus
    ``'fe_tail'`` (the last ``fe_finetune_blocks`` unit trees), or with
    ``train_fe`` the whole param tree."""
    params = bridge.to_jax_params(model)
    if train_fe:
        return params
    sub = {"neigh_consensus": params["neigh_consensus"]}
    if fe_finetune_blocks > 0:
        cnn = model.config.feature_extraction_cnn
        blocks, _ = _finetune_tail_blocks(params["feature_extraction"], cnn)
        _too_many(fe_finetune_blocks, blocks, cnn)
        sub["fe_tail"] = blocks[-fe_finetune_blocks:]
    return sub


def merge_trainable(model, trainable):
    """Inverse of `trainable_subset`: copy a trainable tree's values (numpy
    arrays or tensors, the JAX layout) into ``model`` in place; returns the
    model."""
    t = _numpy_tree(trainable)
    params = bridge.to_jax_params(model)
    layers = t.get("neigh_consensus", params["neigh_consensus"])
    if len(layers) != len(params["neigh_consensus"]):
        raise ValueError(
            f"trainable tree has {len(layers)} NC layers, the model "
            f"{len(params['neigh_consensus'])}"
        )
    tail = t.pop("fe_tail", None)
    out = dict(params)
    out.update(t)
    if tail is not None:
        fe = params["feature_extraction"]
        blocks, write = _finetune_tail_blocks(fe, model.config.feature_extraction_cnn)
        blocks[-len(tail):] = tail
        out["feature_extraction"] = write(fe, blocks)
    return bridge.load_jax_params(model, out)


def trainable_tensors(model, train_fe=False, fe_finetune_blocks=0):
    """Mark the trainable tensors and return them with their paths in the
    JAX package's trainable tree, ``[(path, tensor), ...]``: the NC head
    (``('neigh_consensus', i, 'kernel' | 'bias')``, layer order), then the
    trunk's (``('fe_tail', j, ...)`` for the last ``fe_finetune_blocks``
    units, or ``('feature_extraction', ...)`` with ``train_fe``). Every
    other trunk tensor is marked frozen."""
    trunk = model.feature_extraction
    for p in trunk.parameters():
        p.requires_grad_(False)
    leaves = model.neigh_consensus.trainable()
    out = [(("neigh_consensus", i // 2, ("kernel", "bias")[i % 2]), t)
           for i, t in enumerate(leaves)]
    if train_fe:
        units = [(("feature_extraction",), trunk)]
    elif fe_finetune_blocks > 0:
        units = [(("fe_tail", j), u)
                 for j, u in enumerate(tail_units(model, fe_finetune_blocks))]
    else:
        units = []
    for prefix, unit in units:
        for name, p in unit.named_parameters():
            p.requires_grad_(True)
            out.append((prefix + bridge.jax_path(name), p))
    return out


def make_optimizer(params, learning_rate=5e-4):
    """``torch.optim.Adam(params, lr)``. Its defaults are ``optax.adam``'s:
    b1 0.9, b2 0.999, eps 1e-8 added outside the square root, bias
    correction on both moments."""
    return torch.optim.Adam(params, lr=learning_rate)


def create_train_state(model, learning_rate=5e-4, train_fe=False, step=0,
                       fe_finetune_blocks=0):
    """Mark the trainable tensors (`trainable_tensors`) and pair the model
    with an Adam optimizer over them."""
    named = trainable_tensors(model, train_fe, fe_finetune_blocks)
    return TrainState(model, make_optimizer([t for _, t in named], learning_rate),
                      step, [p for p, _ in named], train_fe, fe_finetune_blocks)


def device_batch(batch, device):
    """The image (or feature) tensors of ``batch`` on ``device``; other
    keys are dropped. float64 arrays (the host resize computes in float64)
    become float32, as ``jnp.asarray`` makes them in the JAX package."""
    keys = (("source_features", "target_features")
            if "source_features" in batch else ("source_image", "target_image"))
    out = {}
    for k in keys:
        t = torch.as_tensor(batch[k])
        dtype = torch.float32 if t.dtype == torch.float64 else t.dtype
        out[k] = t.to(device, dtype=dtype, non_blocking=True)
    return out


def make_train_step(config, train_fe=False, normalization="softmax",
                    fe_finetune_blocks=0, from_features=False):
    """Returns ``step(state, batch) -> (state, loss)``: the weak loss, its
    gradient over the trainable tensors, one Adam step; ``state`` (from
    `create_train_state` with the same ``train_fe`` and
    ``fe_finetune_blocks``) is updated in place and returned with ``step +
    1``, ``loss`` a detached float32 scalar on the model's device.
    ``batch`` holds ``source_image`` / ``target_image`` ``[b, h, w, 3]``
    (or, with ``from_features``, ``source_features`` /
    ``target_features``), numpy or tensors."""
    check_sparse_config(config)
    if from_features:
        check_from_features_frozen(train_fe, fe_finetune_blocks)
    loss_impl = weak_loss_from_features if from_features else weak_loss
    mode = (bool(train_fe), int(fe_finetune_blocks))

    def step(state, batch):
        if (state.train_fe, state.fe_finetune_blocks) != mode:
            raise ValueError(
                f"the state trains train_fe={state.train_fe}, "
                f"fe_finetune_blocks={state.fe_finetune_blocks}; the step was "
                f"made for train_fe={mode[0]}, fe_finetune_blocks={mode[1]}"
            )
        batch = device_batch(batch, state.model.device)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_impl(state.model, config, batch, normalization)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_eval_step(config, normalization="softmax", from_features=False):
    """Validation loss on a batch (reference ``process_epoch('test')``):
    ``eval_step(model, batch) -> loss``, no gradient."""
    check_sparse_config(config)
    loss_impl = weak_loss_from_features if from_features else weak_loss

    def eval_step(model, batch):
        with torch.no_grad():
            return loss_impl(model, config, device_batch(batch, model.device),
                             normalization)

    return eval_step
