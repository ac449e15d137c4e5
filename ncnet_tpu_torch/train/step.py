"""Training and eval steps with a frozen trunk and a trainable NC head
(``ncnet_tpu/train/step.py``).

The reference trains only the NeighConsensus head by default (trunk
frozen, train.py:60-71, Adam lr 5e-4). The trainable subset is the NC
head's parameter list; the optimizer keeps state for nothing else.

Mixed precision (``config.half_precision``, the CLI's default): features,
correlation and the NC stack compute in bfloat16 while the master
parameters, the loss reduction, the gradients as applied and the Adam
state stay float32. The NC weights are cast to bfloat16 inside the stack
(`ncnet_tpu_torch.models.neigh_consensus`); autograd carries their
bfloat16 gradients back through that cast to the float32 masters, where
Adam accumulates and applies them in float32, so repeated small updates
are not swallowed by bfloat16's 8-bit mantissa. Checkpoints therefore
always hold float32 weights.
"""

import numpy as np
import torch

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
    "trainable_subset",
]


class TrainState:
    """The model (trunk + NC head, parameters updated in place), its Adam
    optimizer over the NC head, and the number of steps taken."""

    def __init__(self, model, optimizer, step=0):
        self.model = model
        self.optimizer = optimizer
        self.step = int(step)


def check_trainable(train_fe=False, fe_finetune_blocks=0):
    """Trunk training is not ported: it needs the first NC layer's input
    gradient and a trunk backward."""
    if train_fe or fe_finetune_blocks > 0:
        raise NotImplementedError(
            f"train_fe={train_fe}, fe_finetune_blocks={fe_finetune_blocks}: "
            "training the trunk is not ported yet (ROADMAP A6: it needs the "
            "first NC layer's dx and a trunk backward); the port trains the "
            "NC head over a frozen trunk"
        )


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


def trainable_subset(model, train_fe=False, fe_finetune_blocks=0):
    """The trainable parameters as a tree, ``{'neigh_consensus':
    [{'kernel', 'bias'}, ...]}`` of the model's live tensors."""
    check_trainable(train_fe, fe_finetune_blocks)
    return {"neigh_consensus": model.neigh_consensus.params()}


def merge_trainable(model, trainable):
    """Inverse of `trainable_subset`: copy a trainable tree's values (numpy
    arrays or tensors) into ``model`` in place; returns the model."""
    layers = trainable["neigh_consensus"]
    own = model.neigh_consensus.params()
    if len(layers) != len(own):
        raise ValueError(
            f"trainable tree has {len(layers)} NC layers, the model {len(own)}"
        )
    with torch.no_grad():
        for src, dst in zip(layers, own):
            for name in ("kernel", "bias"):
                value = src[name]
                if not isinstance(value, torch.Tensor):
                    value = torch.from_numpy(np.array(value))
                if tuple(value.shape) != tuple(dst[name].shape):
                    raise ValueError(
                        f"NC {name}: shape {tuple(value.shape)} does not fit "
                        f"{tuple(dst[name].shape)}"
                    )
                dst[name].copy_(value)
    return model


def make_optimizer(params, learning_rate=5e-4):
    """``torch.optim.Adam(params, lr)``. Its defaults are ``optax.adam``'s:
    b1 0.9, b2 0.999, eps 1e-8 added outside the square root, bias
    correction on both moments."""
    return torch.optim.Adam(params, lr=learning_rate)


def create_train_state(model, learning_rate=5e-4, train_fe=False, step=0,
                       fe_finetune_blocks=0):
    """Make the NC head trainable and pair the model with its optimizer."""
    check_trainable(train_fe, fe_finetune_blocks)
    params = model.neigh_consensus.trainable()
    return TrainState(model, make_optimizer(params, learning_rate), step)


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
    gradient over the NC head, one Adam step; ``state`` is updated in
    place and returned with ``step + 1``, ``loss`` a detached float32
    scalar on the model's device. ``batch`` holds ``source_image`` /
    ``target_image`` ``[b, h, w, 3]`` (or, with ``from_features``,
    ``source_features`` / ``target_features``), numpy or tensors."""
    check_sparse_config(config)
    if from_features:
        check_from_features_frozen(train_fe, fe_finetune_blocks)
    check_trainable(train_fe, fe_finetune_blocks)
    loss_impl = weak_loss_from_features if from_features else weak_loss

    def step(state, batch):
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
