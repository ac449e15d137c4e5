"""The port's training checkpoints: one ``.npz`` file.

Keys (`ncnet_tpu_torch.bridge.flatten`'s ``/`` scheme):

* ``params/...`` — every weight of the model as the JAX param tree
  (`bridge.to_jax_params`: float32, HWIO trunk kernels), so the JAX
  package can read a head trained here;
* ``opt/<i>/exp_avg``, ``opt/<i>/exp_avg_sq``, ``opt/<i>/step`` — the Adam
  state of the i-th trainable tensor (`TrainState.optimizer`'s order: the
  NC head, then the trunk tensors that train);
* ``meta`` — one JSON string: the format tag, the config dict, the step,
  the epoch, the train/val loss histories, the best validation loss, the
  optimizer's hyper-parameters, the trunk-training mode (``train_fe``,
  ``fe_finetune_blocks``; the trained tail's values are in ``params``),
  the trainable tensors' paths and the loader cursor of a mid-epoch save
  (``epoch``, ``batch_index``, ``shuffle_seed``, ``epoch_losses``).

A save writes a temporary file and renames it into place. Loading a save
and stepping on replays the uninterrupted run exactly (bitwise on the CPU):
parameters, moments and step counts are stored unrounded. The JAX
package's msgpack checkpoints are read by
`ncnet_tpu_torch.train.jax_checkpoint`, the reference's ``.pth.tar`` by
`ncnet_tpu_torch.convert`.
"""

import dataclasses
import json
import math
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.models.immatchnet import ImMatchNetConfig

FORMAT = "ncnet_tpu_torch.npz/1"


@dataclasses.dataclass
class CheckpointData:
    config: ImMatchNetConfig
    params: Any  # the JAX param tree (numpy)
    # per trainable tensor {'exp_avg', 'exp_avg_sq', 'step'}: a list in the
    # optimizer's order (.npz), or a dict by path (a JAX checkpoint)
    opt_state: Any
    step: int
    epoch: int
    train_loss: list
    val_loss: list
    best_val_loss: float
    optimizer: dict
    cursor: Optional[dict] = None
    train_fe: bool = False
    fe_finetune_blocks: int = 0


def _finite_or_none(v):
    return None if v is None or not math.isfinite(v) else float(v)


def save_checkpoint(path, state, config, epoch, train_loss=(), val_loss=(),
                    best_val_loss=float("inf"), cursor=None, is_best=False):
    """Write ``state`` (a `TrainState`) and the run's records to ``path``;
    with ``is_best`` also copy it to ``best_<name>`` beside it."""
    arrays = {f"params{bridge.SEP}{k}": v for k, v in
              bridge.flatten(bridge.to_jax_params(state.model)).items()}
    group = state.optimizer.param_groups[0]
    opt_sd = state.optimizer.state_dict()["state"]
    for i in range(len(group["params"])):
        st = opt_sd.get(i)
        if st is None:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            arrays[f"opt/{i}/{key}"] = st[key].detach().cpu().numpy()
        arrays[f"opt/{i}/step"] = np.asarray(float(st["step"]), np.float64)
    meta = {
        "format": FORMAT,
        "config": config.to_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "train_loss": [float(v) for v in train_loss],
        "val_loss": [_finite_or_none(v) for v in val_loss],
        "best_val_loss": _finite_or_none(best_val_loss),
        "optimizer": {"lr": group["lr"], "betas": list(group["betas"]),
                      "eps": group["eps"]},
        "cursor": cursor,
        "train_fe": bool(state.train_fe),
        "fe_finetune_blocks": int(state.fe_finetune_blocks),
        "trainable": [list(p) for p in state.paths],
    }
    arrays["meta"] = np.asarray(json.dumps(meta))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(d, "best_" + os.path.basename(path)))


def load_checkpoint(path):
    """Read a file written by `save_checkpoint`, a JAX package ``.msgpack``
    checkpoint (`ncnet_tpu_torch.train.jax_checkpoint`) or a reference
    ``.pth.tar`` / ``.pth`` training checkpoint (its NC head and trunk, no
    optimizer state: the reference's torch Adam is not carried over; a raw
    torchvision state dict raises `ValueError`) -> `CheckpointData`."""
    if path.endswith(".msgpack"):
        from ncnet_tpu_torch.train.jax_checkpoint import load_jax_checkpoint

        return load_jax_checkpoint(path)
    if path.endswith((".pth.tar", ".pth")):
        from ncnet_tpu_torch.convert import convert_checkpoint

        config, params = convert_checkpoint(path)
        return CheckpointData(config=config, params=params, opt_state=None,
                              step=0, epoch=0, train_loss=[], val_loss=[],
                              best_val_loss=float("inf"), optimizer={})
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(str(f["meta"]))
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{path} is not a {FORMAT} checkpoint (format "
                f"{meta.get('format')!r})"
            )
        prefix = f"params{bridge.SEP}"
        params = bridge.unflatten({k[len(prefix):]: f[k] for k in f.files
                                   if k.startswith(prefix)})
        opt = {}
        for k in f.files:
            if k.startswith("opt/"):
                _, i, key = k.split("/")
                opt.setdefault(int(i), {})[key] = f[k]
    opt_state = [opt[i] for i in sorted(opt)] if opt else None
    return CheckpointData(
        config=ImMatchNetConfig.from_dict(meta["config"]),
        params=params,
        opt_state=opt_state,
        step=meta["step"],
        epoch=meta["epoch"],
        train_loss=meta["train_loss"],
        val_loss=[float("nan") if v is None else v for v in meta["val_loss"]],
        best_val_loss=(float("inf") if meta["best_val_loss"] is None
                       else meta["best_val_loss"]),
        optimizer=meta["optimizer"],
        cursor=meta["cursor"],
        train_fe=bool(meta.get("train_fe", False)),
        fe_finetune_blocks=int(meta.get("fe_finetune_blocks", 0)),
    )


def restore(state, ck):
    """Load ``ck``'s parameters, Adam state and step into ``state`` (a
    `TrainState` built for the same config and trunk-training mode) in
    place; returns it. ``ck.opt_state`` None keeps the fresh optimizer."""
    bridge.load_jax_params(state.model, ck.params)
    sd = state.optimizer.state_dict()
    n = len(sd["param_groups"][0]["params"])
    if ck.opt_state is not None:
        opt = ck.opt_state
        if len(opt) != n:
            raise ValueError(
                f"checkpoint holds Adam state for {len(opt)} tensors, "
                f"the optimizer has {n}"
            )
        if isinstance(opt, dict):  # keyed by path (a JAX checkpoint)
            missing = [p for p in state.paths if tuple(p) not in opt]
            if missing:
                raise ValueError(
                    f"checkpoint holds no Adam state for {missing[:3]}: it "
                    "was trained with another trainable set"
                )
            opt = [opt[tuple(p)] for p in state.paths]
        sd["state"] = {
            i: {"step": torch.tensor(float(st["step"]), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(st["exp_avg"])),
                "exp_avg_sq": torch.from_numpy(np.array(st["exp_avg_sq"]))}
            for i, st in enumerate(opt)
        }
        state.optimizer.load_state_dict(sd)
    state.step = int(ck.step)
    return state
