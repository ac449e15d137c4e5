"""The port's training checkpoints: one ``.npz`` file.

Keys (`ncnet_tpu_torch.bridge.flatten`'s ``/`` scheme):

* ``params/...`` — every weight of the model as the JAX param tree
  (`bridge.to_jax_params`: float32, HWIO trunk kernels), so the JAX
  package can read a head trained here;
* ``opt/<i>/exp_avg``, ``opt/<i>/exp_avg_sq``, ``opt/<i>/step`` — the Adam
  state of the i-th trainable tensor (`TrainState.optimizer`'s order);
* ``meta`` — one JSON string: the format tag, the config dict, the step,
  the epoch, the train/val loss histories, the best validation loss, the
  optimizer's hyper-parameters and the loader cursor of a mid-epoch save
  (``epoch``, ``batch_index``, ``shuffle_seed``, ``epoch_losses``).

A save writes a temporary file and renames it into place. Loading a save
and stepping on replays the uninterrupted run exactly (bitwise on the CPU):
parameters, moments and step counts are stored unrounded. Reading the JAX
package's msgpack checkpoints is not ported (ROADMAP A6).
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
    opt_state: Optional[list]  # per trainable tensor {'exp_avg', 'exp_avg_sq', 'step'}
    step: int
    epoch: int
    train_loss: list
    val_loss: list
    best_val_loss: float
    optimizer: dict
    cursor: Optional[dict] = None


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
    """Read a file written by `save_checkpoint` -> `CheckpointData`."""
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
    )


def restore(state, ck):
    """Load ``ck``'s parameters, Adam state and step into ``state`` (a
    `TrainState` built for the same config) in place; returns it."""
    bridge.load_jax_params(state.model, ck.params)
    sd = state.optimizer.state_dict()
    n = len(sd["param_groups"][0]["params"])
    if ck.opt_state is not None:
        if len(ck.opt_state) != n:
            raise ValueError(
                f"checkpoint holds Adam state for {len(ck.opt_state)} tensors, "
                f"the optimizer has {n}"
            )
        sd["state"] = {
            i: {"step": torch.tensor(float(st["step"]), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.asarray(st["exp_avg"])),
                "exp_avg_sq": torch.from_numpy(np.asarray(st["exp_avg_sq"]))}
            for i, st in enumerate(ck.opt_state)
        }
        state.optimizer.load_state_dict(sd)
    state.step = int(ck.step)
    return state
