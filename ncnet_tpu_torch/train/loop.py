"""Epoch-based training loop (``ncnet_tpu/train/loop.py``, single
process).

Reference behaviour kept (train.py:158-205): per-epoch train and
validation passes, a checkpoint each epoch with a ``best_`` copy on an
improved validation loss, loss histories in the checkpoint. Kept from the
JAX loop: exact resume (Adam state, step, a mid-epoch loader cursor with
the epoch's losses so far), ``save_every_steps`` cursor snapshots, the
loader driven by absolute epoch, and ``metrics.jsonl`` beside the
checkpoint. ``max_steps`` stops a run after that many optimizer steps
with a cursor snapshot it can resume from. Not ported yet: preemption
signals, async and sharded checkpoints, the device mesh, the feature
cache and the profiler window (ROADMAP A11, A13, A14, A16).
"""

import json
import math
import os
import time

import numpy as np
import torch

from ncnet_tpu_torch.train.checkpoint import restore, save_checkpoint
from ncnet_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)


def _epoch_iter(loader, epoch, skip=0):
    """Drive a loader by absolute epoch where it has `iter_epoch`; plain
    iterables (lists of batches) keep their own order."""
    if hasattr(loader, "iter_epoch"):
        return loader.iter_epoch(epoch, skip_batches=skip)
    it = iter(loader)
    for _ in range(skip):
        next(it, None)
    return it


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(config, model, train_loader, val_loader=None, num_epochs=5,
          learning_rate=5e-4, checkpoint_dir="trained_models",
          checkpoint_name="ncnet_tpu_torch.npz", log_every=10,
          save_every_steps=0, max_steps=0, resume=None, log=print):
    """Run the training loop; returns ``(state, history)``.

    ``model``: an `ImMatchNet` on its device (its NC head is made
    trainable here). ``resume``: a `CheckpointData` to continue from (its
    parameters, Adam state, step, histories and cursor). ``history`` has
    the per-epoch ``train_loss`` / ``val_loss``, every step's loss
    (``step_losses``, this call's steps), the per-step wall ms
    (``step_ms``, host clock to a device sync) and ``stopped_at_max_steps``.
    """
    device = model.device
    state = create_train_state(model, learning_rate)
    start_epoch, start_batch, epoch_losses0 = 0, 0, None
    best_val = float("inf")
    train_hist, val_hist = [], []
    if resume is not None:
        restore(state, resume)
        best_val = resume.best_val_loss
        train_hist, val_hist = list(resume.train_loss), list(resume.val_loss)
        start_epoch = resume.epoch
        if resume.cursor:
            start_epoch = int(resume.cursor["epoch"])
            start_batch = int(resume.cursor["batch_index"])
            epoch_losses0 = list(resume.cursor["epoch_losses"])
    train_step = make_train_step(config)
    eval_step = make_eval_step(config)
    path = os.path.join(checkpoint_dir, checkpoint_name)
    metrics_path = os.path.join(checkpoint_dir, "metrics.jsonl")
    os.makedirs(checkpoint_dir, exist_ok=True)
    if resume is None:
        open(metrics_path, "w").close()  # a fresh run starts a fresh log

    def snapshot(epoch, losses=None, cursor_batch=None, is_best=False):
        cursor = None
        if cursor_batch is not None:
            cursor = {"epoch": epoch, "batch_index": cursor_batch,
                      "shuffle_seed": int(getattr(train_loader, "seed", 0)),
                      "epoch_losses": list(losses)}
        save_checkpoint(
            path, state, config,
            epoch=epoch if cursor_batch is not None else epoch + 1,
            train_loss=train_hist, val_loss=val_hist, best_val_loss=best_val,
            cursor=cursor, is_best=is_best,
        )

    step_losses, step_ms = [], []
    stopped = False
    for epoch in range(start_epoch, num_epochs):
        t0 = time.perf_counter()
        skip = start_batch if epoch == start_epoch else 0
        # float() of a float32 loss is exact, so a resumed epoch's mean is
        # the uninterrupted run's
        losses = list(epoch_losses0) if skip and epoch_losses0 else []
        i = skip - 1
        for batch in _epoch_iter(train_loader, epoch, skip=skip):
            i += 1
            t_step = time.perf_counter()
            state, loss = train_step(state, batch)
            losses.append(float(loss))  # syncs on the step
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            step_losses.append(losses[-1])
            if (i + 1) % log_every == 0:
                log(f"epoch {epoch + 1} [{i + 1}/{len(train_loader)}] "
                    f"loss {losses[-1]:.6f} ({step_ms[-1]:.0f} ms/step)")
            stop = bool(max_steps) and state.step >= max_steps
            if (save_every_steps and (i + 1) % save_every_steps == 0) or stop:
                snapshot(epoch, losses, cursor_batch=i + 1)
            if stop:
                log(f"stopped at step {state.step} (max_steps): checkpoint "
                    f"{path} written")
                stopped = True
                break
        if stopped:
            break
        train_loss = float(np.mean(losses)) if losses else 0.0
        train_hist.append(train_loss)
        val_loss = float("nan")
        if val_loader is not None:
            vl = [float(eval_step(model, b))
                  for b in _epoch_iter(val_loader, epoch)]
            val_loss = float(np.mean(vl)) if vl else float("nan")
        val_hist.append(val_loss)
        is_best = val_loss < best_val
        if not math.isnan(val_loss):
            best_val = min(best_val, val_loss)
        _sync(device)
        epoch_s = time.perf_counter() - t0
        log(f"epoch {epoch + 1}/{num_epochs}: train {train_loss:.6f} "
            f"val {val_loss:.6f} ({epoch_s:.1f}s)" + (" [best]" if is_best else ""))
        with open(metrics_path, "a") as f:
            f.write(json.dumps({
                "epoch": epoch + 1,
                "train_loss": train_loss,
                "val_loss": None if math.isnan(val_loss) else val_loss,
                "epoch_seconds": round(epoch_s, 2),
                "steps": int(state.step),
                "best": bool(is_best),
            }) + "\n")
        snapshot(epoch, is_best=is_best)
    return state, {
        "train_loss": train_hist,
        "val_loss": val_hist,
        "step_losses": step_losses,
        "step_ms": step_ms,
        "stopped_at_max_steps": stopped,
    }
