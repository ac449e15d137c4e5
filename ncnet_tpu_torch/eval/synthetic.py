"""PCK-style keypoint transfer on `SyntheticPairDataset` pairs
(``ncnet_tpu/eval/synthetic.py``), and the synthetic convergence run, the
counterpart of ``scripts/synthetic_convergence.py``.

The synthetic target is the source cyclically rolled by a known per-pair
horizontal ``shift``: source pixel (x, y) appears at target (x + shift mod
W, y). Query points sit on a grid in the right half of the target; since
``shift < W/2`` their true source positions ``x - shift`` never wrap.

    python -m ncnet_tpu_torch.eval.synthetic [--image_size 128 --steps 400]

trains the NC head with the weak loss (frozen patch16 trunk, identity NC
init, centred features, NC 3-3 / 16-1, lr 5e-4) and prints, as JSON last,
the loss deciles, PCK@0.15 before and after, and the PCK of the
degenerate zero-shift (diagonal) predictor that a trained model must beat.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
from ncnet_tpu_torch.ops.coords import points_to_pixel_coords, points_to_unit_coords
from ncnet_tpu_torch.ops.matches import bilinear_point_transfer, corr_to_matches
from ncnet_tpu_torch.ops.metrics import pck


def _query_grid(h, w, n_side=4):
    """``[2, n_side^2]`` pixel points in the right half of an (h, w) image."""
    xs = np.linspace(w * 0.55, w * 0.95, n_side)
    ys = np.linspace(h * 0.1, h * 0.9, n_side)
    gx, gy = np.meshgrid(xs, ys)
    return np.stack([gx.ravel(), gy.ravel()]).astype(np.float32)


def make_synthetic_pck_step(config, alpha=0.1, n_side=4):
    """``step(model, batch) -> [b] per-pair PCK``; ``batch`` holds the
    images and the per-pair ``shift`` (pixels) as tensors."""

    def step(model, batch):
        src = batch["source_image"]
        b, h, w = src.shape[0], src.shape[1], src.shape[2]
        dev = src.device
        corr = immatchnet_apply(model, config, src, batch["target_image"])
        x_a, y_a, x_b, y_b, _ = corr_to_matches(corr, do_softmax=True)
        tgt_px = torch.from_numpy(_query_grid(h, w, n_side)).to(dev)
        tgt_px = tgt_px[None].repeat(b, 1, 1)
        im_size = torch.tensor([h, w, 3], dtype=torch.float32, device=dev)
        im_size = im_size[None].expand(b, 3)
        tgt_norm = points_to_unit_coords(tgt_px, im_size)
        warped_norm = bilinear_point_transfer((x_a, y_a, x_b, y_b), tgt_norm)
        warped_px = points_to_pixel_coords(warped_norm, im_size)
        # ground truth: x_src = x_tgt - shift (never wraps for these points)
        gt = tgt_px.clone()
        gt[:, 0, :] += -batch["shift"][:, None]
        l_pck = torch.full((b, 1), float(w), dtype=torch.float32, device=dev)
        return pck(gt, warped_px, l_pck, alpha=alpha)

    return step


def evaluate_synthetic(model, config, loader, alpha=0.1, n_side=4):
    """Mean synthetic-transfer PCK over a loader of shift-annotated batches."""
    step = make_synthetic_pck_step(config, alpha, n_side)
    scores = []
    for batch in loader:
        tensors = {k: torch.as_tensor(np.asarray(batch[k], np.float32)).to(model.device)
                   for k in ("source_image", "target_image", "shift")}
        with torch.inference_mode():
            scores.extend(step(model, tensors).cpu().numpy().tolist())
    arr = np.asarray(scores)
    valid = ~np.isnan(arr)
    return float(arr[valid].mean()) if valid.any() else float("nan")


def synthetic_pck_vs_topk(model, config, batches, ks, alpha=0.1, n_side=4):
    """``{k: mean PCK}`` of the same shift-annotated batches at every
    ``nc_topk`` in ``ks`` (0 = dense); at ``k >= hB*wB`` the band is
    complete and the entry equals the dense one."""
    cached = list(batches)
    return {
        int(k): evaluate_synthetic(
            model, config.replace(nc_topk=int(k)), cached, alpha, n_side
        )
        for k in ks
    }


def synthetic_pck_vs_refine(model, config, batches, factors, ks, radius=0,
                            alpha=0.1, n_side=4):
    """The refinement sweep of the JAX package: not ported."""
    raise NotImplementedError(
        "synthetic_pck_vs_refine needs coarse-to-fine refinement, which is "
        "not ported yet (ROADMAP A10)"
    )


def run(image_size=128, steps=400, batch=8, n_pairs=32, lr=5e-4, seed=0,
        ncons_kernel_sizes=(3, 3), ncons_channels=(16, 1), alpha=0.15,
        fe_arch="patch16", nc_init="identity", half_precision=False,
        device=None, log_every=20, verbose=True):
    """Train the NC head on generated pairs and score the transfer.

    Returns the run's metrics (``loss_first`` / ``loss_last``: mean of the
    first / last tenth of the step losses, ``loss_deciles``, ``losses``,
    ``pck_before``, ``pck_after``, ``pck_diagonal_baseline``) and the
    trained ``model`` and ``config``. ``half_precision`` trains in
    bfloat16 over float32 masters (`make_train_step`)."""
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import SyntheticPairDataset
    from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
    from ncnet_tpu_torch.train.step import create_train_state, make_train_step

    config = ImMatchNetConfig(
        feature_extraction_cnn=fe_arch,
        ncons_kernel_sizes=tuple(ncons_kernel_sizes),
        ncons_channels=tuple(ncons_channels),
        # with no pretrained trunk, centring gives the random trunk's
        # correlations their contrast
        center_features=True,
        nc_init=nc_init,
        half_precision=half_precision,
    )
    # patch16 and the identity init: a deep random trunk, or the
    # reference's uniform init, lets the weak loss fall while PCK lands on
    # the degenerate diagonal (the JAX package's finding)
    model = ImMatchNet(config, device=device,
                       generator=torch.Generator().manual_seed(seed))
    size = (image_size, image_size)
    train_ds = SyntheticPairDataset(n=n_pairs, output_size=size, seed=seed)
    eval_ds = SyntheticPairDataset(n=16, output_size=size, seed=seed + 999,
                                   return_shift=True)
    train_loader = DataLoader(train_ds, batch, shuffle=True, seed=seed,
                              num_workers=2, drop_last=True)
    eval_batches = list(DataLoader(eval_ds, 8, shuffle=False, num_workers=2))

    pck_before = evaluate_synthetic(model, config, eval_batches, alpha=alpha)
    state = create_train_state(model, lr)
    step_fn = make_train_step(config)
    losses = []
    it = iter(train_loader)
    for i in range(steps):
        try:
            batch_np = next(it)
        except StopIteration:
            it = iter(train_loader)
            batch_np = next(it)
        state, loss = step_fn(state, {"source_image": batch_np["source_image"],
                                      "target_image": batch_np["target_image"]})
        losses.append(float(loss))
        if verbose and (i + 1) % log_every == 0:
            print(f"step {i + 1}/{steps} loss {losses[-1]:+.6f}", flush=True)
    pck_after = evaluate_synthetic(model, config, eval_batches, alpha=alpha)
    tenth = max(len(losses) // 10, 1)
    deciles = [float(np.mean(part)) for part in np.array_split(losses, 10)
               if len(part)]
    # the PCK of a degenerate zero-shift predictor: a point counts as
    # correct whenever its pair's shift is under the PCK radius
    pck_diagonal = float(np.mean([
        eval_ds[i]["shift"] <= alpha * image_size for i in range(len(eval_ds))
    ]))
    return {
        "loss_first": float(np.mean(losses[:tenth])),
        "loss_last": float(np.mean(losses[-tenth:])),
        "loss_deciles": deciles,
        "losses": losses,
        "pck_before": pck_before,
        "pck_after": pck_after,
        "pck_diagonal_baseline": pck_diagonal,
        "model": model,
        "config": config,
    }


def converged(out):
    """The run's gate: the loss fell, and PCK after training beats both
    PCK before and the degenerate diagonal."""
    return (out["loss_last"] < out["loss_first"]
            and out["pck_after"] > out["pck_before"]
            and out["pck_after"] > out["pck_diagonal_baseline"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n_pairs", type=int, default=32)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--fe_arch", default="patch16")
    p.add_argument("--nc_init", default="identity",
                   choices=["identity", "reference"])
    p.add_argument("--ncons_kernel_sizes", nargs="+", type=int, default=[3, 3])
    p.add_argument("--ncons_channels", nargs="+", type=int, default=[16, 1])
    p.add_argument("--bf16", action="store_true",
                   help="train in bfloat16 over float32 masters")
    p.add_argument("--json_out", default="",
                   help="also write the JSON report to this file")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (the run fails without a card)")
    args = p.parse_args(argv)
    out = run(
        image_size=args.image_size, steps=args.steps, batch=args.batch,
        n_pairs=args.n_pairs, lr=args.lr, seed=args.seed, alpha=args.alpha,
        ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
        ncons_channels=tuple(args.ncons_channels), fe_arch=args.fe_arch,
        nc_init=args.nc_init, half_precision=args.bf16, device=args.device,
    )
    ok = converged(out)
    print(f"loss: first-decile mean {out['loss_first']:+.6f} -> last-decile "
          f"mean {out['loss_last']:+.6f}")
    print(f"synthetic transfer PCK@{args.alpha}: {out['pck_before']:.3f} -> "
          f"{out['pck_after']:.3f} (degenerate-diagonal baseline "
          f"{out['pck_diagonal_baseline']:.3f})")
    print(f"convergence {'OK' if ok else 'NOT DEMONSTRATED'}")
    report = {k: v for k, v in out.items() if k not in ("model", "config")}
    report.update(convergence_ok=ok, steps=args.steps, alpha=args.alpha,
                  image_size=args.image_size, fe_arch=args.fe_arch,
                  nc_init=args.nc_init, seed=args.seed, bf16=args.bf16,
                  config=out["config"].to_dict())
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report, sort_keys=True))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
