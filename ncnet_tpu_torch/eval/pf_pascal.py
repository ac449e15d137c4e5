"""PF-Pascal PCK@alpha evaluation (``ncnet_tpu/eval/pf_pascal.py``) and
its CLI, the counterpart of ``scripts/eval_pf_pascal.py``.

Per pair (reference eval_pf_pascal.py:46-89): forward ->
``corr_to_matches(do_softmax=True)`` -> bilinear keypoint transfer -> PCK
against the -1-padded ground-truth keypoints. The mean is over valid
(non-NaN) pairs. Batches of any size are scored at once.

    python -m ncnet_tpu_torch.eval.pf_pascal --checkpoint ncnet_pfpascal.pth.tar

The telemetry span and pair counter of the JAX eval wait for the port's
telemetry (ROADMAP A16).
"""

import argparse
import json
import os

import numpy as np
import torch

from ncnet_tpu_torch.models.immatchnet import immatchnet_apply
from ncnet_tpu_torch.ops.coords import points_to_pixel_coords, points_to_unit_coords
from ncnet_tpu_torch.ops.matches import bilinear_point_transfer, corr_to_matches
from ncnet_tpu_torch.ops.metrics import pck
from ncnet_tpu_torch.refine import refine_grid_error

# the batch keys the PCK step consumes (and the serving payload carries)
PCK_BATCH_KEYS = (
    "source_image",
    "target_image",
    "source_points",
    "target_points",
    "source_im_size",
    "target_im_size",
    "L_pck",
)


def pck_step_fn(config, alpha=0.1):
    """``step(model, batch) -> [b] per-pair PCK`` on a batch of tensors:
    the one step body of `evaluate` and `evaluate_serving`, so the two
    differ in batching only."""

    def step(model, batch):
        corr = immatchnet_apply(
            model, config, batch["source_image"], batch["target_image"]
        )
        x_a, y_a, x_b, y_b, _ = corr_to_matches(corr, do_softmax=True)
        tgt_norm = points_to_unit_coords(
            batch["target_points"], batch["target_im_size"]
        )
        warped_norm = bilinear_point_transfer((x_a, y_a, x_b, y_b), tgt_norm)
        warped = points_to_pixel_coords(warped_norm, batch["source_im_size"])
        return pck(batch["source_points"], warped, batch["L_pck"], alpha=alpha)

    return step


def host_arrays(batch):
    """The `PCK_BATCH_KEYS` of a numpy batch, float64 made float32 (the
    host resize computes in float64; the JAX package's ``jnp.asarray``
    makes it float32)."""
    out = {}
    for k in PCK_BATCH_KEYS:
        v = np.asarray(batch[k])
        out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
    return out


def _summarize(per_pair):
    arr = np.asarray(per_pair)
    valid = ~np.isnan(arr) & (arr != -1)
    return {
        "pck": float(arr[valid].mean()) if valid.any() else float("nan"),
        "per_pair": per_pair,
        "n_valid": int(valid.sum()),
    }


def evaluate(model, config, loader, alpha=0.1, verbose=True):
    """PCK over ``loader``'s batches (`PFPascalDataset` samples, collated)
    on ``model``'s device. Returns ``{'pck': mean, 'per_pair': [...],
    'n_valid': int}``."""
    step = pck_step_fn(config, alpha)
    per_pair = []
    for i, batch in enumerate(loader):
        tensors = {k: torch.from_numpy(v).to(model.device)
                   for k, v in host_arrays(batch).items()}
        with torch.inference_mode():
            scores = step(model, tensors).cpu().numpy()
        per_pair.extend(scores.tolist())
        if verbose:
            print(f"batch [{i + 1}/{len(loader)}]", flush=True)
    return _summarize(per_pair)


def evaluate_serving(model, config, loader, alpha=0.1, max_batch=8,
                     max_wait=0.002, verbose=True):
    """PCK through the port's `ServeEngine`: the loader's pairs go in as
    single requests, are coalesced into padded micro-batches per image
    shape (every padded batch size warmed before a bucket's first
    request) and scored by `pck_step_fn`'s body, so per-pair PCK is
    `evaluate`'s up to the batch-size rounding of the float32 sums.
    Returns the `evaluate` schema plus ``'serve'``, the engine's report."""
    from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec

    step = pck_step_fn(config, alpha)

    def apply(m, batch):
        return {"pck": step(m, batch)}

    futures = []
    warmed = set()
    with ServeEngine(apply, model, device=model.device, max_batch=max_batch,
                     max_wait=max_wait) as engine:
        for i, batch in enumerate(loader):
            arrs = host_arrays(batch)
            for j in range(len(arrs["source_image"])):
                payload = {k: v[j] for k, v in arrs.items()}
                key = (payload["source_image"].shape,
                       payload["target_image"].shape)
                if key not in warmed:
                    engine.warmup([(key, payload_spec(payload))])
                    warmed.add(key)
                futures.append(engine.submit(key=key, payload=payload))
            if verbose:
                print(f"batch [{i + 1}/{len(loader)}] submitted", flush=True)
        per_pair = [float(f.result()["pck"]) for f in futures]
    out = _summarize(per_pair)
    out["serve"] = engine.report()
    return out


def pck_vs_topk(model, config, loader, ks, alpha=0.1, verbose=False):
    """PCK of the same pairs at every ``nc_topk`` in ``ks`` (0 = dense;
    K > 0 runs the band NC stack, ``ncnet_tpu_torch.sparse``). Returns
    ``{k: evaluate result}``; at ``k >= hB*wB`` the band is complete and
    the result equals the dense one."""
    batches = list(loader)
    return {
        int(k): evaluate(model, config.replace(nc_topk=int(k)), batches,
                         alpha=alpha, verbose=verbose)
        for k in ks
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ncnet_tpu_torch PF-Pascal PCK eval")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference .pth.tar, the port's training .npz or "
                        "the JAX package's .msgpack")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--eval_dataset_path", type=str, default="datasets/pf-pascal")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=0,
                   help="serve the eval through ServeEngine with this max "
                        "batch size (0: score the loader's batches in turn)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bfloat16 features / correlation / NC (readout "
                        "float32); default: the checkpoint's")
    p.add_argument("--refine", type=int, default=None, metavar="R",
                   help="coarse-to-fine refinement (ncnet_tpu_torch.refine) "
                        "for the eval forward: pool features by R, run the "
                        "coarse band at --refine_topk, re-score the "
                        "surviving neighbourhoods at full resolution. 0 "
                        "forces it off; unset keeps the checkpoint's value")
    p.add_argument("--refine_topk", type=int, default=None, metavar="K",
                   help="with --refine: coarse-band width")
    p.add_argument("--refine_radius", type=int, default=None,
                   help="with --refine: extra window reach in coarse cells")
    p.add_argument("--conv4d_impl", type=str, default="tlc",
                   help="the JAX package's conv4d lowering; recorded in "
                        "the config and unread (the port has one conv4d)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (the run fails without a card)")
    return p.parse_args(argv)


def apply_refine_flags(config, args):
    """``config`` with the ``--refine*`` flags that were given (unset keeps
    the config's value)."""
    for flag, field in (("refine", "refine_factor"),
                        ("refine_topk", "refine_topk"),
                        ("refine_radius", "refine_radius")):
        if getattr(args, flag) is not None:
            config = config.replace(**{field: getattr(args, flag)})
    return config


def check_refine_grid(factor, image_size):
    """Exit as the JAX CLI does when the feature grid does not divide by
    the refine factor."""
    error = refine_grid_error(factor, image_size)
    if error:
        raise SystemExit(error)


def main(argv=None):
    from ncnet_tpu_torch.convert import load_model
    from ncnet_tpu_torch.data.loader import DataLoader
    from ncnet_tpu_torch.data.pairs import PFPascalDataset
    from ncnet_tpu_torch.device import resolve_device

    args = parse_args(argv)
    if args.refine is not None:  # a flag's refusal needs no checkpoint
        check_refine_grid(args.refine, args.image_size)
    device = resolve_device(args.device)
    config, model = load_model(args.checkpoint, device=device)
    if args.conv4d_impl:
        config = config.replace(conv4d_impl=args.conv4d_impl)
    if args.bf16 is not None:
        config = config.replace(half_precision=args.bf16)
    config = apply_refine_flags(config, args)
    check_refine_grid(config.refine_factor, args.image_size)

    dataset = PFPascalDataset(
        os.path.join(args.eval_dataset_path, "image_pairs", "test_pairs.csv"),
        args.eval_dataset_path,
        output_size=(args.image_size, args.image_size),
        pck_procedure="scnet",
    )
    loader = DataLoader(dataset, args.batch_size, num_workers=args.num_workers)
    if args.batch:
        stats = evaluate_serving(model, config, loader, max_batch=args.batch)
    else:
        stats = evaluate(model, config, loader)
    print(f"Total: {len(dataset)}")
    print(f"Valid: {stats['n_valid']}")
    print(f"PCK: {stats['pck']:.2%}")
    report = {"total": len(dataset), "n_valid": stats["n_valid"],
              "pck": stats["pck"], "per_pair": stats["per_pair"],
              "config": config.to_dict(), "device": str(device)}
    if args.batch:
        s = stats["serve"]
        print(
            f"Serve: {s['completed']} pairs in {s['batches']} batches, "
            f"occupancy {s['mean_occupancy']:.2f}, "
            f"p50 {s['latency_p50_ms']:.0f} ms / "
            f"p95 {s['latency_p95_ms']:.0f} ms"
        )
        report["serve"] = s
    print(json.dumps(report, sort_keys=True))
    return report


if __name__ == "__main__":
    main()
