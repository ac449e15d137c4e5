"""Training CLI of the port: ``python -m ncnet_tpu_torch.train``.

The counterpart of ``scripts/train.py`` for a frozen trunk and a trainable
NC head, flags spelled the same. Example (the PF-Pascal defaults:
ResNet-101, 400 px, NC 5-5-5 / 16-16-1, batch 16, bfloat16 compute over
float32 masters) on generated pairs with a random trunk:

    python -m ncnet_tpu_torch.train --synthetic --allow_random_fe --max-steps 2

At toy size on the CPU:

    python -m ncnet_tpu_torch.train --synthetic --allow_random_fe \\
        --device cpu --fe_arch patch16 --image_size 64 \\
        --ncons_kernel_sizes 3 3 --ncons_channels 4 1 --batch_size 2 \\
        --synthetic_pairs 8 --num_epochs 1

``--nc_topk K`` trains the NC stack on each pair's top-K correlation band
(sparse-band training; ``--no-nc_topk_mutual`` selects the plain per-A
top-K instead of the mutual band), e.g. ``--nc_topk 50`` at the PF-Pascal
defaults on the card, or ``--nc_topk 4`` at the toy size above.

It prints one JSON report at the end: losses, steps, step ms, peak device
memory and the kernels' launch counts.
"""

import argparse
import json
import os
import sys

import torch

from ncnet_tpu_torch.data.loader import DataLoader
from ncnet_tpu_torch.data.pairs import ImagePairDataset, SyntheticPairDataset
from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.kernels.band_gemm import band_gemm_dx, band_gemm_fwd
from ncnet_tpu_torch.kernels.band_gemm_dw import band_gemm_dw
from ncnet_tpu_torch.kernels.conv4d import conv4d_dx, conv4d_fwd
from ncnet_tpu_torch.kernels.conv4d_dw import conv4d_dw
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.train.checkpoint import load_checkpoint
from ncnet_tpu_torch.train.loop import train


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ncnet_tpu_torch training")
    p.add_argument("--dataset_image_path", type=str, default="datasets/pf-pascal")
    p.add_argument("--dataset_csv_path", type=str,
                   default="datasets/pf-pascal/image_pairs")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated pairs (no dataset needed)")
    p.add_argument("--synthetic_pairs", type=int, default=256)
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--ncons_kernel_sizes", nargs="+", type=int, default=[5, 5, 5])
    p.add_argument("--ncons_channels", nargs="+", type=int, default=[16, 16, 1])
    p.add_argument("--fe_arch", type=str, default="resnet101",
                   choices=("resnet101", "patch16"))
    p.add_argument("--allow_random_fe", action="store_true",
                   help="explicitly allow a randomly initialized frozen trunk "
                        "(the reference always uses ImageNet weights)")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=None,
                   help="bfloat16 features/correlation/NC over float32 master "
                        "weights (default on; a resumed run keeps its "
                        "checkpoint's setting unless given)")
    p.add_argument("--nc_topk", type=int, default=None, metavar="K",
                   help="sparse-band neighbourhood consensus: keep the top-K "
                        "B candidates per A cell and train the NC stack on "
                        "that band. 0 = dense; K >= hB*wB is the dense math. "
                        "Unset keeps a resumed checkpoint's value")
    p.add_argument("--nc_topk_mutual", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="with --nc_topk: mutual band selection (the default) "
                        "or the plain per-A top-K (--no-nc_topk_mutual); "
                        "unset keeps a resumed checkpoint's value")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--result_model_dir", type=str, default="trained_models")
    p.add_argument("--result_model_fn", type=str, default="ncnet_tpu_torch.npz")
    p.add_argument("--checkpoint", type=str, default="",
                   help="resume from a checkpoint of this CLI (.npz)")
    p.add_argument("--save-every-steps", type=int, default=0,
                   dest="save_every_steps",
                   help="also checkpoint every N optimizer steps, with a "
                        "mid-epoch resume cursor; 0 = epoch ends only")
    p.add_argument("--max-steps", type=int, default=0, dest="max_steps",
                   help="stop after N optimizer steps in all (a resumable "
                        "checkpoint is written); 0 = run every epoch")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    if not args.checkpoint and not args.synthetic and not args.allow_random_fe:
        # the reference always trains on an ImageNet-pretrained frozen
        # trunk; NC over random-trunk correlations learns noise
        p.error(
            "no pretrained trunk: pass --checkpoint, or opt in to a random "
            "trunk with --allow_random_fe (loading torchvision trunk weights "
            "is not ported yet)"
        )
    device = resolve_device(args.device)
    resume = None
    if args.checkpoint:
        resume = load_checkpoint(args.checkpoint)
        config = resume.config
        if args.bf16 is not None:
            config = config.replace(half_precision=args.bf16)
        # the band flags override in either direction; unset keeps the
        # checkpoint's (the NC params are the same model either way)
        if args.nc_topk is not None:
            config = config.replace(nc_topk=args.nc_topk)
        if args.nc_topk_mutual is not None:
            config = config.replace(nc_topk_mutual=args.nc_topk_mutual)
        print(f"resuming from {args.checkpoint} at step {resume.step}",
              flush=True)
    else:
        config = ImMatchNetConfig(
            feature_extraction_cnn=args.fe_arch,
            ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
            ncons_channels=tuple(args.ncons_channels),
            half_precision=True if args.bf16 is None else args.bf16,
            nc_topk=args.nc_topk or 0,
            nc_topk_mutual=(True if args.nc_topk_mutual is None
                            else args.nc_topk_mutual),
        )
    model = ImMatchNet(config, device=device,
                       generator=torch.Generator().manual_seed(args.seed))

    size = (args.image_size, args.image_size)
    if args.synthetic:
        train_ds = SyntheticPairDataset(n=args.synthetic_pairs,
                                        output_size=size, seed=args.seed)
        val_ds = SyntheticPairDataset(n=32, output_size=size, seed=args.seed + 1)
    else:
        train_ds, val_ds = (
            ImagePairDataset(os.path.join(args.dataset_csv_path, f"{s}_pairs.csv"),
                             args.dataset_image_path, output_size=size,
                             seed=args.seed)
            for s in ("train", "val"))
    train_loader = DataLoader(train_ds, args.batch_size, shuffle=True,
                              seed=args.seed, num_workers=args.num_workers,
                              drop_last=True)
    val_loader = DataLoader(val_ds, args.batch_size, shuffle=False,
                            num_workers=args.num_workers, drop_last=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels = {"conv4d_fwd": conv4d_fwd, "conv4d_dx": conv4d_dx,
               "conv4d_dw": conv4d_dw, "band_gemm_fwd": band_gemm_fwd,
               "band_gemm_dx": band_gemm_dx, "band_gemm_dw": band_gemm_dw}
    launches0 = {name: k.launches for name, k in kernels.items()}
    state, history = train(
        config, model, train_loader, val_loader,
        num_epochs=args.num_epochs, learning_rate=args.lr,
        checkpoint_dir=args.result_model_dir,
        checkpoint_name=args.result_model_fn,
        save_every_steps=args.save_every_steps, max_steps=args.max_steps,
        resume=resume,
    )
    launches = {name: k.launches - launches0[name] for name, k in kernels.items()}
    ms = history["step_ms"]
    report = {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "config": config.to_dict(),
        "steps": state.step,
        "steps_this_run": len(history["step_losses"]),
        "step_losses": history["step_losses"],
        "train_loss": history["train_loss"],
        "val_loss": [None if v != v else v for v in history["val_loss"]],
        "step_ms": ms,
        "step_ms_median": sorted(ms)[len(ms) // 2] if ms else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "kernel_launches": launches,
        "checkpoint": os.path.join(args.result_model_dir, args.result_model_fn),
        "stopped_at_max_steps": history["stopped_at_max_steps"],
    }
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
