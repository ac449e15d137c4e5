"""Training CLI of the port: ``python -m ncnet_tpu_torch.train``.

The counterpart of ``scripts/train.py``, flags spelled the same: the NC
head over a frozen trunk, or with ``--fe_finetune_params N`` also the
trunk's last N tail units (ResNet-101: layer3's bottlenecks; VGG-16: its
convs; DenseNet-201: denseblock2's layers, then transition2), or with
``--train_fe`` the whole trunk; ``--fe_arch`` picks resnet101, vgg,
densenet201 or patch16. Example (the PF-Pascal defaults:
ResNet-101, 400 px, NC 5-5-5 / 16-16-1, batch 16, bfloat16 compute over
float32 masters) on generated pairs with a random trunk:

    python -m ncnet_tpu_torch.train --synthetic --allow_random_fe --max-steps 2

At toy size on the CPU:

    python -m ncnet_tpu_torch.train --synthetic --allow_random_fe \\
        --device cpu --fe_arch patch16 --image_size 64 \\
        --ncons_kernel_sizes 3 3 --ncons_channels 4 1 --batch_size 2 \\
        --synthetic_pairs 8 --num_epochs 1

``--checkpoint`` resumes from this CLI's ``.npz`` or from the JAX
package's ``.msgpack`` (its Adam moments and step carried over). A resume
keeps the checkpoint's trunk-training mode unless the flags are given; a
different mode starts a fresh optimizer state, as ``scripts/train.py``
does.

``--nc_topk K`` trains the NC stack on each pair's top-K correlation band
(sparse-band training; ``--no-nc_topk_mutual`` selects the plain per-A
top-K instead of the mutual band), e.g. ``--nc_topk 50`` at the PF-Pascal
defaults on the card, or ``--nc_topk 4`` at the toy size above;
``--corr-impl stream`` selects that band from B-tile slabs of the
correlation (``--corr-tile T`` wide) and never holds the volume. ``--refine
R`` trains on the coarse-to-fine band instead (a ``--refine_topk`` band on
features pooled by R, re-scored at full resolution; e.g. ``--refine 5
--refine_topk 16`` at 400 px, ``--refine 2`` at 64 px); the feature grid
``image_size / 16`` must divide by R.

It prints one JSON report at the end: losses, steps, step ms, peak device
memory and the kernels' launch counts.
"""

import argparse
import dataclasses
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
from ncnet_tpu_torch.models.feature_extraction import BACKBONES
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.refine import refine_grid_error
from ncnet_tpu_torch.train.checkpoint import load_checkpoint
from ncnet_tpu_torch.train.loop import train
from ncnet_tpu_torch.train.step import check_from_features_frozen


#: (flag, config field) pairs a resume overrides only when the flag is given
BAND_FLAGS = (("corr_impl", "corr_impl"), ("corr_tile", "corr_stream_tile"),
              ("refine", "refine_factor"), ("refine_topk", "refine_topk"),
              ("refine_radius", "refine_radius"))


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
                   choices=tuple(BACKBONES))
    p.add_argument("--train_fe", action="store_true",
                   help="train the whole trunk with the NC head")
    p.add_argument("--fe_finetune_params", type=int, default=0,
                   help="finetune the last N units of the trunk's tail "
                        "(0 = frozen trunk)")
    p.add_argument("--feature-cache", type=str, default="",
                   dest="feature_cache", metavar="DIR",
                   help="not ported (ROADMAP A11); refused with a trainable "
                        "trunk")
    p.add_argument("--allow_random_fe", action="store_true",
                   help="explicitly allow a randomly initialized trunk "
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
    p.add_argument("--corr-impl", choices=("dense", "stream"), default=None,
                   dest="corr_impl",
                   help="band-path correlation -> top-K selection: 'stream' "
                        "tiles B's grid and never holds the hA*wA*hB*wB "
                        "volume (the same band). Requires --nc_topk or "
                        "--refine. Unset keeps a resumed checkpoint's value "
                        "(fresh configs: dense)")
    p.add_argument("--corr-tile", type=int, default=None, dest="corr_tile",
                   metavar="T",
                   help="with --corr-impl stream: B-grid slab width of the "
                        "streaming GEMM (default 128; clamped to hB*wB)")
    p.add_argument("--refine", type=int, default=None, metavar="R",
                   help="coarse-to-fine refinement: pool features by R, run "
                        "the band at the coarse grid (width --refine_topk), "
                        "re-score the surviving neighbourhoods at full "
                        "resolution. 0 = off; takes precedence over "
                        "--nc_topk. Unset keeps a resumed checkpoint's value")
    p.add_argument("--refine_topk", type=int, default=None, metavar="K",
                   help="with --refine: coarse-band width (default 16; unset "
                        "keeps a resumed checkpoint's value)")
    p.add_argument("--refine_radius", type=int, default=None,
                   help="with --refine: extra window reach in coarse cells "
                        "around each surviving candidate (default 0)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--result_model_dir", type=str, default="trained_models")
    p.add_argument("--result_model_fn", type=str, default="ncnet_tpu_torch.npz")
    p.add_argument("--checkpoint", type=str, default="",
                   help="resume from a checkpoint of this CLI (.npz) or of "
                        "the JAX package (.msgpack)")
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
    if args.feature_cache:
        try:
            check_from_features_frozen(args.train_fe, args.fe_finetune_params)
        except ValueError as e:
            p.error(str(e))
        raise NotImplementedError(
            "--feature-cache (training from cached trunk features) is not "
            "ported yet (ROADMAP A11)"
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
        # so do the selection impl (the band is the same under both) and
        # the refine flags
        for flag, field in BAND_FLAGS:
            if getattr(args, flag) is not None:
                config = config.replace(**{field: getattr(args, flag)})
        # the checkpoint records which tensors trained (the Adam state's
        # shape); default flags adopt its mode, another mode restarts Adam
        if not args.train_fe and not args.fe_finetune_params:
            args.train_fe = resume.train_fe
            args.fe_finetune_params = resume.fe_finetune_blocks
        elif (args.train_fe, args.fe_finetune_params) != (
                resume.train_fe, resume.fe_finetune_blocks):
            print("finetune mode differs from the checkpoint (ckpt: "
                  f"train_fe={resume.train_fe}, fe_finetune_blocks="
                  f"{resume.fe_finetune_blocks}); starting a fresh optimizer "
                  "state", flush=True)
            resume = dataclasses.replace(resume, opt_state=None)
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
            corr_impl=args.corr_impl or "dense",
            corr_stream_tile=128 if args.corr_tile is None else args.corr_tile,
            refine_factor=args.refine or 0,
            refine_topk=16 if args.refine_topk is None else args.refine_topk,
            refine_radius=args.refine_radius or 0,
        )
    # the effective refine geometry, wherever it came from, against the
    # feature grid: the pool needs an even division
    error = refine_grid_error(config.refine_factor, args.image_size)
    if error:
        p.error(error)
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
        resume=resume, train_fe=args.train_fe,
        fe_finetune_blocks=args.fe_finetune_params,
    )
    launches = {name: k.launches - launches0[name] for name, k in kernels.items()}
    ms = history["step_ms"]
    report = {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "config": config.to_dict(),
        "train_fe": state.train_fe,
        "fe_finetune_blocks": state.fe_finetune_blocks,
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
