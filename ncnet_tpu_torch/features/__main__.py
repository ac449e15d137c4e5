"""Populate a frozen-trunk feature cache from a pair dataset: ``python -m
ncnet_tpu_torch.features`` (the counterpart of
``scripts/extract_features.py``, its flags).

Writes one durable digest-guarded store a split under
``<--feature-cache>/<split>``, the layout ``python -m ncnet_tpu_torch.train
--feature-cache DIR`` reads. Only missing shards are extracted, so an
interrupted extraction resumes where it stopped and a complete cache is a
directory scan. PF-Pascal on the card:

    python -m ncnet_tpu_torch.features --feature-cache features/pf-pascal \\
        --dataset_image_path datasets/pf-pascal \\
        --dataset_csv_path datasets/pf-pascal/image_pairs \\
        --fe_weights trained_models/resnet101.pth --bf16

``--synthetic`` extracts the train CLI's generated pairs (same sizes and
seeds), so the cache slots into ``--synthetic`` training; at toy size on
the CPU:

    python -m ncnet_tpu_torch.features --feature-cache /tmp/cache \\
        --synthetic --synthetic_n 8 --fe_arch patch16 --image_size 64 \\
        --allow_random_fe --bf16 --device cpu

A random trunk comes from ``--seed`` as the train CLI draws it, so its
digest matches a training run with the same seed.
"""

import argparse
import os
import sys

import torch

from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.convert import load_trunk_weights
from ncnet_tpu_torch.data.pairs import ImagePairDataset, SyntheticPairDataset
from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.features import FeatureStore, populate_store, trunk_digest
from ncnet_tpu_torch.models.feature_extraction import BACKBONES
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.train.checkpoint import load_checkpoint


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="extract frozen-trunk features into a durable cache")
    p.add_argument("--feature-cache", type=str, required=True,
                   dest="feature_cache", metavar="DIR",
                   help="cache root; one store a split under DIR/<split>")
    p.add_argument("--dataset_image_path", type=str,
                   default="datasets/pf-pascal")
    p.add_argument("--dataset_csv_path", type=str,
                   default="datasets/pf-pascal/image_pairs")
    p.add_argument("--synthetic", action="store_true",
                   help="extract the train CLI's generated pairs")
    p.add_argument("--synthetic_n", type=int, default=256,
                   help="synthetic train-set size (the train CLI's "
                        "--synthetic_pairs)")
    p.add_argument("--synthetic_val_n", type=int, default=32,
                   help="synthetic val-set size (the train CLI uses 32)")
    p.add_argument("--splits", nargs="+", default=["train", "val"],
                   choices=("train", "val"), help="which splits to extract")
    p.add_argument("--image_size", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=8,
                   help="trunk batch (pairs) during extraction")
    p.add_argument("--fe_arch", type=str, default="resnet101",
                   choices=tuple(BACKBONES))
    p.add_argument("--fe_weights", type=str, default="",
                   help="pretrained trunk weights: reference .pth.tar, raw "
                        "torchvision state dict (.pth), JAX .msgpack or the "
                        "train CLI's .npz")
    p.add_argument("--checkpoint", type=str, default="",
                   help="take the trunk's weights and the architecture from "
                        "a checkpoint (.npz, .msgpack or reference .pth.tar)")
    p.add_argument("--allow_random_fe", action="store_true",
                   help="explicitly allow a randomly initialized trunk")
    p.add_argument("--bf16", action="store_true",
                   help="extract and store bfloat16 features (training's "
                        "default dtype); float32 without it")
    p.add_argument("--device_normalize", action="store_true",
                   help="real datasets yield uint8, normalized on the device "
                        "(the train CLI's --device_normalize)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    return p, p.parse_args(argv)


def main(argv=None):
    p, args = parse_args(argv)
    if not (args.checkpoint or args.fe_weights or args.synthetic
            or args.allow_random_fe):
        p.error("no pretrained trunk: pass --fe_weights or --checkpoint, or "
                "opt in to a random trunk with --allow_random_fe")
    device = resolve_device(args.device)
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint)
        config = ck.config.replace(half_precision=args.bf16)
        model = bridge.from_jax_params(ck.params, config, device=device)
        print(f"trunk and architecture from checkpoint {args.checkpoint}")
    else:
        config = ImMatchNetConfig(feature_extraction_cnn=args.fe_arch,
                                  half_precision=args.bf16)
        model = ImMatchNet(config, device=device,
                           generator=torch.Generator().manual_seed(args.seed))
    if args.fe_weights:
        trunk = load_trunk_weights(args.fe_weights,
                                   cnn=config.feature_extraction_cnn)
        bridge.load_jax_params(model, dict(bridge.to_jax_params(model),
                                           feature_extraction=trunk))
        print(f"loaded trunk weights from {args.fe_weights}")

    size = (args.image_size, args.image_size)
    if args.synthetic:
        datasets = {
            "train": SyntheticPairDataset(n=args.synthetic_n, output_size=size,
                                          seed=args.seed),
            "val": SyntheticPairDataset(n=args.synthetic_val_n,
                                        output_size=size, seed=args.seed + 1),
        }
    else:
        datasets = {
            split: ImagePairDataset(
                os.path.join(args.dataset_csv_path, f"{split}_pairs.csv"),
                args.dataset_image_path, output_size=size, seed=args.seed,
                uint8_output=args.device_normalize)
            for split in args.splits
        }
    digest = trunk_digest(bridge.to_jax_params(model)["feature_extraction"],
                          config, size)
    for split in args.splits:
        ds = datasets[split]
        store = FeatureStore.open_or_create(
            os.path.join(args.feature_cache, split), digest, config, size,
            len(ds))
        n = populate_store(store, model, config, ds,
                           batch_size=min(args.batch_size, len(ds)),
                           log_every=5)
        state = "extracted" if n else "already complete;"
        print(f"[features] {split}: {state} {n or store.num_items} pairs -> "
              f"{store.root} (digest {digest[:12]}..., dtype "
              f"{store.manifest['feature_dtype']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
