"""Batched correspondence serving CLI of the port (counterpart of
``scripts/serve.py``).

  python -m ncnet_tpu_torch.serve --synthetic 16 --seed 0 --image-size 400 \
      --max-batch 8
  python -m ncnet_tpu_torch.serve --images DIR --params weights.npz
  python -m ncnet_tpu_torch.serve --synthetic 16 --nc-topk 16
  python -m ncnet_tpu_torch.serve --synthetic 16 --degrade 16

``--images DIR`` pairs the sorted image files consecutively; ``--synthetic
N`` makes N random pairs from ``--seed`` (every fourth target is 304x400,
the rest 400x400, so two buckets are served). Weights come from
``--params file.npz`` (the JAX param tree flattened by
`ncnet_tpu_torch.bridge.flatten`) or are random from ``--seed``. The model
is ImMatchNet at the flags' config (default: the PF-Pascal config, ResNet-101
+ NC 5-5-5 / 16-16-1). ``--nc-topk K`` serves the sparse top-K band
(Sparse-NCNet) as the standard program; ``--degrade K`` pre-warms the band
at K as the degraded program that the engine's hysteresis controller flips
to under queue pressure (``--degrade-high`` / ``--degrade-low``). Prints
one JSON report: pairs/s, occupancy, latency percentiles and the
degradation counts. Runs on the card unless ``--device cpu``.
"""

import argparse
import json
import os
import threading

import numpy as np
import torch

from ncnet_tpu_torch.bridge import load_jax_params, load_npz
from ncnet_tpu_torch.data.images import (
    load_image,
    normalize_image_np,
    resize_bilinear_np,
)
from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.models.feature_extraction import BACKBONES
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.serve.buckets import BucketSpec, pair_bucket
from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
from ncnet_tpu_torch.serve.resilience import HysteresisController
from ncnet_tpu_torch.serve.step import make_serve_match_step

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ncnet_tpu_torch serving CLI")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", type=str,
                     help="directory; sorted files paired consecutively")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="serve N random pairs made from --seed")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic pairs and random weights")
    p.add_argument("--params", type=str, default=None,
                   help=".npz of the JAX param tree (bridge.flatten keys)")
    p.add_argument("--image-size", type=int, default=400,
                   help="bucket universe: max image side after resize")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--concurrency", type=int, default=8,
                   help="client threads submitting requests")
    p.add_argument("--cnn", type=str, default="resnet101",
                   choices=tuple(BACKBONES))
    p.add_argument("--ncons-kernel-sizes", type=int, nargs="+",
                   default=[5, 5, 5])
    p.add_argument("--ncons-channels", type=int, nargs="+",
                   default=[16, 16, 1])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 features / correlation / NC (readout f32)")
    p.add_argument("--nc-topk", type=int, default=-1,
                   help="sparse NC band width K of the standard program "
                        "(-1 keeps the config's, 0 is dense)")
    p.add_argument("--degrade", type=int, default=-1,
                   help="nc_topk of the DEGRADED program the overload "
                        "controller flips to (-1 disables degradation)")
    p.add_argument("--degrade-high", type=float, default=0.75,
                   help="queue-pressure fraction that flips dispatch to "
                        "the degraded program (hysteresis high water)")
    p.add_argument("--degrade-low", type=float, default=0.25,
                   help="queue-pressure fraction that flips back "
                        "(hysteresis low water)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (the run fails without a card)")
    return p.parse_args(argv)


def synthetic_pairs(n, seed):
    """``n`` (source, target) float32 0..255 images; every fourth target
    is 304x400, the rest 400x400."""
    rng = np.random.RandomState(seed)
    pairs = []
    for i in range(n):
        tgt_hw = (304, 400) if i % 4 == 3 else (400, 400)
        pairs.append((
            rng.uniform(0, 255, (400, 400, 3)).astype(np.float32),
            rng.uniform(0, 255, tgt_hw + (3,)).astype(np.float32),
        ))
    return pairs


def image_pairs(directory):
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.lower().endswith(_IMAGE_EXTS)
    )
    if len(files) < 2:
        raise SystemExit(f"--images {directory}: need >= 2 images")
    return [(files[i], files[i + 1]) for i in range(0, len(files) - 1, 2)]


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = ImMatchNetConfig(
        feature_extraction_cnn=args.cnn,
        ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
        ncons_channels=tuple(args.ncons_channels),
        half_precision=args.bf16,
    )
    if args.nc_topk >= 0:
        config = config.replace(nc_topk=args.nc_topk)
    degraded_apply_fn = controller = None
    if args.degrade >= 0:
        # the overload fallback: the same serving forward on a K band
        degraded_apply_fn = make_serve_match_step(
            config.replace(nc_topk=args.degrade)
        )
        controller = HysteresisController(
            high=args.degrade_high, low=args.degrade_low
        )
    model = ImMatchNet(
        config, device=device,
        generator=torch.Generator().manual_seed(args.seed),
    )
    if args.params:
        load_jax_params(model, load_npz(args.params))
    spec = BucketSpec(args.image_size)

    def prep(pair):
        imgs = []
        for img in pair:
            if isinstance(img, str):
                img = load_image(img)
            h, w = spec.bucket(img.shape[0], img.shape[1])
            imgs.append(normalize_image_np(
                resize_bilinear_np(img, h, w)).astype(np.float32))
        return (imgs[0].shape[:2], imgs[1].shape[:2]), {
            "source_image": imgs[0], "target_image": imgs[1],
        }

    requests = (
        synthetic_pairs(args.synthetic, args.seed) if args.synthetic
        else image_pairs(args.images)
    )
    report = {"n_requests": len(requests), "max_batch": args.max_batch,
              "config": config.to_dict(), "nc_topk": config.nc_topk,
              "degrade_topk": args.degrade}
    with ServeEngine(
        make_serve_match_step(config), model, device=device,
        max_batch=args.max_batch, max_wait=args.max_wait_ms / 1e3,
        prep_fn=prep, degraded_apply_fn=degraded_apply_fn,
        degrade_controller=controller,
    ) as engine:
        seen = {}
        for pair in requests:
            shapes = [load_image(x).shape if isinstance(x, str) else x.shape
                      for x in pair]
            key = pair_bucket(spec, shapes[0][:2], shapes[1][:2])
            if key not in seen:
                seen[key] = prep(pair)
        engine.warmup(
            (key, payload_spec(payload)) for key, payload in seen.values()
        )
        report["buckets"] = len(seen)

        futures = [None] * len(requests)
        cursor = iter(range(len(requests)))
        lock = threading.Lock()

        def client():
            while True:
                with lock:
                    i = next(cursor, None)
                if i is None:
                    return
                futures[i] = engine.submit(requests[i])

        threads = [threading.Thread(target=client)
                   for _ in range(args.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for fut in futures:
            fut.exception()  # wait; failures are counted by the engine
    report.update(engine.report())
    print(json.dumps(report, indent=2, sort_keys=True))
    return report


if __name__ == "__main__":
    main()
