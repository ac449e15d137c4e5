"""Batched correspondence serving CLI of the port (counterpart of
``scripts/serve.py``).

  python -m ncnet_tpu_torch.serve --synthetic 16 --seed 0 --image-size 400 \
      --max-batch 8
  python -m ncnet_tpu_torch.serve --images DIR --checkpoint trained.npz
  python -m ncnet_tpu_torch.serve --images DIR --checkpoint ncnet.pth.tar \
      --feature-store gallery/
  python -m ncnet_tpu_torch.serve --synthetic 16 --nc-topk 16
  python -m ncnet_tpu_torch.serve --synthetic 16 --degrade 16
  python -m ncnet_tpu_torch.serve --synthetic 16 --refine 5 --degrade 16

``--images DIR`` pairs the sorted image files consecutively; ``--synthetic
N`` makes N random pairs from ``--seed`` (every fourth target is 304x400,
the rest 400x400, so two buckets are served). Weights: ``--checkpoint``
serves a trained model, the train CLI's ``.npz``, the JAX package's
``.msgpack`` or a reference ``.pth.tar`` / ``.pth``
(`ncnet_tpu_torch.convert.load_model`), whose config is the model's: the
architecture flags (``--cnn``, ``--ncons-*``) are refused beside it,
``--nc-topk K >= 0`` and ``--bf16`` / ``--no-bf16`` override it when
given, and its ``refine_factor`` is stripped from the standard program
(``--refine R`` rebuilds refinement as the ladder's top rung), as
``scripts/serve.py`` does. Without a checkpoint the model is ImMatchNet at
the flags' config (default: the PF-Pascal config, ResNet-101 + NC 5-5-5 /
16-16-1) with weights from ``--params file.npz`` (the JAX param tree
flattened by `ncnet_tpu_torch.bridge.flatten`) or random from ``--seed``.
``--nc-topk K`` serves the sparse top-K band (Sparse-NCNet) as the
standard program; ``--degrade K`` pre-warms the band at K as the degraded
program that the engine's hysteresis controller flips to under queue
pressure (``--degrade-high`` / ``--degrade-low``). ``--refine R``
pre-warms the coarse-to-fine program (a ``--refine-topk`` band on
features pooled by R, re-scored at full resolution) as the rung above
standard: a `QualityLadder` then walks ``refined <-> standard [<->
degraded]`` one rung a flip; the feature grid ``image-size / 16`` must
divide by R. ``--corr-impl stream`` selects every band program's band from
B-tile slabs of the correlation instead of the volume. ``--feature-store
DIR`` serves every rung from a gallery feature store
(`ncnet_tpu_torch.features.GalleryFeatureStore`, under the trunk's
digest): an image is keyed by its file's basename (a synthetic one by its
seed and index), its trunk features extracted on its first visit and read
back on every later one. Prints one JSON report: the weights, pairs/s,
occupancy, latency percentiles and the degradation counts. Runs on the
card unless ``--device cpu``.
"""

import argparse
import json
import os
import threading

import numpy as np
import torch

from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.convert import load_model
from ncnet_tpu_torch.data.images import (
    load_image,
    normalize_image_np,
    resize_bilinear_np,
)
from ncnet_tpu_torch.device import resolve_device
from ncnet_tpu_torch.features import (
    GalleryFeatureStore,
    make_batch_extractor,
    trunk_digest,
)
from ncnet_tpu_torch.models.feature_extraction import BACKBONES
from ncnet_tpu_torch.models.immatchnet import ImMatchNet, ImMatchNetConfig
from ncnet_tpu_torch.refine import refine_grid_error
from ncnet_tpu_torch.serve.buckets import BucketSpec, pair_bucket
from ncnet_tpu_torch.serve.engine import ServeEngine, payload_spec
from ncnet_tpu_torch.serve.resilience import HysteresisController, QualityLadder
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
    p.add_argument("--checkpoint", type=str, default=None,
                   help="serve a trained model: the train CLI's .npz, a JAX "
                        ".msgpack or a reference .pth.tar / .pth; the config "
                        "is the checkpoint's")
    p.add_argument("--params", type=str, default=None,
                   help=".npz of the JAX param tree (bridge.flatten keys) at "
                        "the flags' config")
    p.add_argument("--image-size", type=int, default=400,
                   help="bucket universe: max image side after resize")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--concurrency", type=int, default=8,
                   help="client threads submitting requests")
    p.add_argument("--cnn", type=str, default=None, choices=tuple(BACKBONES),
                   help="trunk (default resnet101); refused with --checkpoint")
    p.add_argument("--ncons-kernel-sizes", type=int, nargs="+", default=None,
                   help="NC kernel sizes (default 5 5 5); refused with "
                        "--checkpoint")
    p.add_argument("--ncons-channels", type=int, nargs="+", default=None,
                   help="NC channels (default 16 16 1); refused with "
                        "--checkpoint")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 features / correlation / NC (readout f32); "
                        "unset keeps the checkpoint's (off without one)")
    p.add_argument("--nc-topk", type=int, default=-1,
                   help="sparse NC band width K of the standard program "
                        "(-1 keeps the config's, 0 is dense)")
    p.add_argument("--feature-store", type=str, default=None,
                   dest="feature_store", metavar="DIR",
                   help="serve from a gallery feature store under DIR: each "
                        "image's trunk features extracted on its first visit "
                        "and read back after (digest-guarded: a store of "
                        "another trunk raises)")
    p.add_argument("--degrade", type=int, default=-1,
                   help="nc_topk of the DEGRADED program the overload "
                        "controller flips to (-1 disables degradation)")
    p.add_argument("--degrade-high", type=float, default=0.75,
                   help="queue-pressure fraction that flips dispatch to "
                        "the degraded program (hysteresis high water)")
    p.add_argument("--degrade-low", type=float, default=0.25,
                   help="queue-pressure fraction that flips back "
                        "(hysteresis low water)")
    p.add_argument("--refine", type=int, default=0, metavar="R",
                   help="pre-warm the coarse-to-fine REFINED program at pool "
                        "factor R as the quality ladder's top rung; dispatch "
                        "walks down to standard (and --degrade, when set) "
                        "under sustained queue pressure and back when it "
                        "clears (0 disables; the feature grid "
                        "image_size/16 must divide by R)")
    p.add_argument("--refine-topk", type=int, default=16, dest="refine_topk",
                   metavar="K",
                   help="with --refine: coarse-band width (the survivors "
                        "re-scored at full resolution)")
    p.add_argument("--refine-radius", type=int, default=0,
                   dest="refine_radius",
                   help="with --refine: extra window reach in coarse cells "
                        "around each survivor")
    p.add_argument("--corr-impl", choices=("dense", "stream"),
                   default="dense", dest="corr_impl",
                   help="band programs' correlation -> top-K selection: "
                        "'stream' tiles B's grid and never holds the volume "
                        "(the same band)")
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


def feature_store_prep(store, model, config, resized):
    """The engine's prep from a gallery feature store: ``prep(((key, image
    or path), (key, image or path))) -> (bucket key, payload)`` whose
    payload holds each image's ``[fh, fw, c]`` trunk features, read from
    ``store`` under its key, or on the key's first visit extracted
    (``resized(image)``, then the trunk at batch 1) and written there. A
    key's lock makes concurrent first visits (the engine's prep threads)
    extract it once."""
    extract = make_batch_extractor(model, config)
    locks, guard = {}, threading.Lock()

    def featurize(key, img):
        with guard:
            lock = locks.setdefault(key, threading.Lock())
        with lock:
            if store.has(key):
                return store.get(key)[0]
            feats = extract(resized(img)[None]).cpu()
            store.put(key, feats)
            return feats[0]

    def prep(pair):
        src, tgt = (featurize(key, img) for key, img in pair)
        return (tuple(src.shape), tuple(tgt.shape)), {
            "source_image": src, "target_image": tgt}

    return prep


ARCH_DEFAULTS = {"cnn": "resnet101", "ncons_kernel_sizes": [5, 5, 5],
                 "ncons_channels": [16, 16, 1]}


def load_weights(args, device):
    """``(config, model, weights)``: a checkpoint's model and config, or the
    flags' config with ``--params`` or random weights from ``--seed``."""
    if args.checkpoint:
        given = [f"--{k.replace('_', '-')}" for k in ARCH_DEFAULTS
                 if getattr(args, k) is not None]
        if given:
            raise SystemExit(
                f"{' '.join(given)} with --checkpoint: the architecture is "
                "the checkpoint's; drop the flag or serve --params at the "
                "flags' config")
        config, model = load_model(args.checkpoint, device=device)
        return config, model, args.checkpoint
    for k, v in ARCH_DEFAULTS.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    config = ImMatchNetConfig(
        feature_extraction_cnn=args.cnn,
        ncons_kernel_sizes=tuple(args.ncons_kernel_sizes),
        ncons_channels=tuple(args.ncons_channels),
    )
    model = ImMatchNet(config, device=device,
                       generator=torch.Generator().manual_seed(args.seed))
    if not args.params:
        return config, model, f"random (seed {args.seed})"
    with np.load(args.params, allow_pickle=False) as f:
        if "meta" in f.files:
            raise SystemExit(
                f"--params {args.params} is a training checkpoint (it has the "
                "train CLI's 'meta' record); serve it with --checkpoint")
        tree = bridge.unflatten({k: f[k] for k in f.files})
    bridge.load_jax_params(model, tree)
    return config, model, args.params


def main(argv=None, results=None):
    """Serve and print the JSON report; returns it. ``results``: a list
    that receives each request's result (``{'matches': [5, n]}``) in
    request order."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    config, model, weights = load_weights(args, device)
    if args.bf16 is not None:
        config = config.replace(half_precision=args.bf16)
    if args.nc_topk >= 0:
        config = config.replace(nc_topk=args.nc_topk)
    if args.corr_impl != "dense":
        if not (config.nc_topk or args.degrade > 0 or args.refine):
            raise SystemExit(
                f"--corr-impl {args.corr_impl} requires a band program "
                "(--nc-topk K, --degrade K or --refine R): the dense NC stack "
                "consumes the full correlation volume, so there is nothing "
                "to stream"
            )
        config = config.replace(corr_impl=args.corr_impl)
    # serving treats refinement as a dispatch rung, not the standard
    # program's: --refine rebuilds it as the ladder's top rung
    config = config.replace(refine_factor=0)
    # the standard program is dense unless --nc-topk: the streamed
    # selection applies to the band programs only
    standard_config = (config if config.nc_topk
                       else config.replace(corr_impl="dense"))
    from_features = bool(args.feature_store)
    degraded_apply_fn = refined_apply_fn = controller = ladder = None
    if args.degrade >= 0:
        # the overload fallback: the same serving forward on a K band
        degraded_apply_fn = make_serve_match_step(
            config.replace(nc_topk=args.degrade), from_features=from_features
        )
    if args.refine > 0:
        error = refine_grid_error(args.refine, args.image_size)
        if error:
            raise SystemExit(error)
        # the quality ceiling, pre-warmed per (bucket, batch size) beside
        # the other programs
        refined_apply_fn = make_serve_match_step(config.replace(
            refine_factor=args.refine, refine_topk=args.refine_topk,
            refine_radius=args.refine_radius), from_features=from_features)
        ladder = QualityLadder(
            rungs=(("refined", "standard", "degraded")
                   if degraded_apply_fn is not None
                   else ("refined", "standard")),
            high=args.degrade_high, low=args.degrade_low,
        )
    elif degraded_apply_fn is not None:
        controller = HysteresisController(
            high=args.degrade_high, low=args.degrade_low
        )
    # every rung serves every bucket: with --refine each bucket's feature
    # grid is quantized to a multiple of the pool factor
    spec = BucketSpec(args.image_size,
                      grid_multiple=args.refine if args.refine > 1 else None)

    def resized(img):
        if isinstance(img, str):
            img = load_image(img)
        h, w = spec.bucket(img.shape[0], img.shape[1])
        return normalize_image_np(resize_bilinear_np(img, h, w)).astype(np.float32)

    if from_features:
        store = GalleryFeatureStore.open_or_create(
            args.feature_store,
            trunk_digest(bridge.to_jax_params(model)["feature_extraction"],
                         config, None),
            config)
        prep = feature_store_prep(store, model, config, resized)
    else:
        def prep(pair):
            src, tgt = (resized(img) for _, img in pair)
            return (src.shape[:2], tgt.shape[:2]), {
                "source_image": src, "target_image": tgt,
            }

    # (key, image or path) pairs: the key names an image in the store
    requests = (
        [((f"synthetic-{args.seed}-{i}-source", a),
          (f"synthetic-{args.seed}-{i}-target", b))
         for i, (a, b) in enumerate(synthetic_pairs(args.synthetic, args.seed))]
        if args.synthetic else
        [tuple((os.path.basename(x), x) for x in pair)
         for pair in image_pairs(args.images)]
    )
    report = {"n_requests": len(requests), "max_batch": args.max_batch,
              "weights": weights, "feature_store": args.feature_store,
              "config": standard_config.to_dict(), "nc_topk": config.nc_topk,
              "degrade_topk": args.degrade, "refine_factor": args.refine,
              "refine_topk": args.refine_topk,
              "refine_radius": args.refine_radius,
              "corr_impl": args.corr_impl}
    with ServeEngine(
        make_serve_match_step(standard_config, from_features=from_features),
        model, device=device,
        max_batch=args.max_batch, max_wait=args.max_wait_ms / 1e3,
        prep_fn=prep, degraded_apply_fn=degraded_apply_fn,
        degrade_controller=controller, refined_apply_fn=refined_apply_fn,
        quality_controller=ladder,
    ) as engine:
        seen = {}
        for pair in requests:
            shapes = [load_image(x).shape if isinstance(x, str) else x.shape
                      for _, x in pair]
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
        if results is not None:
            results.extend(None if fut.exception() else fut.result()
                           for fut in futures)
    report.update(engine.report())
    print(json.dumps(report, indent=2, sort_keys=True))
    return report


if __name__ == "__main__":
    main()
