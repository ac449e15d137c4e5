"""InLoc dense-match dump (``ncnet_tpu/eval/inloc.py``) and its CLI, the
counterpart of ``scripts/eval_inloc.py``.

It keeps the Python side of the reference's eval_inloc.py, so the MATLAB
PnP-RANSAC and pose-verification pipeline runs unchanged on its output:
one ``matches/<experiment>/<q+1>.mat`` per query holding ``matches``
``[1, Npanos, N, 5]``, rows ``(xA, yA, xB, yB, score)`` in normalized
[0, 1] coordinates (eval_inloc.py:126,199-203,221).

Per (query, pano) pair (eval_inloc.py:124-203): aspect-preserving resize
with the feature grid quantized to multiples of ``k_size`` -> the forward
with the fused correlation + 4D max-pool (bfloat16 at the CLI's default)
-> `corr_to_matches` in both directions (``scale='positive'``, softmax)
-> concatenation, descending-score sort and coordinate dedup on the host
-> recentring to feature-cell centres.

    python -m ncnet_tpu_torch.eval.inloc --checkpoint ncnet_ivd.pth.tar

``device_preprocess`` ships each image as uint8 and normalizes it on the
card; ``device_resize`` also ships an image whose quantized resize would
upscale it (InLoc's 1600x1200 panos to 2400x3200) at its original size
and resizes it on the card (`device_resize_uint8`). On an H100 the host's
resize and normalize took 1.2-2.2 s an image against about 0.15 s of
device work a pair (PERF.md), so these two move the dump's largest cost
off the host; the numbers differ from the host route only by the uint8
rounding of resized pixels (at most one gray level on a few pixels).

``feature_store_dir`` (the CLI's ``--feature-store``) dumps from a gallery
feature store (`ncnet_tpu_torch.features.GalleryFeatureStore`, under the
trunk's digest): one trunk forward a query; a pano's features are read
from the store, extracted only on the pano's first visit across queries
and runs, and matched by ``make_match_fn(from_features=True)``, the image
route's math without its trunk.

Not ported, raising with its ROADMAP item: the spatial mesh (A13).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ncnet_tpu_torch import bridge
from ncnet_tpu_torch.data.images import (
    load_image,
    normalize_image_np,
    resize_bilinear_np,
    to_uint8_image,
)
from ncnet_tpu_torch.features import (
    GalleryFeatureStore,
    make_batch_extractor,
    trunk_digest,
)
from ncnet_tpu_torch.models import immatchnet
from ncnet_tpu_torch.ops.image import device_normalize, resize_bilinear_align_corners
from ncnet_tpu_torch.serve.buckets import SCALE_FACTOR, quantized_resize_shape

__all__ = [
    "SCALE_FACTOR",
    "quantized_resize_shape",
    "preprocess_image",
    "load_and_preprocess",
    "device_resize_uint8",
    "make_match_fn",
    "match_pair",
    "dump_matches",
    "n_match_slots",
    "recenter",
]


def _to_str(x):
    """Unwrap scipy-loaded MATLAB cell/char nesting to a plain str."""
    while isinstance(x, np.ndarray):
        x = x.ravel()[0]
    return str(x)


def preprocess_image(img, image_size, k_size, grid_multiple=None):
    """A decoded ``[h, w, 3]`` 0..255 image -> quantized align-corners
    resize (`quantized_resize_shape`) -> ImageNet-normalized float32
    ``[1, h', w', 3]``."""
    h, w = quantized_resize_shape(img.shape[0], img.shape[1], image_size,
                                  k_size, grid_multiple)
    return normalize_image_np(resize_bilinear_np(img, h, w))[None].astype(np.float32)


def load_and_preprocess(path, image_size, k_size, grid_multiple=None,
                        device_normalize=False, device_resize=False,
                        read_image=load_image):
    """Read the image file at ``path`` (``read_image``), then the quantized
    resize; the JAX package's return contract:

    * default: the ImageNet-normalized float32 ``[1, h, w, 3]``
      (`preprocess_image`);
    * ``device_normalize``: the resized image as uint8 ``[1, h, w, 3]``,
      normalized later on the device (`make_match_fn`'s
      ``device_preprocess``);
    * ``device_resize`` (needs ``device_normalize``, else `ValueError`):
      ``(uint8 [1, h', w', 3], target_hw)``. An upscale (the resized area
      larger than the original's) ships the original pixels with the
      target ``(h, w)`` for `device_resize_uint8`; a downscale keeps the
      host resize, the smaller image to ship, with ``None``.
    """
    if device_resize and not device_normalize:
        raise ValueError("device_resize requires device_normalize")
    img = read_image(path)
    if not device_normalize:
        return preprocess_image(img, image_size, k_size, grid_multiple)
    h, w = quantized_resize_shape(img.shape[0], img.shape[1], image_size,
                                  k_size, grid_multiple)
    if device_resize and h * w > img.shape[0] * img.shape[1]:
        return to_uint8_image(img)[None], (h, w)  # upscale: ship the original
    resized = to_uint8_image(resize_bilinear_np(img, h, w))[None]
    return (resized, None) if device_resize else resized


def device_resize_uint8(img, out_h, out_w):
    """uint8 ``[..., h, w, 3]`` on its device -> the align-corners bilinear
    resize to ``(out_h, out_w)`` in float32, clipped to [0, 255], rounded
    half to even and cast back to uint8 (the host route's
    `to_uint8_image` of `resize_bilinear_np`, up to float rounding at
    ``.5``: at most one gray level on a few pixels)."""
    out = resize_bilinear_align_corners(img.to(torch.float32), out_h, out_w)
    return torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)


def make_match_fn(config, mesh=None, softmax=True, device_preprocess=False,
                  concat_directions=False, from_features=False):
    """`ncnet_tpu_torch.models.immatchnet.make_match_fn` (both directions'
    matches of one pair batch, ``(fwd, rev)`` or with
    ``concat_directions`` one ``[5, b, n_fwd + n_rev]`` tensor), with the
    JAX package's signature. ``device_preprocess``: the images come as
    uint8 and are ImageNet-normalized on their device first.
    ``from_features``: ``src`` / ``tgt`` are ``[1, fh, fw, c]`` trunk
    features (the gallery store's) and the forward runs no trunk op; it
    takes no ``device_preprocess`` (`ValueError`). A mesh is not ported
    (raises)."""
    if mesh is not None:
        raise NotImplementedError(
            "a spatial mesh (the correlation pipeline sharded over A-grid "
            "rows) is not ported yet (ROADMAP A13)"
        )
    if from_features and device_preprocess:
        raise ValueError(
            "from_features match fns take feature maps, not images; "
            "device_preprocess does not apply"
        )
    fn = immatchnet.make_match_fn(config, softmax=softmax,
                                  concat_directions=concat_directions,
                                  from_features=from_features)
    if not device_preprocess:
        return fn

    def normalized(model, src, tgt):
        return fn(model, device_normalize(src), device_normalize(tgt))

    return normalized


def recenter(coord, n_cells):
    """Normalized [0, 1] grid coordinates -> feature-cell centres
    (eval_inloc.py:179-189)."""
    return coord * (n_cells - 1) / n_cells + 0.5 / n_cells


def match_pair(match_fn, model, src, tgt, k_size, stride=16,
               both_directions=True, flip_direction=False, dedup=True,
               precomputed=None, shapes=None):
    """``(xA, yA, xB, yB, score)`` numpy arrays for one image pair.

    ``precomputed``: the output of an earlier ``match_fn`` call (the
    ``(fwd, rev)`` pair, or a ``concat_directions`` tensor, which implies
    ``both_directions``); ``shapes``: ``(src.shape, tgt.shape)`` in place
    of the images. Both directions are sorted by descending score and
    deduplicated on their coordinates (the first, highest-scored row of a
    duplicate survives), then recentred on the fine grid's cells.
    """
    src_shape, tgt_shape = shapes if shapes else (src.shape, tgt.shape)
    k = max(k_size, 1)
    fs1 = src_shape[1] // stride // k
    fs2 = src_shape[2] // stride // k
    fs3 = tgt_shape[1] // stride // k
    fs4 = tgt_shape[2] // stride // k
    if precomputed is not None:
        out = precomputed
    else:
        with torch.inference_mode():
            out = match_fn(model, src, tgt)
    if isinstance(out, (tuple, list)):
        fwd, rev = out
        if both_directions:
            parts = torch.cat([fwd, rev], dim=2)
        else:
            parts = rev if flip_direction else fwd
    else:
        if not both_directions:
            raise ValueError(
                "combined [5, b, n] match output implies both_directions; "
                "pass both_directions=True or use a non-concat match fn"
            )
        parts = out
    xa, ya, xb, yb, score = parts.cpu().numpy()[:, 0]

    if both_directions:
        order = np.argsort(-score)  # descending; keeps max-score dup first
        xa, ya, xb, yb, score = (v[order] for v in (xa, ya, xb, yb, score))
        if dedup:
            coords = np.stack([xa, ya, xb, yb])
            _, uniq = np.unique(coords, axis=1, return_index=True)
            xa, ya, xb, yb, score = (v[uniq] for v in (xa, ya, xb, yb, score))

    ya = recenter(ya, fs1 * k)
    xa = recenter(xa, fs2 * k)
    yb = recenter(yb, fs3 * k)
    xb = recenter(xb, fs4 * k)
    return xa, ya, xb, yb, score


def _atomic_savemat(out_path, payload):
    """savemat into a temporary name, then an atomic rename: resume treats
    any existing ``<q+1>.mat`` as complete, so a crash mid-write must
    never leave a file under the final name."""
    from scipy.io import savemat

    tmp = f"{out_path}.tmp.{os.getpid()}"
    try:
        savemat(tmp, payload, do_compression=True)
        os.replace(tmp, out_path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _clean_stale_temps(output_dir):
    """Remove the ``.mat.tmp.<pid>`` files of killed runs, but not those of
    a dump that is still running in the same directory."""
    for stale in os.listdir(output_dir):
        if ".mat.tmp." not in stale:
            continue
        try:
            owner = int(stale.rsplit(".", 1)[-1])
            os.kill(owner, 0)  # raises if no such process
            continue  # the owner is alive: leave its file alone
        except (ValueError, ProcessLookupError):
            pass
        except PermissionError:
            continue  # a process of another user: leave it
        try:
            os.unlink(os.path.join(output_dir, stale))
        except FileNotFoundError:
            pass  # a concurrent start already removed it


def n_match_slots(image_size, k_size, both_directions):
    """The fixed slot count of the .mat contract (eval_inloc.py:116-118)."""
    g = image_size * SCALE_FACTOR / k_size
    n = int(g * np.floor(g * (3 / 4)))
    return 2 * n if both_directions else n


def dump_matches(model, config, shortlist_path, query_path, pano_path,
                 output_dir, image_size=3200, n_queries=356, n_panos=10,
                 both_directions=True, flip_direction=False, verbose=True,
                 mesh=None, softmax=True, device_preprocess=False,
                 device_resize=False, feature_store_dir=None,
                 read_image=load_image):
    """Write ``<output_dir>/<q+1>.mat`` for each of the first ``n_queries``
    queries of the shortlist ``.mat``, matched against its first
    ``n_panos`` panos on ``model``'s device.

    A query whose ``.mat`` exists is skipped (resume); each file is written
    under a temporary name and renamed into place, and the temporary files
    of killed runs are removed at the start. ``read_image(path)`` decodes
    an image file to ``[h, w, 3]`` 0..255 (default: PIL through
    `load_image`). ``device_preprocess`` ships uint8 images normalized on
    the card, ``device_resize`` (needs it) upscales there too
    (`load_and_preprocess`). ``feature_store_dir``: match from a gallery
    feature store there (`_dump_from_store`; not with ``mesh``,
    ``device_preprocess`` or ``device_resize``: `ValueError`). Returns
    ``{'written': [...], 'skipped': [...], 'pairs': n}`` (query numbers,
    1-based), from a store also ``'panos_extracted'``.
    """
    from scipy.io import loadmat

    if feature_store_dir is not None and (
            mesh is not None or device_preprocess or device_resize):
        raise ValueError(
            "feature_store_dir is incompatible with mesh/device_preprocess/"
            "device_resize (the gallery-store dump ships features, not "
            "images)"
        )
    if device_resize and not device_preprocess:
        raise ValueError(
            "device_resize requires device_preprocess (the uint8 wire "
            "format + on-device ImageNet normalization)"
        )
    k_size = config.relocalization_k_size
    stride = model.feature_extraction.stride
    if stride != int(1 / SCALE_FACTOR):
        raise ValueError(
            f"backbone stride {stride} does not match the dump's "
            f"SCALE_FACTOR {SCALE_FACTOR}; the .mat coordinate contract "
            "assumes the reference's 1/16 feature stride"
        )
    match_fn = make_match_fn(config, mesh=mesh, softmax=softmax,
                             device_preprocess=device_preprocess,
                             concat_directions=both_directions,
                             from_features=feature_store_dir is not None)
    db = loadmat(shortlist_path)["ImgList"][0, :]
    pano_fn_all = np.vstack(tuple(db[q][1] for q in range(len(db))))
    os.makedirs(output_dir, exist_ok=True)
    _clean_stale_temps(output_dir)
    n_slots = n_match_slots(image_size, k_size, both_directions)
    if feature_store_dir is not None:
        return _dump_from_store(
            model, config, match_fn, db, pano_fn_all, query_path, pano_path,
            output_dir, image_size, n_queries, n_panos, n_slots,
            both_directions, flip_direction, verbose, feature_store_dir,
            read_image)

    def image(root, fn):
        out = load_and_preprocess(os.path.join(root, fn), image_size, k_size,
                                  device_normalize=device_preprocess,
                                  device_resize=device_resize,
                                  read_image=read_image)
        arr, target_hw = out if device_resize else (out, None)
        t = torch.from_numpy(arr).to(model.device)
        return t if target_hw is None else device_resize_uint8(t, *target_hw)

    done = {"written": [], "skipped": [], "pairs": 0}
    for q in range(n_queries):
        out_path = os.path.join(output_dir, f"{q + 1}.mat")
        if os.path.exists(out_path):  # resumable, unlike the reference
            done["skipped"].append(q + 1)
            continue
        src = image(query_path, _to_str(db[q][0]))
        matches = np.zeros((1, n_panos, n_slots, 5))
        for idx in range(n_panos):
            tgt = image(pano_path, _to_str(db[q][1].ravel()[idx]))
            xa, ya, xb, yb, score = match_pair(
                match_fn, model, src, tgt, k_size, stride, both_directions,
                flip_direction,
            )
            n = min(len(xa), n_slots)
            for col, v in enumerate((xa, ya, xb, yb, score)):
                matches[0, idx, :n, col] = v[:n]
            done["pairs"] += 1
        _atomic_savemat(out_path, {"matches": matches,
                                   "query_fn": _to_str(db[q][0]),
                                   "pano_fn": pano_fn_all})
        done["written"].append(q + 1)
        if verbose:
            print(f"query {q + 1}/{n_queries} -> {out_path}", flush=True)
    return done


def _dump_from_store(model, config, match_fn, db, pano_fn_all, query_path,
                     pano_path, output_dir, image_size, n_queries, n_panos,
                     n_slots, both_directions, flip_direction, verbose,
                     feature_store_dir, read_image):
    """`dump_matches` from a gallery feature store (the JAX package's
    ``_dump_matches_from_store``): one trunk forward a query; a pano's
    features from the store, keyed by its shortlist name, extracted on its
    first visit only. A cached pano is not read from disk: its shard gives
    its grid, and the .mat's coordinates need only the grid times the
    stride."""
    k_size = config.relocalization_k_size
    stride = model.feature_extraction.stride
    store = GalleryFeatureStore.open_or_create(
        feature_store_dir,
        trunk_digest(bridge.to_jax_params(model)["feature_extraction"],
                     config, None),
        config)
    extract = make_batch_extractor(model, config)

    def extract_from_disk(root, fn):
        return extract(load_and_preprocess(os.path.join(root, fn), image_size,
                                           k_size, read_image=read_image))

    done = {"written": [], "skipped": [], "pairs": 0, "panos_extracted": 0}

    def pano_features(fn):
        if store.has(fn):
            return store.get(fn).to(model.device)
        feats = extract_from_disk(pano_path, fn)
        store.put(fn, feats)
        done["panos_extracted"] += 1
        return feats

    def image_shape(feats):
        return (1, feats.shape[1] * stride, feats.shape[2] * stride, 3)

    for q in range(n_queries):
        out_path = os.path.join(output_dir, f"{q + 1}.mat")
        if os.path.exists(out_path):  # resumable, as the image route
            done["skipped"].append(q + 1)
            continue
        qfeat = extract_from_disk(query_path, _to_str(db[q][0]))
        matches = np.zeros((1, n_panos, n_slots, 5))
        for idx in range(n_panos):
            pfeat = pano_features(_to_str(db[q][1].ravel()[idx]))
            xa, ya, xb, yb, score = match_pair(
                match_fn, model, qfeat, pfeat, k_size, stride,
                both_directions, flip_direction,
                shapes=(image_shape(qfeat), image_shape(pfeat)))
            n = min(len(xa), n_slots)
            for col, v in enumerate((xa, ya, xb, yb, score)):
                matches[0, idx, :n, col] = v[:n]
            done["pairs"] += 1
        _atomic_savemat(out_path, {"matches": matches,
                                   "query_fn": _to_str(db[q][0]),
                                   "pano_fn": pano_fn_all})
        done["written"].append(q + 1)
        if verbose:
            print(f"query {q + 1}/{n_queries} -> {out_path}", flush=True)
    return done


def experiment_name(shortlist, image_size, k_size, both_directions,
                    flip_direction, softmax, checkpoint):
    """The reference's output folder name (eval_inloc.py:55-68)."""
    exp = os.path.basename(shortlist).split(".")[0]
    exp += f"_SZ_NEW_{image_size}_K_{k_size}"
    # both_directions takes precedence over flip (the reference's if/elif)
    exp += "_BOTHDIRS" if both_directions else (
        "_AtoB" if flip_direction else "_BtoA")
    if softmax:
        exp += "_SOFTMAX"
    if checkpoint:
        exp += "_CHECKPOINT_" + os.path.basename(checkpoint).split(".")[0]
    return exp


def _str2bool(v):
    return str(v).lower() in ("1", "true", "yes", "y")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ncnet_tpu_torch InLoc match dump")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="reference .pth.tar, the port's training .npz or "
                        "the JAX package's .msgpack")
    p.add_argument("--inloc_shortlist", type=str,
                   default="datasets/inloc/densePE_top100_shortlist_cvpr18.mat")
    p.add_argument("--k_size", type=int, default=2)
    p.add_argument("--image_size", type=int, default=3200)
    p.add_argument("--n_queries", type=int, default=356)
    p.add_argument("--n_panos", type=int, default=10)
    p.add_argument("--softmax", type=_str2bool, default=True)
    p.add_argument("--matching_both_directions", type=_str2bool, default=True)
    p.add_argument("--flip_matching_direction", type=_str2bool, default=False)
    p.add_argument("--pano_path", type=str, default="datasets/inloc/pano/")
    p.add_argument("--query_path", type=str,
                   default="datasets/inloc/query/iphone7/")
    p.add_argument("--output_root", type=str, default="matches")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bfloat16 features / correlation / NC (default on)")
    p.add_argument("--conv4d_impl", type=str, default="cfs",
                   help="the JAX package's conv4d lowering; recorded in "
                        "the config and unread (the port has one conv4d)")
    p.add_argument("--device_preprocess", type=_str2bool, default=False,
                   help="ship uint8 images and ImageNet-normalize them on "
                        "the card (scripts/eval_inloc.py's default is true)")
    p.add_argument("--device_resize", type=_str2bool, default=None,
                   help="with --device_preprocess: ship upscaled images "
                        "(the panos) at their original size and resize them "
                        "on the card; unset follows --device_preprocess")
    p.add_argument("--feature-store", type=str, default=None,
                   dest="feature_store", metavar="DIR",
                   help="gallery feature store: each pano's trunk features "
                        "are extracted once ever (across queries and runs) "
                        "into DIR under the trunk's digest, the query's once "
                        "a query; a store of another trunk raises. Turns "
                        "--device_preprocess / --device_resize off (the "
                        "store route ships features, not images)")
    p.add_argument("--refine", type=int, default=None, metavar="R",
                   help="coarse-to-fine refinement (ncnet_tpu_torch.refine): "
                        "pool features by R, run the coarse band at "
                        "--refine_topk, re-score the survivors at full "
                        "resolution. Requires --k_size 1 (refinement "
                        "replaces the 4D max-pool relocalization). 0 forces "
                        "it off; unset keeps the checkpoint's value")
    p.add_argument("--refine_topk", type=int, default=None, metavar="K",
                   help="with --refine: coarse-band width")
    p.add_argument("--refine_radius", type=int, default=None,
                   help="with --refine: extra window reach in coarse cells")
    p.add_argument("--spatial_shards", type=int, default=0,
                   help="not ported beyond 1 (ROADMAP A13)")
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (the run fails without a card)")
    return p.parse_args(argv)


def main(argv=None):
    from ncnet_tpu_torch.convert import load_model
    from ncnet_tpu_torch.device import resolve_device
    from ncnet_tpu_torch.eval.pf_pascal import apply_refine_flags

    args = parse_args(argv)
    if args.spatial_shards > 1:
        raise NotImplementedError(
            "--spatial_shards: the spatial mesh is not ported yet (ROADMAP A13)"
        )
    if args.device_resize is None:
        args.device_resize = args.device_preprocess
    if args.device_resize and not args.device_preprocess:
        raise ValueError("--device_resize requires --device_preprocess")
    if args.feature_store:
        # the store route ships features: the image transfer route is moot
        args.device_preprocess = args.device_resize = False
    device = resolve_device(args.device)
    config, model = load_model(args.checkpoint, device=device)
    config = apply_refine_flags(
        config.replace(half_precision=args.bf16,
                       relocalization_k_size=args.k_size,
                       conv4d_impl=args.conv4d_impl), args)
    if config.refine_factor and args.k_size > 1:
        # the flag's factor or the checkpoint's: refused at the flag
        # boundary, not deep in the first forward
        raise SystemExit(
            f"--refine {config.refine_factor} requires --k_size 1 (refinement "
            "replaces the 4D-maxpool relocalization)"
        )
    out_dir = os.path.join(args.output_root, experiment_name(
        args.inloc_shortlist, args.image_size, args.k_size,
        args.matching_both_directions, args.flip_matching_direction,
        args.softmax, args.checkpoint))
    print(f"Output matches folder: {out_dir}")
    t0 = time.perf_counter()
    done = dump_matches(
        model, config,
        shortlist_path=args.inloc_shortlist,
        query_path=args.query_path,
        pano_path=args.pano_path,
        output_dir=out_dir,
        image_size=args.image_size,
        n_queries=args.n_queries,
        n_panos=args.n_panos,
        both_directions=args.matching_both_directions,
        flip_direction=(args.flip_matching_direction
                        and not args.matching_both_directions),
        softmax=args.softmax,
        device_preprocess=args.device_preprocess,
        device_resize=args.device_resize,
        feature_store_dir=args.feature_store,
    )
    seconds = time.perf_counter() - t0
    report = {"output_dir": out_dir, **done, "seconds": seconds,
              "n_slots": n_match_slots(args.image_size, args.k_size,
                                       args.matching_both_directions),
              "config": config.to_dict(), "device": str(device)}
    print(json.dumps(report, sort_keys=True))
    return report


if __name__ == "__main__":
    main()
