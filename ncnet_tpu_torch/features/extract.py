"""Populate a feature store by running the frozen trunk once
(``ncnet_tpu/features/extract.py``).

Used by the extraction CLI (``python -m ncnet_tpu_torch.features``) and
by the train CLI's lazy fill (``--feature-cache``): only the missing
shards are extracted, in batches on the model's device, so an interrupted
extraction resumes where it stopped and a populated store costs one
directory scan. Features are written in the dtype `extract_features`
gives (bfloat16 under ``half_precision``).
"""

import time

import torch

from ncnet_tpu_torch.data.images import imagenet_normalize
from ncnet_tpu_torch.models.immatchnet import extract_features
from ncnet_tpu_torch.refine.pool import pool_features


def _images_on(images, device):
    """A numpy or tensor image batch on ``device``: uint8 ImageNet-normalized
    there (the training loss's rule), float64 (the host resize) as float32."""
    t = torch.as_tensor(images).to(device)
    if t.dtype == torch.uint8:
        return imagenet_normalize(t.float())
    return t.float() if t.dtype == torch.float64 else t


def make_batch_extractor(model, config):
    """``[b, h, w, 3]`` image batch (numpy or tensor) -> the feature batch on
    ``model``'s device (no gradient)."""
    def extract(images):
        with torch.no_grad():
            return extract_features(model, config, _images_on(images, model.device))

    return extract


def make_multires_batch_extractor(model, config, factor):
    """``image batch -> (hi, lo)``: one trunk forward, the pooled tier
    (`pool_features`) derived from it on the device, so the two tiers come
    from the same pass."""
    base = make_batch_extractor(model, config)

    def extract(images):
        hi = base(images)
        with torch.no_grad():
            return hi, pool_features(hi, factor,
                                     normalize=config.normalize_features)

    return extract


def _groups(store, dataset, batch_size):
    """``(group, double batch)`` of every missing pair, ``batch_size`` at a
    time: the sources then the targets of one group as one trunk batch,
    the last group padded by repeating its last pair, so every extraction
    runs at one batch size."""
    if len(dataset) != store.num_items:
        # beside the manifest's num_items check: a store populated from
        # another dataset must not be topped up
        raise ValueError(
            f"dataset has {len(dataset)} items but the store manifest "
            f"records {store.num_items}")
    missing = store.missing()
    for lo in range(0, len(missing), batch_size):
        group = missing[lo:lo + batch_size]
        samples = [dataset[i] for i in group]
        samples += [samples[-1]] * (batch_size - len(group))
        images = [torch.as_tensor(s[key]) for key in ("source_image",
                                                      "target_image")
                  for s in samples]
        yield group, torch.stack(images)


def _log(done, total, t0, batch_size, log_every, tiers=""):
    if log_every and (done // batch_size) % log_every == 0:
        rate = done / max(time.perf_counter() - t0, 1e-9)
        print(f"[features] {done}/{total} pairs extracted ({rate:.1f} "
              f"pairs/s{tiers})", flush=True)


def _check_dtype(got, store):
    if got != store.dtype:
        raise RuntimeError(
            f"extractor produced {got} but the store holds {store.dtype}; "
            "the config does not match the manifest")


def populate_store(store, model, config, dataset, batch_size=8, log_every=0):
    """Extract and durably write every missing pair of ``store`` (a
    `FeatureStore`) with ``model``'s trunk; returns the number of pairs
    extracted (0 when the store was complete)."""
    total = len(store.missing())
    extract = make_batch_extractor(model, config)
    t0, done = time.perf_counter(), 0
    for group, images in _groups(store, dataset, batch_size):
        feats = extract(images)
        _check_dtype(feats.dtype, store)
        feats = feats.cpu()
        for j, idx in enumerate(group):
            store.put(idx, feats[j], feats[batch_size + j])
        done += len(group)
        _log(done, total, t0, batch_size, log_every)
    return done


def populate_store_multires(store, model, config, dataset, batch_size=8,
                            log_every=0):
    """`populate_store` for a `MultiResFeatureStore`: each missing pair gets
    both tiers from one trunk pass an image. Returns the pairs extracted."""
    total = len(store.missing())
    extract = make_multires_batch_extractor(model, config, store.factor)
    t0, done = time.perf_counter(), 0
    for group, images in _groups(store, dataset, batch_size):
        hi, low = extract(images)
        _check_dtype(hi.dtype, store)
        hi, low = hi.cpu(), low.cpu()
        for j, idx in enumerate(group):
            store.put(idx, hi[j], hi[batch_size + j], low[j],
                      low[batch_size + j])
        done += len(group)
        _log(done, total, t0, batch_size, log_every, ", 2 resolutions")
    return done
