"""Durable on-disk store of precomputed trunk features
(``ncnet_tpu/features/store.py``, its on-disk format byte for byte).

With the trunk frozen, its forward over a fixed dataset is a
parameter-constant computation; this store makes it a one-time cost. One
shard per image (a pair's source and target are separate shards), float32
or bfloat16, each written with the `ncnet_tpu_torch.resilience.durable`
discipline (temp + fsync + atomic rename + a ``<path>.sha256`` sidecar
checked at read), so a killed extraction never leaves a torn shard and
bitrot is detected instead of trained on.

A shard is a 4-byte little-endian header length, the header (JSON
``{"shape": [...], "dtype": name}``), then the raw little-endian bytes.
bfloat16 shards are read and written as their raw 2-byte words through
``torch.int16`` viewed as ``torch.bfloat16`` (no ``ml_dtypes``); shards
come back as CPU tensors. The manifest (``manifest.json``, sorted keys,
indent 1) records a digest over the trunk's parameter values, the cnn,
the image size, the feature dtype and the normalize/center flags
(`trunk_digest`, the JAX package's hex digest for the same weights).
Opening a store under another digest raises `FeatureCacheMismatch`: a
stale cache is rejected, never reused. A store either package writes
opens and reads in the other.

Disk (PF-Pascal train, 400 px, ResNet-101 to layer3): 25x25x1024
features are 1.28 MB an image in bfloat16.
"""

import hashlib
import json
import os

import numpy as np
import torch

from ncnet_tpu_torch.resilience import durable
from ncnet_tpu_torch.train.jax_checkpoint import msgpack_serialize

MANIFEST_NAME = "manifest.json"
STORE_VERSION = 1

#: on-disk dtype name -> (tensor dtype, the numpy dtype of its raw words)
_DTYPES = {"float32": (torch.float32, np.dtype("<f4")),
           "bfloat16": (torch.bfloat16, np.dtype("<i2"))}


class FeatureCacheMismatch(RuntimeError):
    """The cache on disk was extracted under a different trunk/config."""


def torch_dtype(name):
    """The tensor dtype of an on-disk dtype name."""
    if name not in _DTYPES:
        raise ValueError(
            f"unsupported feature dtype {name!r}; have {tuple(_DTYPES)}")
    return _DTYPES[name][0]


def feature_dtype_name(config):
    """The on-disk dtype a config's extraction produces (`extract_features`:
    bfloat16 under ``half_precision``, else float32)."""
    return "bfloat16" if config.half_precision else "float32"


def trunk_digest(fe_params, config, image_size):
    """SHA-256 hex digest of everything that determines the extracted
    feature bytes: the trunk's parameter values (``fe_params``, the JAX
    layout tree, e.g. ``bridge.to_jax_params(model)['feature_extraction']``),
    hashed as the msgpack bytes flax writes of them, then the JSON (sorted
    keys) of the cnn, the image size, the feature dtype and the
    normalize/center flags.

    ``image_size=None`` means size-agnostic (gallery stores, whose shards
    each describe their own shape)."""
    h = hashlib.sha256(msgpack_serialize(fe_params))
    h.update(json.dumps({
        "cnn": config.feature_extraction_cnn,
        "image_size": (None if image_size is None
                       else [int(s) for s in image_size]),
        "feature_dtype": feature_dtype_name(config),
        "normalize_features": bool(config.normalize_features),
        "center_features": bool(config.center_features),
    }, sort_keys=True).encode("ascii"))
    return h.hexdigest()


def _encode_shard(arr, dtype_name):
    """Self-describing shard bytes of ``arr`` (a tensor on any device, or a
    float32 numpy array)."""
    want = torch_dtype(dtype_name)
    t = torch.as_tensor(arr)
    if t.dtype != want:
        raise ValueError(
            f"shard dtype {t.dtype} does not match the store's "
            f"{dtype_name!r}; extract with the matching config instead of "
            "casting (a silent cast would hide config drift)")
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    head = json.dumps({"shape": list(t.shape), "dtype": dtype_name}).encode("ascii")
    raw = t.numpy().astype(_DTYPES[dtype_name][1], copy=False).tobytes()
    return len(head).to_bytes(4, "little") + head + raw


def _decode_shard(blob, dtype_name):
    hlen = int.from_bytes(blob[:4], "little")
    head = json.loads(blob[4:4 + hlen].decode("ascii"))
    if head["dtype"] != dtype_name:
        raise FeatureCacheMismatch(
            f"shard dtype {head['dtype']!r} does not match the manifest's "
            f"{dtype_name!r}")
    dtype, words = _DTYPES[dtype_name]
    arr = np.frombuffer(blob, dtype=words, offset=4 + hlen)
    t = torch.from_numpy(arr.astype(words.newbyteorder("="), copy=True))
    return t.view(dtype).reshape(head["shape"])


def _write_manifest(root, manifest):
    durable.durable_write_bytes(
        os.path.join(os.path.abspath(root), MANIFEST_NAME),
        json.dumps(manifest, sort_keys=True, indent=1).encode("ascii"))


def _read_manifest(root):
    path = os.path.join(os.path.abspath(root), MANIFEST_NAME)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no feature-cache manifest at {path}")
    return json.loads(durable.read_verified_bytes(path).decode("ascii"))


class FeatureStore:
    """One directory of per-image feature shards plus a digest manifest.

    Construct through `create` / `open_store` / `open_or_create`; the
    manifest and every shard go through durable writes."""

    def __init__(self, root, manifest):
        self.root = os.path.abspath(root)
        self.manifest = manifest

    @classmethod
    def create(cls, root, digest, config, image_size, num_items):
        manifest = {
            "version": STORE_VERSION,
            "digest": str(digest),
            "cnn": config.feature_extraction_cnn,
            "image_size": [int(s) for s in image_size],
            "feature_dtype": feature_dtype_name(config),
            "normalize_features": bool(config.normalize_features),
            "center_features": bool(config.center_features),
            "num_items": int(num_items),
        }
        torch_dtype(manifest["feature_dtype"])  # validates the name
        _write_manifest(root, manifest)
        return cls(root, manifest)

    @classmethod
    def open_store(cls, root, expected_digest=None, num_items=None):
        """Open an existing store. Raises ``FileNotFoundError`` without a
        manifest, `FeatureCacheMismatch` when it was written under another
        digest or for another dataset size, and
        ``durable.IntegrityError`` on a corrupt manifest."""
        manifest = _read_manifest(root)
        if expected_digest is not None and manifest.get("digest") != str(
                expected_digest):
            raise FeatureCacheMismatch(
                f"feature cache at {root} was extracted under digest "
                f"{manifest.get('digest')!r}, but the current trunk/config "
                f"digests to {expected_digest!r} (trunk weights, backbone, "
                "image size, feature dtype, or normalize/center flags "
                "changed). Re-extract into a fresh directory — training on "
                "stale features would silently learn noise.")
        if num_items is not None and int(manifest.get("num_items", -1)) != int(
                num_items):
            raise FeatureCacheMismatch(
                f"feature cache at {root} holds {manifest.get('num_items')} "
                f"items but the dataset has {num_items}; the cache belongs "
                "to a different dataset")
        return cls(root, manifest)

    @classmethod
    def open_or_create(cls, root, digest, config, image_size, num_items):
        """Open a matching store, or create an empty one when there is no
        manifest; an existing manifest with another digest raises."""
        try:
            return cls.open_store(root, expected_digest=digest,
                                  num_items=num_items)
        except FileNotFoundError:
            return cls.create(root, digest, config, image_size, num_items)

    @property
    def num_items(self):
        return int(self.manifest["num_items"])

    @property
    def dtype(self):
        return torch_dtype(self.manifest["feature_dtype"])

    def shard_path(self, idx, role):
        if role not in ("source", "target"):
            raise ValueError(f"unknown shard role {role!r}")
        return os.path.join(self.root, f"{int(idx):08d}.{role}.feat")

    def has(self, idx):
        return all(os.path.exists(self.shard_path(idx, r))
                   for r in ("source", "target"))

    def missing(self):
        """Indices without both shards: the lazy fill's worklist."""
        return [i for i in range(self.num_items) if not self.has(i)]

    def complete(self):
        return not self.missing()

    def put(self, idx, source_features, target_features):
        """Durably write one pair's shards (an idempotent rewrite)."""
        name = self.manifest["feature_dtype"]
        for role, arr in (("source", source_features),
                          ("target", target_features)):
            durable.durable_write_bytes(self.shard_path(idx, role),
                                        _encode_shard(arr, name))

    def get(self, idx):
        """One pair's ``(source, target)`` features as CPU tensors,
        digest-checked (``durable.IntegrityError`` on bitrot)."""
        name = self.manifest["feature_dtype"]
        return tuple(
            _decode_shard(durable.read_verified_bytes(self.shard_path(idx, r)),
                          name)
            for r in ("source", "target"))

    def shard_nbytes(self, idx=0):
        """On-disk size of one pair (both shards)."""
        return sum(os.path.getsize(self.shard_path(idx, r))
                   for r in ("source", "target"))


class GalleryFeatureStore:
    """Path-keyed trunk-feature store for retrieval galleries (InLoc,
    serving): each image's features are one durable shard keyed by a
    digest of its key (path or name), under a manifest pinned to the trunk
    digest without the image size (each shard describes its own shape).
    Opening it under another trunk digest raises `FeatureCacheMismatch`."""

    def __init__(self, root, manifest):
        self.root = os.path.abspath(root)
        self.manifest = manifest

    @classmethod
    def create(cls, root, digest, config):
        manifest = {
            "version": STORE_VERSION,
            "kind": "gallery",
            "digest": str(digest),
            "cnn": config.feature_extraction_cnn,
            "feature_dtype": feature_dtype_name(config),
            "normalize_features": bool(config.normalize_features),
            "center_features": bool(config.center_features),
        }
        torch_dtype(manifest["feature_dtype"])  # validates the name
        _write_manifest(root, manifest)
        return cls(root, manifest)

    @classmethod
    def open_store(cls, root, expected_digest=None):
        manifest = _read_manifest(root)
        if manifest.get("kind") != "gallery":
            raise FeatureCacheMismatch(
                f"feature cache at {root} is a "
                f"{manifest.get('kind', 'pair')!r} store, not a gallery "
                "store; point --feature-store at its own directory")
        if expected_digest is not None and manifest.get("digest") != str(
                expected_digest):
            raise FeatureCacheMismatch(
                f"gallery feature cache at {root} was extracted under "
                f"digest {manifest.get('digest')!r}, but the current "
                f"trunk/config digests to {expected_digest!r} (trunk "
                "weights, backbone, feature dtype, or normalize/center "
                "flags changed). Re-extract into a fresh directory — "
                "matching against stale features would silently produce "
                "noise.")
        return cls(root, manifest)

    @classmethod
    def open_or_create(cls, root, digest, config):
        """Open a matching store, or create an empty one; an existing
        manifest with another digest raises."""
        try:
            return cls.open_store(root, expected_digest=digest)
        except FileNotFoundError:
            return cls.create(root, digest, config)

    def shard_path(self, image_path):
        key = hashlib.sha256(str(image_path).encode("utf-8")).hexdigest()
        return os.path.join(self.root, f"{key[:32]}.feat")

    def has(self, image_path):
        return os.path.exists(self.shard_path(image_path))

    def put(self, image_path, features):
        """Durably write one image's features (an idempotent rewrite)."""
        durable.durable_write_bytes(
            self.shard_path(image_path),
            _encode_shard(features, self.manifest["feature_dtype"]))

    def get(self, image_path):
        """One image's features as a CPU tensor, digest-checked."""
        return _decode_shard(
            durable.read_verified_bytes(self.shard_path(image_path)),
            self.manifest["feature_dtype"])


# multi-resolution stores (refinement): one trunk pass, two resolutions


def pooled_digest(base_digest, factor):
    """Digest of the pooled tier derived from a full-resolution tier's: the
    pooled features are a function of the full-resolution ones
    (`ncnet_tpu_torch.refine.pool.pool_features`), so a change that
    re-digests the fine tier re-digests the pooled one."""
    if int(factor) < 1:
        raise ValueError(f"pool factor must be >= 1, got {factor}")
    h = hashlib.sha256(str(base_digest).encode("ascii"))
    h.update(f":avgpool{int(factor)}".encode("ascii"))
    return h.hexdigest()


class MultiResFeatureStore:
    """Two digest-linked pair stores: ``root/hi`` (the trunk features under
    the trunk digest) and ``root/lo{factor}`` (their pool under
    `pooled_digest`). Both tiers of a pair are written by one `put`, and
    `missing` lists a pair until both hold it."""

    def __init__(self, hi, lo, factor):
        self.hi = hi
        self.lo = lo
        self.factor = int(factor)

    @staticmethod
    def _roots(root, factor):
        root = os.path.abspath(root)
        return os.path.join(root, "hi"), os.path.join(root, f"lo{int(factor)}")

    @classmethod
    def create(cls, root, digest, config, image_size, num_items, factor):
        hi_root, lo_root = cls._roots(root, factor)
        hi = FeatureStore.create(hi_root, digest, config, image_size, num_items)
        lo = FeatureStore.create(lo_root, pooled_digest(digest, factor),
                                 config, image_size, num_items)
        return cls(hi, lo, factor)

    @classmethod
    def open_store(cls, root, factor, expected_digest=None, num_items=None):
        hi_root, lo_root = cls._roots(root, factor)
        hi = FeatureStore.open_store(hi_root, expected_digest=expected_digest,
                                     num_items=num_items)
        lo = FeatureStore.open_store(
            lo_root,
            expected_digest=(None if expected_digest is None
                             else pooled_digest(expected_digest, factor)),
            num_items=num_items)
        return cls(hi, lo, factor)

    @classmethod
    def open_or_create(cls, root, digest, config, image_size, num_items,
                       factor):
        """Open a matching two-tier store, or create an empty one; an
        existing manifest with another digest (either tier) raises."""
        try:
            return cls.open_store(root, factor, expected_digest=digest,
                                  num_items=num_items)
        except FileNotFoundError:
            return cls.create(root, digest, config, image_size, num_items,
                              factor)

    @property
    def num_items(self):
        return self.hi.num_items

    @property
    def dtype(self):
        return self.hi.dtype

    def has(self, idx):
        return self.hi.has(idx) and self.lo.has(idx)

    def missing(self):
        return [i for i in range(self.num_items) if not self.has(i)]

    def complete(self):
        return not self.missing()

    def put(self, idx, source_hi, target_hi, source_lo, target_lo):
        """Durably write one pair at both resolutions (idempotent)."""
        self.hi.put(idx, source_hi, target_hi)
        self.lo.put(idx, source_lo, target_lo)

    def get(self, idx):
        """``((source_hi, target_hi), (source_lo, target_lo))``."""
        return self.hi.get(idx), self.lo.get(idx)


class MultiResGalleryFeatureStore:
    """`GalleryFeatureStore` in the two-tier layout."""

    def __init__(self, hi, lo, factor):
        self.hi = hi
        self.lo = lo
        self.factor = int(factor)

    @classmethod
    def open_or_create(cls, root, digest, config, factor):
        hi_root, lo_root = MultiResFeatureStore._roots(root, factor)
        hi = GalleryFeatureStore.open_or_create(hi_root, digest, config)
        lo = GalleryFeatureStore.open_or_create(
            lo_root, pooled_digest(digest, factor), config)
        return cls(hi, lo, factor)

    def has(self, image_path):
        return self.hi.has(image_path) and self.lo.has(image_path)

    def put(self, image_path, features_hi, features_lo):
        self.hi.put(image_path, features_hi)
        self.lo.put(image_path, features_lo)

    def get(self, image_path):
        """``(features_hi, features_lo)``, each digest-checked."""
        return self.hi.get(image_path), self.lo.get(image_path)
