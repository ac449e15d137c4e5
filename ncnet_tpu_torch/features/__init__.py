"""The frozen-trunk feature cache (``ncnet_tpu/features``): trunk features
extracted once into a durable, digest-guarded store (`store`), filled
lazily or by ``python -m ncnet_tpu_torch.features`` (`extract`), and
consumed by training (``ncnet_tpu_torch.data.features_loader`` and the
``from_features`` steps), serving and the InLoc dump without running the
trunk again."""

from ncnet_tpu_torch.features.extract import (
    make_batch_extractor,
    make_multires_batch_extractor,
    populate_store,
    populate_store_multires,
)
from ncnet_tpu_torch.features.store import (
    FeatureCacheMismatch,
    FeatureStore,
    GalleryFeatureStore,
    MultiResFeatureStore,
    MultiResGalleryFeatureStore,
    feature_dtype_name,
    pooled_digest,
    trunk_digest,
)

__all__ = [
    "FeatureCacheMismatch",
    "FeatureStore",
    "GalleryFeatureStore",
    "MultiResFeatureStore",
    "MultiResGalleryFeatureStore",
    "feature_dtype_name",
    "make_batch_extractor",
    "make_multires_batch_extractor",
    "pooled_digest",
    "populate_store",
    "populate_store_multires",
    "trunk_digest",
]
