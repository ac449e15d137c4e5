"""Shape bucketing: the quantized-resize rule (copy of
``ncnet_tpu/serve/buckets.py``).

Every distinct input shape is its own set of kernel launch shapes, so the
resize policy is the batching policy: two requests share a bucket iff
their quantized shapes coincide, and batching pairs within a bucket pads
only the batch dimension, never the spatial dims (spatial padding would
change the correlation support; batch padding is sliced away at readout).
"""

import dataclasses
from typing import Optional, Tuple

import numpy as np

SCALE_FACTOR = 0.0625  # 1/backbone stride (reference eval_inloc.py:77)


def quantized_resize_shape(h, w, image_size, k_size, grid_multiple=None):
    """The reference's resize rule (eval_inloc.py:84-89): max side ->
    ``image_size``, then quantize so feature-grid dims divide by
    ``grid_multiple`` (default: ``k_size``)."""
    m = grid_multiple if grid_multiple is not None else k_size
    ratio = max(h, w) / image_size
    if m <= 1:
        return int(h / ratio), int(w / ratio)
    s = SCALE_FACTOR
    return (
        int(np.floor(h / ratio * s / m) / s * m),
        int(np.floor(w / ratio * s / m) / s * m),
    )


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """The bucket universe: which quantized shape each raw image maps to.
    ``k_size`` <= 1 means no grid quantization beyond the integer resize."""

    image_size: int
    k_size: int = 1
    grid_multiple: Optional[int] = None

    def bucket(self, h, w) -> Tuple[int, int]:
        """Quantized (h, w) for a raw image of shape (h, w)."""
        return quantized_resize_shape(
            h, w, self.image_size, self.k_size, self.grid_multiple
        )


def pair_bucket(spec, src_hw, tgt_hw):
    """Bucket key for one (source, target) request: a pair of quantized
    shapes. Requests batch together iff their keys are equal."""
    return (spec.bucket(*src_hw), spec.bucket(*tgt_hw))


def request_buckets(spec, pair_shapes):
    """Sorted distinct `pair_bucket` keys over ``(src_hw, tgt_hw)`` raw
    shape pairs — the shape set to warm up."""
    return sorted({pair_bucket(spec, s, t) for s, t in pair_shapes})
