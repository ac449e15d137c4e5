"""Image-pair datasets for training (``ncnet_tpu/data/pairs.py``).

* `ImagePairDataset` (reference lib/im_pair_dataset.py:11-93): CSV rows
  ``source_image,target_image,class,flip`` under an image root, optional
  horizontal flip per row and reference random crop, resized to a square
  training size.
* `SyntheticPairDataset`: generated pairs for runs without image data;
  seeded exactly as the JAX package's, so both give the same pairs.

Datasets are plain indexable objects returning numpy dicts; batching lives
in `ncnet_tpu_torch.data.loader`.
"""

import csv
import os

import numpy as np

from ncnet_tpu_torch.data.images import (
    load_image,
    normalize_image_np,
    resize_bilinear_np,
    to_uint8_image,
)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


class ImagePairDataset:
    """Weak-supervision training pairs."""

    def __init__(self, csv_file, dataset_path, output_size=(400, 400),
                 random_crop=False, normalize=True, seed=0,
                 uint8_output=False):
        """``uint8_output=True`` returns resized images as uint8 without
        normalization; the loss ImageNet-normalizes uint8 batches on the
        device."""
        if uint8_output and normalize:
            normalize = False
        self.header, self.rows = _read_csv(csv_file)
        self.dataset_path = dataset_path
        self.out_h, self.out_w = output_size
        self.random_crop = random_crop
        self.normalize = normalize
        self.uint8_output = uint8_output
        self.seed = seed

    def __len__(self):
        return len(self.rows)

    def _load(self, name, flip, crop_rng):
        img = load_image(os.path.join(self.dataset_path, name))
        if crop_rng is not None:
            # reference crop (lib/im_pair_dataset.py:68-74): corners in the
            # outer quarters, so the window is always >= half size
            h, w = img.shape[:2]
            top = crop_rng.randint(max(h // 4, 1))
            bottom = int(3 * h / 4 + crop_rng.randint(max(h // 4, 1)))
            left = crop_rng.randint(max(w // 4, 1))
            right = int(3 * w / 4 + crop_rng.randint(max(w // 4, 1)))
            img = img[top:bottom, left:right]
        if flip:
            img = img[:, ::-1]
        img = resize_bilinear_np(img, self.out_h, self.out_w)
        if self.uint8_output:
            return to_uint8_image(img)
        if self.normalize:
            img = normalize_image_np(img)
        return img

    def __getitem__(self, idx):
        row = self.rows[idx]
        flip = bool(int(float(row[3]))) if len(row) > 3 else False
        # per-sample RNG from (seed, idx): the same for any worker count
        crop_rng = (
            np.random.RandomState((self.seed * 100003 + idx) % (2**31))
            if self.random_crop else None
        )
        return {
            "source_image": self._load(row[0], flip, crop_rng),
            "target_image": self._load(row[1], flip, crop_rng),
            "set_class": np.float32(float(row[2])) if len(row) > 2 else np.float32(0),
        }


class SyntheticPairDataset:
    """Generated pairs: the target is the source rolled horizontally by a
    random shift, so a trained model has a known cyclic correspondence to
    learn (source pixel (x, y) appears at target (x + shift mod W, y))."""

    def __init__(self, n=256, output_size=(400, 400), seed=0,
                 return_shift=False, granularity=8):
        """``granularity``: pixel scale of the noise texture (base noise is
        upsampled by this factor)."""
        self.n = n
        self.out_h, self.out_w = output_size
        self.seed = seed
        self.return_shift = return_shift
        self.granularity = granularity

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed * 100003 + idx)
        # clamp so tiny output sizes still get a >= 1-cell base texture
        g = min(self.granularity, self.out_h, self.out_w)
        base = rng.rand(self.out_h // g, self.out_w // g, 3).astype(np.float32)
        img = resize_bilinear_np(base * 255.0, self.out_h, self.out_w)
        shift = rng.randint(0, self.out_w // 2)
        tgt = np.roll(img, shift, axis=1)
        out = {
            "source_image": normalize_image_np(img),
            "target_image": normalize_image_np(tgt),
            "set_class": np.float32(0),
        }
        if self.return_shift:
            out["shift"] = np.float32(shift)
        return out
