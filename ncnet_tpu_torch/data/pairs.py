"""Image-pair datasets for training (``ncnet_tpu/data/pairs.py``).

* `ImagePairDataset` (reference lib/im_pair_dataset.py:11-93): CSV rows
  ``source_image,target_image,class,flip`` under an image root, optional
  horizontal flip per row and reference random crop, resized to a square
  training size.
* `PFPascalDataset` (reference lib/pf_dataset.py:11-112): evaluation
  pairs with semicolon-separated keypoint columns ``XA;YA;XB;YB`` (up to
  `MAX_KEYPOINTS`, -1-padded) and the PCK reference length of the 'pf'
  (max ground-truth bounding-box side) or 'scnet' (rescale to 224)
  procedure; `pf_pascal_sample` makes one sample from decoded arrays.
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


MAX_KEYPOINTS = 20


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


def _points(xs, ys):
    """``"x1;x2;..."``, ``"y1;y2;..."`` -> ``[2, MAX_KEYPOINTS]`` float32,
    -1-padded."""
    x = [float(v) for v in xs.split(";") if v.strip()]
    y = [float(v) for v in ys.split(";") if v.strip()]
    pts = -np.ones((2, MAX_KEYPOINTS), np.float32)
    pts[0, : len(x)] = x
    pts[1, : len(y)] = y
    return pts


def pf_pascal_sample(img_a, img_b, row, output_size=(400, 400),
                     pck_procedure="scnet", normalize=True):
    """One PF-Pascal sample from decoded ``[h, w, 3]`` 0..255 images and
    its CSV ``row`` (``source, target, class, XA, YA, XB, YB``): images
    resized (align-corners) to ``output_size`` and ImageNet-normalized,
    ``*_im_size``, ``*_points`` and ``L_pck`` as `PFPascalDataset` returns
    them."""
    out_h, out_w = output_size
    size_a = np.asarray(img_a.shape, np.float32)
    size_b = np.asarray(img_b.shape, np.float32)
    pts_a = _points(row[3], row[4])
    pts_b = _points(row[5], row[6])
    n_pts = int(np.sum(pts_a[0] != -1))
    if pck_procedure == "pf":
        l_pck = np.float32(np.max(
            pts_a[:, :n_pts].max(axis=1) - pts_a[:, :n_pts].min(axis=1)
        ))
    elif pck_procedure == "scnet":
        # SCNet protocol (lib/pf_dataset.py:66-75): points rescaled as if
        # the images were 224x224; L_pck = 224
        pts_a[0, :n_pts] *= 224 / size_a[1]
        pts_a[1, :n_pts] *= 224 / size_a[0]
        pts_b[0, :n_pts] *= 224 / size_b[1]
        pts_b[1, :n_pts] *= 224 / size_b[0]
        size_a[0:2] = 224
        size_b[0:2] = 224
        l_pck = np.float32(224.0)
    else:
        raise ValueError(f"unknown pck procedure {pck_procedure!r}")

    def prep(img):
        img = resize_bilinear_np(img, out_h, out_w)
        return normalize_image_np(img) if normalize else img

    return {
        "source_image": prep(img_a),
        "target_image": prep(img_b),
        "source_im_size": size_a[:3],
        "target_im_size": size_b[:3],
        "source_points": pts_a,
        "target_points": pts_b,
        "L_pck": np.asarray([l_pck], np.float32),
    }


class PFPascalDataset:
    """PF-Pascal keypoint-annotated evaluation pairs; ``category`` (1-20,
    the CSV's class column) keeps one class."""

    def __init__(self, csv_file, dataset_path, output_size=(400, 400),
                 category=None, pck_procedure="scnet", normalize=True):
        self.header, rows = _read_csv(csv_file)
        if category is not None:
            rows = [r for r in rows if int(float(r[2])) == int(category)]
        self.rows = rows
        self.dataset_path = dataset_path
        self.output_size = tuple(output_size)
        self.pck_procedure = pck_procedure
        self.normalize = normalize

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        row = self.rows[idx]
        return pf_pascal_sample(
            load_image(os.path.join(self.dataset_path, row[0])),
            load_image(os.path.join(self.dataset_path, row[1])),
            row, self.output_size, self.pck_procedure, self.normalize,
        )


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
