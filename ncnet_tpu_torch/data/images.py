"""Host-side image decode / resize / normalize (numpy; `preprocess` chains
the three), and the ImageNet normalization on tensors. Counterparts of
``ncnet_tpu/data/images.py`` and ``ncnet_tpu/ops/image.py``."""

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path):
    """Decode an image file -> float32 RGB ``[h, w, 3]`` in 0..255;
    grayscale is stacked to 3 channels and alpha dropped."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr.astype(np.float32)


def resize_bilinear_np(image, out_h, out_w):
    """Align-corners bilinear resize of a channels-last ``[h, w, c]`` image."""
    h, w = image.shape[:2]
    if (h, w) == (out_h, out_w):
        return image.astype(np.float32)

    def axis_coords(n_in, n_out):
        if n_out == 1:
            return np.zeros(1), np.zeros(1, np.int64), np.zeros(1, np.int64)
        pos = np.linspace(0.0, n_in - 1.0, n_out)
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, n_in - 1)
        return pos - lo, lo, hi

    fy, y0, y1 = axis_coords(h, out_h)
    fx, x0, x1 = axis_coords(w, out_w)
    img = image.astype(np.float32)
    top = img[y0] * (1 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    return top[:, x0] * (1 - fx)[None, :, None] + top[:, x1] * fx[None, :, None]


def normalize_image_np(image):
    """0..255 float RGB -> ImageNet-normalized."""
    return (image / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def imagenet_normalize(image, scale_255=True):
    """``(image/255 - mean) / std`` on a channels-last tensor."""
    mean = torch.as_tensor(IMAGENET_MEAN, dtype=image.dtype, device=image.device)
    std = torch.as_tensor(IMAGENET_STD, dtype=image.dtype, device=image.device)
    if scale_255:
        image = image / 255.0
    return (image - mean) / std


def to_uint8_image(image):
    """Rounded uint8 of a [0, 255]-range float image (the loader's
    ``uint8_output`` wire format)."""
    return np.rint(np.clip(image, 0.0, 255.0)).astype(np.uint8)



def preprocess(path, out_h, out_w):
    """Decode -> resize -> normalize: ``(the normalized [out_h, out_w, 3]
    image, its original (h, w))``, as the JAX package's."""
    img = load_image(path)
    orig = img.shape[:2]
    img = resize_bilinear_np(img, out_h, out_w)
    return normalize_image_np(img), orig
