"""Host-side image transforms with torchvision semantics.

Copy of ``pemp_tpu/data/transforms.py`` (reference
data_kits/pascal_voc.py:26-84, :137-240): bilinear image and nearest mask
resize, ColorJitter(0.4, 0.4, 0.4), the shared-flag horizontal flip,
ImageNet normalisation and the foreground-keeping random crop
(``smart_crop``). Augmentation draws come from Python's ``random``
module, in the JAX package's order, so seeding ``random`` alike gives
both packages the same train episodes; test-time preprocessing (resize
and normalise) is deterministic.
"""

from __future__ import annotations

import random
from typing import Tuple

import numpy as np
from PIL import Image, ImageEnhance

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_image(img: Image.Image, size_hw) -> Image.Image:
    return img.resize((size_hw[1], size_hw[0]), Image.BILINEAR)


def resize_mask(mask: Image.Image, size_hw) -> Image.Image:
    return mask.resize((size_hw[1], size_hw[0]), Image.NEAREST)


def color_jitter(img: Image.Image, brightness=0.4, contrast=0.4,
                 saturation=0.4) -> Image.Image:
    """torchvision's ColorJitter: the three enhancements in random order,
    each with a factor drawn from U[1 - x, 1 + x]."""
    ops = []
    if brightness > 0:
        f = random.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = random.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = random.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    random.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def normalize(img, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    """PIL image (or uint8 HWC array) -> float32 in [0, 1] -> ImageNet
    normalised. Every operation stays in float32, as torchvision's
    Normalize on float32 tensors: the config's mean and std are tuples,
    and numpy would upcast them and the whole image to float64 (4x the
    cost and a 1-ulp difference from the reference)."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    if isinstance(img, np.ndarray):
        arr = img.astype(np.float32)
    else:
        arr = np.asarray(img.convert("RGB"), np.float32)
    arr /= 255.0
    arr -= mean
    arr /= std
    return arr


def hflip_image(img: Image.Image) -> Image.Image:
    return img.transpose(Image.FLIP_LEFT_RIGHT)


def smart_crop(image: np.ndarray, mask: np.ndarray, height: int, width: int,
               min_pixels: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """A random ``height`` x ``width`` crop that keeps enough foreground
    (or background): a uniform draw first; when it holds fewer than
    ``min_pixels`` of the scarce one, a redraw from the range whose crops
    overlap the scarce region's bounding box, and if that crop holds none
    of it, up to 101 uniform retries.

    image: [H, W, C]; mask: [H, W] uint8 in {0, 255}.
    """
    mh, mw = mask.shape
    my = random.randint(0, mh - height)
    mx = random.randint(0, mw - width)
    patch = mask[my:my + height, mx:mx + width]

    def bbox_guided(scarce: np.ndarray):
        ys = np.where(scarce.max(axis=1) > 0)[0]
        xs = np.where(scarce.max(axis=0) > 0)[0]
        ymin, ymax = ys.min(), ys.max() + 1
        xmin, xmax = xs.min(), xs.max() + 1
        y_lo = max(0, ymax - height)
        y_hi = max(min(mh - height, ymin), y_lo)
        x_lo = max(0, xmax - width)
        x_hi = max(min(mw - width, xmin), x_lo)
        return (random.randint(y_lo, y_hi), random.randint(x_lo, x_hi))

    def random_retry():
        for _ in range(101):
            y = random.randint(0, mh - height)
            x = random.randint(0, mw - width)
            if np.count_nonzero(mask[y:y + height, x:x + width]) > 0:
                return y, x
        print("Warning: full-zero mask")
        return (random.randint(0, mh - height), random.randint(0, mw - width))

    if np.count_nonzero(patch) < min_pixels:            # scarce foreground
        my, mx = bbox_guided(mask)
        if np.count_nonzero(mask[my:my + height, mx:mx + width]) == 0:
            my, mx = random_retry()
    elif np.count_nonzero(255 - patch) < min_pixels:    # scarce background
        my, mx = bbox_guided(255 - mask)
        if np.count_nonzero(255 - mask[my:my + height, mx:mx + width]) == 0:
            my, mx = random_retry()

    return (image[my:my + height, mx:mx + width],
            mask[my:my + height, mx:mx + width])
