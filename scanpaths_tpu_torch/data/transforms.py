"""Image loading and tensorization.

Replicates the reference input pipeline (reference AiR/train.py:43-47):
resize to (H=240, W=320) with bilinear interpolation, scale to [0, 1],
normalize with ImageNet statistics.  Output is NHWC float32 (the
TPU-native layout; the reference used NCHW for cuDNN).

The port's own copy of ``scanpaths_tpu/data/transforms.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str, height: int = 240, width: int = 320) -> np.ndarray:
    """Read an image file -> normalized [H, W, 3] float32."""
    img = Image.open(path).convert("RGB").resize((width, height),
                                                 Image.BILINEAR)
    return normalize_image(np.asarray(img, np.float32) / 255.0)


def normalize_image(img01: np.ndarray) -> np.ndarray:
    """[H, W, 3] in [0,1] -> ImageNet-normalized float32."""
    return ((img01 - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def resize_map(arr: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Resize a 2-D float map (attention/bbox mask) to ``out_hw``.

    The reference uses skimage.transform.resize (bilinear with
    anti-aliasing, reference AiR/dataset/dataset.py:152); cv2 INTER_AREA
    is the equivalent antialiased downscale here.
    """
    import cv2

    h, w = out_hw
    interp = cv2.INTER_AREA if (arr.shape[0] > h or arr.shape[1] > w) \
        else cv2.INTER_LINEAR
    return cv2.resize(arr.astype(np.float32), (w, h), interpolation=interp)
