"""Offline dataset statistics: a copy of
``certifiedgpt_tpu/utils/dataset_stats.py`` for the port.

Channel mean/std over an image directory (ref
``utils/compute_std_mean.py:8-37``), numpy/PIL only.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
from PIL import Image

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def compute_mean_std(
    root_dir: str, image_size: int = 448
) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming per-channel mean/std over all images under ``root_dir``."""
    num_pixels = 0
    pixel_sum = np.zeros(3, np.float64)
    pixel_sq_sum = np.zeros(3, np.float64)

    for root, _, files in os.walk(root_dir):
        for name in files:
            if not name.lower().endswith(IMAGE_EXTENSIONS):
                continue
            img = Image.open(os.path.join(root, name)).convert("RGB")
            img = img.resize((image_size, image_size), Image.BICUBIC)
            arr = np.asarray(img, np.float64) / 255.0  # [H, W, 3]
            num_pixels += arr.shape[0] * arr.shape[1]
            pixel_sum += arr.sum(axis=(0, 1))
            pixel_sq_sum += np.square(arr).sum(axis=(0, 1))

    if num_pixels == 0:
        raise ValueError(f"No images found under {root_dir}")
    mean = pixel_sum / num_pixels
    var = pixel_sq_sum / num_pixels - np.square(mean)
    return mean.astype(np.float32), np.sqrt(np.maximum(var, 0)).astype(np.float32)
