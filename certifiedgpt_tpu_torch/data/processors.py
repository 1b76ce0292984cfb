"""Image / caption processors (host-side, numpy).

A copy of ``certifiedgpt_tpu/data/processors.py``: bicubic resize to a
square (PIL), scale to [0, 1], normalize with the CLIP mean/std; output is
numpy float32 NHWC, the layout the port's models take. Gaussian noise for
smoothing is not added here: it is drawn on the device
(``ops/noise.py``). Registered under the JAX package's names in the port's
registry: ``blip2_image_train``, ``blip2_image_val``, ``blip_caption``.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from certifiedgpt_tpu_torch.common.registry import registry

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class BaseProcessor:
    def __call__(self, item):
        return item

    @classmethod
    def from_config(cls, cfg=None):
        return cls()


class BlipImageBaseProcessor(BaseProcessor):
    def __init__(
        self,
        image_size: int = 448,
        mean: Optional[Sequence[float]] = None,
        std: Optional[Sequence[float]] = None,
    ):
        self.image_size = image_size
        self.mean = np.asarray(mean if mean is not None else CLIP_MEAN, np.float32)
        self.std = np.asarray(std if std is not None else CLIP_STD, np.float32)

    def __call__(self, image: Image.Image) -> np.ndarray:
        if not isinstance(image, Image.Image):
            # accept ndarray input (tests, synthetic data)
            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = np.clip(arr * 255.0, 0, 255).astype(np.uint8)
            image = Image.fromarray(arr)
        image = image.convert("RGB").resize(
            (self.image_size, self.image_size), Image.BICUBIC
        )
        arr = np.asarray(image, np.float32) / 255.0  # [H, W, C]
        return (arr - self.mean) / self.std

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            image_size=cfg.get("image_size", 448),
            mean=cfg.get("mean"),
            std=cfg.get("std"),
        )


@registry.register_processor("blip2_image_train")
class Blip2ImageTrainProcessor(BlipImageBaseProcessor):
    """Train-split image processor (resize+normalize; the reference's
    min/max_scale random-crop args are accepted but unused there too,
    ref ``blip_processors.py:19-49``)."""


@registry.register_processor("blip2_image_val")
class Blip2ImageEvalProcessor(BlipImageBaseProcessor):
    """Val/eval-split image processor."""


@registry.register_processor("blip_caption")
class BlipCaptionProcessor(BaseProcessor):
    """Caption cleanup: prompt prefix, lowercase, strip punctuation,
    collapse whitespace, truncate to ``max_words``
    (ref ``blip_processors.py:72-114``)."""

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + self.pre_caption(caption)

    def pre_caption(self, caption: str) -> str:
        caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
        caption = re.sub(r"\s{2,}", " ", caption)
        caption = caption.rstrip("\n").strip(" ")
        words = caption.split(" ")
        if len(words) > self.max_words:
            caption = " ".join(words[: self.max_words])
        return caption

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        return cls(
            # NOTE the reference's asymmetry, preserved: __init__ defaults
            # max_words=50 but the registry/from_config path — the one
            # every YAML-built processor takes — defaults to 100
            # (ref blip_processors.py:74,87)
            prompt=cfg.get("prompt", ""), max_words=cfg.get("max_words", 100)
        )
