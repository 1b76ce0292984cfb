"""Train-time input noise.

The one function of ``certifiedgpt_tpu/agents/finetune.py`` that the eval
agent needs. The ``FinetuneAgent`` itself waits for training (ROADMAP.md,
modules item 14).
"""

from __future__ import annotations

import torch


def add_input_noise(images: torch.Tensor, sigma: float, dist: str = "gaussian",
                    generator: torch.Generator = None) -> torch.Tensor:
    """Per-pixel noise drawn on the images' device from ``generator``:
    ``images + sigma * U[0, 1)`` under ``dist="uniform"`` (the reference's
    ``maybe_add_noise``), else ``images + sigma * N(0, 1)``; ``sigma <= 0``
    returns the images unchanged."""
    if sigma <= 0:
        return images
    draw = torch.rand if dist == "uniform" else torch.randn
    return images + sigma * draw(images.shape, generator=generator, device=images.device,
                                 dtype=images.dtype)
