"""Monte-Carlo noise injection for randomized smoothing.

Port of the live path of ``certifiedgpt_tpu/ops/noise.py::noisy_tile``
(the XLA path, :93-103): tile one clean normalized image n times and add
``sigma * N(0, 1)``. The JAX package's Pallas ``_noise_kernel`` is off the
certify path there (``use_pallas`` defaults to False and the classifier never
sets it), so it is not ported here. Noise comes from an explicit
``torch.Generator``; its stream differs from JAX's threefry, so tests compare
the noise by its statistics.
"""

from __future__ import annotations

from typing import Union

import torch


def noisy_tile(
    x: torch.Tensor,  # [H, W, C] clean normalized image
    n: int,
    sigma: Union[float, torch.Tensor],
    generator: torch.Generator,
) -> torch.Tensor:
    """Return ``n`` noisy copies ``[n, H, W, C]`` (f32) of the clean image.

    ``sigma`` is a runtime scalar (a number or a 0-d tensor). ``sigma = 0``
    returns the clean tile bit for bit: a Python 0 skips the draw, and a
    0-d tensor gives ``x + 0 * noise``, which is ``x`` in IEEE f32."""
    tiled = x.float().unsqueeze(0).expand((n,) + tuple(x.shape))
    if isinstance(sigma, (int, float)) and sigma <= 0:
        return tiled
    noise = torch.randn(
        tiled.shape, generator=generator, device=x.device, dtype=torch.float32
    )
    return tiled + sigma * noise
