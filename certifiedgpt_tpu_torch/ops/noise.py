"""Monte-Carlo noise injection for randomized smoothing.

Port of ``certifiedgpt_tpu/ops/noise.py::noisy_tile``: tile one clean
normalized image n times and add ``sigma * N(0, 1)``.

- The live path (the JAX package's XLA path, :93-103) draws the noise with
  ``torch.randn`` from the caller's ``torch.Generator``; its stream differs
  from JAX's threefry, so tests compare the noise by its statistics.
- The kernel mode (``use_kernel=True``, off by default as the JAX package's
  ``use_pallas``) replaces the Pallas ``_noise_kernel`` (:58) with the CUDA
  kernel of ``csrc/noise.cu``: tile, Philox4x32-10 bits, Box-Muller and add
  in one pass. Each call draws two 32-bit seed words from the generator
  (:138-141), and image i of the batch uses the counter (i, pair index, 0, 0)
  under that key. CPU tensors take ``_noisy_tile_kernel_plain``, which
  computes the same integers in torch; CUDA tensors launch the kernel or
  raise. ``noisy_tile.launches`` counts the kernel launches.
"""

from __future__ import annotations

from typing import Union

import torch

from certifiedgpt_tpu_torch.ops import cuda_kernels

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI = 6.283185307179586


def _mulhilo32(a: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of ``a * x`` for uint32 values held in int64:
    ``x`` is split into 16-bit halves so that no product leaves int64."""
    p_lo = (x & 0xFFFF) * a  # < 2^48
    p_hi = (x >> 16) * a  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Random123) on uint32 words held in int64 tensors:
    ``counter`` is four broadcastable words (c0, c1, c2, c3), ``key`` two
    (k0, k1); returns the four output words. The plain version of the
    generator in ``csrc/noise.cu``, bit for bit."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """(0, 1] f32 from uint32 words: 23 bits under the exponent of 1.0 give
    [1, 2), then ``2 - x`` (the TPU kernel's trick, :35-47)."""
    one_to_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return 2.0 - one_to_two


def _gaussian_from_bits(bits1: torch.Tensor, bits2: torch.Tensor) -> torch.Tensor:
    """Box-Muller, the cosine branch (:50-55), each step rounded in f32."""
    r = torch.sqrt(-2.0 * torch.log(_uniform_from_bits(bits1)))
    two_pi = torch.tensor(_TWO_PI, dtype=torch.float32, device=bits2.device)
    return r * torch.cos(two_pi * _uniform_from_bits(bits2))


def _noisy_tile_kernel_plain(x: torch.Tensor, n: int, sigma: torch.Tensor,
                             seed: torch.Tensor) -> torch.Tensor:
    """The noise kernel's function in torch: ``seed`` two uint32 words (an
    int32 tensor), ``sigma`` an f32 scalar tensor; element e of image i takes
    words (2 (e % 2), 2 (e % 2) + 1) of Philox4x32-10 at counter
    (i, e // 2, 0, 0). The integers are the kernel's bit for bit; the
    transform here is exact (``torch.log``, ``sqrt``, ``cos``), while the
    kernel takes approximations for its arguments' domains (``lg2.approx``
    with a series near u1 = 1, ``sqrt.approx``, ``cos.approx``): its largest
    ``|g_kernel - g_plain|`` over the 57.8 M normals of the main path's
    shape, 96 x [448, 448, 3], is 3.3e-6 (``chip_smoke.py`` on an H100)."""
    shape = x.shape
    xf = x.float().reshape(-1)
    elems = xf.numel()
    pairs = (elems + 1) // 2
    dev = x.device
    draw = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    pair = torch.arange(pairs, dtype=torch.int64, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    key = [seed[i].to(torch.int64) & _MASK32 for i in range(2)]
    w0, w1, w2, w3 = philox4x32_10((draw, pair, zero, zero), key)
    g = torch.stack([_gaussian_from_bits(w0, w1), _gaussian_from_bits(w2, w3)], dim=-1)
    g = g.reshape(n, 2 * pairs)[:, :elems]
    out = xf[None, :] + sigma.float() * g
    return out.reshape((n,) + tuple(shape))


def _seed_words(generator: torch.Generator, device) -> torch.Tensor:
    """Two int32 seed words in [0, 2^31 - 1) from the caller's generator, on
    ``device`` (as ``jax.random.randint(key, (2,), 0, int32 max)``)."""
    return torch.randint(0, 2 ** 31 - 1, (2,), generator=generator, device=device,
                         dtype=torch.int32)


def noisy_tile(
    x: torch.Tensor,  # [H, W, C] clean normalized image
    n: int,
    sigma: Union[float, torch.Tensor],
    generator: torch.Generator,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Return ``n`` noisy copies ``[n, H, W, C]`` (f32) of the clean image.

    ``sigma`` is a runtime scalar (a number or a 0-d tensor). ``sigma = 0``
    returns the clean tile bit for bit: a Python 0 skips the draw, and a
    0-d tensor gives ``x + 0 * noise``, which is ``x`` in IEEE f32.
    ``use_kernel`` takes the fused noise kernel (see the module note); it
    draws for any sigma, 0 included."""
    if use_kernel:
        return _noisy_tile_kernel(x, n, sigma, generator)
    tiled = x.float().unsqueeze(0).expand((n,) + tuple(x.shape))
    if isinstance(sigma, (int, float)) and sigma <= 0:
        return tiled
    noise = torch.randn(
        tiled.shape, generator=generator, device=x.device, dtype=torch.float32
    )
    return tiled + sigma * noise


def _noisy_tile_kernel(x, n, sigma, generator) -> torch.Tensor:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    seed = _seed_words(generator, x.device)
    sig = torch.as_tensor(sigma, dtype=torch.float32).to(x.device).reshape(())
    if kind == "cpu":
        return _noisy_tile_kernel_plain(x, n, sig, seed)
    if x.dtype != torch.float32:
        raise TypeError(f"noisy_tile kernel: the image must be f32, got {x.dtype}")
    if not 0 < n <= 65535:
        raise ValueError(f"noisy_tile kernel: n must be in [1, 65535], got {n}")
    out = _launch_noise(x.contiguous(), n, sig, seed)
    noisy_tile.launches += 1
    return out


def _launch_noise(x: torch.Tensor, n: int, sigma: torch.Tensor,
                  seed: torch.Tensor) -> torch.Tensor:
    """The noise kernel on checked operands (a contiguous f32 CUDA image,
    ``sigma`` and ``seed`` on its device): returns ``[n, *x.shape]``."""
    out = torch.empty((n,) + tuple(x.shape), dtype=torch.float32, device=x.device)
    code = cuda_kernels.build().lib.cgpt_noisy_tile(
        x.data_ptr(), seed.data_ptr(), sigma.data_ptr(), out.data_ptr(), x.numel(), n,
        cuda_kernels.stream_of(x),
    )
    cuda_kernels.check(code, "noisy_tile")
    return out


cuda_kernels.launch_counter(noisy_tile, r"\bnoise_kernel\b")

