"""Port: Monte-Carlo noise (certifiedgpt_tpu_torch/ops/noise.py) and the
certify seeds. The generators differ from JAX's threefry, so the noise is
held to its statistics; the seeds are held to the JAX package's bit for
bit."""

import numpy as np
import pytest
import torch

from certifiedgpt_tpu.agents.certify import certify_seed as j_certify_seed
from certifiedgpt_tpu_torch.agents.certify import certify_seed
from certifiedgpt_tpu_torch.ops.noise import noisy_tile
from certifiedgpt_tpu_torch.smoothing.classifier import chunk_seed


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_sigma_zero_returns_the_clean_tile_bit_for_bit():
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 8, 3).astype(np.float32))
    want = np.broadcast_to(x.numpy()[None], (4, 8, 8, 3))
    np.testing.assert_array_equal(noisy_tile(x, 4, 0.0, _gen(1)).numpy(), want)
    # a runtime (tensor) sigma of 0 draws and multiplies the draw away
    np.testing.assert_array_equal(noisy_tile(x, 4, torch.tensor(0.0), _gen(1)).numpy(), want)


@pytest.mark.parametrize("sigma", [0.25, 0.5, 1.0])
def test_noise_moments_and_determinism(sigma):
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 16, 3).astype(np.float32))
    out = noisy_tile(x, 64, sigma, _gen(3))
    assert out.shape == (64, 16, 16, 3) and out.dtype == torch.float32
    resid = ((out - x[None]) / sigma).numpy()
    assert abs(resid.mean()) < 0.02
    assert abs(resid.std() - 1.0) < 0.02
    assert not np.allclose(resid[0], resid[1])  # draws are independent
    np.testing.assert_array_equal(noisy_tile(x, 64, sigma, _gen(3)).numpy(), out.numpy())
    assert not torch.equal(noisy_tile(x, 64, sigma, _gen(4)), out)


def test_certify_seed_matches_jax():
    for base, index, sigma in [(42, 0, 0.5), (42, 7, 0.25), (0, 123456, 1.0), (7, 3, 0.0)]:
        assert certify_seed(base, index, sigma) == j_certify_seed(base, index, sigma)
    assert certify_seed(42, 0, 0.5) != certify_seed(42, 0, 0.25)


def test_chunk_seed_depends_on_seed_and_chunk_only():
    seeds = {chunk_seed(s, c) for s in (1, 2, (1 << 62) + 5) for c in range(50)}
    assert len(seeds) == 150
    assert all(0 <= s < 1 << 64 for s in seeds)
    assert chunk_seed(9, 3) == chunk_seed(9, 3)
