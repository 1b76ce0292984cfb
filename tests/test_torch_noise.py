"""Port: Monte-Carlo noise (certifiedgpt_tpu_torch/ops/noise.py) and the
certify seeds. The generators differ from JAX's threefry and the TPU's
hardware bits, so the noise is held to its statistics, and the kernel mode's
Philox4x32-10 to Random123's published known answers; the seeds are held to
the JAX package's bit for bit."""

import numpy as np
import pytest
import torch

from certifiedgpt_tpu.agents.certify import certify_seed as j_certify_seed
from certifiedgpt_tpu_torch.agents.certify import certify_seed
from certifiedgpt_tpu_torch.ops import noise as TN
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


# Random123 kat_vectors: philox4x32 10, (counter, key) -> output words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("case", range(len(PHILOX_KAT)))
def test_philox_matches_random123_known_answers(case):
    counter, key, want = PHILOX_KAT[case]
    got = TN.philox4x32_10([torch.tensor(c) for c in counter], [torch.tensor(k) for k in key])
    assert [int(w) for w in got] == list(want)


@pytest.mark.parametrize("sigma", [0.25, 0.5, 1.0])
def test_noise_kernel_mode_moments_and_determinism(sigma):
    """The kernel mode's plain version (CPU): moments within 0.02, the same
    generator state gives the same noise, another gives other noise, and
    every image of the batch has its own."""
    x = torch.from_numpy(np.random.RandomState(1).randn(16, 16, 3).astype(np.float32))
    out = noisy_tile(x, 64, sigma, _gen(3), use_kernel=True)
    assert out.shape == (64, 16, 16, 3) and out.dtype == torch.float32
    resid = ((out - x[None]) / sigma).numpy()
    assert abs(resid.mean()) < 0.02
    assert abs(resid.std() - 1.0) < 0.02
    assert not np.allclose(resid[0], resid[1])
    np.testing.assert_array_equal(noisy_tile(x, 64, sigma, _gen(3), use_kernel=True).numpy(),
                                  out.numpy())
    assert not torch.equal(noisy_tile(x, 64, sigma, _gen(4), use_kernel=True), out)


def test_noise_kernel_mode_seed_words_and_sigma_zero():
    """Other seed words give other noise; sigma = 0 (a number or a 0-d
    tensor) returns the clean tile bit for bit although the noise is drawn;
    an odd element count takes the first word pair of the last counter."""
    x = torch.from_numpy(np.random.RandomState(2).randn(5, 3, 3).astype(np.float32))
    sigma = torch.tensor(0.5)
    a = TN._noisy_tile_kernel_plain(x, 4, sigma, torch.tensor([1, 2], dtype=torch.int32))
    b = TN._noisy_tile_kernel_plain(x, 4, sigma, torch.tensor([1, 3], dtype=torch.int32))
    c = TN._noisy_tile_kernel_plain(x, 4, sigma, torch.tensor([2, 2], dtype=torch.int32))
    assert not torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(b, c)
    # element 2j + 1 of image i: words 2, 3 of the counter (i, j, 0, 0)
    w = TN.philox4x32_10([torch.tensor(v) for v in (3, 10, 0, 0)],
                         [torch.tensor(1), torch.tensor(2)])
    g = TN._gaussian_from_bits(w[2], w[3])
    assert float(a[3].reshape(-1)[21]) == float(x.reshape(-1)[21] + sigma * g)
    want = np.broadcast_to(x.numpy()[None], (4, 5, 3, 3))
    for zero in (0.0, torch.tensor(0.0)):
        np.testing.assert_array_equal(noisy_tile(x, 4, zero, _gen(1), use_kernel=True).numpy(),
                                      want)


def test_noise_kernel_mode_counts_no_launch_on_cpu():
    before = noisy_tile.launches
    noisy_tile(torch.zeros(2, 2, 3), 2, 0.5, _gen(0), use_kernel=True)
    assert noisy_tile.launches == before


def test_certify_seed_matches_jax():
    for base, index, sigma in [(42, 0, 0.5), (42, 7, 0.25), (0, 123456, 1.0), (7, 3, 0.0)]:
        assert certify_seed(base, index, sigma) == j_certify_seed(base, index, sigma)
    assert certify_seed(42, 0, 0.5) != certify_seed(42, 0, 0.25)


def test_chunk_seed_depends_on_seed_and_chunk_only():
    seeds = {chunk_seed(s, c) for s in (1, 2, (1 << 62) + 5) for c in range(50)}
    assert len(seeds) == 150
    assert all(0 <= s < 1 << 64 for s in seeds)
    assert chunk_seed(9, 3) == chunk_seed(9, 3)
