"""Port: Monte-Carlo noise (certifiedgpt_tpu_torch/ops/noise.py, the
``noise_dist`` modes of smoothing/classifier.py) and the certify seeds. The
generators differ from JAX's threefry and the TPU's hardware bits, so the
noise is held to its statistics, and the kernel mode's Philox4x32-10 to
Random123's published known answers; the seeds are held to the JAX
package's bit for bit."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.agents.certify import certify_seed as j_certify_seed
from certifiedgpt_tpu_torch.agents.certify import certify_item, certify_seed
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.ops import noise as TN
from certifiedgpt_tpu_torch.ops.noise import noisy_tile
from certifiedgpt_tpu_torch.smoothing import classifier as TC
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


def _assert_one_sided_uniform(resid):
    """Residuals ``(out - x) / sigma`` of the uniform mode: all in [0, 1),
    mean 1/2 and variance 1/12."""
    assert resid.min() >= 0.0 and resid.max() < 1.0
    assert abs(resid.mean() - 0.5) < 0.01
    assert abs(resid.var() - 1.0 / 12.0) < 0.005


def _noisy_batch(monkeypatch, image, mc_batch, sigma, generator, noise_dist):
    """The noisy images that ``make_noisy_generate_fn``'s noise step hands to
    generation (stubbed) for one chunk."""
    seen = []

    def fake_generate(params, cfg, batch, max_new_tokens, eos, pad, **kw):
        seen.append(batch["image"])
        return torch.zeros((mc_batch, max_new_tokens), dtype=torch.long)

    monkeypatch.setattr(TC, "generate_greedy", fake_generate)
    fn = TC.make_noisy_generate_fn(_stub_model(), sigma, mc_batch, 1, seq_len=4,
                                   noise_dist=noise_dist)
    ids = torch.zeros((1, 4), dtype=torch.long)
    fn(image, ids, torch.ones_like(ids), torch.zeros(1, dtype=torch.long), generator)
    return seen[0]


@pytest.mark.parametrize("sigma", [0.25, 0.5, 2.0])
def test_uniform_noise_dist_matches_the_jax_contract(monkeypatch, sigma):
    """``noise_dist="uniform"``: ``x + sigma * U[0, 1)`` on the tiled image,
    in the port and as the JAX package's noise step computes it
    (``x + sigma * jax.random.uniform(key, shape)``) on the same numpy
    image; the two streams differ, the contract is the same."""
    x = np.random.RandomState(5).randn(16, 16, 3).astype(np.float32)
    out = _noisy_batch(monkeypatch, torch.from_numpy(x), 64, sigma, _gen(9), "uniform")
    assert out.shape == (64, 16, 16, 3) and out.dtype == torch.float32
    _assert_one_sided_uniform(((out - torch.from_numpy(x)[None]) / sigma).double().numpy())
    tiled = jnp.broadcast_to(jnp.asarray(x)[None], (64,) + x.shape)
    j_out = tiled + jnp.float32(sigma) * jax.random.uniform(jax.random.PRNGKey(9), tiled.shape,
                                                            tiled.dtype)
    _assert_one_sided_uniform((np.asarray(j_out, np.float64) - x[None]) / sigma)


def test_uniform_noise_dist_sigma_zero_is_the_clean_tile(monkeypatch):
    x = torch.from_numpy(np.random.RandomState(6).randn(8, 8, 3).astype(np.float32))
    want = np.broadcast_to(x.numpy()[None], (4, 8, 8, 3))
    out = _noisy_batch(monkeypatch, x, 4, 0.0, _gen(1), "uniform")
    np.testing.assert_array_equal(out.numpy(), want)


def _stub_model():
    """What ``make_sample_fn`` reads of a model when generation is stubbed."""
    cfg = types.SimpleNamespace(vit=types.SimpleNamespace(img_size=8), num_img_tokens=4)
    return types.SimpleNamespace(device=torch.device("cpu"), cfg=cfg, params=None,
                                 tokenizer=ByteTokenizer())


@pytest.mark.parametrize("noise_dist", ["uniform", "gaussian", "laplace", None])
def test_certify_item_draws_the_run_blocks_noise_dist(monkeypatch, noise_dist):
    """``certify_item`` reads ``noise_dist`` from the run block as the JAX
    package's ``CertifyAgent`` does: ``uniform`` draws one-sided uniform
    noise, any other value (or none) the Gaussian. The noisy images are
    captured where the generate step receives them."""
    seen = []

    def fake_generate(params, cfg, batch, max_new_tokens, eos, pad, **kw):
        seen.append(batch["image"].clone())
        return torch.full((batch["image"].shape[0], max_new_tokens), eos, dtype=torch.long)

    monkeypatch.setattr(TC, "generate_greedy", fake_generate)
    image = np.random.RandomState(7).randn(8, 8, 3).astype(np.float32)
    run = dict(noise_level=0.5, certify_n0=16, certify_n=48, mc_batch=16, max_new_tokens=2,
               seq_len=32, seed=3)
    if noise_dist is not None:
        run["noise_dist"] = noise_dist
    row = certify_item(_stub_model(), image, "<Img><ImageHere></Img> what?", ["cat"], run,
                       index=0)
    assert row["draws"] == 64 and len(seen) == 4
    resid = ((torch.cat(seen) - torch.from_numpy(image)[None]) / 0.5).double().numpy()
    if noise_dist == "uniform":
        _assert_one_sided_uniform(resid)
    else:
        assert resid.min() < -1.0 and abs(resid.mean()) < 0.05 and abs(resid.std() - 1.0) < 0.05
