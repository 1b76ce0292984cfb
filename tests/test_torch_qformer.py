"""Port parity: the Q-Former (certifiedgpt_tpu_torch/models/qformer.py)
against the JAX package's ``qformer_apply`` on the CPU, f32, with the same
jittered parameters (relative error 1e-5: summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from certifiedgpt_tpu.models import qformer as JQF
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.models import qformer as TQF
from certifiedgpt_tpu_torch.models.from_jax import tensor_from_numpy


def _jittered(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.randn(*np.shape(a))).astype(np.float32), tree
    )


def test_qformer_apply_matches_jax():
    cfg_j = JQF.QFormerConfig.tiny()
    cfg_t = TQF.QFormerConfig.tiny()
    params = _jittered(JQF.init_qformer(jax.random.PRNGKey(0), cfg_j), 1)
    img = np.random.RandomState(2).randn(3, 17, cfg_j.encoder_width).astype(np.float32)
    want = np.asarray(JQF.qformer_apply(jax.tree.map(jnp.asarray, params), cfg_j,
                                        jnp.asarray(img)))
    module = TQF.QFormer(cfg_t, TL.tree_map(tensor_from_numpy, params))
    got = module(torch.from_numpy(img)).numpy()
    assert got.shape == (3, cfg_t.num_query_tokens, cfg_t.hidden_size)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    assert [cfg_t.has_cross_attention(i) for i in range(4)] == [True, False, True, False]
