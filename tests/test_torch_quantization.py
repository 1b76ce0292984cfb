"""Port parity: int8 quantization and the two row-quant kernels' plain
versions (certifiedgpt_tpu_torch/ops/quantization.py) against the JAX
package, on the CPU. The CUDA kernels themselves run only on a GPU
(tests/test_torch_kernels_gpu.py; ``python3 chip_smoke.py`` holds them
against these plain versions at the serving shapes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from certifiedgpt_tpu.models import layers as JL
from certifiedgpt_tpu.ops import quantization as JQ
from certifiedgpt_tpu_torch.models import layers as TL
from certifiedgpt_tpu_torch.ops import quantization as TQ


def _bf16_pair(a: np.ndarray):
    """The same bf16 values in both frameworks."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _codes(a):
    return np.asarray(a).astype(np.int32)


def test_weight_and_row_quantization_match_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(24, 16).astype(np.float32)
    # exact .5 ties exercise round-half-to-even
    w[0, :4] = [0.5, 1.5, -2.5, 127.0]
    jq = JQ.quantize_kernel(jnp.asarray(w))
    tq = TQ.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(_codes(jq["kernel_q"]), _codes(tq["kernel_q"]))
    np.testing.assert_allclose(np.asarray(jq["scale"]), tq["scale"].numpy(), rtol=1e-7)

    ws = rng.randn(3, 24, 16).astype(np.float32)
    js = JQ.quantize_stacked_kernel(jnp.asarray(ws))
    ts = TQ.quantize_stacked_kernel(torch.from_numpy(ws))
    np.testing.assert_array_equal(_codes(js["kernel_q"]), _codes(ts["kernel_q"]))

    x = (rng.randn(5, 7, 32) * 3).astype(np.float32)
    x[0, 0, :3] = [63.5, -0.5, 127.0]  # ties at the row's scale of 1.0
    jxq, jxs = JQ.quantize_rows(jnp.asarray(x))
    txq, txs = TQ.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(_codes(jxq), _codes(txq))
    np.testing.assert_allclose(np.asarray(jxs), txs.numpy(), rtol=1e-7)


@pytest.mark.parametrize("interpret", [False, True], ids=["xla_chain", "pallas_interpret"])
def test_ln_quant_rows_plain_matches_jax(interpret):
    """Against the XLA chain (bit-level up to f32 reduction order) and the
    Pallas kernel in interpret mode: codes within one step, scales 1e-4."""
    rng = np.random.RandomState(7)
    x = rng.randn(256, 384).astype(np.float32) * 2
    jx, tx = _bf16_pair(x)
    scale = (1.0 + 0.1 * rng.randn(384)).astype(np.float32)
    bias = (0.1 * rng.randn(384)).astype(np.float32)
    jxq, jxs = JQ.ln_quant_rows(jx, jnp.asarray(scale), jnp.asarray(bias), 1e-6,
                                interpret=interpret)
    txq, txs = TQ.ln_quant_rows(tx, torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    np.testing.assert_allclose(np.asarray(jxs), txs.numpy(), rtol=1e-4)
    diff = np.abs(_codes(jxq) - _codes(txq))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("interpret", [False, True], ids=["xla_chain", "pallas_interpret"])
def test_gelu_quant_rows_plain_matches_jax(interpret):
    """The XLA chain rounds the bf16 GELU in bf16 arithmetic and the Pallas
    kernel uses an erf approximation: codes within one step, scales 1e-2
    (one bf16 step of the row's absmax)."""
    rng = np.random.RandomState(0)
    jx, tx = _bf16_pair(rng.randn(256, 384).astype(np.float32) * 3)
    jxq, jxs = JQ.gelu_quant_rows(jx, interpret=interpret)
    txq, txs = TQ.gelu_quant_rows(tx)
    np.testing.assert_allclose(np.asarray(jxs), txs.numpy(), rtol=1e-2)
    diff = np.abs(_codes(jxq) - _codes(txq))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-2


@pytest.mark.parametrize("form", ["float", "weight_only", "w8a8"])
def test_dense_forms_match_jax(form):
    """layers.dense in its three forms, plus ln_dense/gelu_dense on the
    W8A8 path, in f32 (rtol 1e-5: f32 summation order only)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 10, 24).astype(np.float32)
    p = JL.init_dense(jax.random.PRNGKey(2), 24, 16)
    p["bias"] = jnp.asarray(rng.randn(16).astype(np.float32))
    if form != "float":
        p = dict(JQ.quantize_kernel(p["kernel"]), bias=p["bias"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    aq = form == "w8a8"
    np.testing.assert_allclose(
        np.asarray(JL.dense(p, jnp.asarray(x), act_quant=aq)),
        TL.dense(tp, torch.from_numpy(x), act_quant=aq).numpy(), rtol=1e-5, atol=1e-5,
    )
    ln = {"scale": jnp.asarray(1 + 0.1 * rng.randn(24).astype(np.float32)),
          "bias": jnp.asarray(0.1 * rng.randn(24).astype(np.float32))}
    tln = {k: torch.from_numpy(np.array(v)) for k, v in ln.items()}
    np.testing.assert_allclose(
        np.asarray(JL.ln_dense(p, jnp.asarray(x), ln, act_quant=aq)),
        TL.ln_dense(tp, torch.from_numpy(x), tln, act_quant=aq).numpy(), rtol=1e-5, atol=1e-5,
    )
    p2 = JL.init_dense(jax.random.PRNGKey(3), 16, 24)
    if form != "float":
        p2 = JQ.quantize_kernel(p2["kernel"])
    tp2 = {k: torch.from_numpy(np.array(v)) for k, v in p2.items()}
    h = rng.randn(3, 10, 16).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(JL.gelu_dense(p2, jnp.asarray(h), act_quant=aq)),
        TL.gelu_dense(tp2, torch.from_numpy(h), act_quant=aq).numpy(), rtol=1e-5, atol=1e-5,
    )


def test_int8_matmul_exact_and_quantize_modules():
    rng = np.random.RandomState(4)
    a = rng.randint(-127, 128, size=(32, 64)).astype(np.int8)
    b = rng.randint(-127, 128, size=(64, 24)).astype(np.int8)
    got = TQ.int8_accumulate(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, a.astype(np.int64) @ b.astype(np.int64))
    col = TQ.int8_kernel_layout(torch.from_numpy(b))
    assert col.stride() == (1, 64) and torch.equal(col, torch.from_numpy(b))

    tree = {"layers": {"fc": {"kernel": rng.randn(2, 8, 8).astype(np.float32),
                              "bias": np.zeros((2, 8), np.float32)},
                       "norm": {"scale": np.ones((2, 8), np.float32)}},
            "head": {"kernel": np.ones((8, 4), np.float32)}}
    jt = JQ.quantize_llama(jax.tree.map(jnp.asarray, tree))
    tt = TQ.quantize_llama(TL.tree_map(torch.from_numpy, tree))
    assert set(tt["layers"]["fc"]) == {"kernel_q", "scale", "bias"}
    assert set(tt["layers"]["norm"]) == {"scale"} and "kernel" in tt["head"]
    np.testing.assert_array_equal(_codes(jt["layers"]["fc"]["kernel_q"]),
                                  _codes(tt["layers"]["fc"]["kernel_q"]))
    vit = TQ.quantize_eva_vit({"layers": {"qkv": {"kernel": torch.ones(2, 8, 24)},
                                          "other": {"kernel": torch.ones(2, 8, 8)}}})
    assert "kernel_q" in vit["layers"]["qkv"] and "kernel" in vit["layers"]["other"]


def test_wrappers_count_no_launch_on_cpu():
    x = torch.randn(4, 16).to(torch.bfloat16)
    before = (TQ.ln_quant_rows.launches, TQ.gelu_quant_rows.launches)
    TQ.ln_quant_rows(x, torch.ones(16), torch.zeros(16))
    TQ.gelu_quant_rows(x)
    assert (TQ.ln_quant_rows.launches, TQ.gelu_quant_rows.launches) == before
