"""The distributed code paths at world size 1 on the card, through NCCL.

The card machine has one GPU, and NCCL refuses two ranks on one card, so
the data-parallel and tensor-parallel paths are held there at world size 1:
the mesh's groups exist, every collective runs on the one rank. The
row-parallel dense's W8A8 rescale is the one-rank product bit for bit. A tiny
W8A8 decoder's prefill and int8-cache decode through the tensor-parallel
functions (forced on: the decoder splits only past one rank) give the plain
run's greedy tokens and its logits within 2e-2 relative (bf16 roundings:
the plain run rounds each weight-only product to bf16 before its scale,
the split path sums f32 partials and rounds once; one bf16 rounding is
3.9e-3 relative); a certification whose chunks go through
the batch group's token gather gives the plain run's labels; the GPipe
loss and ``llama_proj`` gradient of a tiny fp32 model at one stage in two
microbatches give the sequential path's (f32, TF32 off: 1e-5 relative;
only the products' row blocking differs). They skip
where there is no CUDA device. This file imports neither JAX nor the
JAX package, so on the GPU machine it runs without the conftest:

    python -m pytest --noconftest tests/test_torch_parallel_gpu.py -q
"""

from unittest import mock

import numpy as np
import pytest
import torch

from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import llama as TLM
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.minigpt4 import MiniGPT4Config
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_params
from certifiedgpt_tpu_torch.parallel.mesh import make_mesh, partition_llama, set_active_mesh
from certifiedgpt_tpu_torch.parallel.pipeline import pipeline_minigpt4_loss
from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn


@pytest.fixture
def nccl(tmp_path):
    """One NCCL rank on the card, joined through a file."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        yield make_mesh(n_model=1)
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()


def _model(device):
    cfg = MiniGPT4Config.tiny(llama=TLM.LlamaConfig.tiny(act_quant=True, kv_quant=True,
                                                         dtype=torch.bfloat16))
    return MiniGPT4Model(cfg, build_synthetic_params(cfg, device, seed=0), ByteTokenizer())


@pytest.mark.gpu
def test_tensor_parallel_path_at_world_size_one(nccl):
    model = _model("cuda")
    cfg = model.cfg.llama
    b, s, new = 4, 24, 4
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((b, s, cfg.hidden_size), generator=g, device="cuda").to(cfg.dtype)
    mask = torch.ones((b, s + new), dtype=torch.int32, device="cuda")
    positions = torch.arange(s, device="cuda").expand(b, s)

    def run(params):
        cache = TLM.init_kv_cache(cfg, b, s + new, "cuda")
        logits, _, cache = TLM.llama_apply(params, cfg, x, mask, positions, cache, 0)
        out = [logits[:, -1]]
        for t in range(new):
            token = torch.argmax(out[-1], dim=-1)
            emb = TLM.embed_tokens(params, token[:, None])
            logits, _, cache = TLM.llama_apply(params, cfg, emb, mask,
                                               torch.full((b, 1), s + t, device="cuda"),
                                               cache, s + t)
            out.append(logits[:, -1])
        return torch.stack(out)

    with torch.no_grad():
        plain = run(model.params["llama"])
        assert nccl.model_group is not None and nccl.batch_group is not None
        with mock.patch.object(TLM, "tensor_parallel", lambda: nccl), \
                mock.patch.object(TM, "tensor_parallel", lambda: nccl):
            tp = run(partition_llama(model.params["llama"], nccl, cfg))
    assert torch.equal(tp.argmax(-1), plain.argmax(-1))
    rel = float((tp - plain).norm() / plain.norm())
    assert rel < 2e-2, rel


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_row_parallel_w8a8_rescale_at_world_size_one(nccl, dtype):
    """The row-parallel dense's W8A8 path on the card (the W8A8 GEMM
    kernel's int32 sums, their sum over the model group, ``w8a8_epilogue``)
    is the one-rank W8A8 product bit for bit, with a bias."""
    from certifiedgpt_tpu_torch.ops import quantization as Q
    from certifiedgpt_tpu_torch.parallel import tensor_parallel as TP

    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((130, 272), generator=g, device="cuda").to(dtype)
    params = Q.quantize_kernel(torch.randn((272, 136), generator=g, device="cuda") * 0.05)
    params["kernel_q"] = Q.int8_kernel_layout(params["kernel_q"])
    params["bias"] = (torch.randn(136, generator=g, device="cuda") * 0.1).to(dtype)
    before = (Q.w8a8_product.launches, Q.w8a8_epilogue.launches)
    with torch.no_grad():
        got = TP.row_parallel_dense(params, x, nccl, act_quant=True)
    assert (Q.w8a8_product.launches, Q.w8a8_epilogue.launches) == (before[0] + 1,
                                                                   before[1] + 1)
    want = Q.w8a8_matmul(x, params["kernel_q"], params["scale"], params["bias"])
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.gpu
def test_data_parallel_certify_at_world_size_one(nccl):
    model = _model("cuda")
    vocab = AnswerVocabulary(["cat", "dog"])
    image = np.random.RandomState(0).randn(28, 28, 3).astype(np.float32)

    def labels(mesh):
        set_active_mesh(mesh)
        fn = make_sample_fn(model, "<Img><ImageHere></Img> [vqa] what?", vocab, sigma=0.5,
                            mc_batch=8, max_new_tokens=3, seq_len=32, mesh=mesh)
        return fn(image, 24, seed=3)

    with torch.no_grad():
        plain = labels(None)
        got = labels(nccl)
    np.testing.assert_array_equal(got, plain)


@pytest.mark.gpu
def test_pipeline_at_one_stage_matches_sequential(nccl):
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_train_batch

    cfg = MiniGPT4Config.tiny(llama=TLM.LlamaConfig.tiny(num_layers=4))
    model = MiniGPT4Model(cfg, build_synthetic_params(cfg, "cuda", seed=0), ByteTokenizer())
    trainable = model.make_trainable(("llama_proj",))
    spec = BatchSpec(seq_len=48, num_img_tokens=cfg.num_img_tokens, max_answer_len=8)
    text = build_train_batch(ByteTokenizer(), [f"<Img><ImageHere></Img> what is {i}?"
                                               for i in range(4)],
                             ["cat", "dog", "two", "red"], spec)
    batch = {k: torch.from_numpy(v).long().cuda() for k, v in text.items()}
    batch["image"] = torch.from_numpy(np.random.RandomState(0).randn(
        4, cfg.vit.img_size, cfg.vit.img_size, 3).astype(np.float32)).cuda()
    assert nccl.n_pipe == 1 and nccl.pipe_group is None

    def loss_and_grad(loss_fn):
        for p in trainable["llama_proj"].values():
            p.grad = None
        loss = loss_fn()
        loss.backward()
        return float(loss.detach()), trainable["llama_proj"]["kernel"].grad.clone()

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = loss_and_grad(lambda: TM.minigpt4_loss(model.params, cfg, batch))
        got = loss_and_grad(lambda: pipeline_minigpt4_loss(model.params, cfg, batch, nccl, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert abs(got[0] - want[0]) / abs(want[0]) < 1e-5
    assert float((got[1] - want[1]).norm() / want[1].norm()) < 1e-5
