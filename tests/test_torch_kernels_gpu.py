"""The port's CUDA kernels (certifiedgpt_tpu_torch/csrc/) and their wrappers.

Tests marked ``gpu`` build and launch the kernels and hold each against its
plain PyTorch version on the card; they skip where there is no CUDA device.
This file imports neither JAX nor the JAX package, so on the GPU machine
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

The unmarked tests check, on any device, the wrappers' argument checks and
the build's failure when there is no ``nvcc``.
"""

import pytest
import torch

from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops import flash_attention as FA
from certifiedgpt_tpu_torch.ops import quantization as Q


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run on the GPU machine)")
    return torch.device("cuda")


def _qkv(b, n, h, d, device, generator=None, dtype=torch.bfloat16):
    """q, k, v (and the cls parts) as strided views of one fused product
    ``[B, 1 + N, 3, H, D]``, the way the ViT makes them."""
    prem = (d ** -0.5) * FA.CLS_SPLIT_Q_PREMUL_LOG2E
    y = torch.randn((b, n + 1, 3, h, d), generator=generator, device=device)
    y[:, :, 0] *= prem
    y = y.to(dtype)
    patches = [y[:, 1:, i].transpose(1, 2) for i in range(3)]
    cls = [y[:, :1, i].transpose(1, 2) for i in range(3)]
    return (*patches, *cls)


@pytest.mark.parametrize("case", ["n_not_tile", "d_too_wide", "d_not_8", "float32",
                                  "mixed_strides"])
def test_cls_split_operand_checks(case):
    b, n, h, d = 2, 128, 2, 88
    if case == "n_not_tile":
        n = 100
    elif case == "d_too_wide":
        d = FA.KERNEL_HEAD_DIM + 8
    elif case == "d_not_8":
        d = 84
    args = list(_qkv(b, n, h, d, "cpu", dtype=torch.float32 if case == "float32"
                     else torch.bfloat16))
    if case == "mixed_strides":
        args[1] = args[1].contiguous()
    with pytest.raises((ValueError, TypeError)):
        FA._check_operands(*args)
    if case == "n_not_tile":
        FA._check_operands(*_qkv(b, 128, h, d, "cpu"))  # the good shape passes


def test_row_quant_checks():
    with pytest.raises(TypeError, match="bf16"):
        Q._check_rows(torch.zeros(4, 16), "ln_quant_rows")
    with pytest.raises(ValueError, match="multiple of 8"):
        Q._check_rows(torch.zeros(4, 12, dtype=torch.bfloat16), "ln_quant_rows")
    with pytest.raises(ValueError, match="at most"):
        Q._check_rows(torch.zeros(2, Q.MAX_ROW_WIDTH + 8, dtype=torch.bfloat16), "x")
    assert Q._check_rows(torch.zeros(3, 5, 16, dtype=torch.bfloat16), "x") == (15, 16)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(cuda_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_kernels._nvcc()
    a = cuda_kernels._digest(cuda_kernels._sources())
    assert a == cuda_kernels._digest(cuda_kernels._sources()) and len(a) == 16


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [96, 4096])
def test_row_quant_kernels_match_plain_on_gpu(cuda, rows):
    """int8 codes equal except +-1 on at most 0.1 %; scales rtol 1e-2."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn((rows, 1408), generator=g, device=cuda) * 3).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(1408, generator=g, device=cuda)
    bias = 0.1 * torch.randn(1408, generator=g, device=cuda)
    for kern, plain, args in (
        (Q.ln_quant_rows, Q._ln_quant_rows_plain, (x, scale, bias, 1e-6)),
        (Q.gelu_quant_rows, Q._gelu_quant_rows_plain, (x,)),
    ):
        n = kern.launches
        kq, ks = kern(*args)
        pq, ps = plain(*args)
        assert kern.launches == n + 1
        diff = (kq.int() - pq.int()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
        torch.testing.assert_close(ks, ps, rtol=1e-2, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_cls_split_kernel_matches_plain_on_gpu(cuda, b):
    """bf16 outputs within atol 2e-2 of the plain version, at the served
    head dim (88)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    views = _qkv(b, 256, 16, 88, cuda, generator=g)
    before = FA.cls_split_attention_parts.launches
    out_c, out_p = FA.cls_split_attention_parts(*views)
    assert FA.cls_split_attention_parts.launches == before + 1
    ref_c, ref_p = FA._cls_split_attention_plain(*views)
    torch.testing.assert_close(out_p.float(), ref_p.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(out_c.float(), ref_c.float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 32])
def test_int8_matmul_on_gpu(cuda, rows):
    """Exact at any row count: fewer than 17 rows are padded for _int_mm."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-127, 128, (rows, 64), generator=g, device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 24), generator=g, device=cuda, dtype=torch.int8)
    want = a.double() @ b.double()
    got = Q.int8_matmul(a, Q.int8_kernel_layout(b))
    assert got.shape == (rows, 24) and torch.equal(got.double(), want)
    with pytest.raises(ValueError, match="column-major"):
        Q.int8_matmul(a, b.contiguous())
