"""The port's CUDA kernels (certifiedgpt_tpu_torch/csrc/) and their wrappers.

Tests marked ``gpu`` build and launch the kernels and hold each against its
plain PyTorch version on the card; they skip where there is no CUDA device.
This file imports neither JAX nor the JAX package, so on the GPU machine
(which has no JAX) it runs without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

The unmarked tests check, on any device, the wrappers' argument checks, the
build's failure when there is no ``nvcc`` and ``sass_count.py``'s loop count.
"""

import ctypes
import dataclasses
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import sass_count
from certifiedgpt_tpu_torch.ops import attention as A
from certifiedgpt_tpu_torch.ops import cuda_kernels
from certifiedgpt_tpu_torch.ops import elementwise as E
from certifiedgpt_tpu_torch.ops import flash_attention as FA
from certifiedgpt_tpu_torch.ops import noise as N
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


@pytest.mark.parametrize("case", ["float32", "d_too_wide", "d_not_8", "row_stride", "shapes"])
def test_flash_operand_checks(case):
    b, s, h, d = 2, 40, 2, 88
    if case == "d_too_wide":
        d = FA.KERNEL_HEAD_DIM + 8
    elif case == "d_not_8":
        d = 84
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    y = torch.zeros((b, s, 3, h, d), dtype=dtype)
    q, k, v = (y[:, :, i].transpose(1, 2) for i in range(3))
    if case == "row_stride":
        k = torch.zeros((b, h, s, d + 4), dtype=dtype)[..., :d]
    elif case == "shapes":
        v = v[:, :, :-1]
    with pytest.raises((ValueError, TypeError)):
        FA._check_rows("flash_attention", (("q", q), ("k", k), ("v", v)))
    if case == "shapes":  # views of one fused product at dh = 88 pass
        FA._check_rows("flash_attention", (("q", q), ("k", k), ("v", q)))


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


def test_device_events_leave_out_the_trace_pads():
    """``device_events`` keeps the card's operations of a trace, events or
    their averages, and drops the spins that pad a ``device_trace``."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    events = [SimpleNamespace(key=key, device_type=kind) for key, kind in (
        ("at::cuda::(anonymous namespace)::spin_kernel(long)", DeviceType.CUDA),
        ("void (anonymous namespace)::rotary_kernel<float>(RotaryArgs)", DeviceType.CUDA),
        ("aten::add", DeviceType.CPU),
        ("Memset (Device)", DeviceType.CUDA),
        ("at::cuda::(anonymous namespace)::spin_kernel(long)", DeviceType.CUDA))]
    assert cuda_kernels.device_events(events) == [events[1], events[3]]


# cuobjdump -sass of a small kernel: a guarded entry, an image loop with a
# block jumped over, and an out-of-line slow path that jumps back
_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_112noise_kernelILb1EEEvPKf
        /*0000*/                   S2R R0, SR_TID.X ;                 /* 0x0000000000007919 */
        /*0010*/               @P0 EXIT ;
        /*0020*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0030*/                   LDS.128 R8, [UR6] ;
        /*0040*/                   IMAD.WIDE.U32 R12, R8, -0x326172a9, RZ ;
        /*0050*/                   LOP3.LUT R12, R13, UR5, R12, 0x96, !PT ;
        /*0060*/                   MUFU.LG2 R14, R12 ;
        /*0070*/                   FFMA R15, R14, R4, R5 ;
        /*0080*/              @!P1 BRA 0xa0 ;
        /*0090*/                   FMUL R15, R15, 2 ;
        /*00a0*/                   STG.E.128 desc[UR4][R2.64], R12 ;
        /*00b0*/                   UIADD3 UR4, UR4, 0x1, URZ ;
        /*00c0*/               @P2 BRA 0x30 ;
        /*00d0*/                   EXIT ;
        /*00e0*/                   MOV R1, R2 ;
        /*00f0*/                   BRA 0x40 ;
        /*0100*/                   BRA 0x100;
\t\tFunction : _ZN12_GLOBAL__N_112noise_kernelILb0EEEvPKf
        /*0000*/                   EXIT ;
"""


def test_sass_count_counts_one_trip_of_the_innermost_loop():
    insts = sass_count.parse(_SASS, sass_count.NOISE_KERNEL)
    assert len(insts) == 17 and insts[1] == (0x10, True, "EXIT", "")
    # the loop 0x30-0xc0; the block 0xe0-0xf0 jumps back over an EXIT
    assert sass_count.loop_trip(insts) == {"all": 10, "memory": 2, "integer": 2, "mufu": 1,
                                           "f32": 2, "control": 2, "uniform": 1}
    assert sass_count.loop_trip(sass_count.parse(_SASS, "ILb0E")) is None
    # 10 instructions an element of 57.8 M at 128 a clock on 132 SMs at 1980 MHz
    assert sass_count.issue_ms(10, 96 * 448 * 448 * 3, 132, 1980.0) == pytest.approx(
        10 * 96 * 448 * 448 * 3 / (128 * 132 * 1980e6) * 1e3)


def test_sass_count_counts_opcodes_of_each_instance():
    """Each function whose name holds the part, its opcodes by base (the
    weight-only kernel's I2F check reads I2F and I2FP)."""
    counts = sass_count.opcode_counts(_SASS, "noise_kernel")
    assert set(counts) == {"_ZN12_GLOBAL__N_112noise_kernelILb1EEEvPKf",
                           "_ZN12_GLOBAL__N_112noise_kernelILb0EEEvPKf"}
    first = counts["_ZN12_GLOBAL__N_112noise_kernelILb1EEEvPKf"]
    assert first["BRA"] == 4 and first["EXIT"] == 2 and sum(first.values()) == 17
    assert counts["_ZN12_GLOBAL__N_112noise_kernelILb0EEEvPKf"] == {"EXIT": 1}
    assert sass_count.opcode_counts(_SASS, "int8_weight_matmul_kernel") == {}


def _assert_codes_close(got, want, share, scale_rtol):
    """Codes at most one step apart on at most ``share`` of the elements;
    scales within ``scale_rtol``."""
    (kq, ks), (pq, ps) = got, want
    diff = (kq.int() - pq.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= share
    torch.testing.assert_close(ks, ps, rtol=scale_rtol, atol=0)


# A GELU row whose values come out of the GELU unchanged (x >= 6 rounds
# Phi(x) to 1): its absmax 127 gives the scale 1, so the halves are exact ties
_TIES = [127.0, 63.5, 6.5, 7.5, 8.5, 9.5, 10.5, 125.5, 126.5, 64.5, 6.0, 100.0, 120.5, 11.5,
         12.5, 13.5]


@pytest.mark.gpu
@pytest.mark.parametrize("param_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 96, 4097])
@pytest.mark.parametrize("k", [8, 1408, 6144, 8192])
def test_row_quant_kernels_match_plain_on_gpu(cuda, k, rows, param_dtype):
    """Both kernels at the served widths (1408, 6144), the narrowest and the
    widest, over row counts that leave teams and blocks idle, on N(0, 3^2)
    rows with a row of zeros and a row of exact ties: against the plain
    versions that repeat their arithmetic (the LayerNorm's, the A-S GELU's)
    codes one step apart on at most 1e-4 of the elements and scales within
    1e-6; against the exact-erf GELU one step on 1e-3, scales 1e-2. The
    LayerNorm reads gamma and beta as bf16 or f32."""
    g = torch.Generator(device=cuda).manual_seed(k + rows)
    x = (torch.randn((rows, k), generator=g, device=cuda) * 3).to(torch.bfloat16)
    if rows > 1:
        x[rows // 2] = 0
        ties = torch.tensor(_TIES[:k], device=cuda)
        x[0, :ties.numel()] = ties.to(torch.bfloat16)
        x[0, ties.numel():] = 0
    scale = (1 + 0.1 * torch.randn(k, generator=g, device=cuda)).to(param_dtype)
    bias = (0.1 * torch.randn(k, generator=g, device=cuda)).to(param_dtype)
    n = (Q.ln_quant_rows.launches, Q.gelu_quant_rows.launches)
    ln = Q.ln_quant_rows(x, scale, bias, 1e-6)
    gelu = Q.gelu_quant_rows(x)
    assert (Q.ln_quant_rows.launches, Q.gelu_quant_rows.launches) == (n[0] + 1, n[1] + 1)
    _assert_codes_close(ln, Q._ln_quant_rows_plain(x, scale, bias, 1e-6), 1e-4, 1e-6)
    _assert_codes_close(gelu, Q._gelu_quant_rows_as_plain(x), 1e-4, 1e-6)
    _assert_codes_close(gelu, Q._gelu_quant_rows_plain(x), 1e-3, 1e-2)
    if rows > 1:
        assert not gelu[0][rows // 2].any()
        want = torch.round(ties.float()).to(torch.int8)  # half to even
        assert float(gelu[1][0]) == 1.0 and torch.equal(gelu[0][0, :ties.numel()], want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [16, 1408])
def test_ln_quant_kernel_rounds_ties_to_even_on_gpu(cuda, k):
    """gamma = 0 makes the LayerNorm's output beta exactly: beta with the
    absmax 127 gives the scale 1 and codes rint(beta), half to even."""
    x = torch.randn((5, k), device=cuda).to(torch.bfloat16)
    beta = torch.tensor((_TIES + [-0.5, -1.5, -2.5, 0.5, 1.5, 2.5]) * k, device=cuda)[:k]
    q, s = Q.ln_quant_rows(x, torch.zeros(k, device=cuda), beta, 1e-6)
    assert torch.equal(s, torch.ones_like(s))
    assert torch.equal(q, torch.round(beta).to(torch.int8).expand(5, k))


@pytest.mark.gpu
def test_row_quant_kernels_refuse_bad_operands_on_gpu(cuda):
    """A CUDA tensor launches the kernel or raises: a view off the 16-byte
    boundary, f16 LayerNorm parameters and params on another device raise
    before any launch; zero rows launch nothing."""
    x = torch.zeros(4 * 16 + 8, dtype=torch.bfloat16, device=cuda)
    n = (Q.ln_quant_rows.launches, Q.gelu_quant_rows.launches)
    with pytest.raises(ValueError, match="16-byte"):
        Q.gelu_quant_rows(x[1:65].view(4, 16))
    ok = x[8:72].view(4, 16)
    with pytest.raises(TypeError):
        Q.ln_quant_rows(ok, torch.ones(16, device=cuda).half(), torch.zeros(16, device=cuda))
    with pytest.raises(ValueError):
        Q.ln_quant_rows(ok, torch.ones(16), torch.zeros(16))
    q, s = Q.gelu_quant_rows(ok[:0])
    assert q.shape == (0, 16) and s.shape == (0, 1)
    assert (Q.ln_quant_rows.launches, Q.gelu_quant_rows.launches) == n


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(1, 256, 88), (4, 256, 88), (2, 64, 88), (2, 192, 88),
                                   (1, 1024, 88), (2, 2112, 88), (2, 128, 8), (2, 192, 96)])
def test_cls_split_kernel_matches_plain_on_gpu(cuda, b, n, d):
    """bf16 outputs within atol 2e-2 (1e-2 relative, Frobenius) of the plain
    version, patch rows and the cls row of the one launch: at the served head
    dim (88) and at the narrowest and widest, with a half-filled 128-query
    block (N = 64, 192), and with more keys than one chunk of the cls row
    (N = 2112). The cls row is also held against its own plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    views = _qkv(b, n, 16, d, cuda, generator=g)
    before = FA.cls_split_attention_parts.launches
    rows_before = FA._cls_query_row.calls
    out_c, out_p = FA.cls_split_attention_parts(*views)
    assert FA.cls_split_attention_parts.launches == before + 1
    assert FA._cls_query_row.calls == rows_before  # no plain cls row on the CUDA path
    assert out_p.transpose(1, 2).is_contiguous() and out_c.shape == (b, 16, 1, d)
    ref_c, ref_p = FA._cls_split_attention_plain(*views)
    torch.testing.assert_close(out_p.float(), ref_p.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(out_c.float(), ref_c.float(), atol=2e-2, rtol=0)
    qp, kp, vp, qc, kc, vc = views
    row = FA._cls_query_row(qc, kp, vp, kc, vc)
    torch.testing.assert_close(out_c.float(), row.float(), atol=2e-2, rtol=0)
    assert _rel(out_p, ref_p) < 1e-2 and _rel(out_c, ref_c) < 1e-2 and _rel(out_c, row) < 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 32])
def test_int8_matmul_on_gpu(cuda, rows):
    """Exact at any row count (the W8A8 GEMM kernel's int32 instance: a
    single partial row tile at 1 and 16 rows)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randint(-127, 128, (rows, 64), generator=g, device=cuda, dtype=torch.int8)
    b = torch.randint(-127, 128, (64, 24), generator=g, device=cuda, dtype=torch.int8)
    want = a.double() @ b.double()
    got = Q.int8_accumulate(a, Q.int8_kernel_layout(b))
    assert got.shape == (rows, 24) and torch.equal(got.double(), want)
    with pytest.raises(ValueError, match="column-major"):
        Q.int8_accumulate(a, b.contiguous())


def _bshd_views(b, s, h, d, device, generator):
    """q, k, v as [B, S, H, D] views of one fused product [B, S, 3 * H * D]
    (the flash_custom layout; row stride 3 H D)."""
    y = torch.randn((b, s, 3 * h * d), generator=generator, device=device)
    return [t.reshape(b, s, h, d) for t in y.to(torch.bfloat16).split(h * d, dim=-1)]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", [
    (2, 1025, 16, 88),  # the ViT's sequence: a 1-token tail tile
    (4, 333, 16, 88),
    (2, 33, 4, 8),
    (2, 64, 4, 32),
    (2, 1, 4, 88), (2, 63, 4, 88), (2, 65, 4, 88), (2, 128, 4, 88), (2, 129, 4, 88),
    (1, 300, 2, 96),
], ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain_on_gpu(cuda, shape, causal):
    """bf16 outputs within atol 2e-2 (1e-2 relative, Frobenius) of the plain
    version in both layouts, causal or not, with ragged tails around the
    64-key tile and the 128-query block and narrow heads; an explicit scale
    is folded into the exponent."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = _bshd_views(*shape, cuda, g)
    before = FA.flash_attention.launches
    out = FA.flash_attention(q, k, v, causal=causal)
    assert FA.flash_attention.launches == before + 1
    assert out.shape == q.shape and out.is_contiguous()
    ref = FA._flash_attention_plain(q, k, v, causal, shape[-1] ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    assert _rel(out, ref) < 1e-2
    if causal:  # the first query sees only the first key
        torch.testing.assert_close(out[:, 0], v[:, 0])
    out_s = FA.flash_attention(q, k, v, causal=causal, scale=0.2)
    ref_s = FA._flash_attention_plain(q, k, v, causal, 0.2)
    torch.testing.assert_close(out_s.float(), ref_s.float(), atol=2e-2, rtol=0)
    assert _rel(out_s, ref_s) < 1e-2
    # [B, H, S, D] views of a fused [B, S, 3, H, D] product (the flash form)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if not causal:
        outh = FA.builtin_flash_attention_bhsd(qh, kh, vh, shape[-1])
        torch.testing.assert_close(outh.transpose(1, 2).float(), ref.float(), atol=2e-2, rtol=0)
        torch.testing.assert_close(FA.builtin_flash_attention(q, k, v).float(), ref.float(),
                                   atol=2e-2, rtol=0)
        # contiguous [B, H, S, D] operands of their own (other strides)
        outc = FA.builtin_flash_attention_bhsd(qh.contiguous(), kh.contiguous(),
                                               vh.contiguous(), shape[-1])
        torch.testing.assert_close(outc.transpose(1, 2).float(), ref.float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_raises_on_bad_operands_on_gpu(cuda):
    x = torch.zeros((1, 64, 2, 88), device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        FA.flash_attention(x, x, x)
    y = torch.zeros((1, 64, 2, 104), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(y, y, y)
    z = torch.zeros((1, 64, 2, 88), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="positive"):
        FA.flash_attention(z, z, z, scale=0.0)
    for case in ("n_not_tile", "d_too_wide", "float32", "mixed_strides"):
        n, d = (100 if case == "n_not_tile" else 128), (104 if case == "d_too_wide" else 88)
        args = list(_qkv(2, n, 2, d, cuda, dtype=torch.float32 if case == "float32"
                         else torch.bfloat16))
        if case == "mixed_strides":
            args[1] = args[1].contiguous()
        with pytest.raises((ValueError, TypeError)):
            FA.cls_split_attention_parts(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 64, 192])
def test_cls_split_scaled_matches_plain_on_gpu(cuda, n):
    """The explicit-scale form on [B, H, 1 + N, D] tensors (cls at index 0):
    the patch views start 176 bytes into each (b, h) row block. All 1 + N
    rows come from one launch; the cls row is also held against its own
    plain version."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((2, 16, 1 + n, 88), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    before = FA.cls_split_attention_scaled.launches
    rows_before = FA._cls_query_row.calls
    out = FA.cls_split_attention_scaled(q, k, v, 88)
    assert FA.cls_split_attention_scaled.launches == before + 1
    assert FA._cls_query_row.calls == rows_before
    ref = FA._cls_split_attention_scaled_plain(q, k, v, 88 ** -0.5)
    assert out.shape == ref.shape == (2, 16, 1 + n, 88)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    assert _rel(out, ref) < 1e-2 and _rel(out[:, :, :1], ref[:, :, :1]) < 1e-2
    row = FA._cls_query_row(q[:, :, :1], k[:, :, 1:], v[:, :, 1:], k[:, :, :1], v[:, :, :1],
                            88 ** -0.5 * FA.CLS_SPLIT_Q_PREMUL_LOG2E)
    torch.testing.assert_close(out[:, :, :1].float(), row.float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("sigma", [0.5, 3.0])
@pytest.mark.parametrize("n", [1, 3, 96])
@pytest.mark.parametrize("hwc", [(448, 448, 3), (1,), (7,), (8,), (9,), (4097,), (5, 3, 3)],
                         ids=["448px", "1", "7", "8", "9", "4097", "odd45"])
def test_noise_kernel_matches_plain_on_gpu(cuda, hwc, n, sigma):
    """Values within 1e-5 of the plain version at sigma 0.5, scaled with
    sigma, on the same seed words (the same Philox integers; the kernel's
    log, sqrt and cos are approximations for their arguments' domains, the
    plain version's exact), one launch a call, and sigma = 0 returns the
    clean tile bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(hwc, generator=g, device=cuda)
    gen = torch.Generator(device=cuda)
    before = N.noisy_tile.launches
    out = N.noisy_tile(x, n, sigma, gen.manual_seed(5), use_kernel=True)
    assert N.noisy_tile.launches == before + 1
    seed = N._seed_words(gen.manual_seed(5), cuda)
    ref = N._noisy_tile_kernel_plain(x, n, torch.tensor(sigma, device=cuda), seed)
    assert out.shape == ref.shape == (n, *hwc)
    torch.testing.assert_close(out, ref, atol=1e-5 * sigma / 0.5, rtol=0)
    zero = N.noisy_tile(x, n, 0.0, gen, use_kernel=True)
    assert N.noisy_tile.launches == before + 2
    assert torch.equal(zero, x.expand_as(zero))


@pytest.mark.gpu
def test_noise_kernel_takes_a_non_contiguous_image(cuda):
    """A strided image is made contiguous first: the same values as the
    kernel on its contiguous copy, and as the plain version, on the same
    seed words."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((16, 10, 3), generator=g, device=cuda)[:, ::2]
    assert not x.is_contiguous()
    gen = torch.Generator(device=cuda)
    out = N.noisy_tile(x, 3, 0.5, gen.manual_seed(2), use_kernel=True)
    want = N.noisy_tile(x.contiguous(), 3, 0.5, gen.manual_seed(2), use_kernel=True)
    assert torch.equal(out, want)
    ref = N._noisy_tile_kernel_plain(x, 3, torch.tensor(0.5, device=cuda),
                                     N._seed_words(gen.manual_seed(2), cuda))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


_CURAND_SOURCE = r"""
#include <curand_kernel.h>
__global__ void philox(const uint4* c, uint2 k, uint4* out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = curand_Philox4x32_10(c[i], k);
}
extern "C" int curand_philox(const void* c, unsigned k0, unsigned k1, void* out, int n) {
  philox<<<(n + 127) / 128, 128>>>(static_cast<const uint4*>(c), make_uint2(k0, k1),
                                   static_cast<uint4*>(out), n);
  cudaDeviceSynchronize();
  return static_cast<int>(cudaGetLastError());
}
"""


@pytest.mark.gpu
def test_philox_matches_curand_on_gpu(cuda, tmp_path):
    """The plain generator gives the words of curand's device-side
    Philox4x32-10 (curand_philox4x32_x.h), built here for the test only; the
    noise kernel's values equal the plain version's on the same seed words
    (test_noise_kernel_matches_plain_on_gpu), so it draws the same words."""
    src = tmp_path / "curand_philox.cu"
    src.write_text(_CURAND_SOURCE)
    lib_path = tmp_path / "libcurand_philox.so"
    subprocess.run([cuda_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.curand_philox.argtypes = (ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                                  ctypes.c_void_p, ctypes.c_int)
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 4096
    ctr = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 4), generator=g, device=cuda,
                        dtype=torch.int32)
    key = (0x9E3779B9, 0x12345678)
    want = torch.empty_like(ctr)
    assert lib.curand_philox(ctr.data_ptr(), *key, want.data_ptr(), n) == 0
    words = [(ctr[:, i].long() & 0xFFFFFFFF) for i in range(4)]
    plain = N.philox4x32_10(words, [torch.tensor(k, device=cuda) for k in key])
    assert torch.equal(torch.stack(plain, dim=1), want.long() & 0xFFFFFFFF)


# ----------------------------------------------------------------------
# the int8 ops of the main path: quantize_rows, the W8A8 epilogue, the
# weight-only product and attention over the int8 KV cache
# ----------------------------------------------------------------------
def reciprocal_rows(n, k, seed=0):
    """bf16 rows ``[n, k]`` whose absmax ``a`` is a value where the product
    with f32(1 / 127) and the IEEE division a / 127 differ (what PyTorch on
    CUDA computes for ``t / 127.0``, against the JAX package's division),
    found with numpy from seeded |N(0, 3^2)| maxima; the other values of a
    row lie within its absmax."""
    rng = np.random.RandomState(seed)
    cand = torch.from_numpy(np.abs(rng.randn(50 * n) * 3).astype(np.float32))
    cand = cand.to(torch.bfloat16).float().numpy()
    differ = cand / np.float32(127) != cand * (np.float32(1) / np.float32(127))
    amax = cand[differ][:n]
    assert amax.size == n
    x = rng.uniform(-1, 1, (n, k)).astype(np.float32) * amax[:, None]
    x[:, 0] = amax
    return torch.from_numpy(x).to(torch.bfloat16), amax


@pytest.mark.gpu
def test_quantize_rows_divides_by_127_on_gpu(cuda):
    """The row scale is max(amax, 1e-8) / 127 as one IEEE division on the
    card, as on the CPU and in the JAX package: on rows whose absmax makes
    the reciprocal product differ from the division, the scales equal
    numpy's division and the codes and scales the CPU's, through the kernel
    and through the plain version on the card."""
    x, amax = reciprocal_rows(64, 256)
    want = (amax / np.float32(127))[:, None]
    cpu_q, cpu_s = Q.quantize_rows(x)
    np.testing.assert_array_equal(cpu_s.numpy(), want)
    q, s = Q.quantize_rows(x.to(cuda))
    np.testing.assert_array_equal(s.cpu().numpy(), want)
    assert torch.equal(q.cpu(), cpu_q) and torch.equal(s.cpu(), cpu_s)
    q, s = Q._quantize_rows_plain(x.to(cuda))
    np.testing.assert_array_equal(s.cpu().numpy(), want)
    assert torch.equal(q.cpu(), cpu_q) and torch.equal(s.cpu(), cpu_s)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 8, 96, 4097])
@pytest.mark.parametrize("k", [8, 128, 1408, 4096, 11008, 32768])
def test_quant_rows_kernel_matches_plain_on_gpu(cuda, k, rows, dtype):
    """quantize_rows' kernel (bf16 rows, and the f32 instance) against its
    plain version on the card and on the CPU, bit for bit: the KV cache's
    rows (128), the ViT's proj input (1408), the prefill's inputs (4096,
    11008) and the narrowest and widest, on N(0, 3^2) rows with a row of
    zeros and a row of exact ties."""
    g = torch.Generator(device=cuda).manual_seed(k + rows)
    x = (torch.randn((rows, k), generator=g, device=cuda) * 3).to(dtype)
    if rows > 1:
        x[rows // 2] = 0
        ties = torch.tensor(_TIES[:k], device=cuda)
        x[0, :ties.numel()] = ties.to(torch.bfloat16)
        x[0, ties.numel():] = 0
    n = Q.quantize_rows.launches
    q, s = Q.quantize_rows(x)
    assert Q.quantize_rows.launches == n + 1
    pq, ps = Q._quantize_rows_plain(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)
    cq, cs = Q.quantize_rows(x.cpu())
    assert torch.equal(q.cpu(), cq) and torch.equal(s.cpu(), cs)
    if rows > 1:
        assert float(s[0]) == 1.0 and torch.equal(q[0, :ties.numel()],
                                                  torch.round(ties).to(torch.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("m,n", [(1, 1408), (8, 4224), (96, 6144), (4097, 1408), (300, 11008)])
def test_w8a8_epilogue_matches_plain_on_gpu(cuda, m, n, bias, dtype):
    """The epilogue (bf16 out, and the f32 instance) against its plain chain
    bit for bit, from an int32 accumulator that is a row slice, with and
    without a bias; and _w8a8_epilogue (the W8A8 GEMM kernel) end to end
    from int8 rows against the plain rescale of the kernel's int32 sums."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    acc = torch.randint(-2 ** 22, 2 ** 22, (m + 5, n), generator=g, device=cuda,
                        dtype=torch.int32)[:m]
    xs = torch.rand((m, 1), generator=g, device=cuda) * 1e-2
    ws = torch.rand(n, generator=g, device=cuda) * 1e-3
    b = torch.randn(n, generator=g, device=cuda).to(dtype) if bias else None
    before = Q.w8a8_epilogue.launches
    out = Q.w8a8_epilogue(acc, xs, ws, b, dtype)
    assert Q.w8a8_epilogue.launches == before + 1 and out.dtype == dtype
    assert torch.equal(out, Q._w8a8_epilogue_plain(acc, xs, ws, b, dtype))
    xq = torch.randint(-127, 128, (m, 256), generator=g, device=cuda, dtype=torch.int8)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (256, n), generator=g, device=cuda,
                                            dtype=torch.int8))
    got = Q._w8a8_epilogue(xq, xs, kq, ws, dtype, b)
    want = Q._w8a8_epilogue_plain(Q.int8_accumulate(xq, kq), xs, ws, b, dtype)
    assert torch.equal(got, want)


def _int_mm(xq, kq):
    """torch._int_mm's exact int32 product (rows zero-padded to 24 where
    fewer: it takes M > 16), the yardstick of the W8A8 GEMM kernel."""
    m = xq.shape[0]
    if m < 24:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 24 - m))
    return torch._int_mm(xq, kq)[:m]


def _w8a8_operands(m, k, n, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device, dtype=torch.int8)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=device,
                                            dtype=torch.int8))
    xs = torch.rand((m, 1), generator=g, device=device) * 1e-2 + 1e-3
    ws = torch.rand(n, generator=g, device=device) * 1e-4
    return g, xq, kq, xs, ws


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("m,k,n", [(1, 1408, 4224), (8, 1408, 6144), (96, 6144, 1408),
                                   (130, 4112, 136), (1000, 272, 200), (2048, 1408, 4224),
                                   (9216, 4096, 4096), (3193, 1408, 4224), (2000, 1424, 1408),
                                   (1, 1408, 1408), (8, 1408, 1408), (96, 1408, 1408),
                                   (128, 1408, 1408), (1, 6144, 1408), (8, 6144, 1408),
                                   (128, 6144, 1408), (128, 6144, 4224)])
def test_w8a8_product_matches_plain_on_gpu(cuda, m, k, n, bias, dtype):
    """The W8A8 GEMM kernel (each tile width the launcher picks, rows, K and
    N off the tiles; tiles several times the persistent blocks with an odd
    count of row tiles, so a cluster's partner lies past the edge; K off the
    128-byte step; 1-128 rows with K split over blocks) bit for bit the
    plain rescale of torch._int_mm's exact sums, in one launch; its int32
    instance equal to torch._int_mm."""
    g, xq, kq, xs, ws = _w8a8_operands(m, k, n, cuda, m + k + n)
    b = (torch.randn(n, generator=g, device=cuda) * 0.1).to(dtype) if bias else None
    acc = _int_mm(xq, kq)
    before = Q.w8a8_product.launches
    out = Q.w8a8_product(xq, xs, kq, ws, b, dtype)
    assert Q.w8a8_product.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    assert torch.equal(out, Q._w8a8_epilogue_plain(acc, xs, ws, b, dtype))
    assert torch.equal(Q.int8_accumulate(xq, kq), acc)


@pytest.mark.gpu
def test_w8a8_product_of_a_stacked_layer_and_in_a_graph(cuda):
    """A layer of a stacked [L, K, N] column-major kernel (its offset a
    multiple of 16 bytes), replayed from a CUDA graph, gives the eager
    launch's output; one call is one kernel and nothing else on the card."""
    g, xq, _, xs, ws = _w8a8_operands(300, 1408, 1408, cuda, 3)
    stacked = Q.int8_kernel_layout(torch.randint(-127, 128, (3, 1408, 1408), generator=g,
                                                 device=cuda, dtype=torch.int8))
    kq = stacked[1]
    want = Q._w8a8_epilogue_plain(_int_mm(xq, kq), xs, ws, None, torch.bfloat16)
    assert torch.equal(Q.w8a8_product(xq, xs, kq, ws), want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q.w8a8_product(xq, xs, kq, ws)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = Q.w8a8_product(xq, xs, kq, ws)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    counts, ops = cuda_kernels.traced_launches(lambda: Q.w8a8_product(xq, xs, kq, ws))
    assert counts == {Q.w8a8_product: 1} and ops == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(96, 6144, 1408), (8, 6144, 4224), (1, 6144, 1408)])
def test_w8a8_split_k_leaves_its_counters_clean(cuda, m, k, n):
    """Two split-K calls in a row on the device's scratch give equal
    outputs, the plain rescale of the exact sums, and leave every tile
    counter at zero; the launch plan splits K and launches a block a unit."""
    g, xq, kq, xs, ws = _w8a8_operands(m, k, n, cuda, 7)
    b = (torch.randn(n, generator=g, device=cuda) * 0.1).to(torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits = Q.w8a8_splits(m, n, k, sms)
    assert splits > 1
    plan = (ctypes.c_int * 11)()
    cuda_kernels.check(cuda_kernels.build().lib.cgpt_w8a8_gemm_plan(m, n, k, splits, plan),
                       "plan")
    assert plan[8] == splits and plan[7] == 1 and plan[5] == plan[4] <= sms
    first = Q.w8a8_product(xq, xs, kq, ws, b)
    second = Q.w8a8_product(xq, xs, kq, ws, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, Q._w8a8_epilogue_plain(_int_mm(xq, kq), xs, ws, b, torch.bfloat16))
    scratch, units = Q._split_scratch(cuda)
    assert not bool(scratch[units * Q.W8A8_SPLIT_TILE[0] * Q.W8A8_SPLIT_TILE[1]:].any())


@pytest.mark.gpu
def test_w8a8_product_is_persistent_at_the_vit_shapes(cuda):
    """At the ViT's patch-stream products the plan launches fewer blocks
    than tiles, in clusters of two, with the epilogue staged apart from the
    ring and stored by TMA."""
    for k, n in ((1408, 4224), (1408, 1408), (1408, 6144), (6144, 1408)):
        plan = (ctypes.c_int * 11)()
        cuda_kernels.check(cuda_kernels.build().lib.cgpt_w8a8_gemm_plan(98304, n, k, 1, plan),
                           "plan")
        assert plan[5] < plan[4] and plan[7] == 2 and plan[8] == 1 and plan[10] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k_not_16", "row_major", "float16"])
def test_w8a8_product_refuses_on_gpu(cuda, case):
    """What the kernel does not take raises; nothing falls back."""
    k = 40 if case == "k_not_16" else 64
    _, xq, kq, xs, ws = _w8a8_operands(32, k, 16, cuda, 4)
    if case == "row_major":
        kq = kq.contiguous()
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    before = Q.w8a8_product.launches
    with pytest.raises((TypeError, ValueError)):
        Q.w8a8_product(xq, xs, kq, ws, None, dtype)
    assert Q.w8a8_product.launches == before


#: relative Frobenius error of the weight-only kernel against its plain
#: version: both sum exact products in f32, in another order, so only a few
#: bf16 roundings of the output move (one step each, 2^-8 relative)
INT8_MATMUL_REL_LIMIT = 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 17, 96, 130, 700, 9216])
@pytest.mark.parametrize("k,n", [(64, 24), (4096, 4096), (4096, 11008), (11008, 4096),
                                 (1408, 200), (4112, 136), (48, 8)])
def test_int8_weight_matmul_matches_plain_on_gpu(cuda, m, k, n):
    """The weight-only product against its plain version (f32 sums of the
    same exact products) within INT8_MATMUL_REL_LIMIT, and against the sums
    in f64: at the decode's rows (1, 8, 96; 17, an instance of 32 rows
    partly filled), a second row tile (130), a larger M (700) and the
    prefill's 9216 rows, split K and not, K off the 64-value K tile (4112,
    48), N a multiple of 8 off the 128-channel tile."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                                            dtype=torch.int8))
    scale = torch.rand(n, generator=g, device=cuda) * 1e-2
    before = Q.int8_weight_forward.launches
    out = Q.int8_weight_forward(x, kq, scale)
    assert Q.int8_weight_forward.launches == before + 1
    assert out.shape == (m, n) and out.dtype == torch.bfloat16
    plain = Q._int8_weight_forward_plain(x, kq, scale)
    exact = ((x.double() @ kq.double()) * scale.double()).to(torch.bfloat16)
    assert _rel(out, plain) < INT8_MATMUL_REL_LIMIT
    assert _rel(out, exact) < INT8_MATMUL_REL_LIMIT
    again = Q.int8_weight_forward(x, kq, scale)
    assert torch.equal(out, again)  # the split-K sum's order is fixed


@pytest.mark.gpu
def test_int8_weight_matmul_refuses_bad_operands_on_gpu(cuda):
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=cuda)
    kq = torch.zeros((64, 24), dtype=torch.int8, device=cuda)
    n = Q.int8_weight_forward.launches
    with pytest.raises(ValueError, match="column-major"):
        Q.int8_weight_forward(x, kq, torch.ones(24, device=cuda))
    with pytest.raises(TypeError):
        Q.int8_weight_forward(x.half(), Q.int8_kernel_layout(kq), torch.ones(24, device=cuda))
    assert Q.int8_weight_forward.launches == n


#: relative Frobenius error of the weight-only kernel's f32 instance: exact
#: products of x's three bf16 terms summed in f32 in another order than
#: cuBLAS's, a few f32 ulps
F32_MATMUL_REL_LIMIT = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 64, 24), (3, 64, 128), (33, 1408, 200),
                                   (96, 4096, 4096), (1, 4096, 11008), (8, 11008, 4096),
                                   (768, 4096, 4096), (9216, 11008, 4096)])
def test_int8_weight_matmul_f32_matches_plain_on_gpu(cuda, m, k, n):
    """The f32 instance (f32 configurations) launches the kernel and agrees
    with the exact (f64) product and with the plain version's f32 product
    (TF32 off), at chip_smoke.py's shapes and the prefill's ``down_proj``
    (the deepest K)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                                            dtype=torch.int8))
    scale = torch.rand(n, generator=g, device=cuda) * 1e-2
    before = Q.int8_weight_forward.launches
    out = Q.int8_weight_forward(x, kq, scale)
    assert Q.int8_weight_forward.launches == before + 1
    exact = ((x.double() @ kq.double()) * scale.double()).float()
    assert out.dtype == torch.float32 and _rel(out, exact) < F32_MATMUL_REL_LIMIT
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = Q._int8_weight_forward_plain(x, kq, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert _rel(out, ref) < F32_MATMUL_REL_LIMIT


@pytest.mark.gpu
def test_int8_weight_matmul_f32_split_edges_on_gpu(cuda):
    """x at the three-term split's edges: rows of tiny values (|x| near
    2^-120, where the lo term is a bf16 subnormal: the kernel loses at most
    2^-126 a value, against the f64 product), huge ones near the top of the
    f32 range (truncation never rounds up into infinity), zeros of both
    signs, and an infinite value (its own hi term: the row is infinite where
    the plain product is, NaN nowhere else)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    k, n = 256, 64
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                                            dtype=torch.int8))
    scale = torch.ones(n, device=cuda)
    x = torch.randn((4, k), generator=g, device=cuda)
    x[0] *= 2.0 ** -120
    x[1] = x[1].sign() * 3.4e38 / k / 127
    x[2] = 0.0
    x[2, ::2] = -0.0
    out = Q.int8_weight_forward(x, kq, scale)
    exact = x.double() @ kq.double()
    budget = (2.0 ** -126) * kq.double().abs().sum(dim=0)
    assert bool(((out[0].double() - exact[0]).abs() <= budget + 1e-6 * exact[0].abs()).all())
    assert float((out[1].double() - exact[1]).norm() / exact[1].norm()) < F32_MATMUL_REL_LIMIT
    assert bool(torch.isfinite(out[1]).all())
    assert not out[2].any()
    x[3, 5] = float("inf")
    out = Q.int8_weight_forward(x, kq, scale)
    ref = Q._int8_weight_forward_plain(x, kq, scale)
    assert torch.equal(out[3].isinf(), ref[3].isinf()) and torch.equal(out[3].isnan(),
                                                                        ref[3].isnan())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 96])
def test_int8_weight_matmul_split_k_on_two_streams_on_gpu(cuda, m):
    """Split-K launches in flight on two streams at once share nothing:
    every result equals the one of a launch alone."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((m, 4096), generator=g, device=cuda).to(torch.bfloat16)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (4096, 4096), generator=g,
                                            device=cuda, dtype=torch.int8))
    scale = torch.rand(4096, generator=g, device=cuda) * 1e-2
    want = Q.int8_weight_forward(x, kq, scale)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = []
    for i in range(8):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(Q.int8_weight_forward(x, kq, scale))
    torch.cuda.synchronize()
    assert all(torch.equal(o, want) for o in outs)


def _weight_only_case(m, k, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    kq = Q.int8_kernel_layout(torch.randint(-127, 128, (k, n), generator=g, device="cuda",
                                            dtype=torch.int8))
    return x, kq, torch.rand(n, generator=g, device="cuda") * 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 96])
def test_int8_weight_matmul_in_a_cuda_graph_on_gpu(cuda, m):
    """A decode layer's products captured in a CUDA graph (split K and
    not) replay to the eager results, replay after replay."""
    shapes = [(4096, 4096), (4096, 11008), (11008, 4096)]
    cases = [_weight_only_case(m, k, n, seed) for seed, (k, n) in enumerate(shapes)]
    eager = [Q.int8_weight_forward(*c) for c in cases]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        [Q.int8_weight_forward(*c) for c in cases]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [Q.int8_weight_forward(*c) for c in cases]
    for _ in range(3):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


@pytest.mark.gpu
def test_int8_weight_matmul_is_one_kernel_and_no_memset_on_gpu(cuda):
    """Each call puts one operation on the card, the kernel: no memset of
    split-K counters (the first two shapes split K, the third does not)."""
    cases = [_weight_only_case(m, k, n, 5) for m, k, n in
             ((96, 4096, 4096), (8, 11008, 4096), (9216, 4096, 1408))]
    for c in cases:  # first calls: the build and the device queries
        Q.int8_weight_forward(*c)
    torch.cuda.synchronize()
    with cuda_kernels.device_trace() as prof:
        for c in cases:
            Q.int8_weight_forward(*c)
    ops = [e.name for e in cuda_kernels.device_events(prof.events())]
    assert len(ops) == len(cases), ops
    assert all("int8_weight_matmul_kernel" in name for name in ops), ops


#: relative Frobenius error of the int8-KV attention kernel against its
#: plain version: the same roundings, the f32 sums in another order (1.6e-5
#: measured on the H100); a kernel that skipped p's bf16 rounding is 2.6e-3 off
KV8_REL_LIMIT = 5e-4


def _kv8_case(b, sq, h, h_kv, t, dh, offset, device, seed=0):
    """q and a quantized cache of ``t`` slots, the first ``offset + sq``
    written, with the decoder's mask: query i at position offset + i sees
    slot j <= offset + i that its row's validity keeps (row 0 left-padded)."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device=device).to(torch.bfloat16)
    k = torch.randn((b, t, h_kv, dh), generator=g, device=device).to(torch.bfloat16)
    v = torch.randn((b, t, h_kv, dh), generator=g, device=device).to(torch.bfloat16)
    kq, ks = Q.quantize_rows(k)
    vq, vs = Q.quantize_rows(v)
    valid = torch.ones((b, t), dtype=torch.int32, device=device)
    valid[0, :2] = 0
    q_pos = offset + torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(t, device=device)[None, :]
    mask = (k_pos <= q_pos)[None, None] & valid[:, None, None, :].bool()
    return q, kq, ks, vq, vs, mask


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,h,h_kv,t,offset", [
    (96, 1, 32, 32, 106, 100),  # the certify decode
    (4, 96, 32, 32, 106, 0),  # the certify prefill's rows
    (3, 1, 8, 2, 330, 321),  # grouped-query heads, eval's cache
    (2, 7, 8, 4, 40, 3),
    (2, 1, 4, 4, 1500, 1400),  # a long cache
    (96, 96, 32, 32, 106, 0),  # the certify prefill
    (3, 9, 8, 2, 77, 5),  # grouped heads (36 rows a kv head), T off the 32-key tile
    (2, 40, 8, 2, 200, 0),  # 160 rows a kv head (ten row tiles: two units)
    (2, 33, 4, 4, 50, 10),  # two key tiles
    (2, 12, 4, 4, 300, 280),  # several query rows over a cache past 256
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kv8_matches_plain_on_gpu(cuda, b, sq, h, h_kv, t, offset, dtype):
    """The kernels against their plain version within KV8_REL_LIMIT
    (relative Frobenius) and 2e-2 absolute, for bf16 and f32 queries: decode
    and prefill rows, grouped-query heads, a left-padded row, a long cache;
    with no mask and with one mask row for every query; and a fully masked
    row gives zeros, as the plain version's guard does. Each call is one
    launch of the kernel ``kv8_kernel`` names, with no rows to write: bf16
    queries of several rows the prefill kernel (counted in
    ``prefill_attention_kv8.launches``), a lone row the decode kernel
    (``decode_attention_kv8.launches``), f32 queries of several rows the
    tiled kernel; the cache comes out bit for bit as it went in."""
    q, *cache = _kv8_case(b, sq, h, h_kv, t, 128, offset, cuda)
    args = (q.to(dtype), *cache)
    kept = [c.clone() for c in cache[:4]]
    counters = (A.multi_head_attention_kv8, A.prefill_attention_kv8, A.decode_attention_kv8)
    before = [c.launches for c in counters]
    out = A.multi_head_attention_kv8(*args)
    kernel = A.kv8_kernel(dtype, sq, 128, h // h_kv, False)
    want = {"tiled": (1, 0, 0), "prefill": (0, 1, 0), "decode": (0, 0, 1)}[kernel]
    assert [c.launches - n for c, n in zip(counters, before)] == list(want)
    assert kernel == ("decode" if sq == 1 else "prefill" if dtype == torch.bfloat16 else "tiled")
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.uint8) if a.dtype == torch.int8 else a.view(torch.int32),
                           b_.view(torch.uint8) if b_.dtype == torch.int8 else b_.view(torch.int32))
               for a, b_ in zip(cache[:4], kept))
    ref = A._multi_head_attention_kv8_plain(*args)
    assert out.shape == ref.shape == (b, sq, h, 128) and out.dtype == dtype
    assert _rel(out, ref) < KV8_REL_LIMIT
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
    nomask = A.multi_head_attention_kv8(*args[:5], None, 0.1)
    assert _rel(nomask, A._multi_head_attention_kv8_plain(*args[:5], None, 0.1)) < KV8_REL_LIMIT
    mask = args[5].clone()
    mask[-1] = False
    out = A.multi_head_attention_kv8(*args[:5], mask)
    assert not out[-1].any() and torch.isfinite(out).all()
    assert _rel(out, A._multi_head_attention_kv8_plain(*args[:5], mask)) < KV8_REL_LIMIT
    # one mask row for every query ([B, 1, 1, T], a stride of 0)
    pad = args[5][:, :, -1:]
    out = A.multi_head_attention_kv8(*args[:5], pad)
    assert _rel(out, A._multi_head_attention_kv8_plain(*args[:5], pad)) < KV8_REL_LIMIT


@pytest.mark.gpu
def test_attention_kv8_prefill_takes_strided_queries_on_gpu(cuda):
    """q as a view of the fused qkv product (head stride 3 * 128, an offset
    row pointer) and a cache slice of a longer cache, as the decoder hands
    them over: the prefill kernel (no rows to write) against the plain
    version."""
    q, kq, ks, vq, vs, mask = _kv8_case(3, 20, 8, 8, 120, 128, 0, cuda, seed=4)
    fused = torch.stack([q, q, q], dim=3).reshape(3, 20, 8 * 3, 128)[:, :, 1::3]
    assert not fused.is_contiguous()
    longer = [torch.cat([c, c[:, :8]], dim=1)[:, :120] for c in (kq, ks, vq, vs)]
    out = A.multi_head_attention_kv8(fused, longer[0], longer[1], longer[2], longer[3], mask)
    ref = A._multi_head_attention_kv8_plain(q, kq, ks, vq, vs, mask)
    assert _rel(out, ref) < KV8_REL_LIMIT


@pytest.mark.gpu
def test_attention_kv8_refuses_bad_operands_on_gpu(cuda):
    q, kq, ks, vq, vs, mask = _kv8_case(2, 3, 4, 4, 16, 128, 0, cuda)
    n = A.multi_head_attention_kv8.launches
    with pytest.raises(ValueError, match="head-agnostic"):
        A.multi_head_attention_kv8(q, kq, ks, vq, vs, mask.expand(2, 4, 3, 16))
    with pytest.raises(TypeError):
        A.multi_head_attention_kv8(q.half(), kq, ks, vq, vs, mask)
    long = _kv8_case(1, 1, 4, 4, 60000, 128, 0, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        A.multi_head_attention_kv8(*long)
    assert A.multi_head_attention_kv8.launches == n


def _bits(t):
    return t.view(torch.uint8 if t.dtype == torch.int8 else torch.int32)


def _kv8_any(b, sq, h, h_kv, t, dh, offset, dtype, device, seed=0):
    """``_kv8_case`` at any head_dim and dtype, the last batch row fully
    masked when there are several."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((b, sq, h, dh), generator=g, device=device).to(dtype)
    kq, ks = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g, device=device))
    vq, vs = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g, device=device))
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    q_pos = offset + torch.arange(sq, device=device)[:, None]
    mask = (torch.arange(t, device=device)[None, :] <= q_pos)[None, None] & \
        valid[:, None, None, :]
    return q, kq, ks, vq, vs, mask


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("dh", [16, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_kv8_lone_row_runs_the_decode_kernel_on_gpu(cuda, g, dh, dtype):
    """A lone query row (bf16 or f32) at a group of ``KV8_DECODE_GROUPS``
    is one launch of the decode kernel with nothing to write: the cache
    comes out bit for bit as it went in, the output within KV8_REL_LIMIT of
    the plain version, a fully masked row zeros."""
    q, *cache = _kv8_any(6, 1, 4 * g, 4, 106, dh, 100, dtype, cuda, seed=g + dh)
    kept = [c.clone() for c in cache[:4]]
    before = (A.decode_attention_kv8.launches, A.multi_head_attention_kv8.launches)
    out = A.multi_head_attention_kv8(q, *cache)
    assert (A.decode_attention_kv8.launches, A.multi_head_attention_kv8.launches) == \
        (before[0] + 1, before[1])
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(cache[:4], kept))
    ref = A._multi_head_attention_kv8_plain(q, *cache)
    assert out.dtype == dtype and _rel(out, ref) < KV8_REL_LIMIT
    assert not out[-1].any() and torch.isfinite(out).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,h,h_kv,t,dh,offset,dtype", [
    (4, 1, 12, 4, 106, 128, 100, torch.bfloat16),  # a lone row, three a kv head
    (3, 1, 6, 1, 300, 64, 299, torch.float32),  # a lone row, six a kv head
    (2, 7, 8, 8, 40, 64, 3, torch.bfloat16),  # another head width
    (2, 33, 4, 2, 90, 80, 50, torch.bfloat16),  # five 16-value pieces a row
    (2, 5, 4, 4, 77, 256, 60, torch.bfloat16),  # the widest head_dim
    (2, 40, 8, 2, 200, 128, 0, torch.float32),  # 160 rows a kv head: three row tiles
    (3, 17, 4, 4, 33, 16, 10, torch.float32),  # the tiny configuration's head_dim
    (2, 9, 4, 4, 4096, 256, 4000, torch.float32),  # a long cache at the widest head_dim
])
def test_attention_kv8_tiled_matches_plain_on_gpu(cuda, b, sq, h, h_kv, t, dh, offset, dtype):
    """The tiled kernel (``kv8_kernel`` "tiled"): f32 queries, bf16 at
    other head widths, lone rows at other groups, one launch each with no
    rows to write; the cache unchanged, the output within KV8_REL_LIMIT
    of the plain version with the decoder's mask and with none, a fully
    masked row zeros."""
    q, *cache = _kv8_any(b, sq, h, h_kv, t, dh, offset, dtype, cuda, seed=dh + sq)
    assert A.kv8_kernel(dtype, sq, dh, h // h_kv, False) == "tiled"
    kept = [c.clone() for c in cache[:4]]
    before = A.multi_head_attention_kv8.launches
    out = A.multi_head_attention_kv8(q, *cache)
    assert A.multi_head_attention_kv8.launches == before + 1
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b_)) for a, b_ in zip(cache[:4], kept))
    ref = A._multi_head_attention_kv8_plain(q, *cache)
    assert out.dtype == dtype and _rel(out, ref) < KV8_REL_LIMIT
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
    assert not out[-1].any() and torch.isfinite(out).all()
    nomask = A.multi_head_attention_kv8(q, *cache[:4], None, 0.1)
    assert _rel(nomask, A._multi_head_attention_kv8_plain(q, *cache[:4], None, 0.1)) \
        < KV8_REL_LIMIT


# ----------------------------------------------------------------------
# the decode step's int8-KV attention with its cache write
# (csrc/attention_kv8_decode.cu)
# ----------------------------------------------------------------------
def _decode_case(b, t, h, h_kv, dh, offset, dtype, device, seed=0):
    """The step's q, k and v in ``dtype``; a cache of ``t`` slots holding
    quantized rows of N(0, 2^2) data; the decoder's
    mask [B, 1, 1, T]: slots after ``offset`` hidden, row 0 left-padded by
    up to two slots, the last row of a batch fully masked."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, 1, n, dh), generator=g, device=device).to(dtype) * s
               for n, s in ((h, 1.0), (h_kv, 3.0), (h_kv, 1.0)))
    kc, ksc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g,
                                                 device=device) * 2)
    vc, vsc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g, device=device))
    cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :min(2, offset)] = False
    if b > 1:
        valid[-1] = False
    mask = (torch.arange(t, device=device) <= offset)[None, None, None, :] & \
        valid[:, None, None, :]
    return q, k, v, cache, mask


def _copy(cache):
    return {name: c.clone() for name, c in cache.items()}


def _cache_bits_unequal(a, b):
    return {name: int((a[name].view(torch.int8 if a[name].dtype == torch.int8 else torch.int32)
                       != b[name].view(torch.int8 if b[name].dtype == torch.int8
                                       else torch.int32)).sum()) for name in a}


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,h,h_kv,dh,offset", [
    (96, 106, 32, 32, 128, 100),  # the certify decode
    (1, 106, 32, 32, 128, 105),  # a caption's decode (batch 1)
    (96, 106, 32, 8, 128, 60),  # grouped-query heads (4 a kv head), the certify batch
    (1, 300, 32, 8, 128, 299),  # past one 128-position tile, the last slot
    (96, 2048, 32, 32, 128, 2000),  # a long cache, many tiles
    (1, 2048, 32, 8, 128, 1024),
    (4, 1, 32, 8, 128, 0),  # one cached position
    (3, 130, 8, 1, 128, 128),  # eight query heads a kv head, the offset in the second tile
    (2, 40, 4, 2, 128, 39),  # two a kv head
    (3, 17, 4, 4, 16, 9),  # the tiny configuration's head_dim
    (2, 33, 4, 2, 48, 20),  # three 16-byte pieces a row
    (2, 20, 4, 4, 256, 7),  # the widest head_dim
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_decode_attention_kv8_matches_plain_on_gpu(cuda, b, t, h, h_kv, dh, offset, dtype):
    """One launch writes the cache bit for bit as the plain sequence does
    (quantize_rows of k and v, the slot writes) and attends within
    KV8_REL_LIMIT (relative Frobenius) and 2e-2 absolute of the plain
    attention; a fully masked row gives zeros; with no mask and another
    scale too."""
    q, k, v, cache, mask = _decode_case(b, t, h, h_kv, dh, offset, dtype, cuda)
    mine, ref_cache = _copy(cache), _copy(cache)
    before = A.decode_attention_kv8.launches
    out = A.decode_attention_kv8(q, k, v, mine, offset, mask)
    assert A.decode_attention_kv8.launches == before + 1
    ref = A._decode_attention_kv8_plain(q, k, v, ref_cache, offset, mask)
    torch.cuda.synchronize()
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert out.shape == ref.shape == (b, 1, h, dh) and out.dtype == dtype
    assert _rel(out, ref) < KV8_REL_LIMIT
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
    if b > 1:
        assert not out[-1].any() and torch.isfinite(out).all()
    mine, ref_cache = _copy(cache), _copy(cache)
    out = A.decode_attention_kv8(q, k, v, mine, offset, None, 0.1)
    ref = A._decode_attention_kv8_plain(q, k, v, ref_cache, offset, None, 0.1)
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert _rel(out, ref) < KV8_REL_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,offset", [(96, 106, 100), (8, 300, 250)],
                         ids=["4_warps", "8_warps"])
def test_decode_attention_kv8_is_deterministic_on_gpu(cuda, b, t, offset):
    """The partial outputs meet in a fixed order: repeated launches agree
    bit for bit, and with the plain version, at both block widths the
    launcher picks (4 warps for many items over one tile, 8 otherwise)."""
    q, k, v, cache, mask = _decode_case(b, t, 32, 32, 128, offset, torch.bfloat16, cuda, seed=2)
    outs = [A.decode_attention_kv8(q, k, v, cache, offset, mask) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    ref = A._decode_attention_kv8_plain(q, k, v, _copy(cache), offset, mask)
    assert _rel(outs[0], ref) < KV8_REL_LIMIT


@pytest.mark.gpu
def test_decode_attention_kv8_in_a_cuda_graph_and_on_two_streams_on_gpu(cuda):
    """Captured in a CUDA graph, a decode layer's launch replays to the
    eager output and cache, replay after replay; launches on two streams at
    once, each on a cache of its own, give the output of a launch alone."""
    q, k, v, cache, mask = _decode_case(96, 106, 32, 32, 128, 100, torch.bfloat16, cuda, seed=3)
    eager_cache = _copy(cache)
    eager = A.decode_attention_kv8(q, k, v, eager_cache, 100, mask)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.decode_attention_kv8(q, k, v, _copy(cache), 100, mask)
    torch.cuda.current_stream().wait_stream(side)
    graphed = _copy(cache)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.decode_attention_kv8(q, k, v, graphed, 100, mask)
    for _ in range(3):
        out.zero_()
        for name in graphed:
            graphed[name].copy_(cache[name])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert _cache_bits_unequal(graphed, eager_cache) == {name: 0 for name in cache}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    caches = [_copy(cache) for _ in range(8)]
    torch.cuda.synchronize()
    outs = []
    for i, c in enumerate(caches):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(A.decode_attention_kv8(q, k, v, c, 100, mask))
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager) for o in outs)
    assert all(_cache_bits_unequal(c, eager_cache) == {name: 0 for name in cache}
               for c in caches)


@pytest.mark.gpu
def test_decode_attention_kv8_is_one_kernel_and_no_memset_on_gpu(cuda):
    """Each call puts one operation on the card, the kernel: the cache
    write rides in it, no copy, no quantization launch, no memset."""
    cases = [_decode_case(96, 106, 32, 32, 128, 100, dt, cuda) for dt in
             (torch.bfloat16, torch.float32)]
    for q, k, v, cache, mask in cases:  # first calls: the build and the device queries
        A.decode_attention_kv8(q, k, v, cache, 100, mask)
    torch.cuda.synchronize()
    with cuda_kernels.device_trace() as prof:
        for q, k, v, cache, mask in cases:
            A.decode_attention_kv8(q, k, v, cache, 100, mask)
    ops = [e.name for e in cuda_kernels.device_events(prof.events())]
    assert len(ops) == len(cases), ops
    assert all("kv8_decode_kernel" in name for name in ops), ops


@pytest.mark.gpu
def test_decode_attention_kv8_refuses_bad_operands_on_gpu(cuda):
    q, k, v, cache, mask = _decode_case(2, 16, 12, 4, 128, 5, torch.bfloat16, cuda)
    n = A.decode_attention_kv8.launches
    with pytest.raises(ValueError, match="query heads a kv head"):  # three a kv head
        A.decode_attention_kv8(q, k, v, cache, 5, mask)
    q, k, v, cache, mask = _decode_case(2, 16, 8, 4, 128, 5, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head-agnostic"):
        A.decode_attention_kv8(q, k, v, cache, 5, mask.expand(2, 8, 1, 16))
    with pytest.raises(TypeError):
        A.decode_attention_kv8(q.half(), k.half(), v.half(), cache, 5, mask)
    with pytest.raises(ValueError, match="outside"):
        A.decode_attention_kv8(q, k, v, cache, 16, mask)
    assert A.decode_attention_kv8.launches == n


# ----------------------------------------------------------------------
# the prefill's int8-KV attention with its cache write
# (csrc/attention_kv8_prefill.cu)
# ----------------------------------------------------------------------
def _prefill_case(b, s, t, h, h_kv, offset, dtype, device, seed=0):
    """The prefill's q, k and v [B, S, ., 128] in ``dtype``; a cache of
    ``t`` slots holding quantized rows of N(0, 2^2) data; the decoder's
    mask [B, 1, S, T]: query i at slot offset + i sees the slots up to its
    own, row 0 left-padded by two slots, the last row of a batch fully
    masked."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, 128), generator=g, device=device).to(dtype) * sc
               for n, sc in ((h, 1.0), (h_kv, 3.0), (h_kv, 1.0)))
    kc, ksc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, 128), generator=g,
                                                 device=device) * 2)
    vc, vsc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, 128), generator=g, device=device))
    cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    q_pos = offset + torch.arange(s, device=device)[:, None]
    mask = (torch.arange(t, device=device)[None, :] <= q_pos)[None, None] & \
        valid[:, None, None, :]
    return q, k, v, cache, mask


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,h_kv,offset", [
    (96, 96, 106, 32, 32, 0),  # the certify prefill
    (8, 320, 330, 32, 32, 0),  # eval's prefill
    (1, 96, 106, 32, 32, 0),  # a caption's prefill (batch 1)
    (4, 40, 256, 32, 8, 216),  # grouped heads (4 a kv head), the new rows last
    (3, 33, 257, 16, 2, 100),  # eight a kv head, a tile past 256 positions
    (2, 64, 330, 32, 16, 7),  # two a kv head, old slots on both sides
    (8, 96, 2048, 32, 32, 1900),  # a long cache at an offset
    (2, 64, 4096, 32, 32, 4000),  # the longest
    (3, 7, 106, 12, 4, 50),  # three a kv head, one row tile
    (2, 2, 40, 4, 4, 37),  # two rows, at the cache's end
])
def test_prefill_attention_kv8_matches_plain_on_gpu(cuda, b, s, t, h, h_kv, offset):
    """One launch writes the cache bit for bit as the plain sequence does
    (quantize_rows of k and v, the slot writes) and attends within
    KV8_REL_LIMIT (relative Frobenius) and 2e-2 absolute of the plain
    attention; a fully masked row gives zeros; with no mask and another
    scale too; and the same launch with no rows to write
    (``multi_head_attention_kv8``) over the written cache."""
    q, k, v, cache, mask = _prefill_case(b, s, t, h, h_kv, offset, torch.bfloat16, cuda)
    mine, ref_cache = _copy(cache), _copy(cache)
    before = A.prefill_attention_kv8.launches
    out = A.prefill_attention_kv8(q, k, v, mine, offset, mask)
    assert A.prefill_attention_kv8.launches == before + 1
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, offset, mask)
    torch.cuda.synchronize()
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert out.shape == ref.shape == (b, s, h, 128) and out.dtype == torch.bfloat16
    assert _rel(out, ref) < KV8_REL_LIMIT
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
    if b > 1:
        assert not out[-1].any() and torch.isfinite(out).all()
    args = (q, mine["k"], mine["k_scale"], mine["v"], mine["v_scale"], mask)
    assert _rel(A.multi_head_attention_kv8(*args), ref) < KV8_REL_LIMIT
    mine, ref_cache = _copy(cache), _copy(cache)
    out = A.prefill_attention_kv8(q, k, v, mine, offset, None, 0.1)
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, offset, None, 0.1)
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert _rel(out, ref) < KV8_REL_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["one_row", "keys", "random"])
def test_prefill_attention_kv8_takes_any_head_agnostic_mask_on_gpu(cuda, kind):
    """A mask [1, 1, S, T] for every batch row, [B, 1, 1, T] for every
    query, and any [B, 1, S, T] (holes anywhere: tiles kept after dead
    ones); k and v as views of a fused product (strided rows)."""
    b, s, t, h, h_kv, offset = 3, 70, 200, 8, 4, 60
    q, k, v, cache, mask = _prefill_case(b, s, t, h, h_kv, offset, torch.bfloat16, cuda, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    mask = {"one_row": mask[:1],
            "keys": torch.rand((b, 1, 1, t), generator=g, device=cuda) < 0.5,
            "random": torch.rand((b, 1, s, t), generator=g, device=cuda) < 0.3}[kind]
    fused = torch.cat([k, v], dim=2)
    k, v = fused[:, :, :h_kv], fused[:, :, h_kv:]
    assert not k.is_contiguous()
    mine, ref_cache = _copy(cache), _copy(cache)
    out = A.prefill_attention_kv8(q, k, v, mine, offset, mask)
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, offset, mask)
    torch.cuda.synchronize()
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert _rel(out, ref) < KV8_REL_LIMIT


@pytest.mark.gpu
def test_prefill_attention_kv8_f32_runs_the_sequence_on_gpu(cuda):
    """f32 q, k and v (the tiny and f32 configurations) take what replaced
    the sequence (``quantize_rows``' kernel on k and v, the slot writes and
    the attention): one launch of the tiled kernel, which writes the cache
    bit for bit; no launch of the prefill kernel or of ``quantize_rows``."""
    q, k, v, cache, mask = _prefill_case(3, 20, 50, 8, 2, 10, torch.float32, cuda)
    mine, ref_cache = _copy(cache), _copy(cache)
    before = (A.prefill_attention_kv8.launches, A.multi_head_attention_kv8.launches,
              Q.quantize_rows.launches)
    out = A.prefill_attention_kv8(q, k, v, mine, 10, mask)
    assert (A.prefill_attention_kv8.launches, A.multi_head_attention_kv8.launches,
            Q.quantize_rows.launches) == (before[0], before[1] + 1, before[2])
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, 10, mask)
    torch.cuda.synchronize()
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert out.dtype == torch.float32 and _rel(out, ref) < KV8_REL_LIMIT


def _prefill_any(b, s, t, h, h_kv, dh, offset, dtype, device, seed=0):
    """``_prefill_case`` at any head_dim."""
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, dh), generator=g, device=device).to(dtype) * sc
               for n, sc in ((h, 1.0), (h_kv, 3.0), (h_kv, 1.0)))
    kc, ksc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g,
                                                 device=device) * 2)
    vc, vsc = Q._quantize_rows_plain(torch.randn((b, t, h_kv, dh), generator=g, device=device))
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    valid[0, :2] = False
    if b > 1:
        valid[-1] = False
    q_pos = offset + torch.arange(s, device=device)[:, None]
    mask = (torch.arange(t, device=device)[None, :] <= q_pos)[None, None] & \
        valid[:, None, None, :]
    return q, k, v, {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}, mask


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,h_kv,dh,offset", [
    (96, 96, 106, 32, 32, 128, 0),  # the certify prefill
    (8, 320, 330, 32, 32, 128, 0),  # eval's prefill
    (2, 64, 2048, 32, 32, 128, 1900),  # a long cache, the new rows at an offset
    (4, 40, 256, 32, 8, 128, 216),  # grouped heads (4 a kv head), the new rows last
    (3, 21, 60, 12, 4, 64, 30),  # three a kv head, another head width
    (2, 9, 20, 4, 4, 16, 5),  # the tiny configuration's head_dim
    (2, 5, 30, 4, 2, 256, 25),  # the widest head_dim
])
def test_prefill_attention_kv8_f32_is_one_launch_on_gpu(cuda, b, s, t, h, h_kv, dh, offset):
    """The f32 prefill is one launch of the tiled kernel: the cache's codes
    and scales bit for bit the plain sequence's, the output within
    KV8_REL_LIMIT, a fully masked row zeros, no ``quantize_rows`` launch."""
    q, k, v, cache, mask = _prefill_any(b, s, t, h, h_kv, dh, offset, torch.float32, cuda)
    mine, ref_cache = _copy(cache), _copy(cache)
    before = (A.multi_head_attention_kv8.launches, Q.quantize_rows.launches)
    out = A.prefill_attention_kv8(q, k, v, mine, offset, mask)
    assert (A.multi_head_attention_kv8.launches, Q.quantize_rows.launches) == \
        (before[0] + 1, before[1])
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, offset, mask)
    torch.cuda.synchronize()
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert out.dtype == torch.float32 and _rel(out, ref) < KV8_REL_LIMIT
    assert not out[-1].any() and torch.isfinite(out).all()


@pytest.mark.gpu
def test_prefill_attention_kv8_f32_long_cache_runs_on_gpu(cuda):
    """A 2048-slot f32 cache runs in one launch: the new rows at 1900, then a
    bare f32 call of several rows over the whole cache; the tiled launches
    are deterministic, replay from a CUDA graph and are one kernel and no
    memset a call. An 8192-slot cache under several f32 rows runs too (eight
    rows of Dh + T floats would not fit in shared memory)."""
    q, k, v, cache, mask = _prefill_any(8, 96, 2048, 32, 32, 128, 1900, torch.float32, cuda,
                                        seed=5)
    mine, ref_cache = _copy(cache), _copy(cache)
    out = A.prefill_attention_kv8(q, k, v, mine, 1900, mask)
    ref = A._prefill_attention_kv8_plain(q, k, v, ref_cache, 1900, mask)
    assert _cache_bits_unequal(mine, ref_cache) == {name: 0 for name in cache}
    assert _rel(out, ref) < KV8_REL_LIMIT
    args = (q, mine["k"], mine["k_scale"], mine["v"], mine["v_scale"], mask)
    bare = A.multi_head_attention_kv8(*args)
    assert _rel(bare, A._multi_head_attention_kv8_plain(*args)) < KV8_REL_LIMIT
    assert torch.equal(A.multi_head_attention_kv8(*args), bare)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.prefill_attention_kv8(q, k, v, _copy(cache), 1900, mask)
    torch.cuda.current_stream().wait_stream(side)
    graphed = _copy(cache)
    with torch.cuda.graph(graph):
        replayed = A.prefill_attention_kv8(q, k, v, graphed, 1900, mask)
    for _ in range(2):
        replayed.zero_()
        for name in graphed:
            graphed[name].copy_(cache[name])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, out)
        assert _cache_bits_unequal(graphed, mine) == {name: 0 for name in cache}
    fresh = _copy(cache)
    torch.cuda.synchronize()
    with cuda_kernels.device_trace() as prof:
        A.prefill_attention_kv8(q, k, v, fresh, 1900, mask)
    ops = [e.name for e in cuda_kernels.device_events(prof.events())]
    assert len(ops) == 1 and "attention_kv8_kernel" in ops[0], ops
    q, *cache = _kv8_any(2, 9, 8, 8, 8192, 128, 8190, torch.float32, cuda, seed=6)
    out = A.multi_head_attention_kv8(q, *cache)
    assert _rel(out, A._multi_head_attention_kv8_plain(q, *cache)) < KV8_REL_LIMIT


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,offset", [(96, 96, 106, 0), (8, 320, 330, 0), (2, 64, 2048, 1900)],
                         ids=["certify", "eval", "long"])
def test_prefill_attention_kv8_is_deterministic_on_gpu(cuda, b, s, t, offset):
    """Each row's sums run in a fixed order: repeated launches agree bit
    for bit, the cache too, with one unit an item and with several."""
    q, k, v, cache, mask = _prefill_case(b, s, t, 32, 32, offset, torch.bfloat16, cuda, seed=2)
    caches = [_copy(cache) for _ in range(3)]
    outs = [A.prefill_attention_kv8(q, k, v, c, offset, mask) for c in caches]
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert all(_cache_bits_unequal(c, caches[0]) == {name: 0 for name in cache} for c in caches)


@pytest.mark.gpu
def test_prefill_attention_kv8_in_a_cuda_graph_and_on_two_streams_on_gpu(cuda):
    """Captured in a CUDA graph, a prefill layer's launch replays to the
    eager output and cache, replay after replay; launches on two streams at
    once, each on a cache of its own, give the output of a launch alone."""
    q, k, v, cache, mask = _prefill_case(8, 320, 330, 32, 32, 0, torch.bfloat16, cuda, seed=3)
    eager_cache = _copy(cache)
    eager = A.prefill_attention_kv8(q, k, v, eager_cache, 0, mask)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        A.prefill_attention_kv8(q, k, v, _copy(cache), 0, mask)
    torch.cuda.current_stream().wait_stream(side)
    graphed = _copy(cache)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = A.prefill_attention_kv8(q, k, v, graphed, 0, mask)
    for _ in range(3):
        out.zero_()
        for name in graphed:
            graphed[name].copy_(cache[name])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert _cache_bits_unequal(graphed, eager_cache) == {name: 0 for name in cache}
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    caches = [_copy(cache) for _ in range(6)]
    torch.cuda.synchronize()
    outs = []
    for i, c in enumerate(caches):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(A.prefill_attention_kv8(q, k, v, c, 0, mask))
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager) for o in outs)
    assert all(_cache_bits_unequal(c, eager_cache) == {name: 0 for name in cache}
               for c in caches)


@pytest.mark.gpu
def test_prefill_attention_kv8_is_one_kernel_and_no_memset_on_gpu(cuda):
    """Each call puts one operation on the card, the kernel: the cache
    write rides in it, no copy, no quantization launch, no memset; a bare
    ``multi_head_attention_kv8`` of several bf16 rows is the same kernel."""
    q, k, v, cache, mask = _prefill_case(96, 96, 106, 32, 32, 0, torch.bfloat16, cuda)
    A.prefill_attention_kv8(q, k, v, cache, 0, mask)  # the build and the device queries
    args = (q, cache["k"], cache["k_scale"], cache["v"], cache["v_scale"], mask)
    A.multi_head_attention_kv8(*args)
    torch.cuda.synchronize()
    with cuda_kernels.device_trace() as prof:
        A.prefill_attention_kv8(q, k, v, cache, 0, mask)
        A.multi_head_attention_kv8(*args)
    ops = [e.name for e in cuda_kernels.device_events(prof.events())]
    assert len(ops) == 2, ops
    assert all("kv8_prefill_kernel" in name for name in ops), ops


@pytest.mark.gpu
def test_prefill_attention_kv8_refuses_bad_operands_on_gpu(cuda):
    q, k, v, cache, mask = _prefill_case(2, 6, 16, 8, 4, 5, torch.bfloat16, cuda)
    n = A.prefill_attention_kv8.launches
    with pytest.raises(ValueError, match="head-agnostic"):
        A.prefill_attention_kv8(q, k, v, cache, 5, mask.expand(2, 8, 6, 16))
    with pytest.raises(ValueError, match="outside"):
        A.prefill_attention_kv8(q, k, v, cache, 11, mask)
    with pytest.raises(ValueError, match="prefill_attention_kv8"):
        A.prefill_attention_kv8(q, k[:, :, :2], v[:, :, :2], cache, 5, mask)
    bad = dict(cache, k_scale=cache["k_scale"].double())
    with pytest.raises(TypeError):
        A.prefill_attention_kv8(q, k, v, bad, 5, mask)
    assert A.prefill_attention_kv8.launches == n


# ----------------------------------------------------------------------
# the decoder's fused elementwise ops (csrc/elementwise.cu)
# ----------------------------------------------------------------------
def _ulps_off(got, want) -> float:
    """The largest |got - want| in ulps of want's dtype at want."""
    g, w = got.double(), want.double()
    spacing = torch.from_numpy(np.spacing(want.float().abs().cpu().numpy())).to(g.device)
    if want.dtype == torch.bfloat16:
        spacing = spacing * 2.0 ** 16
    return float(((g - w).abs() / spacing.double()).max())


def _codes_agree(got, want) -> None:
    """Codes within one step on at most 1e-3 of the elements, scales
    within 2^-7 relative (an ulp of a row's largest value)."""
    (gq, gs), (wq, ws) = got, want
    diff = (gq.int() - wq.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 1e-3
    assert float(((gs - ws).abs() / ws).max()) <= 2.0 ** -7


def _fused_rows(m, k, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = 3.0 * torch.randn((m, k), generator=g, device=device)
    y = torch.randn((m, k), generator=g, device=device)
    x[-1] = 0.0
    y[-1] = 0.0
    scale = 1.0 + 0.1 * torch.randn((k,), generator=g, device=device)
    return x.to(dtype), y.to(dtype), scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k", [(9216, 4096), (96, 4096), (1, 4096), (7, 64), (3, 11008)])
def test_add_rms_norm_matches_plain_on_gpu(cuda, dtype, m, k):
    """With and without a residual, rows and codes: the sum bit for bit,
    the normalized rows within one ulp of bf16 (16 of f32: the sum of
    squares runs in the kernel's order, and the sums' difference of a few
    ulps passes through rsqrt; 5 seen at [9216, 4096]), a zero row
    normalized to zeros, codes and scales within the quantization limits."""
    x, y, scale = _fused_rows(m, k, dtype, cuda, seed=m + k)
    for res in (y, None):
        for sc in (scale, scale.to(dtype)):
            s, h = E.add_rms_norm(x, res, sc, 1e-6)
            ps, ph = E._add_rms_norm_plain(x, res, sc, 1e-6)
            torch.cuda.synchronize()
            assert torch.equal(s, ps) and h.dtype == dtype
            assert _ulps_off(h, ph) <= (1 if dtype == torch.bfloat16 else 16)
            assert not h[-1].any()
            s2, codes = E.add_rms_norm(x, res, sc, 1e-6, quantize=True)
            assert torch.equal(s2, ps)
            _codes_agree(codes, E._add_rms_norm_plain(x, res, sc, 1e-6, quantize=True)[1])
            assert not codes[0][-1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,n", [(9216, 11008), (96, 11008), (1, 11008), (5, 128), (4, 5504)])
def test_silu_mul_matches_plain_on_gpu(cuda, dtype, m, n):
    """``silu(gate) * up`` rows within one ulp of the plain version's (the
    same expf and division: equal but for the toolkits' expf), codes and
    scales within the quantization limits, a zero row to zeros."""
    gate, up, _ = _fused_rows(m, n, dtype, cuda, seed=m + n)
    out = E.silu_mul(gate, up)
    want = E._silu_mul_plain(gate, up)
    torch.cuda.synchronize()
    assert out.dtype == dtype and _ulps_off(out, want) <= 1 and not out[-1].any()
    codes = E.silu_mul(gate, up, quantize=True)
    _codes_agree(codes, E._silu_mul_plain(gate, up, quantize=True))
    assert not codes[0][-1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,h,hk,dh", [(96, 96, 32, 32, 128), (96, 1, 32, 32, 128),
                                         (1, 1, 32, 32, 128), (3, 7, 4, 2, 16)])
def test_rotary_matches_plain_on_gpu(cuda, dtype, b, s, h, hk, dh):
    """q and k rotated in place in one launch, bit for bit the plain
    version, from int64 and int32 positions (left padding, a row at a late
    position), q and k as strided views of one fused product."""
    g = torch.Generator(device=cuda).manual_seed(b * s + h)
    fused = torch.randn((b, s, h + 2 * hk, dh), generator=g, device=cuda).to(dtype)
    q, k = fused[:, :, :h], fused[:, :, h:h + hk]
    pos = torch.arange(s, device=cuda)[None].repeat(b, 1)
    pos[0] = (pos[0] - 2).clamp_min(0)
    pos[-1] += 4000 - s
    cos, sin = E.rotary_tables(dh, 4096, 10000.0, cuda)
    for positions in (pos, pos.int()):
        want_q, want_k = E._rotary_plain(q, k, cos, sin, positions)
        qc, kc = q.clone(), k.clone()
        n = E.rotary.launches
        got_q, got_k = E.rotary(qc, kc, cos, sin, positions)
        torch.cuda.synchronize()
        assert E.rotary.launches == n + 1 and got_q is qc and got_k is kc
        assert torch.equal(qc, want_q) and torch.equal(kc, want_k)
    strided_q, strided_k = q.clone(), k.clone()
    whole = fused.clone()
    E.rotary(whole[:, :, :h], whole[:, :, h:h + hk], cos, sin, pos)
    E.rotary(strided_q, strided_k, cos, sin, pos)
    assert torch.equal(whole[:, :, :h], strided_q) and torch.equal(whole[:, :, h:h + hk], strided_k)
    assert torch.equal(whole[:, :, h + hk:], fused[:, :, h + hk:])  # v untouched


@pytest.mark.gpu
def test_fused_elementwise_ops_in_a_cuda_graph_one_kernel_each_on_gpu(cuda):
    """A decode layer's three ops captured in a CUDA graph replay to the
    eager results, and each call is one kernel in a profiler trace."""
    x, y, scale = _fused_rows(96, 4096, torch.bfloat16, cuda, seed=1)
    gate, up, _ = _fused_rows(96, 11008, torch.bfloat16, cuda, seed=2)
    q = torch.randn((96, 1, 32, 128), device=cuda).to(torch.bfloat16)
    k = torch.randn((96, 1, 32, 128), device=cuda).to(torch.bfloat16)
    pos = torch.full((96, 1), 105, device=cuda)
    cos, sin = E.rotary_tables(128, 4096, 10000.0, cuda)

    def layer():
        s, h = E.add_rms_norm(x, y, scale, 1e-6)
        qr, kr = E.rotary(q.clone(), k.clone(), cos, sin, pos)
        return s, h, qr, kr, E.silu_mul(gate, up)

    eager = layer()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        layer()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = layer()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))
    with cuda_kernels.device_trace() as prof:
        E.add_rms_norm(x, y, scale, 1e-6, quantize=True)
        E.rotary(q, k, cos, sin, pos)
        E.silu_mul(gate, up, quantize=True)
    ops = [e.name for e in cuda_kernels.device_events(prof.events())]
    assert len(ops) == 3, ops
    for name, op in zip(("add_rms_norm_kernel", "rotary_kernel", "silu_mul_kernel"), ops):
        assert name in op, ops


@pytest.mark.gpu
def test_fused_elementwise_ops_refuse_bad_operands_on_gpu(cuda):
    x = torch.zeros((4, 64), device=cuda, dtype=torch.bfloat16)
    scale = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        E.add_rms_norm(x.half(), None, scale)
    with pytest.raises(ValueError):
        E.add_rms_norm(x, x[:, :32], scale)
    with pytest.raises(ValueError):
        E.add_rms_norm(x[:, :62], None, scale[:62])
    with pytest.raises(ValueError):
        E.silu_mul(x, x.float())
    q = torch.zeros((2, 3, 4, 16), device=cuda, dtype=torch.bfloat16)
    cos, sin = E.rotary_tables(16, 64, 10000.0, cuda)
    with pytest.raises(ValueError, match="positions"):
        E.rotary(q, q, cos, sin, torch.zeros((2, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="table"):
        E.rotary(q, q, cos.double(), sin, torch.zeros((2, 3), dtype=torch.long, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k", [(4096, 4096), (96, 4096), (1, 4096), (7, 64), (3, 5120)])
def test_add_rms_norm_grad_matches_plain_on_gpu(cuda, dtype, m, k):
    """The norm's backward with and without the stream's later gradient,
    bf16 and f32 scales: within ``chip_smoke.norm_grad_slack`` of the plain
    version (autograd's backward of the plain chain: the kernel's two row
    sums run in its own order), a zero row's gradient the later gradient
    alone, one launch a call, a new tensor."""
    x, gs, scale = _fused_rows(m, k, dtype, cuda, seed=m + k + 1)
    g = _fused_rows(m, k, dtype, cuda, seed=m + k + 2)[0] / 3.0
    for later in (gs, None):
        for sc in (scale, scale.to(dtype)):
            n = E.add_rms_norm_grad.launches
            got = E.add_rms_norm_grad(x, g, later, sc, 1e-6)
            want = E._add_rms_norm_grad_plain(x, g, later, sc, 1e-6)
            torch.cuda.synchronize()
            assert E.add_rms_norm_grad.launches == n + 1 and got.dtype == dtype
            assert got.data_ptr() not in (x.data_ptr(), g.data_ptr())
            tol = chip_smoke.norm_grad_slack(torch, x, g, later, sc, want)
            assert bool(((got.float() - want.float()).abs() <= tol).all())
            # the last row is zeros in x (and in g): its norm term is 0
            assert torch.equal(got[-1], later[-1] if later is not None else torch.zeros_like(got[-1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,n", [(4096, 11008), (96, 11008), (1, 11008), (5, 128)])
def test_silu_mul_grad_matches_plain_on_gpu(cuda, dtype, m, n):
    """SiLU x up's backward, bit for bit the plain version's (PyTorch's
    ``silu_backward`` on the card), from contiguous rows and from column
    slices of a wider product; one launch a call."""
    gate, up, _ = _fused_rows(m, n, dtype, cuda, seed=m + n + 3)
    g = _fused_rows(m, n, dtype, cuda, seed=m + n + 4)[0]
    wide = torch.cat([gate, up], dim=-1)
    for a, b in ((gate, up), (wide[:, :n], wide[:, n:])):
        count = E.silu_mul_grad.launches
        got = E.silu_mul_grad(g, a, b)
        want = E._silu_mul_grad_plain(g, a, b)
        torch.cuda.synchronize()
        assert E.silu_mul_grad.launches == count + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,h,hk,dh", [(16, 256, 32, 32, 128), (1, 1, 32, 32, 128),
                                         (3, 7, 4, 2, 16)])
def test_rotary_grad_matches_plain_on_gpu(cuda, dtype, b, s, h, hk, dh):
    """The rotary's backward, bit for bit the plain version's, at packed
    (restarting) positions, from contiguous gradients and from transposed
    views; new tensors, the gradients left as they were; one launch for q
    and k; and the rotation followed by its backward gives back the rows
    within the dtype's rounding."""
    g = torch.Generator(device=cuda).manual_seed(b + s + h)
    gq = torch.randn((b, s, h, dh), generator=g, device=cuda).to(dtype)
    gk = torch.randn((b, s, hk, dh), generator=g, device=cuda).to(dtype)
    pos = torch.arange(s, device=cuda)[None].repeat(b, 1) % max(1, (s + 2) // 3)
    cos, sin = E.rotary_tables(dh, 4096, 10000.0, cuda)
    views = (gq.transpose(1, 2).contiguous().transpose(1, 2),
             gk.transpose(1, 2).contiguous().transpose(1, 2))
    for q, k in ((gq, gk), views):
        q0, k0 = q.clone(), k.clone()
        n = E.rotary_grad.launches
        got = E.rotary_grad(q, k, cos, sin, pos)
        want = E._rotary_grad_plain(q, k, cos, sin, pos)
        torch.cuda.synchronize()
        assert E.rotary_grad.launches == n + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(q, q0) and torch.equal(k, k0)
    back = E.rotary_grad(*E.rotary(gq.clone(), gk.clone(), cos, sin, pos), cos, sin, pos)
    rel = float((back[0].float() - gq.float()).norm() / gq.float().norm())
    assert rel < (1e-2 if dtype == torch.bfloat16 else 1e-6)


def _tiny_minigpt4(cuda, act_quant: bool):
    """A tiny MiniGPT-4 on the card with a bf16 decoder (W8A8 or bf16
    products) and a packed batch whose last row is all padding."""
    from certifiedgpt_tpu_torch.data.text import BatchSpec, ByteTokenizer, pack_train_batch
    from certifiedgpt_tpu_torch.models import minigpt4 as TM
    from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model, build_synthetic_params

    cfg = TM.MiniGPT4Config.tiny()
    cfg = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, img_size=224, attn_impl="flash_cls",
                                     act_quant=True, dtype=torch.bfloat16),
        llama=dataclasses.replace(cfg.llama, act_quant=act_quant, dtype=torch.bfloat16))
    params = build_synthetic_params(cfg, cuda, seed=0, quantize_llama=act_quant)
    model = MiniGPT4Model(cfg, params, ByteTokenizer())
    tr = model.make_trainable(("llama_proj",))
    questions = ["<Img><ImageHere></Img> what is it?", "<Img><ImageHere></Img> colour?",
                 "<Img><ImageHere></Img> how many?", "<Img><ImageHere></Img> where?"] * 2
    answers = ["a cat", "red", "two", "in the kitchen"] * 2
    spec = BatchSpec(seq_len=80, num_img_tokens=cfg.num_img_tokens, max_answer_len=16)
    text = pack_train_batch(ByteTokenizer(), questions, answers, spec, 2)
    for key, fill in (("input_ids", 0), ("attention_mask", 0), ("labels", -100),
                      ("segment_ids", 0), ("positions", 0)):
        text[key][-1] = fill
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {k: torch.from_numpy(v).long().to(cuda) for k, v in text.items()}
    batch["image"] = torch.randn((len(questions), 224, 224, 3), generator=g, device=cuda)
    return TM, model, cfg, tr["llama_proj"], batch


@pytest.mark.gpu
@pytest.mark.parametrize("act_quant", [True, False], ids=["w8a8", "bf16"])
def test_train_step_through_the_decoder_kernels_on_gpu(cuda, act_quant):
    """A tiny MiniGPT-4's loss and ``llama_proj`` gradient with the
    decoder's fused ops and their backward kernels against the same with
    every one of the six on its plain version: within 1e-2 (loss) and 5e-2
    (gradient), finite; each kernel launched as often as the decoder has
    norms (two a layer and the final one), rotaries and SiLU x ups."""
    from unittest import mock

    TM, model, cfg, proj, batch = _tiny_minigpt4(cuda, act_quant)
    fused = ("add_rms_norm", "rotary", "silu_mul", "add_rms_norm_grad", "rotary_grad",
             "silu_mul_grad")

    def loss_and_grad():
        for p in proj.values():
            p.grad = None
        loss = TM.minigpt4_loss(model.params, cfg, batch)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), proj["kernel"].grad.clone()

    for name in fused:
        getattr(E, name).launches = 0
    loss, grad = loss_and_grad()
    depth = cfg.llama.num_layers
    assert [getattr(E, name).launches for name in fused] == [2 * depth + 1, depth, depth] * 2
    plain = {"add_rms_norm": E._add_rms_norm_plain, "rotary": E._rotary_plain,
             "silu_mul": E._silu_mul_plain, "add_rms_norm_grad": E._add_rms_norm_grad_plain,
             "rotary_grad": E._rotary_grad_plain, "silu_mul_grad": E._silu_mul_grad_plain}
    patches = [mock.patch.object(E, name, fn) for name, fn in plain.items()]
    for p in patches:
        p.start()
    try:
        plain_loss, plain_grad = loss_and_grad()
    finally:
        for p in patches:
            p.stop()
    assert torch.isfinite(loss) and bool(torch.isfinite(grad).all())
    assert abs(float(loss) - float(plain_loss)) / abs(float(plain_loss)) < 1e-2
    assert float((grad - plain_grad).norm() / plain_grad.norm()) < 5e-2


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,k", [(4096, 4096, 4096), (300, 11008, 4096), (5, 72, 144),
                                   (1, 64, 128)])
def test_w8_grad_gemm_matches_plain_on_gpu(cuda, m, n, k):
    """The straight-through input gradient reading the int8 kernel: an
    identity ``g`` gives back ``_dequantized_t``'s weight bit for bit, and
    ``_grad_input`` of bf16 rows (one launch, ragged edges included) is
    within an ulp and the f32 sum order (``chip_smoke.GRAD_GEMM_SUM_SLACK``)
    of ``_grad_input_plain``; f32 rows take the plain version."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    kq, scale, rows = chip_smoke.grad_gemm_case(torch, cuda, g, m, n, k)
    eye = torch.eye(n, device=cuda, dtype=torch.bfloat16)
    assert torch.equal(Q.w8_grad_gemm(eye, kq, scale), Q._dequantized_t(kq, scale, torch.bfloat16))
    launches = Q.w8_grad_gemm.launches
    got = Q._grad_input(rows.reshape(1, m, n), kq, scale, torch.float32)
    want = Q._grad_input_plain(rows.reshape(1, m, n), kq, scale, torch.float32)
    assert Q.w8_grad_gemm.launches == launches + 1 and got.dtype == torch.float32
    mag = rows.float().abs() @ Q._dequantized_t(kq, scale, torch.float32).abs()
    ulp = torch.from_numpy(np.spacing(want[0].abs().cpu().numpy())).to(cuda) * 2.0 ** 16
    slack = (ulp + 2.0 * (n - 1) * chip_smoke.GRAD_GEMM_SUM_SLACK * mag)[None]
    assert bool(((got[0] - want[0]).abs() <= slack[0]).all())
    f32 = Q._grad_input(rows.float(), kq, scale, torch.float32)
    assert Q.w8_grad_gemm.launches == launches + 1
    assert torch.equal(f32, Q._grad_input_plain(rows.float(), kq, scale, torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 64, 16])
@pytest.mark.parametrize("b,s,packed,left", [(2, 256, True, False), (3, 200, False, True),
                                             (1, 70, False, False)])
def test_training_attention_matches_plain_on_gpu(cuda, d, b, s, packed, left):
    """The training attention's forward and backward kernels against the
    plain version under autograd, within ``chip_smoke.TRAIN_ATTN_REL``;
    queries that see no key give exact zeros and zero gradients; one launch
    of each kernel; f32 operands take the plain version."""
    g = torch.Generator(device=cuda).manual_seed(b + s + d)
    q, k, v, go, valid, seg = chip_smoke.train_attention_case(torch, cuda, g, b, s, packed,
                                                              left)
    q, k, v, go = (t[..., :d].contiguous() for t in (q, k, v, go))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counts = [A.train_attention_fwd.launches, A.train_attention_dq.launches,
              A.train_attention_dkv.launches]
    out = A.training_attention(*leaves, valid, seg)
    grads = torch.autograd.grad(out, leaves, go)
    assert [A.train_attention_fwd.launches, A.train_attention_dq.launches,
            A.train_attention_dkv.launches] == [c + 1 for c in counts]
    pleaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pout = A._training_attention_plain(*pleaves, valid, seg)
    pgrads = torch.autograd.grad(pout, pleaves, go)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (pout, *pgrads)):
        assert chip_smoke.rel_err(got.detach(), want.detach()) < chip_smoke.TRAIN_ATTN_REL[name]
    dead = ~A.training_mask(valid, seg, s, cuda).any(dim=-1)[:, 0]
    assert not out[dead].any() and not grads[0][dead].any()
    f32 = A.training_attention(q.float(), k.float(), v.float(), valid, seg)
    assert A.train_attention_fwd.launches == counts[0] + 1
    assert torch.equal(f32, A._training_attention_plain(q.float(), k.float(), v.float(), valid,
                                                        seg))


@pytest.mark.gpu
def test_training_attention_refuses_other_widths_on_gpu(cuda):
    """A bf16 head width without an instance raises; nothing falls back."""
    x = torch.zeros((1, 8, 2, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        A.training_attention(x, x, x, torch.ones((1, 8), device=cuda))


@pytest.mark.gpu
def test_lm_head_backward_splits_the_cotangent_on_gpu(cuda):
    """The lm_head's backward on the card, the f32 cotangent as three bf16
    terms times the bf16 head, against the f32 product with the head cast
    to f32 (TF32 off): within 2e-5 relative before the rounding to bf16 (two
    orders of f32 sums of 32000 terms)."""
    from certifiedgpt_tpu_torch.models import llama as LL

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(3)
    cot = torch.randn((300, 32000), generator=g, device=cuda)
    head = (torch.randn((4096, 32000), generator=g, device=cuda) * 0.02).bfloat16()
    got = LL._f32_times_t(cot, head)
    want = cot @ head.float().t()
    assert got.dtype == torch.float32
    assert float((got - want).norm() / want.norm()) < 2e-5
