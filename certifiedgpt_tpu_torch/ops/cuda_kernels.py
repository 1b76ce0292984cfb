"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file under ``certifiedgpt_tpu_torch/csrc/`` is compiled by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, loaded with ``ctypes``. The build happens at first use, into
``build/certifiedgpt_tpu_torch/`` beside the package, and the library file is
keyed by a hash of the sources, so an edited source rebuilds. The sources
compile in parallel, one ``nvcc`` per file, and link once.

Each C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception. Nothing here falls back:
a missing ``nvcc`` or a failed build raises.

Each wrapper that launches a kernel carries a launch counter
(``launch_counter``), listed in ``LAUNCH_COUNTERS`` with the kernel's name;
``traced_launches`` counts the same launches in a ``torch.profiler`` trace
(``device_trace``).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "certifiedgpt_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# C entry point -> argument types (all return an int cudaError_t code)
_SIGNATURES = {
    "cgpt_ln_quant": (_P, _P, _I32, _P, _I32, _P, _P, _I64, _I32, _F32, _P),  # x, gamma, is f32, beta, is f32, q, s, M, K, eps
    "cgpt_gelu_quant": (_P, _P, _P, _I64, _I32, _P),
    "cgpt_cls_split_attention": (
        _P, _P, _P, _I64, _I64, _I64,  # q, k, v and their strides
        _P, _P, _P, _I64, _I64,  # qc, kc, vc and their strides
        _P, _I64, _I64, _I64,  # out and its strides
        _P, _I64, _I64,  # out_c and its strides
        _I32, _I32, _I32, _I32,  # B, H, N, D
        _F32,  # scale_log2
        _P,  # stream
    ),
    "cgpt_flash_attention": (
        _P, _I64, _I64, _I64,  # q and its (b, h, s) strides
        _P, _I64, _I64, _I64,  # k
        _P, _I64, _I64, _I64,  # v
        _P, _I64, _I64, _I64,  # out
        _I32, _I32, _I32, _I32,  # B, H, S, D
        _F32, _I32,  # scale_log2, causal
        _P,  # stream
    ),
    "cgpt_noisy_tile": (_P, _P, _P, _P, _I64, _I32, _P),  # x, seed, sigma, out, elems, n
    "cgpt_quant_rows": (_P, _P, _P, _I64, _I32, _P),  # x, q, s, M, K
    "cgpt_quant_rows_f32": (_P, _P, _P, _I64, _I32, _P),  # x, q, s, M, K
    "cgpt_w8a8_epilogue": (_P, _I64, _P, _P, _P, _P, _I64, _I32, _I32, _P),  # acc, lda, xs, ws, bias, out, M, N, out f32
    "cgpt_w8a8_gemm": (
        _P, _I64, _P, _I64,  # int8 rows and their stride, the column-major int8 kernel and its
        # channel stride
        _P, _P, _P,  # xs, ws, bias (or null)
        _P, _I64,  # out and its row stride
        _I64, _I32, _I32, _I32,  # M, N, K, out kind (0 bf16, 1 f32, 2 the int32 sums)
        _I32, _P, _I32,  # K splits, the split-K scratch (or null) and its work units
        _P,  # stream
    ),
    "cgpt_w8a8_gemm_plan": (_I64, _I32, _I32, _I32, _P),  # M, N, K, K splits, int[11] out
    "cgpt_train_attention_fwd": (
        _P, _P, _P, _P, _P,  # q, k, v, the keys' validity, the segment ids (or null)
        _P, _P, _P,  # out, the rows' max and sum
        _I32, _I32, _I32, _I32, _I32, _F32,  # B, S, H, Hkv, head_dim, scale
        _P,  # stream
    ),
    "cgpt_train_attention_bwd": (
        _P, _P, _P, _P, _P, _P,  # q, k, v, validity, segment ids (or null), the output's gradient
        _P, _P, _P,  # the rows' max and sum, D (written by part 0, read by part 1)
        _P, _P, _P,  # dq, dk, dv
        _I32, _I32, _I32, _I32, _I32, _F32, _I32,  # B, S, H, Hkv, head_dim, scale, part (0 dq,
        # 1 dk and dv)
        _P,  # stream
    ),
    "cgpt_w8_grad_gemm": (
        _P, _I64, _P, _I64, _P,  # g and its row stride, the column-major int8 kernel and its
        # channel stride, the channel scales
        _P, _I64, _I64, _I32, _I32,  # out and its row stride, M, N, K
        _P,  # stream
    ),
    "cgpt_int8_weight_matmul_plan": (_I32, _I32, _I32, _I32, _P),  # M, N, K, x f32, int[7] out
    "cgpt_int8_weight_matmul": (
        _P, _I64, _P, _I64, _P, _P, _I64,  # x, ldx, kernel, its channel stride, scale, out, ldo
        _I32, _I32, _I32, _I32,  # M, N, K, x f32
        _P,  # stream
    ),
    "cgpt_attention_kv8": (
        _P, _I64, _I64, _I64,  # q and its (b, s, h) strides
        _P, _I64, _I64, _I64,  # the new k rows and their (b, s, h) strides
        _P, _I64, _I64, _I64,  # the new v rows and their (b, s, h) strides
        _P, _P, _I64, _I64, _I64,  # the int8 cache k, v and their (b, t, h) strides
        _P, _P, _I64, _I64, _I64,  # k_scale, v_scale and their (b, t, h) strides
        _P, _I64, _I64, _I64,  # mask and its (b, s, t) strides
        _P,  # out
        _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # B, Sq, H, Hkv, T, Dh, offset, Sn
        _F32, _I32,  # scale, q f32
        _P,  # stream
    ),
    "cgpt_attention_kv8_plan": (_I32, _I32, _I32, _I32, _P),  # Sq, g, Dh, q f32, int[3] out
    "cgpt_attention_kv8_prefill": (
        _P, _I64, _I64, _I64,  # q and its (b, s, h) strides
        _P, _I64, _I64, _I64,  # the new k rows and their (b, s, h) strides
        _P, _I64, _I64, _I64,  # the new v rows and their (b, s, h) strides
        _P, _P, _I64, _I64, _I64,  # the int8 cache k, v and their (b, t, h) strides
        _P, _P, _I64, _I64, _I64,  # k_scale, v_scale and their (b, t, h) strides
        _P, _I64, _I64, _I64,  # mask and its (b, s, t) strides
        _P,  # out
        _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # B, Sq, H, Hkv, T, Dh, offset, Sn
        _F32,  # scale
        _P,  # stream
    ),
    "cgpt_attention_kv8_prefill_plan": (_I32,) * 7 + (_P,),  # B, Sq, H, Hkv, T, offset, Sn, int[5] out
    "cgpt_add_rms_norm": (
        _P, _P, _P, _P, _I32,  # x, y (or null), x + y, scale, scale f32
        _P, _P, _P,  # out, or codes and row scales
        _I64, _I32, _F32, _I32, _I32,  # M, K, eps, rows f32, quantize
        _P,  # stream
    ),
    "cgpt_silu_mul": (_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _P),  # gate, up, out, q, s, M, N, f32, quantize
    "cgpt_rotary": (
        _P, _I64, _I64, _I64,  # q and its (b, s, h) strides
        _P, _I64, _I64, _I64,  # k and its (b, s, h) strides
        _P, _I64, _I64, _I64,  # the rotated q (q itself in place) and its strides
        _P, _I64, _I64, _I64,  # the rotated k and its strides
        _P, _P,  # the cos and sin tables
        _P, _I64, _I64, _I32,  # positions, their (b, s) strides, int64
        _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # B, S, Hq, Hk, Dh, max_len, f32
        _I32,  # inverse (the backward)
        _P,  # stream
    ),
    "cgpt_add_rms_norm_grad": (
        _P, _P, _P, _P, _I32,  # s, the output's gradient, s's other gradient (or null), scale, f32
        _P, _I64, _I32, _F32, _I32,  # the input gradient, M, K, eps, rows f32
        _P,  # stream
    ),
    "cgpt_silu_mul_grad": (_P, _P, _P, _P, _P, _I64, _I32, _P),  # g, gate, up, g_gate, g_up, elems, f32
    "cgpt_attention_kv8_decode": (
        _P, _I64, _I64,  # q and its (b, h) strides
        _P, _P, _I64, _I64,  # the step's k, v and their (b, h) strides
        _P, _P, _I64, _I64, _I64,  # the int8 cache k, v and their (b, t, h) strides
        _P, _P, _I64, _I64, _I64,  # k_scale, v_scale and their (b, t, h) strides
        _P, _I64, _I64,  # mask and its (b, t) strides
        _P,  # out
        _I32, _I32, _I32, _I32, _I32, _I32,  # B, H, Hkv, T, Dh, offset
        _P,  # the slot as an int32 on the device (read in place of offset), or null
        _F32, _I32,  # scale, q f32
        _P,  # stream
    ),
}


@dataclasses.dataclass(frozen=True)
class Build:
    """The loaded library with how it was obtained: ``seconds`` spent
    compiling (0 when the hashed library already existed) and the
    compiler's output (``ptxas -v``: registers, shared memory, spills)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of certifiedgpt_tpu_torch are "
        "built with the CUDA toolkit (sm_90a) at first use"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256()
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    units = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (u.stem + ".o") for u in units]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(u), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for u, o in zip(units, objs)
        ]
        failed = []
        for unit, proc in zip(units, procs):
            out, _ = proc.communicate()
            log.append(f"== {unit.name}\n{out}")
            if proc.returncode != 0:
                failed.append(unit.name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(log)
            )
        so_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so_tmp, target)
    return "\n".join(log)


@functools.cache
def build() -> Build:
    """Compile (if the hashed library is missing) and load the kernels."""
    target = BUILD_DIR / f"libcgpt_kernels_{_digest(_sources())}.so"
    t0 = time.perf_counter()
    log = ""
    if not target.exists():
        log = _compile(target)
    seconds = time.perf_counter() - t0 if log else 0.0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cgpt_error_string.argtypes = (ctypes.c_int,)
    lib.cgpt_error_string.restype = ctypes.c_char_p
    return Build(lib, target, seconds, log)


def check(code: int, kernel: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        msg = build().lib.cgpt_error_string(code).decode()
        raise RuntimeError(f"{kernel}: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


# every wrapper that counts its kernel's launches (``launch_counter``)
LAUNCH_COUNTERS: list = []


def launch_counter(owner, kernel: str):
    """Give the wrapper ``owner`` its launch counter: ``owner.launches``
    (0), to which the wrapper adds one where it launches its kernel, and
    ``owner.kernel_name``, a regular expression for the kernel's name as a
    profiler shows it. The owner is listed in ``LAUNCH_COUNTERS``."""
    owner.launches = 0
    owner.kernel_name = re.compile(kernel)
    LAUNCH_COUNTERS.append(owner)
    return owner


# a trace may miss the first device operations of its session (on an
# H100: the arange that opens a prefill, at times a dozen operations, and
# in one process the first two of every session, also where the host had
# waited 50 ms before the first launch). Spins of the card open and close
# each session and take such losses in place of the traced work.
TRACE_PAD_SPINS = (10, 2)  # before and after the traced work
_PAD_CYCLES = 10 ** 7  # a spin of about 5 ms
_PAD_KERNEL = "spin_kernel"  # the kernel of ``torch.cuda._sleep``


def _pad(spins: int) -> None:
    for _ in range(spins):
        torch.cuda._sleep(_PAD_CYCLES)


@contextlib.contextmanager
def device_trace(cpu: bool = False):
    """A ``torch.profiler`` session of the card's activity (and the host's,
    with ``cpu``) over the body of the ``with``, which starts with the card
    idle and is followed by a synchronize. Spins pad the session on both
    sides; ``device_events`` leaves them out. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        _pad(TRACE_PAD_SPINS[0])
        torch.cuda.synchronize()
        yield prof
        _pad(TRACE_PAD_SPINS[1])
        torch.cuda.synchronize()


def device_events(events) -> list:
    """The card's operations among a ``device_trace``'s events (or their
    ``key_averages()``), without the session's pads."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and _PAD_KERNEL not in e.key]


def traced_launches(fn):
    """Run ``fn()`` under ``device_trace`` and count the kernels it put on
    the card: ``({counter: launches}, device operations)``, the first for
    each counter whose kernel ran, the second every CUDA event of the
    trace."""
    with device_trace() as prof:
        fn()
    names = [e.name for e in device_events(prof.events())]
    counts = {c: sum(1 for n in names if c.kernel_name.search(n)) for c in LAUNCH_COUNTERS}
    return {c: n for c, n in counts.items() if n}, len(names)
