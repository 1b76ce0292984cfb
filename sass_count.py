"""Count a CUDA kernel's SASS instructions by class, from ``cuobjdump -sass``.

A measuring aid of ``chip_smoke.py`` and ``scripts/bench_torch_noise.py``;
the package does not use it. It counts each opcode over a kernel's
instances (``opcode_counts``: the weight-only int8 kernel must carry no
``I2F``), and one trip of a kernel's innermost loop: for the noise kernel
(``certifiedgpt_tpu_torch/csrc/noise.cu``), one
trip of its image loop writes eight elements of one image, so the count over
eight is what an element costs in issue slots. The time those take at 128
instructions a clock an SM is an issue-rate figure, not a bound. Needs the
CUDA toolkit's ``cuobjdump`` and ``nvidia-smi``.
"""

from __future__ import annotations

import re
import shutil
import subprocess

# the noise kernel's instance for whole 16-byte quads (every image size that
# is a multiple of 4), and the elements one trip of its image loop writes
NOISE_KERNEL = "noise_kernelILb1E"
NOISE_ELEMS_PER_TRIP = 8

# SASS opcode (its first word) -> class; anything else is "other" (moves,
# conversions, special registers, predicate logic)
_CLASSES = {
    "mufu": ("MUFU",),
    "memory": ("LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LDL", "STL", "LD", "ST", "ATOM",
               "ATOMS", "ATOMG", "RED", "LDGSTS", "LDSM", "STSM", "UBLKCP", "SYNCS"),
    "control": ("BRA", "EXIT", "BSSY", "BSYNC", "CALL", "RET", "NOP", "BAR", "WARPSYNC",
                "YIELD", "BPT"),
    "f32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FRND", "FCHK", "FSET"),
    "uniform": ("UIADD3", "UIMAD", "ULOP3", "USHF", "UMOV", "ULEA", "USEL", "UISETP", "UPRMT",
                "S2UR", "R2UR", "UFLO", "UPOPC", "UBMSK", "USGXT", "UPLOP3"),
    "integer": ("IMAD", "IADD3", "IADD", "ISETP", "IABS", "IMNMX", "VIMNMX", "LOP3", "LOP",
                "SHF", "LEA", "PRMT", "SEL", "POPC", "FLO", "BMSK", "SGXT", "IDP", "ISCADD",
                "VIADD", "IMUL", "BREV"),
}


def _class(opcode: str) -> str:
    base = opcode.split(".")[0]
    return next((name for name, ops in _CLASSES.items() if base in ops), "other")


def parse(text: str, function: str):
    """Instructions of the first function in ``cuobjdump -sass`` output whose
    name contains ``function``: a list of (address, predicated, opcode,
    operands)."""
    insts, inside = [], False
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = function in line
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);", line)
        if inside and m:
            insts.append((int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4)))
    return insts


def sass_of(lib_path) -> str:
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout


def opcode_counts(text: str, function: str):
    """{function name: {opcode base: count}} of every function in ``cuobjdump
    -sass`` output whose name contains ``function`` (each instance of a
    template, say)."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            found = line.split("Function :")[1].strip()
            name = found if function in found else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if name and m:
            counts = out.setdefault(name, {})
            base = m.group(1).split(".")[0]
            counts[base] = counts.get(base, 0) + 1
    return out


def _branch_target(op: str, args: str):
    """The address a ``BRA`` jumps to, or None for any other instruction."""
    if not op.startswith("BRA"):
        return None
    try:
        return int(args.split()[-1].strip("`()"), 16)
    except (ValueError, IndexError):
        return None


def loop_trip(insts):
    """The instructions of one trip of the innermost loop, counted by class
    (``all`` and one key per class present), or None without a loop. A loop
    is the span from a backward branch's target to the branch; a span that
    holds an unpredicated EXIT is an out-of-line block jumping back, not a
    loop."""
    addr = {a: i for i, (a, _, _, _) in enumerate(insts)}
    loops = []
    for i, (_, _, op, args) in enumerate(insts):
        lo = addr.get(_branch_target(op, args))
        if lo is not None and lo < i and not any(
                o == "EXIT" and not p for _, p, o, _ in insts[lo:i]):
            loops.append((i - lo, lo, i))
    if not loops:
        return None
    _, lo, hi = min(loops)
    counts = {"all": hi + 1 - lo}
    for _, _, op, _ in insts[lo:hi + 1]:
        c = _class(op)
        counts[c] = counts.get(c, 0) + 1
    return counts


def noise_trip(lib_path):
    """One trip of the noise kernel's image loop in a built library, counted
    by class, and its instructions an element."""
    trip = loop_trip(parse(sass_of(lib_path), NOISE_KERNEL))
    if trip is None:
        raise RuntimeError(f"no image loop in the SASS of {NOISE_KERNEL!r} in {lib_path}")
    return trip, trip["all"] / NOISE_ELEMS_PER_TRIP


def max_sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reads it (an
    instantaneous read depends on the load and idles far lower)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def issue_ms(per_elem: float, elems: int, sms: int, clock_mhz: float) -> float:
    """Time of ``per_elem`` instructions for each of ``elems`` elements at
    128 instructions a clock an SM."""
    return per_elem * elems / (128 * sms * clock_mhz * 1e6) * 1e3
