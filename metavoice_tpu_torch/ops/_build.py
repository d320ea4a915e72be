"""Build and load the port's CUDA kernels (``metavoice_tpu_torch/csrc/*.cu``).

The sources have a plain C interface and no PyTorch headers, so ``nvcc``
builds them in seconds: one compile per source, all started together, then
one link into a shared library that ``ctypes`` loads (the same pattern as
``metavoice_tpu/native/__init__.py`` for the BPE engine). The library goes
to ``metavoice_tpu_torch/_build/`` (git-ignored), named by a hash of the
sources, the headers they include (``*.cuh``) and the flags, so an edited
source never loads a stale build. A failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> (restype, argtypes) of every C entry point in csrc/
_SIGNATURES = {
    "mv_decode_attention": (_I, [_I] + [_P] * 6 + [_I] * 6 + [_P] + [_I] * 2 + [_P, _P, _I, _P, _P]),
    "mv_decode_attention_multi": (_I, [_I] + [_P] * 6 + [_I] * 8 + [_P, _I, _I, _P, _P, _I, _P, _P]),
    "mv_matmul_int4_i32": (_I, [_P] * 4 + [_I] * 6 + [_P, _P, _I, _P]),
    "mv_matmul_int8_i32": (_I, [_P] * 4 + [_I] * 6 + [_P, _P, _P, _I, _P]),
    "mv_decode_stack_int4": (_I, [_P] * 22 + [_I] * 11 + [_F, _I, _I] + [_P] * 4 + [_L] + [_P] * 4 + [_I, _P, _P]),
    "mv_decode_stack_int8": (_I, [_P] * 18 + [_I] * 10 + [_F, _I, _I] + [_P] * 4 + [_L] + [_P] * 4 + [_I, _P, _P]),
    "mv_decode_block_int4": (_I, [_I] + [_P] * 11 + [_I] * 2 + [_P] + [_I] * 9 + [_P, _I, _I] + [_P] * 3 + [_L, _P, _I, _P, _P, _I, _P]),
    "mv_decode_ffn_int4": (_I, [_P] * 8 + [_I] * 6 + [_P] * 3 + [_L, _P, _I, _P]),
    "mv_matmul_int8": (_I, [_P] * 4 + [_I] * 8 + [_P, _L, _P, _I, _P]),
    "mv_decode_block_int8": (_I, [_P] * 9 + [_I] * 2 + [_P] + [_I] * 5 + [_P, _I, _I] + [_P] * 3 + [_L, _P, _I, _P, _P, _I, _P]),
    "mv_decode_ffn_int8": (_I, [_P] * 8 + [_I] * 3 + [_P] * 3 + [_L, _P, _I, _P]),
    "mv_matmul_int4_grouped": (_I, [_P] * 5 + [_I] * 10 + [_P, _P, _I, _P]),
    "mv_decode_stack_values": (_I, [_P, _P, _P]),
}


class KernelLibrary:
    """The built library, with the seconds and compiler output of its build."""

    def __init__(self, path: Path, build_seconds: float, build_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log
        self.lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.restype = restype
            fn.argtypes = argtypes


_loaded: KernelLibrary | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): cannot build the CUDA kernels")


def _run_together(cmds: list[list[str]]) -> str:
    """Start every command at once, wait for all; their output, or raise."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, output in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}")
    return "".join(outputs)


def kernels() -> KernelLibrary:
    """Build (on first use) and load the kernel library."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # the sources and the headers they include
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libmvtt_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
            nvcc = _nvcc()
            objs = [os.path.join(tmp_dir, src.stem + ".o") for src in sources]
            compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(src)] for src, o in zip(sources, objs)]
            log = _run_together(compiles)
            tmp = os.path.join(tmp_dir, out.name)
            log += _run_together([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    _loaded = KernelLibrary(out, time.perf_counter() - t0, log)
    return _loaded
