"""Where a call of the ring of tensor-core tiles (``int4g_ring_kernel``,
``csrc/matmul_ring.cuh``: K11's, K12's and K13's above 8 rows) spends its
time, from timer marks in an experiment build. Needs a CUDA card and nvcc.

    python3 -m metavoice_tpu_torch.tools.ring_marks

It copies ``metavoice_tpu_torch/csrc`` into
``metavoice_tpu_torch/_build/ring_marks`` (git-ignored), patches marks into
the ring kernel (``%globaltimer`` at each block's start, the producers' and
the consumers' loop ends, the partial's write and the merge's end; SM
cycles by ``clock64()`` summed over a block's steps: producer warp 0's
wait for the step's copies, its conversion up to its arrival, its copy
issue for a step ahead with the wait for the slot; consumer warp 0's wait
for a step and its products), builds ``matmul_int4_grouped.cu`` and
``matmul_int8.cu`` alone, loads them in place of the repository's library,
and runs one call of each main-path projection at M 256 and 16 (and qkv at
M 64) after three warm ones. One line a call: its plan, the blocks' median
loop, epilogue and end times (ns from each block's start), the merging
blocks' end, and the median cycles a step of each phase. The marks change
nothing else in the kernel; a patch that no longer finds its place in the
source raises.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
import types

import numpy as np
import torch

from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.ops import quantized as Q

N_BLOCKS = 4096  # blocks a call the marks hold
N_MARKS = 16
CALLS = (("K12", 256, 2048, 6144), ("K12", 256, 2048, 2048), ("K12", 256, 2048, 5632), ("K12", 256, 5632, 2048),
         ("K13", 256, 2048, 6144), ("K12", 16, 2048, 6144), ("K12", 16, 5632, 2048), ("K13", 16, 2048, 6144),
         ("K12", 64, 2048, 6144), ("K11", 256, 2048, 6144), ("K11", 256, 2048, 2048), ("K11", 256, 2048, 5632),
         ("K11", 256, 5632, 2048), ("K11", 16, 2048, 6144), ("K11", 16, 5632, 2048), ("K11", 64, 2048, 6144))
SOURCES = {"mv_matmul_int4_grouped": "matmul_int4_grouped.cu", "mv_matmul_int8": "matmul_int8.cu"}


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}: update the marks patch")
    return text.replace(old, new, 1)


def _patch(src) -> str:
    """The ring header's text with the marks."""
    c = src.read_text()
    c = _sub(c, '#include "prefill_ring.cuh"\n', '#include "prefill_ring.cuh"\n'
             f"__device__ unsigned long long rg_marks[{N_BLOCKS}][{N_MARKS}];\n"
             "__device__ __forceinline__ unsigned long long rg_time() {\n"
             "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n")
    c = _sub(c, "  __syncthreads();\n\n  float acc[kWmt][kWnt][4];  // the consumers' products",
             "  __syncthreads();\n"
             "  unsigned long long* mk = rg_marks[min(blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z), "
             f"{N_BLOCKS - 1}u)];\n"
             "  const unsigned long long t_start = rg_time();\n"
             "  long long c_wf = 0, c_cv = 0, c_is = 0, c_fw = 0, c_mm = 0;\n\n"
             "  float acc[kWmt][kWnt][4];  // the consumers' products")
    c = _sub(c, "      pf_bar_wait(&wfull[slot], (t / kSlots) & 1);",
             "      const long long c1_ = clock64();\n      pf_bar_wait(&wfull[slot], (t / kSlots) & 1);\n"
             "      const long long c2_ = clock64();\n      c_wf += c2_ - c1_;")
    c = _sub(c, "      pf_bar_arrive(&full[slot]);  // its weights are ready (x: the slot's xfull barrier)\n",
             "      pf_bar_arrive(&full[slot]);  // its weights are ready (x: the slot's xfull barrier)\n"
             "      const long long c3_ = clock64();\n      c_cv += c3_ - c2_;\n")
    c = _sub(c, "      if (lane == 0 && t + S::kAhead < n_steps) issue(t + S::kAhead);  // then the copies of a step ahead\n"
             "    }\n",
             "      if (lane == 0 && t + S::kAhead < n_steps) issue(t + S::kAhead);  // then the copies of a step ahead\n"
             "      c_is += clock64() - c3_;\n    }\n"
             "    if (tid == 0) mk[1] = rg_time() - t_start, mk[5] = c_wf, mk[6] = c_cv, mk[7] = c_is, mk[11] = n_steps;\n")
    c = _sub(c, "      pf_bar_wait(&xfull[slot], (t / kSlots) & 1);\n      pf_bar_wait(&full[slot], (t / kSlots) & 1);\n",
             "      const long long c4_ = clock64();\n      pf_bar_wait(&xfull[slot], (t / kSlots) & 1);\n"
             "      pf_bar_wait(&full[slot], (t / kSlots) & 1);\n      const long long c5_ = clock64();\n"
             "      c_fw += c5_ - c4_;\n")
    c = _sub(c, "      if (lane == 0) pf_bar_arrive(&empty[slot]);  // the warp is done with the slot\n    }\n  }\n",
             "      if (lane == 0) pf_bar_arrive(&empty[slot]);  // the warp is done with the slot\n"
             "      c_mm += clock64() - c5_;\n    }\n"
             "    if (tid == kRgProducers) mk[2] = rg_time() - t_start, mk[9] = c_fw, mk[10] = c_mm;\n  }\n")
    c = _sub(c, "  if (one) return;\n", "  if (tid == kRgProducers) mk[3] = rg_time() - t_start;\n"
             "  if (one) {\n    if (tid == kRgProducers) mk[4] = rg_time() - t_start;\n    return;\n  }\n")
    c = _sub(c, "  if (!last_s) return;\n", "  if (!last_s) {\n    if (tid == 0) mk[4] = rg_time() - t_start;\n"
             "    return;\n  }\n  if (tid == 0) mk[12] = 1;\n")
    c = _sub(c, "  if (tid == 0) a.tickets[tile] = 0;\n}\n",
             "  if (tid == 0) a.tickets[tile] = 0, mk[4] = rg_time() - t_start;\n}\n")
    return c


# the C entries that read and clear the marks, appended to each source built
MARKS_ENTRIES = ("\nextern \"C\" int mv_ring_marks(void* host) {\n"
                 "  return (int)cudaMemcpyFromSymbol(host, rg_marks, sizeof(rg_marks));\n}\n"
                 "extern \"C\" int mv_ring_marks_clear() {\n"
                 "  static unsigned long long zero[sizeof(rg_marks) / sizeof(unsigned long long)];\n"
                 "  return (int)cudaMemcpyToSymbol(rg_marks, zero, sizeof(rg_marks));\n}\n")


def _build_marks() -> dict:
    """Both marked sources built, each into its own library (each its own
    marks), loaded in place of the repository's -> entry name -> library."""
    src_dir = _build.BUILD_DIR / "ring_marks"
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src_dir)
    header = src_dir / "matmul_ring.cuh"
    header.write_text(_patch(header))
    libs = {}
    fns = {}
    for entry, name in SOURCES.items():
        src = src_dir / name
        src.write_text(src.read_text() + MARKS_ENTRIES)
        so = src_dir / f"libringmarks_{src.stem}.so"
        t0 = time.perf_counter()
        out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(out.stdout + out.stderr)
        regs = sorted(set(re.findall(r"Used \d+ registers", out.stdout + out.stderr)))
        print(f"marks build of {name} {time.perf_counter() - t0:.1f} s: {regs}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = _build._SIGNATURES[entry]
        lib.mv_ring_marks.argtypes = [ctypes.c_void_p]
        libs[entry], fns[entry] = lib, fn
    library = _build.KernelLibrary.__new__(_build.KernelLibrary)
    library.lib = types.SimpleNamespace(**fns)
    _build._loaded = library  # the wrappers now launch the marked kernels
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ring_marks needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    libs = _build_marks()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for kernel, m, k, n in CALLS:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        if kernel == "K11":
            q, s = Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02)
            call, lib = (lambda: Q.matmul_int8(x, q, s)), libs["mv_matmul_int8"]
            bm, split_chunks, n_splits = Q.int8_tile_plan(m, k, n)
        else:
            packed = kernel == "K13"
            q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device=dev) * 0.02)
            w = Q.pack_int4(q) if packed else q
            fn = Q.matmul_int4_packed if packed else Q.matmul_int4
            call, lib = (lambda: fn(x, w, s, z)), libs["mv_matmul_int4_grouped"]
            bm, split_chunks, n_splits = Q.int4g_tile_plan(m, k, n, packed)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        lib.mv_ring_marks_clear()
        call()
        torch.cuda.synchronize()
        blocks = -(-m // bm) * -(-n // Q.INT4G_RING_BN) * n_splits
        marks = np.zeros((N_BLOCKS, N_MARKS), np.uint64)
        if lib.mv_ring_marks(ctypes.c_void_p(marks.ctypes.data)):
            raise RuntimeError("reading the marks failed")
        r = marks[:blocks].astype(np.float64)
        steps = np.maximum(r[:, 11], 1)
        merging = r[:, 12] == 1

        def per_step(col):
            return np.median(r[:, col] / steps)

        print(f"{kernel} M {m} {k}x{n}: plan bm {bm}, {n_splits} splits of {split_chunks} staged "
              f"blocks, {blocks} blocks, {np.median(r[:, 11]):.0f} steps a block; ns from a block's start (medians): "
              f"producers' loop {np.median(r[:, 1]):.0f}, consumers' loop {np.median(r[:, 2]):.0f}, epilogue "
              f"{np.median(r[:, 3]):.0f}, end {np.median(r[:, 4]):.0f} (merging blocks "
              f"{np.median(r[merging, 4]) if merging.any() else 0:.0f}); cycles a step (medians): producer warp 0 "
              f"waits for the copies {per_step(5):.0f}, converts {per_step(6):.0f}, issues ahead {per_step(7):.0f}; "
              f"consumer warp 0 waits {per_step(9):.0f}, multiplies {per_step(10):.0f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
