"""Where a decode-stack step (K3 or K7) spends its time, from ``%globaltimer``
marks in an experiment build of its kernels. Needs a CUDA card and nvcc.

    python3 -m metavoice_tpu_torch.tools.stack_marks [--wfmt i4|i8] [--pos 255]
    python3 -m metavoice_tpu_torch.tools.stack_marks --ffn i4|i8

It copies ``metavoice_tpu_torch/csrc`` into ``metavoice_tpu_torch/_build/marks``
(git-ignored), patches marks into every product kernel (``stack_gemv``: its
start, after ``pdl_wait``, once the slice's copies are issued and the
scalars have landed, once the slice has landed, after the norm-and-sum
pass, before its products, at its products' end, at its end) and into the
attention split (start, after its wait, end), builds
``decode_stack_int4.cu`` alone, loads it in place of the repository's
library, times one full-width step at ``--pos`` from CUDA events (20 steps
eager, then 100 replayed from a CUDA graph), then runs one step with the
marks on and prints layer 5's launches: blocks, first start, median phase
times and the last block's end. The marks change nothing else in the
kernels; a patch that no longer finds its place in the sources raises.

``--ffn i4`` (K6) or ``--ffn i8`` (K10) marks the two products of one
per-layer FFN call instead: it builds ``decode_block_int4.cu`` or
``decode_block_int8.cu`` alone with the same marks, times the 24 layers'
calls at B 2 (eager and from a CUDA graph) and prints layer 5's call.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

N_MARKS = 8
SLOTS = (160, 1024, N_MARKS)  # (launch, block, mark)
NAMES = ["qkv", "att", "cmb", "o", "w13", "w2"]


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"the source no longer holds {old[:60]!r}: update the marks patch")
    return text.replace(old, new, 1)


def _patch(src_dir):
    att = (src_dir / "decode_attention.cuh").read_text()
    att = _sub(att, "namespace {\n", "namespace {\n"
               f"__device__ unsigned long long g_marks[{SLOTS[0]}][{SLOTS[1]}][{SLOTS[2]}];\n"
               "__device__ __forceinline__ unsigned long long mk_time() {\n"
               "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
               f"__device__ __forceinline__ unsigned long long* mk_at(int i, int b) {{ return g_marks[i][min(b, {SLOTS[1] - 1})]; }}\n")
    att = _sub(att, "decode_attn_split(SplitArgs<TQ, T> a) {\n  if constexpr (kChained) {\n    pdl_wait();",
               "decode_attn_split(SplitArgs<TQ, T> a) {\n  unsigned long long* mk = nullptr;\n"
               "  if constexpr (kChained) {\n    mk = mk_at(6 * a.layer + 1, blockIdx.x + gridDim.x * blockIdx.y);\n"
               "    if (threadIdx.x == 0) mk[0] = mk_time();\n    pdl_wait();\n    if (threadIdx.x == 0) mk[1] = mk_time();")
    att = _sub(att, "  __syncthreads();\n\n  if (threadIdx.x < DH) {\n    const int d = threadIdx.x;",
               "  __syncthreads();\n  if (kChained && threadIdx.x == 0) mk[7] = mk_time();\n\n"
               "  if (threadIdx.x < DH) {\n    const int d = threadIdx.x;")
    (src_dir / "decode_attention.cuh").write_text(att)

    h = (src_dir / "decode_stack_gemv.cuh").read_text()
    h = _sub(h, "struct SgArgs {", "struct SgArgs {\n  int mark;")
    h = _sub(h, "  // int4 takes its run in batches",
             "  unsigned long long* mk = mk_at(a.mark, blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));\n"
             "  if (tid == 0) mk[0] = mk_time();\n  // int4 takes its run in batches")
    h = _sub(h, "  pdl_wait();\n", "  pdl_wait();\n  if (tid == 0) mk[1] = mk_time();\n")
    h = _sub(h, "#pragma unroll\n  for (int q = 0; q < kSgRows * kSgCols / kSgThreads; ++q) {\n"
             "    const int i = tid + q * kSgThreads;\n    if (i < b_rows * kSgCols) s_resid",
             "  if (tid == 0) mk[2] = mk_time();\n#pragma unroll\n  for (int q = 0; q < kSgRows * kSgCols / kSgThreads; ++q) {\n"
             "    const int i = tid + q * kSgThreads;\n    if (i < b_rows * kSgCols) s_resid")
    h = _sub(h, "  sg_bar_wait(&s_bar);\n  __syncthreads();\n",
             "  sg_bar_wait(&s_bar);\n  __syncthreads();\n  if (tid == 0) mk[3] = mk_time();\n")
    h = _sub(h, "  __syncthreads();\n  if constexpr (kInt8) {\n    if (tid < b_rows) {",
             "  __syncthreads();\n  if (tid == 0) mk[4] = mk_time();\n  if constexpr (kInt8) {\n    if (tid < b_rows) {")
    h = _sub(h, "  // the products: out[cp][e]", "  if (tid == 0) mk[5] = mk_time();\n  // the products: out[cp][e]")
    h = _sub(h, "  // the warps' sums, then the block's", "  if (tid == 0) mk[6] = mk_time();\n  // the warps' sums, then the block's")
    h = _sub(h, "  if (n_parts == 1) return;\n  __syncthreads();  // the block's writes",
             "  if (tid == 0) mk[7] = mk_time();\n  if (n_parts == 1) return;\n  __syncthreads();  // the block's writes")
    h = _sub(h, "  if (tid == 0) a.tickets[blockIdx.x] = 0;\n}", "  if (tid == 0) {\n    a.tickets[blockIdx.x] = 0;\n    mk[7] = mk_time();\n  }\n}")
    (src_dir / "decode_stack_gemv.cuh").write_text(h)

    c = (src_dir / "decode_stack_int4.cu").read_text()
    for name, idx in (("q", 0), ("o", 3), ("f", 4), ("w", 5)):  # (SgArgs, the launch's mark slot)
        c = _sub(c, f"    SgArgs {name} = base;\n", f"    SgArgs {name} = base;\n    {name}.mark = 6 * l + {idx};\n")
    c = _sub(c, "    SgArgs hd = base;\n", "    SgArgs hd = base;\n    hd.mark = 6 * a.n_layer;\n")
    (src_dir / "decode_stack_int4.cu").write_text(c + _EXPORTS)


_EXPORTS = ('\nextern "C" int mv_marks(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_marks, sizeof(g_marks)); }\n'
            'extern "C" int mv_marks_clear(void* zeros) { return (int)cudaMemcpyToSymbol(g_marks, zeros, '
            'sizeof(g_marks)); }\n')
FFN_SOURCES = {"i4": ("decode_block_int4.cu", "mv_decode_ffn_int4"), "i8": ("decode_block_int8.cu", "mv_decode_ffn_int8")}


def _patch_ffn(src_dir, wfmt: str):
    """Marks slot 0 for the FFN's w1/w3 launch, 1 for its w2 launch."""
    name = FFN_SOURCES[wfmt][0]
    c = (src_dir / name).read_text()
    c = _sub(c, "  SgArgs f = {};\n", "  SgArgs f = {};\n  f.mark = 0;\n")
    c = _sub(c, "  SgArgs w = f;\n", "  SgArgs w = f;\n  w.mark = 1;\n")
    (src_dir / name).write_text(c + _EXPORTS)


def _build_marks(ffn: str | None = None) -> ctypes.CDLL:
    src_dir = _build.BUILD_DIR / "marks"
    shutil.rmtree(src_dir, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, src_dir)
    _patch(src_dir)
    source, entries = "decode_stack_int4.cu", ("mv_decode_stack_int4", "mv_decode_stack_int8")
    if ffn is not None:
        _patch_ffn(src_dir, ffn)
        source, entry = FFN_SOURCES[ffn]
        entries = (entry,)
    so = src_dir / "libmarks.so"
    t0 = time.perf_counter()
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                          str(src_dir / source)], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    regs = re.findall(r"Used \d+ registers", out.stdout + out.stderr)
    print(f"marks build {time.perf_counter() - t0:.1f} s: {regs}")
    lib = ctypes.CDLL(str(so))
    library = _build.KernelLibrary.__new__(_build.KernelLibrary)
    library.lib = lib
    for name in entries:
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = _build._SIGNATURES[name]
    _build._loaded = library  # the wrapper now launches the marked kernels
    return lib


def _read_marks(lib) -> np.ndarray:
    marks = np.zeros(SLOTS, np.uint64)
    lib.mv_marks(ctypes.c_void_p(marks.ctypes.data))
    return marks.astype(np.int64)


def _product_line(r, label: str) -> str:
    """A product's marks (blocks x N_MARKS, us from the call's first start)."""
    med = [np.median(r[:, j + 1] - r[:, j]) for j in range(1, 7)]
    return (f"{label}: {len(r)} blocks, start {r[:, 0].min():.2f}-{r[:, 0].max():.2f} us, wait done "
            f"{r[:, 1].min():.2f}, end {r[:, 7].max():.2f}; medians: scalars {med[0]:.2f}, slice {med[1]:.2f}, "
            f"norm+sums {med[2]:.2f}, int8 sums {med[3]:.2f}, products {med[4]:.2f}, epilogue {med[5]:.2f}")


def ffn_main(wfmt: str) -> int:
    """K6 (i4) or K10 (i8) at the main-path shape, B 2: times, then layer 5's
    call with the marks on."""
    lib = _build_marks(wfmt)
    dev = torch.device("cuda")
    cfg = first_stage_config()
    gen = torch.Generator(device=dev).manual_seed(1)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    if wfmt == "i4":
        lay = Q.quantize_params_int4_i32(params)["layers"]
        args = [t for k in ("w1", "w3", "w2") for t in (lay[k]["pw"], lay[k]["sc"])]

        def call(li):
            return Q.decode_ffn_int4(x, *args, li)
    else:
        lay = Q.quantize_params_int8(params)["layers"]

        def call(li):
            return Q.ffn_int8(x, *[lay[k][f][li] for k in ("w1", "w3", "w2") for f in ("q", "scales")])
    del params

    def layers():
        for li in range(cfg.n_layer):
            call(li)

    for _ in range(3):
        layers()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        layers()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 10 / cfg.n_layer
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        layers()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    print(f"{'K6' if wfmt == 'i4' else 'K10'} B 2: {eager_ms:.4f} ms a layer eager, "
          f"{start.elapsed_time(end) / 20 / cfg.n_layer:.4f} from a CUDA graph (CUDA events); "
          f"{torch.cuda.get_device_name(0)}")
    zeros = np.zeros(SLOTS, np.uint64)  # held while the copy reads it
    lib.mv_marks_clear(ctypes.c_void_p(zeros.ctypes.data))
    call(5)
    torch.cuda.synchronize()
    marks = _read_marks(lib)
    base = marks[0, :, 0][marks[0, :, 0] > 0].min()
    prev_end = None
    for idx, label in enumerate(("w1/w3", "w2")):
        live = marks[idx, :, 0] > 0
        r = (marks[idx][live] - base) / 1e3
        line = _product_line(r, f"layer 5 {label}")
        if prev_end is not None:
            line += f"; from the last end {r[:, 1].min() - prev_end:.2f}"
        prev_end = r[:, 7].max()
        print(line)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--wfmt", choices=("i4", "i8"), default="i4")
    ap.add_argument("--pos", type=int, default=255)
    ap.add_argument("--ffn", choices=tuple(FFN_SOURCES), help="mark one K6 (i4) or K10 (i8) call instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stack_marks needs a CUDA card")
    if args.ffn:
        return ffn_main(args.ffn)
    vpw = 8 if args.wfmt == "i4" else 4
    lib = _build_marks()
    dev = torch.device("cuda")
    cfg = first_stage_config()
    gen = torch.Generator(device=dev).manual_seed(1)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    lay = params["layers"]
    for key in ("attn_norm_w", "ffn_norm_w"):
        lay[key] = (1 + 0.1 * torch.randn(lay[key].shape, generator=gen, device=dev)).to(torch.bfloat16)
    qp = (Q.quantize_params_int4_i32 if vpw == 8 else Q.quantize_params_int8_i32)(params)
    fields = ("pw", "sc") if vpw == 8 else ("p8", "sc8")
    lay = qp["layers"]
    weights = [lay[k][f] for k in ("wqkv", "wo", "w1", "w3", "w2") for f in fields]
    shape = (cfg.n_layer, cfg.block_size, 2, cfg.n_local_heads, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(norm_eps=cfg.norm_eps, wfmt=args.wfmt)
    if vpw == 8:
        kw.update(ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])

    pos_t = torch.tensor(args.pos, dtype=torch.int32, device=dev)

    def step():
        return DS.decode_stack_int4(x, lay["attn_norm_w"], lay["ffn_norm_w"], *weights, kc, vc, pos_t,
                                    cfg.n_head, **kw)

    for _ in range(3):
        step()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        step()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 20
    side = torch.cuda.Stream()  # then 20 steps captured in a CUDA graph, replayed 5 times
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            step()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    print(f"{args.wfmt} pos {args.pos}: {eager_ms:.4f} ms a step eager, {start.elapsed_time(end) / 100:.4f} "
          f"from a CUDA graph (CUDA events); {torch.cuda.get_device_name(0)}")
    zeros = np.zeros(SLOTS, np.uint64)
    lib.mv_marks_clear(ctypes.c_void_p(zeros.ctypes.data))
    step()
    torch.cuda.synchronize()
    marks = _read_marks(lib)
    base = marks[0, :, 0][marks[0, :, 0] > 0].min()
    prev_end = None
    for idx in [*range(30, 36), 6 * cfg.n_layer]:
        live = marks[idx, :, 0] > 0
        if not live.any():
            continue
        r = (marks[idx][live] - base) / 1e3
        name = NAMES[idx % 6] if idx < 6 * cfg.n_layer else "head"
        line = (f"layer {idx // 6} {name}: {live.sum()} blocks, start {r[:, 0].min():.2f}-{r[:, 0].max():.2f} us, "
                f"wait done {r[:, 1].min():.2f}, end {r[:, 7].max():.2f}")
        if name != "att":
            line = _product_line(r, f"layer {idx // 6} {name}")
        if prev_end is not None:
            line += f"; from the last end {r[:, 1].min() - prev_end:.2f}"
        prev_end = r[:, 7].max()
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
