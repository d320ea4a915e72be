"""Device times of the attention blocks K5 and K9 alone, on the card.

    python3 -m metavoice_tpu_torch.tools.block_times [--trees OLD NEW] [--breakdown]

Each time is per layer, from a CUDA graph of the 24 layers' calls in turn,
at the main-path shape (D 2048, 16 heads, B 2, S 2048, random weights and
caches from seeds), at pos 0, 255, 1000 and 2047: K5 on a bf16, an int8 and
a packed cache, K9 on a bf16 cache.

* ``--trees OLD NEW``: two checkouts' roots (an older commit unpacked with
  ``git archive`` or ``git checkout-index -a --prefix=DIR/`` into a
  git-ignored directory, and this one), each timed in its own process with
  that tree's own package and kernels, in the order OLD NEW NEW OLD: one
  JSON line a run. The wrappers' signatures are the same in both.
* ``--breakdown``: each kernel of a K5 / K9 call by profiled device time
  over 3 replays of the graph (a kernel starts before the one before it
  ends, programmatic dependent launch, so the times overlap).

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

POSITIONS = (0, 255, 1000, 2047)
KV_FORMATS = ("bf16", "int8", "int8_packed")


def _setup(root: str):
    """torch, with the package of the tree at ``root`` first on sys.path."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("block_times needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch


def _cache(torch, cfg, fmt: str, gen, dev, b: int):
    """A (L, S, B, H_kv, 128) cache of ``fmt`` filled with random values (and
    scales in [0.005, 0.03))."""
    from metavoice_tpu_torch.models import transformer as tfm

    kv = tfm.KVCache.create(cfg, b, cfg.block_size, dtype=torch.bfloat16 if fmt == "bf16" else fmt, device=dev)
    if fmt == "bf16":
        for t in (kv.k, kv.v):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        return kv
    lo, hi = (-127, 128) if fmt == "int8" else (-(2**31), 2**31)
    for t in (kv.k, kv.v):
        t.copy_(torch.randint(lo, hi, t.shape, generator=gen, device=dev, dtype=t.dtype))
    for t in (kv.k_scale, kv.v_scale):
        t.copy_(0.005 + 0.025 * torch.rand(t.shape, generator=gen, device=dev))
    return kv


def _cases(torch):
    """(n_layer, [(label, fn(layer, pos))]) of K5 per cache format and K9."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config()
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    l4 = Q.quantize_params_int4_i32(params)["layers"]
    w4 = (l4["wqkv"]["pw"], l4["wqkv"]["sc"], l4["wo"]["pw"], l4["wo"]["sc"])
    l8 = Q.quantize_params_int8(params)["layers"]
    del params
    out = []
    for fmt in KV_FORMATS:
        kv = _cache(torch, cfg, fmt, gen, dev, 2)
        out.append((f"K5 {fmt}", lambda li, pos, kv=kv: A.decode_attention_block_int4(
            x, *w4, kv.k, kv.v, li, pos, cfg.n_head, k_scale=kv.k_scale, v_scale=kv.v_scale)))
    kv = _cache(torch, cfg, "bf16", gen, dev, 2)
    out.append(("K9", lambda li, pos: A.decode_attention_block_int8(
        x, l8["wqkv"]["q"][li], l8["wqkv"]["scales"][li], l8["wo"]["q"][li], l8["wo"]["scales"][li],
        kv.k, kv.v, li, pos, cfg.n_head)))
    return cfg.n_layer, out


def _graph(torch, fn, n_layer: int):
    """fn(layer) for every layer in turn, warmed eagerly on a side stream and
    captured in a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for li in range(n_layer):
            fn(li)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for li in range(n_layer):
            fn(li)
    return graph


def _layer_ms(torch, fn, n_layer: int, iters: int = 20) -> float:
    """Device ms per call of fn(layer): the graph of the n_layer calls
    replayed ``iters`` times between CUDA events, after 3 warm-up replays."""
    graph = _graph(torch, fn, n_layer)
    for _ in range(3):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / n_layer


def time_tree(root: str) -> dict:
    """K5 and K9 of the tree at ``root`` (its package and kernels), ms a layer
    from a CUDA graph."""
    torch = _setup(root)
    n_layer, cases = _cases(torch)
    return {"tree": root, **{f"{label} {pos}": _layer_ms(torch, lambda li: fn(li, pos), n_layer)
                             for label, fn in cases for pos in POSITIONS}}


def breakdown() -> dict:
    """Each kernel of a call at pos 255: mean profiled device time (us)."""
    torch = _setup(os.getcwd())
    n_layer, cases = _cases(torch)
    out = {}
    for label, fn in cases:
        graph = _graph(torch, lambda li: fn(li, 255), n_layer)
        graph.replay()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
        evs = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        per: dict = {}
        for i, (t0, t1, name) in enumerate(evs):
            kind = "attention" if "attn_row_kernel" in name else ("qkv product" if i % 3 == 0 else "o-proj")
            per.setdefault(kind, []).append(t1 - t0)
        span = (evs[-1][1] - evs[0][0]) / (3 * n_layer)
        out[label] = {**{k: sum(v) / len(v) for k, v in per.items()}, "first start to last end, a call": span,
                      "kernels a call": len(evs) / (3 * n_layer)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)  # a child of --trees
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.trees:
        old, new = args.trees
        for root in (old, new, new, old):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], capture_output=True,
                                 text=True)
            if run.returncode:
                raise SystemExit(f"timing {root} failed:\n{run.stdout}\n{run.stderr}")
            print(run.stdout.strip().splitlines()[-1], flush=True)
    if args.breakdown:
        print(json.dumps(breakdown()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
