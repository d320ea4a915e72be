"""Device times of the per-layer decode kernels alone, on the card: the
attention blocks K5 and K9 and the FFNs K6 and K10; and of the prefill
matmuls K2 and K8, the groupwise matmuls K12 and K13 and the plain-int8
matmul K11.

    python3 -m metavoice_tpu_torch.tools.block_times [--trees OLD NEW] [--breakdown] [--bits OLD NEW [--changed K11]]

Each time is per layer, from a CUDA graph of the 24 layers' calls in turn,
at the main-path shape (D 2048, 16 heads, B 2, S 2048, FFN 5632 (K6's
packed to 6144), random weights and caches from seeds): K5 on a bf16, an
int8 and a packed cache and K9 on a bf16 cache at pos 0, 255, 1000 and
2047; K6 and K10. K2 and K8 (``matmul_int4_i32``, ``matmul_int8_i32``):
one layer's five projections (qkv, wo, w1, w3, w2 at D 2048, FFN 6144),
each on 8 weight sets in turn from a CUDA graph, at M 256 (the prefill),
16 and 32 (the unfused int4 route, the int8 per-layer route). K12 and K13
(``matmul_int4``, ``matmul_int4_packed``, groupsize 128): the same at FFN
5632, and single projections at the other row counts and groupsizes of
their card tests that take the ring of tiles (M 9, 64, 65, 200; groupsizes
8 and 24 at M 2 and 8). K11 (``matmul_int8``): the five projections at FFN
5632 at M 2 (a decode step of the CFG pair), 16, 32 and 256, and single
projections at the other row counts and widths of its card tests (M 1, 8,
9, 64, 65, 200, 600; N 2064).

* ``--trees OLD NEW``: two checkouts' roots (an older commit unpacked with
  ``git archive`` or ``git checkout-index -a --prefix=DIR/`` into a
  git-ignored directory, and this one), each timed in its own process with
  that tree's own package and kernels, in the order OLD NEW NEW OLD: one
  JSON line a run. The wrappers' signatures are the same in both.
* ``--breakdown``: each kernel of a call (K5 / K9 at pos 255) by profiled
  device time over 3 replays of the graph (a kernel starts before the one
  before it ends, programmatic dependent launch, so the times overlap).
* ``--bits OLD NEW``: the outputs of the kernels that share the tensor-core
  GEMV header (a K3 and a K7 step with the new rows they write, K5 on each
  cache format with its cache row and scales, K9 with its cache row; pos
  255 and 1000), of those that share the prefill ring's primitives (K2 and
  K8 at M 256, 16 and 32 on the qkv and w2 shapes), and of those on the
  ring of tensor-core tiles or K12/K13's GEMV (K12, K13 and K11 at M 2, 16,
  32 and 256 on the qkv and w2 shapes; K11's M 2 on the decode GEMV) on the
  same seeded inputs, each tree in its own process, compared bit for bit:
  one line a case, exit 1 on any difference but in the cases named by
  ``--changed`` (prefixes, e.g. ``K11``: a kernel the NEW tree redesigns).

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

POSITIONS = (0, 255, 1000, 2047)
KV_FORMATS = ("bf16", "int8", "int8_packed")
PREFILL_M = (256, 16, 32)
PREFILL_SHAPES = ((2048, 6144), (2048, 2048), (2048, 6144), (2048, 6144), (6144, 2048))  # qkv, wo, w1, w3, w2
GROUPED_SHAPES = ((2048, 6144), (2048, 2048), (2048, 5632), (2048, 5632), (5632, 2048))  # K12/K13: FFN 5632
# K12/K13 single projections (M, K, N, groupsize): the ring's other row counts and groupsizes of the card tests
GROUPED_CASES = ((9, 2048, 6144, 128), (64, 2048, 6144, 128), (65, 2048, 2048, 128), (200, 2048, 6144, 128),
                 (2, 2048, 2048, 8), (2, 1152, 2048, 24), (8, 1152, 2048, 24))
PLAIN8_M = (2, 16, 32, 256)  # K11: a decode step of the CFG pair, the spec verify and batched CFG rows, prefill
# K11 single projections (M, K, N): its card tests' other row counts and an N off the GEMV's 64-column grid
PLAIN8_CASES = ((1, 2048, 6144), (8, 5632, 2048), (9, 2048, 6144), (64, 2048, 6144), (65, 2048, 2048),
                (200, 2048, 6144), (600, 2048, 2048), (2, 2048, 2064), (32, 2048, 2064))


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


BLOCK_KERNELS = ("qkv product", "attention", "o-proj")  # a K5 / K9 call's launches, in order
FFN_KERNELS = ("w1/w3 product", "w2 product")  # a K6 / K10 call's


def _cases(torch):
    """(n_layer, [(label, fn(layer, pos), positions, its launches' names)]) of
    K5 per cache format, K9, K6 and K10 (the FFNs at one position, None)."""
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
    f4 = [t for k in ("w1", "w3", "w2") for t in (l4[k]["pw"], l4[k]["sc"])]
    l8 = Q.quantize_params_int8(params)["layers"]
    del params
    out = []
    for fmt in KV_FORMATS:
        kv = _cache(torch, cfg, fmt, gen, dev, 2)
        out.append((f"K5 {fmt}", lambda li, pos, kv=kv: A.decode_attention_block_int4(
            x, *w4, kv.k, kv.v, li, pos, cfg.n_head, k_scale=kv.k_scale, v_scale=kv.v_scale),
            POSITIONS, BLOCK_KERNELS))
    kv = _cache(torch, cfg, "bf16", gen, dev, 2)
    out.append(("K9", lambda li, pos: A.decode_attention_block_int8(
        x, l8["wqkv"]["q"][li], l8["wqkv"]["scales"][li], l8["wo"]["q"][li], l8["wo"]["scales"][li],
        kv.k, kv.v, li, pos, cfg.n_head), POSITIONS, BLOCK_KERNELS))
    out.append(("K6", lambda li, pos: Q.decode_ffn_int4(x, *f4, li), (None,), FFN_KERNELS))
    out.append(("K10", lambda li, pos: Q.ffn_int8(x, *[l8[k][f][li] for k in ("w1", "w3", "w2")
                                                      for f in ("q", "scales")]), (None,), FFN_KERNELS))
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


def _prefill_ms(torch) -> dict:
    """K2, K8, K12 and K13: ms of one layer's five projections at each M of
    PREFILL_M, K11 at each of PLAIN8_M, each projection's time a call from a
    CUDA graph of its 8 weight sets in turn (50 MB and more a shape, so the
    weights come from HBM); and the single projections of GROUPED_CASES and
    PLAIN8_CASES."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for m in PREFILL_M for k in (2048, 6144)}
    out = {}
    for label, quantize, call in (("K2", Q.quantize_int4_i32, Q.matmul_int4_i32),
                                  ("K8", Q.quantize_int8_i32, Q.matmul_int8_i32)):
        total = dict.fromkeys(PREFILL_M, 0.0)
        for k, n in PREFILL_SHAPES:
            packed = [quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02) for _ in range(8)]
            for m in PREFILL_M:
                x = xs[(m, k)]
                total[m] += _layer_ms(torch, lambda i: call(x, *packed[i]), len(packed))
            del packed
        out.update({f"{label} M{m}": ms for m, ms in total.items()})
    for label, packed in (("K12", False), ("K13", True)):
        call = Q.matmul_int4_packed if packed else Q.matmul_int4
        total = dict.fromkeys(PREFILL_M, 0.0)
        xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
              for m in PREFILL_M for k in (2048, 5632)}
        for k, n in GROUPED_SHAPES:
            mats = [_grouped(torch, Q, k, n, 128, packed, gen, dev) for _ in range(8)]
            for m in PREFILL_M:
                x = xs[(m, k)]
                total[m] += _layer_ms(torch, lambda i: call(x, *mats[i]), len(mats))
            del mats
        out.update({f"{label} M{m}": ms for m, ms in total.items()})
        for m, k, n, gs in GROUPED_CASES:
            mats = [_grouped(torch, Q, k, n, gs, packed, gen, dev) for _ in range(8)]
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            out[f"{label} M{m} {k}x{n} g{gs}"] = _layer_ms(torch, lambda i: call(x, *mats[i], gs), len(mats))
            del mats
    total = dict.fromkeys(PLAIN8_M, 0.0)
    xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for m in PLAIN8_M for k in (2048, 5632)}
    for k, n in GROUPED_SHAPES:
        mats = [Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02) for _ in range(8)]
        for m in PLAIN8_M:
            x = xs[(m, k)]
            total[m] += _layer_ms(torch, lambda i: Q.matmul_int8(x, *mats[i]), len(mats))
        del mats
    out.update({f"K11 M{m}": ms for m, ms in total.items()})
    for m, k, n in PLAIN8_CASES:
        mats = [Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02) for _ in range(8)]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        out[f"K11 M{m} {k}x{n}"] = _layer_ms(torch, lambda i: Q.matmul_int8(x, *mats[i]), len(mats))
        del mats
    return out


def _grouped(torch, Q, k: int, n: int, gs: int, packed: bool, gen, dev):
    """One groupwise int4 weight set from the generator: (q or p, scales, zeros)."""
    q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device=dev) * 0.02, gs)
    return (Q.pack_int4(q) if packed else q), s, z


def time_tree(root: str) -> dict:
    """K2, K8, K11, K12 and K13 (ms of a layer's five projections; K11, K12
    and K13 also single projections), K5, K9, K6 and K10 (ms a layer) of the tree at
    ``root`` (its package and kernels), from CUDA graphs."""
    torch = _setup(root)
    prefill = _prefill_ms(torch)
    n_layer, cases = _cases(torch)
    return {"tree": root, **prefill,
            **{label if pos is None else f"{label} {pos}": _layer_ms(torch, lambda li: fn(li, pos), n_layer)
               for label, fn, positions, _ in cases for pos in positions}}


def breakdown() -> dict:
    """Each kernel of a call (the attention blocks at pos 255): mean
    profiled device time (us)."""
    torch = _setup(os.getcwd())
    n_layer, cases = _cases(torch)
    out = {}
    for label, fn, _, kinds in cases:
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
        for i, (t0, t1, _) in enumerate(evs):  # the calls' launches in order
            per.setdefault(kinds[i % len(kinds)], []).append(t1 - t0)
        span = (evs[-1][1] - evs[0][0]) / (3 * n_layer)
        out[label] = {**{k: sum(v) / len(v) for k, v in per.items()}, "first start to last end, a call": span,
                      "kernels a call": len(evs) / (3 * n_layer)}
    return out


def save_outputs(root: str, path: str):
    """The --bits cases of the tree at ``root`` -> ``path`` (torch.save of
    name -> CPU tensors): the inputs themselves, then each call's outputs."""
    torch = _setup(root)
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import decode_stack as DS
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config()
    gen = torch.Generator(device=dev).manual_seed(3)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    lay = params["layers"]
    for key in ("attn_norm_w", "ffn_norm_w"):
        lay[key] = (1 + 0.1 * torch.randn(lay[key].shape, generator=gen, device=dev)).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    out = {"inputs": [x, lay["wqkv"][3]]}

    def cache(fmt, seed):
        return _cache(torch, cfg, fmt, torch.Generator(device=dev).manual_seed(seed), dev, 2)

    for wfmt, quantize, fields in (("i4", Q.quantize_params_int4_i32, ("pw", "sc")),
                                   ("i8", Q.quantize_params_int8_i32, ("p8", "sc8"))):
        qp = quantize(params)
        ql = qp["layers"]
        weights = [ql[k][f] for k in ("wqkv", "wo", "w1", "w3", "w2") for f in fields]
        kw = dict(norm_eps=cfg.norm_eps, wfmt=wfmt)
        if wfmt == "i4":
            kw.update(ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])
        for pos in (255, 1000):
            kv = cache("bf16", pos)
            step = DS.decode_stack_int4(x, ql["attn_norm_w"], ql["ffn_norm_w"], *weights, kv.k, kv.v,
                                        torch.tensor(pos, dtype=torch.int32, device=dev), cfg.n_head, **kw)
            out[f"{'K3' if wfmt == 'i4' else 'K7'} pos {pos}"] = [step[0], *step[3:], kv.k[:, pos], kv.v[:, pos]]
            if wfmt == "i4":
                for fmt in KV_FORMATS:
                    kv = cache(fmt, pos + 7)
                    y = A.decode_attention_block_int4(x, *weights[:4], kv.k, kv.v, 5, pos, cfg.n_head,
                                                      k_scale=kv.k_scale, v_scale=kv.v_scale)[0]
                    layer5 = [t[5] for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]
                    out[f"K5 {fmt} pos {pos}"] = [y, *layer5]
    for label, quantize, call in (("K2", Q.quantize_int4_i32, Q.matmul_int4_i32),
                                  ("K8", Q.quantize_int8_i32, Q.matmul_int8_i32)):
        for k, n in ((2048, 6144), (6144, 2048)):
            packed = quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02)
            for m in PREFILL_M:
                xm = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                out[f"{label} M{m} {k}x{n}"] = [xm, call(xm, *packed)]
    for label in ("K11", "K12", "K13"):
        for k, n in ((2048, 6144), (5632, 2048)):
            w = torch.randn((k, n), generator=gen, device=dev) * 0.02
            if label == "K11":
                mats = Q.quantize_int8(w)
                call = Q.matmul_int8
            else:
                q, sc, z = Q.quantize_int4_grouped(w)
                mats = (Q.pack_int4(q) if label == "K13" else q, sc, z)
                call = Q.matmul_int4_packed if label == "K13" else Q.matmul_int4
            for m in (2, *PREFILL_M):
                xm = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                out[f"{label} M{m} {k}x{n}"] = [xm, call(xm, *mats)]
    l8 = Q.quantize_params_int8(params)["layers"]
    for pos in (255, 1000):
        kv = cache("bf16", pos + 9)
        y, _, _ = A.decode_attention_block_int8(x, *[l8[k][f][5] for k in ("wqkv", "wo") for f in ("q", "scales")],
                                                kv.k, kv.v, 5, pos, cfg.n_head)
        out[f"K9 pos {pos}"] = [y, kv.k[5], kv.v[5]]
    torch.save({k: [t.cpu() for t in v] for k, v in out.items()}, path)


def compare_bits(old: str, new: str, tmp: str, changed: tuple = ()) -> bool:
    """--bits: each tree's outputs saved by its own process, then compared;
    whether every case but those named by a prefix in ``changed`` agrees."""
    paths = []
    for i, root in enumerate((old, new)):
        paths.append(os.path.join(tmp, f"bits_{i}.pt"))
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--save", root, paths[-1]],
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"running {root} failed:\n{run.stdout}\n{run.stderr}")
    import torch

    a, b = (torch.load(p) for p in paths)
    same_all = a.keys() == b.keys()
    for name in a:
        same = len(a[name]) == len(b.get(name, ())) and all(
            torch.equal(s.reshape(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8))
            for s, t in zip(a[name], b[name]))
        expected = name.startswith(changed)
        same_all &= same or expected
        print(f"{name}: {'bit for bit' if same else 'DIFFERS'} ({len(a[name])} tensors)"
              + (" (a redesigned kernel: not counted)" if expected and not same else ""), flush=True)
    return same_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--breakdown", action="store_true")
    ap.add_argument("--bits", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--changed", default="", help="--bits: comma-separated case prefixes NEW is meant to change")
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)  # a child of --trees
    ap.add_argument("--save", nargs=2, metavar=("ROOT", "PATH"), help=argparse.SUPPRESS)  # a child of --bits
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one)), flush=True)
        return 0
    if args.save:
        save_outputs(*args.save)
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
    if args.bits:
        with tempfile.TemporaryDirectory() as tmp:
            if not compare_bits(*args.bits, tmp, tuple(c for c in args.changed.split(",") if c)):
                return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
