"""Device times of every cut of the ring of tensor-core tiles (K11's
``ops/quantized.int8_tile_plan``, K12's and K13's ``int4g_tile_plan``: rows
of a tile, splits of K) at the main shapes, on the card.

    python3 -m metavoice_tpu_torch.tools.ring_cuts [--kernels K11,K12,K13] [--fit] [--out PATH]

For each projection of a layer (qkv 2048 x 6144, wo 2048 x 2048, w1 2048 x
5632, w2 5632 x 2048; K12/K13 at groupsize 128) at M 16, 32, 64 and 256,
each kernel asked for, it times the plan's own cut and every other one (the
fewest rows that hold M, or half of them from 128 rows up; split counts
from 1 to 32 within the partials' bound), each from a CUDA graph of 8
weight sets in turn, by replacing the plan for the call. One JSON line a
shape: the plan's cut, the three fastest, and with ``--out`` every cut's
time in a JSON file. ``--fit`` fits the plan's model constants (K11's
``INT8_STEP_CYCLES`` and the rest; K12's and K13's, shared,
``INT4G_STEP_CYCLES`` and the rest) to these times by least squares on the
relative error, at CLOCK_HZ, and prints them with the cut each model picks
and its time against the fastest. Needs a CUDA card; prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = ((2048, 6144), (2048, 2048), (2048, 5632), (5632, 2048))
ROWS = (16, 32, 64, 256)
SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16, 22, 32)
CLOCK_HZ = 1.98e9  # the H100's SM clock under load: the model's cycles at this rate
# the model's constants, in _ring_cost's order, by the kernels that share them
CONSTANTS = {"K11": ("INT8_STEP_CYCLES", "INT8_STEP_ROW_CYCLES", "INT8_START_CYCLES", "INT8_MERGE_ROW_CYCLES",
                     "INT8_MERGE_SPLIT_ROW_CYCLES"),
             "K12": ("INT4G_STEP_CYCLES", "INT4G_STEP_ROW_CYCLES", "INT4G_START_CYCLES", "INT4G_MERGE_ROW_CYCLES",
                     "INT4G_MERGE_SPLIT_ROW_CYCLES")}


def _graph_ms(torch, fn, n: int) -> float:
    """Device ms per call of fn(i), i = 0..n-1 in turn, from a CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(i)
    for _ in range(3):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 20 / n


def _kernel(torch, Q, name: str):
    """(the wrapper, the plan's name in ops/quantized, plan(m, k, n), a weight
    set of (k, n) from the generator, the rows of w a K spans, steps a
    staged block) of kernel ``name``."""
    if name == "K11":
        return (Q.matmul_int8, "int8_tile_plan", Q.int8_tile_plan,
                lambda k, n, gen: Q.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") * 0.02),
                lambda k: k, 1)
    packed = name == "K13"

    def make(k, n, gen):
        q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
        return Q.pack_int4(q) if packed else q, s, z

    return (Q.matmul_int4_packed if packed else Q.matmul_int4, "int4g_tile_plan",
            lambda m, k, n: Q.int4g_tile_plan(m, k, n, packed), make, lambda k: k // 2 if packed else k,
            2 if packed else 1)


def _features(Q, c: dict, steps_a_chunk: int) -> list[float]:
    """The model's cycles of cut c as a sum over its constants: the
    coefficient of each (the cost is linear in them)."""
    unit = [tuple(float(i == j) for j in range(5)) for i in range(5)]
    return [Q._ring_cost(c["bm"], c["split_chunks"] * steps_a_chunk, c["splits"], c["m"], c["n"], u) for u in unit]


def fit(Q, lines: list[dict]) -> dict:
    """Least-squares constants of each model over every cut of its kernels'
    lines (relative error), and the cut each fitted model picks per shape:
    its time against the fastest."""
    import numpy as np

    out = {}
    for model, kernels in (("K11", ("K11",)), ("K12", ("K12", "K13"))):
        rows, want = [], []
        for line in lines:
            if line["kernel"] in kernels:
                steps = 2 if line["kernel"] == "K13" else 1
                for c in line["cuts"]:
                    f = _features(Q, c | {"m": line["m"], "n": line["n"]}, steps)
                    rows.append([v / c["ms"] for v in f])
                    want.append(CLOCK_HZ * 1e-3)  # cycles / ms, each row divided by its own time
        if not rows:
            continue
        consts, *_ = np.linalg.lstsq(np.array(rows), np.array(want), rcond=None)
        consts = [round(float(v)) for v in consts]
        names = CONSTANTS[model]
        saved = [getattr(Q, a) for a in names]
        for a, v in zip(names, consts):
            setattr(Q, a, v)
        picks = []
        try:
            for line in lines:
                if line["kernel"] in kernels:
                    _, _, plan, _, _, _ = _kernel(None, Q, line["kernel"])
                    bm, _, ns = plan(line["m"], line["k"], line["n"])
                    ms = next((c["ms"] for c in line["cuts"] if (c["bm"], c["splits"]) == (bm, ns)), None)
                    best = line["cuts"][0]["ms"]
                    picks.append({"kernel": line["kernel"], "m": line["m"], "k": line["k"], "n": line["n"], "bm": bm,
                                  "splits": ns, "ms": ms, "fastest_ms": best,
                                  "over": None if ms is None else ms / best - 1})  # None: a cut not timed
        finally:
            for a, v in zip(names, saved):
                setattr(Q, a, v)
        out[model] = {"constants": dict(zip(names, consts)), "picks": picks}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="K11,K12,K13", help="comma-separated, of K11, K12, K13")
    ap.add_argument("--fit", action="store_true", help="fit each model's constants to the times and print them")
    ap.add_argument("--out", help="write every cut's time here (JSON)")
    args = ap.parse_args()
    import torch

    from metavoice_tpu_torch.ops import quantized as Q

    if not torch.cuda.is_available():
        raise SystemExit("ring_cuts needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name in args.kernels.split(","):
        fn, plan_name, plan, make, rows_w, _ = _kernel(torch, Q, name)
        original = getattr(Q, plan_name)
        try:
            for k, n in SHAPES:
                mats = [make(k, n, gen) for _ in range(8)]
                n_chunks = -(-rows_w(k) // Q.INT4G_RING_CHUNK)
                for m in ROWS:
                    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
                    bm0 = next(b for b in Q.INT4G_RING_ROWS if b >= m)
                    cuts = []
                    for bm in (bm0, bm0 // 2) if bm0 >= 128 else (bm0,):
                        seen = set()
                        for want in SPLITS:
                            split_chunks = -(-n_chunks // want)
                            n_splits = -(-n_chunks // split_chunks)
                            if n_splits in seen or n_splits * m * n * 4 > Q.INT4G_RING_PART_BYTES:
                                continue
                            seen.add(n_splits)
                            setattr(Q, plan_name, lambda *_, cut=(bm, split_chunks, n_splits): cut)
                            ms = _graph_ms(torch, lambda i: fn(x, *mats[i]), len(mats))
                            setattr(Q, plan_name, original)
                            blocks = -(-m // bm) * -(-n // Q.INT4G_RING_BN) * n_splits
                            cuts.append({"ms": ms, "bm": bm, "splits": n_splits, "split_chunks": split_chunks,
                                         "blocks": blocks})
                    cuts.sort(key=lambda c: c["ms"])
                    chosen = plan(m, k, n)
                    mine = next((c["ms"] for c in cuts if (c["bm"], c["splits"]) == (chosen[0], chosen[2])), None)
                    line = {"kernel": name, "m": m, "k": k, "n": n,
                            "plan": {"bm": chosen[0], "splits": chosen[2], "ms": mine}, "fastest": cuts[:3]}
                    print(json.dumps(line), flush=True)
                    out.append(line | {"cuts": cuts})
                del mats
        finally:
            setattr(Q, plan_name, original)
    if args.fit:
        for model, res in fit(Q, out).items():
            print(json.dumps({"model": model, "constants": res["constants"]}), flush=True)
            for pick in res["picks"]:
                print(json.dumps(pick), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
