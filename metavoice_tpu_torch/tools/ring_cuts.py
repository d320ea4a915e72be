"""Device times of every cut of K12's and K13's ring of tensor-core tiles
(``ops/quantized.int4g_tile_plan``: rows of a tile, splits of K) at the main
shapes, on the card.

    python3 -m metavoice_tpu_torch.tools.ring_cuts [--out PATH]

For each projection of a layer (qkv 2048 x 6144, wo 2048 x 2048, w1 2048 x
5632, w2 5632 x 2048; groupsize 128) at M 16, 32, 64 and 256, both formats,
it times the plan's own cut and every other one (the fewest rows that hold
M, or half of them from 128 rows up; split counts from 1 to 32 within the
partials' bound), each from a CUDA graph of 8 weight sets in turn, by
replacing the plan for the call. One JSON line a shape: the plan's cut,
the three fastest, and with ``--out`` every cut's time in a JSON file. The
plan's model constants (``INT4G_STEP_CYCLES`` and the rest) were fitted to
such a run. Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SHAPES = ((2048, 6144), (2048, 2048), (2048, 5632), (5632, 2048))
ROWS = (16, 32, 64, 256)
SPLITS = (1, 2, 3, 4, 5, 6, 8, 11, 16, 22, 32)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    plan = Q.int4g_tile_plan
    out = []
    try:
        for packed in (False, True):
            fn = Q.matmul_int4_packed if packed else Q.matmul_int4
            for k, n in SHAPES:
                mats = []
                for _ in range(8):
                    q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device=dev) * 0.02)
                    mats.append((Q.pack_int4(q) if packed else q, s, z))
                n_chunks = -(-(k // 2 if packed else k) // Q.INT4G_RING_CHUNK)
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
                            Q.int4g_tile_plan = lambda *_, cut=(bm, split_chunks, n_splits): cut
                            ms = _graph_ms(torch, lambda i: fn(x, *mats[i]), len(mats))
                            Q.int4g_tile_plan = plan
                            blocks = -(-m // bm) * -(-n // Q.INT4G_RING_BN) * n_splits
                            cuts.append({"ms": ms, "bm": bm, "splits": n_splits, "split_chunks": split_chunks,
                                         "blocks": blocks})
                    cuts.sort(key=lambda c: c["ms"])
                    chosen = plan(m, k, n, packed)
                    mine = next(c["ms"] for c in cuts if (c["bm"], c["splits"]) == (chosen[0], chosen[2]))
                    line = {"kernel": "K13" if packed else "K12", "m": m, "k": k, "n": n,
                            "plan": {"bm": chosen[0], "splits": chosen[2], "ms": mine}, "fastest": cuts[:3]}
                    print(json.dumps(line), flush=True)
                    out.append(line | {"cuts": cuts})
                del mats
    finally:
        Q.int4g_tile_plan = plan
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
