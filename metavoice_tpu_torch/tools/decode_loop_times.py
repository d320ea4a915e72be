"""ms a token of the first stage's decode loop on the card, route by route,
in two trees side by side: each tree's own ``models/first_stage.decode``
(its package and kernels), each tree timed in a process of its own, in the
order OLD NEW NEW OLD.

    python3 -m metavoice_tpu_torch.tools.decode_loop_times --trees OLD NEW

OLD and NEW are checkouts' roots (an older commit unpacked with ``git
archive`` into a git-ignored directory, and this one). Each route decodes
192 steps from pos 128 at full width (24L/16H/2048d), the CFG pair, on
seeded random weights and a cache of random values, with Gumbel noise
injected that never draws end-of-audio: bf16 (K1), int4 (K3), int8 (K7),
int4 on the int8 cache (K5/K6), plain int8 (K9/K10) and bf16 with 2 kv
heads (GQA, K4). Each is timed over three calls after one untimed call
(host clock around synchronized calls). One JSON line a run: each route's
ms a token, three values. Needs a CUDA card; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROUTES = ("bf16", "int4", "int8", "int4, int8 cache", "int8_plain", "gqa")
POS, STEPS, CALLS = 128, 192, 3


def _route_ms(torch, route: str) -> list[float]:
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config(**({"n_local_heads": 2} if route == "gqa" else {}))
    gen = torch.Generator(device=dev).manual_seed(24)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    quantize = {"int4": Q.quantize_params_int4_i32, "int4, int8 cache": Q.quantize_params_int4_i32,
                "int8": Q.quantize_params_int8_i32, "int8_plain": Q.quantize_params_int8}.get(route)
    if quantize is not None:
        params = quantize(params)
    int8_cache = route == "int4, int8 cache"
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype="int8" if int8_cache else torch.bfloat16, device=dev)
    for t in (kv.k, kv.v):
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev) if int8_cache
                else torch.randn(t.shape, generator=gen, device=dev))
    for t in (kv.k_scale, kv.v_scale) if int8_cache else ():
        t.copy_(0.005 + 0.025 * torch.rand(t.shape, generator=gen, device=dev))
    e = torch.empty((STEPS, 1, cfg.vocab_sizes[0]), device=dev).exponential_(generator=gen)
    noise = -torch.log(e.clamp_min(1e-30))
    noise[..., T.END_OF_AUDIO_TOKEN] = -1e4
    cur = torch.randint(0, T.END_OF_AUDIO_TOKEN, (1,), generator=gen, device=dev)
    spk = torch.randn((1, cfg.speaker_emb_dim), generator=gen, device=dev)
    ms = []
    for i in range(CALLS + 1):
        stats: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs.decode(params, cfg, cur, POS, kv, spk, STEPS, noise=noise, stats=stats)
        torch.cuda.synchronize()
        if i:
            ms.append(1e3 * (time.perf_counter() - t0) / stats["decode_steps"])
    return ms


def time_tree(root: str) -> dict:
    """Each route's ms a token in the tree at ``root``."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_loop_times needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": root}
    for route in ROUTES:
        out[route] = _route_ms(torch, route)
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"), required=True)
    ap.add_argument("--one", metavar="ROOT", help=argparse.SUPPRESS)  # a child of --trees
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_tree(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    old, new = args.trees
    for root in (old, new, new, old):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--trees", old, new, "--one", root],
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"timing {root} failed:\n{run.stdout}\n{run.stderr}")
        print(run.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
