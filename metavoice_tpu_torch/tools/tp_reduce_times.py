"""How long one gloo ``all_reduce`` of a tensor-parallel step's partial sums
takes between two ranks sharing one card: the CUDA tensor handed to gloo
(what ``models/transformer.apply_blocks(tp=...)`` does), the same tensor
staged through the host by the caller, and a host tensor alone.

Each rank reduces a (2, T, 2048) bf16 tensor (the CFG pair's rows of a
full-width decode step at T 1, a 128-token prefill at T 128) 200 times
after 10 untimed ones, with the torch thread pool at its default size and
at one thread. Run on a machine with a card:

    python3 -m metavoice_tpu_torch.tools.tp_reduce_times
"""

from __future__ import annotations

import subprocess
import time

SHAPES = ((2, 1, 2048), (2, 128, 2048))
ROUTES = ("cuda", "staged", "host")
REPS = 200


def _rank(rank: int, threads: int | None) -> dict:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    out = {}
    for shape in SHAPES:
        y = torch.randn(shape, device="cuda").to(torch.bfloat16)
        h = y.cpu()
        for route in ROUTES:
            def once():
                if route == "cuda":
                    dist.all_reduce(y)
                elif route == "staged":
                    s = y.cpu()
                    dist.all_reduce(s)
                    y.copy_(s)
                else:
                    dist.all_reduce(h)

            for _ in range(10):
                once()
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(REPS):
                once()
            torch.cuda.synchronize()
            out[(shape, route)] = (time.perf_counter() - t0) / REPS * 1e3
    return out


def main() -> int:
    import torch

    from metavoice_tpu_torch.parallel import mesh

    if not torch.cuda.is_available():
        raise SystemExit("tp_reduce_times needs a card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{card}; torch {torch.__version__}; two gloo ranks on cuda:0")
    for threads in (None, 1):
        res = mesh.spawn(_rank, 2, args=(threads,), backend="gloo", devices=["cuda:0", "cuda:0"], deadline=300)
        for key, ms in res[0].items():
            print(f"threads {threads or 'default'}: {key[0]} {key[1]}: {ms:.4f} ms an all_reduce on rank 0, "
                  f"{res[1][key]:.4f} on rank 1")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
