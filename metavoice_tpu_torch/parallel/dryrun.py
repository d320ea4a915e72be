"""One sharded finetune step on N ranks: the port's counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m metavoice_tpu_torch.parallel.dryrun N [--devices D ...] [--backend gloo]

spawns N ranks (``mesh.spawn``), tensor parallel 2 when N is even (else 1),
the rest data parallel. Each rank takes JAX's tiny first stage (2 layers, 4
heads, dim 64, block 64, vocab 96) from one seed, keeps its shards
(``sharding.shard_params``) and runs one ``training/finetune.make_train_step``
over the grid: ``FinetuneConfig()`` with the last-block mask, f32 compute,
a global batch of ``max(2 * data, 2)`` rows of 16 tokens, each data rank
taking its rows. With a tensor group it then runs one ``tp_forward`` decode
step at position 0 on its serving shards (``prepare_tp_params``) and a
heads-split cache. It prints JAX's line, with the full-scale (24L/16H/2048d)
training state a rank from ``aot.abstract_train_state`` (on the meta
device) where JAX AOT-compiles the full-scale steps.

Devices: one card a rank by default (raises when there are too few);
``--devices cpu`` runs every rank on the CPU, ``--devices cuda:0`` every
rank on the first card (with ``--backend gloo``: NCCL holds one rank a
card), or give one device a rank. The decode step's cache is int8: the
tiny model's head_dim of 16 is not one the decode-attention kernels take
(64 or 128), and a T = 1 step on the int8 cache runs the plain dequantizing
path on every device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.parallel import aot
from metavoice_tpu_torch.parallel import mesh as pmesh
from metavoice_tpu_torch.parallel import sharding as psh
from metavoice_tpu_torch.parallel import tp_decode as tpd
from metavoice_tpu_torch.training import finetune as ft

TINY = dict(n_layer=2, n_head=4, dim=64, block_size=64, vocab_sizes=(96,))  # JAX's dryrun_multichip config
TOKENS = 16  # a batch row's tokens


def tiny_params() -> tuple:
    """(cfg, the dense f32 tree on the CPU) of the dryrun's model, from seed 0."""
    cfg = first_stage_config(**TINY)
    return cfg, tfm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(0), dtype=torch.float32)


def tiny_batch(rows: int, seed: int = 0) -> dict:
    """A global batch of ``rows`` x TOKENS tokens and speaker embeddings (numpy)."""
    rng = np.random.default_rng(seed)
    vocab = TINY["vocab_sizes"][0]
    return {"x": rng.integers(0, vocab, (rows, TOKENS)), "y": rng.integers(0, vocab, (rows, TOKENS)),
            "spk_emb": rng.normal(size=(rows, 256)).astype(np.float32)}


def dryrun_rank(rank: int, tensor_parallel: int, devices: list) -> dict:
    """One rank of the dryrun (``mesh.spawn``'s ``fn``; ``devices`` one a
    rank) -> {"mesh": (data, tensor), "loss", "grad_norm", "logits": this
    rank's rows of the decode step's first-head logits, None at tp 1}."""
    mesh = pmesh.make_mesh(tensor_parallel, device=devices[rank])
    cfg, params = tiny_params()
    ftc = ft.FinetuneConfig()
    state, opt = ft.init_train_state(psh.shard_params(params, cfg, mesh), ftc)
    mask = ft.trainable_mask(state.params, cfg, ftc.last_n_blocks_to_finetune)
    step = ft.make_train_step(cfg, ftc, opt, grad_mask=mask, compute_dtype=torch.float32, mesh=mesh)
    rows = max(2 * mesh.data_parallel, 2)
    state, metrics = step(state, tiny_batch(rows))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"non-finite loss in the sharded train step: {loss}")
    logits = None
    if tensor_parallel > 1:
        rng = np.random.default_rng(1)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, 1)))
        spk = torch.from_numpy(rng.normal(size=(rows, cfg.speaker_emb_dim)).astype(np.float32))
        lo, hi = mesh.batch_rows(rows)
        kv = tpd.make_tp_cache(cfg, mesh, rows, dtype="int8")
        out, _ = tpd.tp_forward(tpd.prepare_tp_params(params, cfg, mesh), cfg, mesh, tok[lo:hi].to(mesh.device),
                                spk[lo:hi].to(mesh.device), None, kv, 0, compute_dtype=torch.float32)
        logits = out[0].float().cpu().numpy()
        if not np.isfinite(logits).all():
            raise FloatingPointError("non-finite logits in the TP decode step")
    return {"mesh": (mesh.data_parallel, mesh.tensor_parallel), "loss": loss,
            "grad_norm": float(metrics["grad_norm"]), "logits": logits}


def dryrun(n: int, devices: list | None = None, backend: str | None = None) -> list[dict]:
    """Spawn the ``n`` ranks (``mesh.spawn``'s ``devices`` and ``backend``),
    print the result line -> each rank's :func:`dryrun_rank` result."""
    tp = 2 if n % 2 == 0 else 1
    if devices is not None and len(devices) == 1:
        devices = devices * n
    if devices is None and torch.cuda.is_available():  # spawn's default, which the ranks are told
        devices = [f"cuda:{r}" for r in range(n)]
    ranks = pmesh.spawn(dryrun_rank, n, args=(tp, devices), backend=backend, devices=devices)
    dp = n // tp
    state = aot.abstract_train_state(tp=tp)[0]["bytes"]
    print(f"dryrun_multichip OK: mesh=(data={dp}, tensor={tp}), loss={ranks[0]['loss']:.4f}, full-scale "
          f"24L/2048d train state a rank {sum(state.values()) / 1e9:.2f} GB (params and AdamW moments, meta "
          f"device), TP decode step " + ("OK" if ranks[0]["logits"] is not None else "skipped (tp=1)"))
    return ranks


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=8, help="ranks (default 8, as JAX's dryrun)")
    ap.add_argument("--devices", nargs="+", help="one device a rank, or one for every rank (default one card a rank)")
    ap.add_argument("--backend", help="the process group's backend (default NCCL on cards, gloo on the CPU)")
    args = ap.parse_args(argv)
    dryrun(args.n, args.devices, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
