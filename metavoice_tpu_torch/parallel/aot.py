"""Full-scale sharded layouts without weights (port of
metavoice_tpu/parallel/aot.py).

The JAX package builds the real metavoice-1B first stage (24L/16H/2048d)
as abstract arrays carrying shardings and compiles its sharded decode and
train steps ahead of time, so a virtual CPU mesh can show the full-scale
programs build. Eager PyTorch has no ahead-of-time compile. What stays is
each rank's state at full scale on the ``meta`` device (shapes and dtypes,
no memory), through the same cut as the running code: :func:`abstract_params`
(the serving shards, ``tp_decode.prepare_tp_params``) and
:func:`abstract_train_state` (the training shards, ``sharding.shard_params``,
with AdamW's moments). The evidence that the full-scale sharded programs
build and run, the role of ``compile_sharded_decode_step`` and
``compile_sharded_train_step``, is ``chip_smoke.py``, which runs them:
phase 57 the decode step (``TTS(tensor_parallel=2)`` at full width on two
ranks), phase 59 the train step (``training/finetune.make_train_step`` on
the whole tree at full width, DP 2 x TP 2 on four ranks).
"""

from __future__ import annotations

import torch

from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.parallel import sharding as psh
from metavoice_tpu_torch.parallel import tp_decode as tpd
from metavoice_tpu_torch.parallel.mesh import Mesh
from metavoice_tpu_torch.training import finetune as ft


def _meta_mesh(tp: int, rank: int) -> Mesh:
    return Mesh(tp, 1, rank, 0, tuple(range(tp)), None, None, torch.device("meta"))


def _meta_params(cfg: TransformerConfig | None, dtype) -> tuple[TransformerConfig, dict]:
    cfg = cfg or first_stage_config()
    return cfg, tfm.init_params(cfg, device="meta", dtype=dtype)


def abstract_params(cfg: TransformerConfig | None = None, tp: int = 1, quantisation_mode: str | None = None,
                    dtype=torch.bfloat16) -> list[dict]:
    """Every tensor rank's serving param tree of ``cfg`` (default the
    full-scale first stage) split ``tp`` ways, on the ``meta`` device ->
    one tree a rank, in rank order."""
    cfg, params = _meta_params(cfg, dtype)
    return [tpd.prepare_tp_params(params, cfg, _meta_mesh(tp, r), quantisation_mode) for r in range(tp)]


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in ft.tree_leaves(tree))


def abstract_train_state(cfg: TransformerConfig | None = None, tp: int = 1, dtype=torch.bfloat16) -> list[dict]:
    """Every tensor rank's training state of ``cfg`` (default the
    full-scale first stage) split ``tp`` ways, on the ``meta`` device, in
    ``dtype`` (bf16 by default, as JAX's ``abstract_params``) -> one dict a
    rank, in rank order: ``params`` (the rank's shards, what
    ``sharding.shard_params`` gives it), ``mu`` and ``nu`` (AdamW's
    moments, in the params' dtype), and ``bytes``, each of their sizes. A
    step also holds grads of the params' size, and the activations."""
    cfg, params = _meta_params(cfg, dtype)
    out = []
    for r in range(tp):
        shards = psh.shard_params(params, cfg, _meta_mesh(tp, r))
        opt = ft.AdamW(learning_rate=0.0).init(shards)
        trees = {"params": shards, "mu": opt["mu"], "nu": opt["nu"]}
        out.append({**trees, "bytes": {k: _bytes(v) for k, v in trees.items()}})
    return out
