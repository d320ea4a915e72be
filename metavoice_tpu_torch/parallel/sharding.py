"""Parameter sharding rules, Megatron-style (port of
metavoice_tpu/parallel/sharding.py).

The JAX package states its layout as ``PartitionSpec`` annotations that
GSPMD partitions by, and GSPMD inserts the reductions. Here every
reduction is explicit (``models/transformer.apply_blocks(tp=...)``), so
each rank holds ordinary tensors: its own shards of the stacked layer
weights, cut once by :func:`shard_params` for serving and training alike.
``param_specs`` is the table of the one dimension each leaf is split on
over the tensor group, or None where every rank holds the whole leaf:

  * ``wqkv`` (and ``wqkv_b``): column-parallel by head block: rank r holds
    its own heads of q, k and v, ``[q_r | k_r | v_r]`` (:func:`qkv_block`).
    JAX's GSPMD layout splits the stored columns plainly, which gives rank
    r its heads only because the JAX serving path stores them permuted
    (``tp_decode.permute_qkv_cols``); a plain split of the dense tree at tp
    2 would give rank 0 every q column and half of k;
  * ``w1`` / ``w3`` (GELU ``w_fc``, ``w_fc_b``): column-parallel, each
    rank's own FFN slice;
  * ``wo`` / ``w2`` (``w_proj``): row-parallel, the input features split,
    so each rank's product is a partial sum that the tensor group reduces;
  * everything else whole on every rank: norms, the row-parallel biases,
    and, unlike JAX (which splits them over their feature or vocab dim),
    the embeddings, the speaker projection and the LM heads: about 10 M
    parameters of the full-width first stage.

The batch splits over the data group (each rank keeps its own rows, see
``mesh.process_batch_slice``), and a KV cache (L, S, B, H, Dh) splits its
batch over the data group and its heads over the tensor group
(``tp_decode.make_tp_cache``). :func:`gather_params` is the inverse of the
cut: the dense tree rebuilt from every rank's shards, the counterpart of
reading a sharded JAX array whole.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.parallel.mesh import Mesh

# the stacked (L, ...) layer leaves split over the tensor group, by the dim each is split on
LAYER_SPLITS = {"wqkv": 2, "wqkv_b": 1, "w1": 2, "w3": 2, "w_fc": 2, "w_fc_b": 1, "wo": 1, "w2": 1, "w_proj": 1}
# the keys under which a tree holds stacked layer leaves: the whole stack, or finetuning's split of it
LAYER_KEYS = ("layers", "layers_head", "layers_tail")
_QKV = ("wqkv", "wqkv_b")


def param_specs(cfg: TransformerConfig) -> dict[str, Any]:
    """The split dim of every leaf of ``models/transformer.init_params``'s
    tree (None: replicated), in its shape: ``LAYER_SPLITS`` for the layer
    leaves ``cfg`` has. ``wqkv``'s split is by head block
    (:func:`qkv_block`), not a plain cut of its columns."""
    swiglu = cfg.nonlinearity_type == "swiglu"
    keys = ["attn_norm_w", "wqkv", "wo", "ffn_norm_w"] + (["w1", "w3", "w2"] if swiglu else ["w_fc", "w_proj"])
    if cfg.bias:
        keys += ["attn_norm_b", "ffn_norm_b", "wqkv_b", "wo_b"] + ([] if swiglu else ["w_fc_b", "w_proj_b"])
    specs: dict[str, Any] = {"wtes": [None] * len(cfg.vocab_sizes), "wpe": None,
                             "layers": {k: LAYER_SPLITS.get(k) for k in keys}, "ln_f_w": None}
    if cfg.bias:
        specs["ln_f_b"] = None
    if cfg.speaker_emb_dim:
        specs["speaker_cond"] = None
    if cfg.target_vocab_sizes is not None:
        specs["lm_heads"] = [None] * len(cfg.target_vocab_sizes)
    return specs


def split_leaves(tree: Any) -> Any:
    """True for each leaf of a param tree (the stacked tree, or
    ``training/finetune.split_trainable``'s halves) that the tensor group
    splits, False for the replicated ones."""
    if not isinstance(tree, dict):
        raise TypeError(f"a param tree is a dict, got {type(tree).__name__}")

    def flags(node, split: bool):
        if isinstance(node, dict):
            return {k: flags(v, split) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [flags(v, split) for v in node]
        return split

    return {k: ({lk: flags(lv, lk in LAYER_SPLITS) for lk, lv in v.items()} if k in LAYER_KEYS else flags(v, False))
            for k, v in tree.items()}


def _qkv_split(w: torch.Tensor, cfg: TransformerConfig):
    qd = cfg.n_head * cfg.head_dim
    kvd = cfg.n_local_heads * cfg.head_dim
    return torch.split(w, [qd, kvd, kvd], dim=-1)


def qkv_block(w: torch.Tensor, cfg: TransformerConfig, tp: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s qkv columns ``[q_r | k_r | v_r]`` (weights or bias)."""
    return torch.cat([p.chunk(tp, dim=-1)[rank] for p in _qkv_split(w, cfg)], dim=-1)


def _cut(key: str, w: torch.Tensor, cfg: TransformerConfig, tp: int, rank: int) -> torch.Tensor:
    if key in _QKV:
        return qkv_block(w, cfg, tp, rank)
    dim = LAYER_SPLITS[key]
    if w.shape[dim] % tp:
        raise ValueError(f"{key}: dim {dim} of {tuple(w.shape)} does not split into {tp} shards")
    return w.chunk(tp, dim=dim)[rank]


def shard_layers(layers: dict, cfg: TransformerConfig, tp: int, rank: int) -> dict:
    """Rank ``rank``'s dense shards of the stacked layer weights (views
    where a cut is one slice), every other layer leaf whole."""
    if tp == 1:
        return dict(layers)
    return {k: (_cut(k, w, cfg, tp, rank) if k in LAYER_SPLITS else w) for k, w in layers.items()}


def shard_params(params: Any, cfg: TransformerConfig, mesh: Mesh) -> Any:
    """This rank's dense param tree on its device: its shards of the layer
    weights (:func:`shard_layers`), every other leaf whole, each a
    contiguous copy (a step that trains the shards in place leaves the
    caller's tree as it was)."""

    def move(node):
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [move(v) for v in node]
        return node.to(mesh.device, memory_format=torch.contiguous_format, copy=True)

    out = {k: move(v) for k, v in params.items() if k != "layers"}
    out["layers"] = move(shard_layers(params["layers"], cfg, mesh.tensor_parallel, mesh.tensor_rank))
    return out


def _join(key: str, parts: list, cfg: TransformerConfig) -> torch.Tensor:
    """Every rank's shard of a layer leaf, in tensor-rank order -> the dense leaf."""
    if key in _QKV:
        tp = len(parts)
        qd, kvd = cfg.n_head * cfg.head_dim // tp, cfg.n_local_heads * cfg.head_dim // tp
        q, k, v = zip(*(torch.split(p, [qd, kvd, kvd], dim=-1) for p in parts))
        return torch.cat([*q, *k, *v], dim=-1)
    return torch.cat(parts, dim=LAYER_SPLITS[key])


def join_shards(shards: list, cfg: TransformerConfig) -> Any:
    """Every tensor rank's shard tree (the stacked tree :func:`shard_params`
    gives, or a tree of its leaves' grads), in tensor-rank order -> the
    dense tree, qkv re-interleaved from the head blocks; the replicated
    leaves are rank 0's."""
    out = dict(shards[0])
    out["layers"] = {k: (_join(k, [s["layers"][k] for s in shards], cfg) if k in LAYER_SPLITS else w)
                     for k, w in shards[0]["layers"].items()}
    return out


def gather_params(shards: Any, cfg: TransformerConfig, mesh: Mesh) -> Any:
    """Every rank of the tensor group passes its shard tree (the stacked
    tree :func:`shard_params` gives) -> the dense tree on each rank, the
    split leaves all-gathered over the group and joined, qkv re-interleaved
    from the head blocks; the replicated leaves are this rank's. A
    collective: every rank of the tensor group calls it."""
    out = dict(shards)
    if mesh.tensor_group is None:
        return out
    layers = {}
    for k, w in shards["layers"].items():
        if k not in LAYER_SPLITS:
            layers[k] = w
            continue
        w = w.detach().contiguous()
        parts = [torch.empty_like(w) for _ in range(mesh.tensor_parallel)]
        dist.all_gather(parts, w, group=mesh.tensor_group)
        layers[k] = _join(k, parts, cfg)
    out["layers"] = layers
    return out
