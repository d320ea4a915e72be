"""Parameter sharding rules, Megatron-style (port of the serving half of
metavoice_tpu/parallel/sharding.py).

The JAX package states its layout as ``PartitionSpec`` annotations that
GSPMD partitions by; here it is a table of the one dimension each stacked
leaf is split on over the tensor group, or None where every rank holds the
whole leaf:

  * ``wqkv`` / ``w1`` / ``w3`` (and GELU ``w_fc``): column-parallel, the
    output features split, so each rank computes its own heads / FFN slice;
  * ``wo`` / ``w2`` (``w_proj``): row-parallel, the input features split,
    so each rank's product is a partial sum that the tensor group reduces;
  * embeddings and LM heads split the feature / vocab dim; norms replicate.

The batch splits over the data group (each rank keeps its own rows, see
``mesh.process_batch_slice``), and a KV cache (L, S, B, H, Dh) splits its
batch over the data group and its heads over the tensor group
(``tp_decode.make_tp_cache``). This is the plain split of the JAX
package's ``param_specs``; the serving path's layout, with its permuted
qkv columns and per-shard quantization, is ``tp_decode.prepare_tp_params``.
"""

from __future__ import annotations

from typing import Any

from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.parallel.mesh import Mesh


def param_specs(cfg: TransformerConfig) -> dict[str, Any]:
    """The split dim of every leaf of ``models/transformer.init_params``'s
    tree (None: replicated), in its shape."""
    layers: dict[str, int | None] = {"attn_norm_w": None, "wqkv": 2, "wo": 1, "ffn_norm_w": None}
    if cfg.nonlinearity_type == "swiglu":
        layers.update(w1=2, w3=2, w2=1)
    else:
        layers.update(w_fc=2, w_proj=1)
        if cfg.bias:
            layers.update(w_fc_b=1, w_proj_b=None)
    if cfg.bias:
        layers.update(attn_norm_b=None, ffn_norm_b=None, wqkv_b=1, wo_b=None)
    specs: dict[str, Any] = {"wtes": [1] * len(cfg.vocab_sizes), "wpe": 1, "layers": layers, "ln_f_w": None}
    if cfg.bias:
        specs["ln_f_b"] = None
    if cfg.speaker_emb_dim:
        specs["speaker_cond"] = 1
    if cfg.target_vocab_sizes is not None:
        specs["lm_heads"] = [1] * len(cfg.target_vocab_sizes)
    return specs


def shard_params(params: Any, cfg: TransformerConfig, mesh: Mesh) -> Any:
    """This rank's slice of a dense param tree on its device: each split
    leaf cut in ``mesh.tensor_parallel`` equal parts along its dim, part
    ``mesh.tensor_rank`` kept; replicated leaves whole."""

    def cut(x, dim):
        if dim is not None:
            x = x.chunk(mesh.tensor_parallel, dim=dim)[mesh.tensor_rank]
        return x.contiguous().to(mesh.device)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        return cut(node, spec)

    return walk(params, param_specs(cfg))
