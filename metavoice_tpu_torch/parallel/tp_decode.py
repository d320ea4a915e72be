"""Tensor-parallel decode: Megatron TP over ``torch.distributed`` (port of
metavoice_tpu/parallel/tp_decode.py).

Each rank of a tensor group holds its own shards with ordinary tensor
shapes (:func:`prepare_tp_params`) and runs the ordinary block stack on
them (``models/transformer.apply_blocks`` with ``tp=`` the tensor group):
the hand-written kernels run unmodified at the local shapes, and the two
reductions of a layer, after the attention output projection and after the
FFN down projection, are ``all_reduce`` sums over the group, the row-
parallel biases added after them. The routes that fuse across those points
(the int4 and int8 decode stacks, the int4 and plain-int8 attention-block
and FFN kernels) stay off under TP, so a T = 1 step runs each layer's
projections through ``_linear`` and its attention through the decode-
attention kernel on the rank's own heads. The embedding, the LM head and
the sampling are replicated: after each reduction every rank holds the same
hidden state, so with the same seeded generator every rank draws the same
tokens.

Layout (what :func:`prepare_tp_params` gives rank r of tp): the cut of
``sharding.shard_params``, which training takes too, and the JAX
package's serving layout cut to one rank, then quantized per shard:

* ``wqkv`` (and ``wqkv_b``): rank r's columns ``[q_r | k_r | v_r]``, its
  own heads for all three projections (the JAX package stores the columns
  permuted so that a natural split gives each device this block,
  :func:`permute_qkv_cols`);
* ``w1`` / ``w3`` (GELU ``w_fc``, ``w_fc_b``): column-parallel, rank r's
  r-th column slice. Quantized, the slice is quantized alone; in int4 its
  hidden width is padded to ``8 * I32_GROUPSIZE`` with the pad columns'
  ``sc`` (and bias) zero, so it meets w2's per-shard padded K;
* ``wo`` / ``w2`` (``w_proj``): row-parallel, rank r's r-th slice of input
  rows, quantized alone when quantized. Slicing a packed tensor would be
  wrong: the int4 and int8 words interleave input rows across slabs
  (``ops/quantized.pack_int4_i32``);
* everything else (norms, row-parallel biases, embeddings, heads): whole.

The KV cache is each rank's own: its heads of every row
(:func:`make_tp_cache`). The merge counters and scratch of the kernels are
per device within a process (``ops/quantized.merge_tickets``): two ranks
on one card are two processes, each with its own allocations, sharing
nothing.
"""

from __future__ import annotations

import dataclasses

import torch

from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops.quantized import I32_GROUPSIZE, quantize_int4_i32, quantize_int8_i32
from metavoice_tpu_torch.parallel.mesh import Mesh
from metavoice_tpu_torch.parallel.sharding import qkv_block, shard_layers, shard_params

_COLUMN = ("wqkv", "w1", "w3", "w_fc")
_ROW = ("wo", "w2", "w_proj")
_HIDDEN_OUT = ("w1", "w3", "w_fc")  # the FFN hidden width on the out axis
TP_MODES = (None, "int4", "int8")


def local_view(cfg: TransformerConfig, tp: int) -> TransformerConfig:
    """One rank's view of the model: local head counts, the full residual
    width (``head_dim_override`` keeps head_dim the global one)."""
    if cfg.n_head % tp or cfg.n_local_heads % tp:
        raise ValueError(f"n_head={cfg.n_head}/n_local_heads={cfg.n_local_heads} not divisible by tp={tp}")
    return dataclasses.replace(cfg, n_head=cfg.n_head // tp, n_local_heads=cfg.n_local_heads // tp,
                               head_dim_override=cfg.head_dim)


def permute_qkv_cols(w: torch.Tensor, cfg: TransformerConfig, tp: int) -> torch.Tensor:
    """(..., D, q+k+v) -> the per-rank column blocks ``[q_i | k_i | v_i]``
    side by side, the JAX package's stored layout."""
    return torch.cat([qkv_block(w, cfg, tp, i) for i in range(tp)], dim=-1)


def _pad_cols(w: torch.Tensor, multiple: int) -> torch.Tensor:
    npad = -w.shape[-1] % multiple
    return w if npad == 0 else torch.cat([w, w.new_zeros((*w.shape[:-1], npad))], dim=-1)


def _quantize_int4(chunk: torch.Tensor, pad_out: bool) -> dict:
    """int4-in-int32 quantization of one (L, K, Nc) shard, layer by layer;
    ``pad_out`` pads its columns to ``8 * I32_GROUPSIZE``, their ``sc``
    zero, so they come out exactly 0."""
    n_real = chunk.shape[-1]
    if pad_out:
        chunk = _pad_cols(chunk, 8 * I32_GROUPSIZE)
    packed = [quantize_int4_i32(chunk[li]) for li in range(chunk.shape[0])]
    pw = torch.stack([p for p, _ in packed])
    sc = torch.stack([s for _, s in packed])
    if sc.shape[-1] != n_real:
        col = torch.arange(sc.shape[-1], device=sc.device) < n_real
        sc = torch.where(col[None, None, :], sc, torch.zeros_like(sc))
    return {"pw": pw, "sc": sc}


def _quantize_int8(chunk: torch.Tensor, pad_out: bool) -> dict:
    """int8-in-int32 quantization of one (L, K, Nc) shard (no hidden
    padding: the format needs K % 4 only)."""
    del pad_out
    packed = [quantize_int8_i32(chunk[li]) for li in range(chunk.shape[0])]
    return {"p8": torch.stack([p for p, _ in packed]), "sc8": torch.stack([s for _, s in packed])}


_QUANTIZERS = {"int4": _quantize_int4, "int8": _quantize_int8}


def _quantize_layers(out: dict, quantisation_mode: str | None) -> dict:
    """One rank's dense shards -> its serving format, each shard quantized alone."""
    if quantisation_mode not in TP_MODES:
        raise ValueError(f"tp quantisation_mode must be None|'int4'|'int8', got {quantisation_mode!r}")
    if quantisation_mode is None:
        return out
    out = dict(out)
    quant = _QUANTIZERS[quantisation_mode]
    for key in _COLUMN + _ROW:
        if key in out:
            out[key] = quant(out[key], key in _HIDDEN_OUT)
    if quantisation_mode == "int4" and "w_fc_b" in out:
        # the column bias follows w_fc's padded width: the pad units are
        # zero-activation, so a zero bias keeps them inert
        out["w_fc_b"] = _pad_cols(out["w_fc_b"], 8 * I32_GROUPSIZE)
    return out


def build_tp_layers(layers: dict, cfg: TransformerConfig, tp: int, quantisation_mode: str | None,
                    rank: int) -> dict:
    """Dense stacked (L, in, out) layer weights -> rank ``rank``'s layer
    weights in the TP layout (module docstring), each shard quantized alone
    with the port's quantizers when ``quantisation_mode`` is ``"int4"`` or
    ``"int8"``: shard ``rank`` of the JAX package's ``build_tp_layers``."""
    return _quantize_layers(shard_layers(layers, cfg, tp, rank), quantisation_mode)


def prepare_tp_params(params: dict, cfg: TransformerConfig, mesh: Mesh, quantisation_mode: str | None = None) -> dict:
    """A dense param tree (tensors on any device; a JAX tree reaches here
    through ``utils/checkpoint.params_from_numpy``) -> this rank's tree on
    its device: its layer shards, cut, moved and then quantized on the
    rank's device (:func:`build_tp_layers`), and the other leaves whole."""
    quantized = [k for k, w in params["layers"].items() if isinstance(w, dict)]
    if quantized:
        raise ValueError(f"prepare_tp_params takes dense layer weights, {quantized} are quantized")
    out = shard_params(params, cfg, mesh)
    out["layers"] = _quantize_layers(out["layers"], quantisation_mode)
    return out


def make_tp_cache(cfg: TransformerConfig, mesh: Mesh, batch: int, max_seq_len: int | None = None,
                  data_sharded: bool = True, dtype=torch.bfloat16) -> tfm.KVCache:
    """This rank's KV cache: its heads (``local_view``) of its rows, the
    batch split over the data group, or, with ``data_sharded=False``, every
    row (the single-utterance layout: the 2 or 3 guidance rows do not split
    over a data group). ``dtype`` as ``KVCache.create`` takes it; a
    quantized format's scale table is the local one, which is shard r of
    the JAX package's per-shard-padded global table."""
    lcfg = local_view(cfg, mesh.tensor_parallel)
    if data_sharded and batch % mesh.data_parallel:
        raise ValueError(f"batch {batch} does not split over {mesh.data_parallel} data ranks")
    batch_local = batch // mesh.data_parallel if data_sharded else batch
    return tfm.KVCache.create(lcfg, batch_local, max_seq_len, dtype=dtype, device=mesh.device)


@torch.inference_mode()
def tp_forward(params_tp: dict, cfg: TransformerConfig, mesh: Mesh, idx, spk_emb, spk_cond_mask, kv: tfm.KVCache,
               cache_pos: int, compute_dtype=torch.bfloat16):
    """A cached TP forward of this rank's rows -> (per-hierarchy logits,
    the cache, written in place): prefill (T > 1) or decode (T = 1) at
    ``cache_pos``. ``params_tp`` from :func:`prepare_tp_params`, ``kv``
    from :func:`make_tp_cache`; the logits are the same on every rank of
    the tensor group."""
    return tfm.forward(params_tp, local_view(cfg, mesh.tensor_parallel), idx, spk_emb=spk_emb,
                       spk_cond_mask=spk_cond_mask, kv_cache=kv, cache_pos=cache_pos, compute_dtype=compute_dtype,
                       tp=mesh.tensor_group)


@torch.inference_mode()
def tp_forward_nocache(params_tp: dict, cfg: TransformerConfig, mesh: Mesh, idx, spk_emb,
                       compute_dtype=torch.bfloat16) -> list[torch.Tensor]:
    """The uncached TP forward of this rank's rows (the non-causal second
    stage's shape: multi-hierarchy embeddings and heads replicated) ->
    per-hierarchy logits."""
    logits, _ = tfm.forward(params_tp, local_view(cfg, mesh.tensor_parallel), idx, spk_emb=spk_emb,
                            compute_dtype=compute_dtype, tp=mesh.tensor_group)
    return logits


def tp_generate(params_tp: dict, cfg: TransformerConfig, mesh: Mesh, prompt_tokens, spk_emb, *,
                kv_cache: tfm.KVCache | None = None, cache_dtype=None, **generate_kwargs):
    """Single-utterance TP generation: ``models/first_stage.generate`` on
    this rank's shards and its heads-split cache (made here unless given),
    the reductions over the tensor group. Same sampling and return as
    ``generate``; every rank returns the same tokens."""
    if kv_cache is None:
        rows = fs._normalize_guidance(generate_kwargs.get("guidance_scale", 3.0))[2]
        kv_cache = make_tp_cache(cfg, mesh, rows, data_sharded=False,
                                 dtype=cache_dtype or generate_kwargs.get("compute_dtype", torch.bfloat16))
    return fs.generate(params_tp, local_view(cfg, mesh.tensor_parallel), prompt_tokens, spk_emb, kv_cache=kv_cache,
                       tp=mesh.tensor_group, **generate_kwargs)
