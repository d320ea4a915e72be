"""Weights in and out of the port: the JAX package's ``.npz`` files and
parameter pytrees.

``load_npz`` reads what ``metavoice_tpu/utils/checkpoint.py:save_npz`` and
``save_first_stage_quantized`` write: a flat ``key/path -> array`` archive
whose bf16 leaves are stored widened to f32 and listed in the reserved
``__bf16_keys__`` entry (``save_npz``) or in ``__meta__["bf16_keys"]`` (the
quantize CLI's writer), narrowed back here (without ml_dtypes: torch rounds
f32 to bf16 to nearest even, as ml_dtypes does, and the stored values were
bf16 to begin with). ``load_first_stage_npz`` also reads the config and
quantisation mode such a first-stage file carries, and
``save_first_stage_quantized`` writes one in the JAX package's layout.

``params_from_numpy`` turns the JAX package's parameter pytrees, as numpy
arrays (ml_dtypes bf16 included) or the tensors of a ``load_npz`` tree,
into the port's parameter trees on a device: the
first and second stage transformers, the speaker encoder and EnCodec all use
the same nesting of dicts and lists, with NamedTuples turned into dicts.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config
from metavoice_tpu_torch.core.device import resolve_device


def _unflatten(flat: dict[str, Any]) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(tree)


def _flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Tree of tensors -> flat ``key/path -> CPU tensor``, the JAX package's
    key layout."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: torch.as_tensor(tree).detach().cpu()}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}{k}/"))
    return flat


def load_npz(path: str) -> tuple[Any, dict]:
    """-> (tree of CPU tensors, meta). Leaves listed in ``__bf16_keys__`` or
    in ``meta["bf16_keys"]`` come back as torch.bfloat16; the reserved
    entries never reach the tree."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"])) if "__meta__" in data.files else {}
        bf16 = set(meta.get("bf16_keys") or [])
        if "__bf16_keys__" in data.files:
            bf16 |= set(data["__bf16_keys__"].tolist())
        flat = {}
        for k in data.files:
            if k in ("__meta__", "__bf16_keys__"):
                continue
            t = torch.from_numpy(np.array(data[k]))
            flat[k] = t.to(torch.bfloat16) if k in bf16 else t
    return _unflatten(flat), meta


def save_first_stage_quantized(path: str, params: Any, cfg: TransformerConfig, tokenizer_info: dict | None,
                               quantisation_mode: str) -> None:
    """Write a quantized first stage as the JAX package's
    ``save_first_stage_quantized`` does: bf16 leaves widened to f32 and
    listed in ``__meta__["bf16_keys"]``, beside the config, the tokenizer
    info and the mode."""
    flat = _flatten(params)
    bf16_keys = sorted(k for k, t in flat.items() if t.dtype == torch.bfloat16)
    meta = {
        "format": "first_stage_quantized",
        "quantisation_mode": quantisation_mode,
        "config": dataclasses.asdict(cfg),
        "tokenizer": tokenizer_info or {},
        "bf16_keys": bf16_keys,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta),
             **{k: (t.float() if t.dtype == torch.bfloat16 else t).numpy() for k, t in flat.items()})


# reference-style ``model_args`` names -> TransformerConfig fields
_MODEL_ARGS = (("block_size", "block_size"), ("n_layer", "n_layer"), ("n_head", "n_head"),
               ("n_local_heads", "n_local_heads"), ("n_embd", "dim"), ("causal", "causal"),
               ("norm_type", "norm_type"), ("nonlinearity_type", "nonlinearity_type"), ("bias", "bias"),
               ("spkemb_dropout", "spkemb_dropout"), ("spk_emb_on_text", "spk_emb_on_text"))


def load_first_stage_npz(path: str):
    """A native ``.npz`` first stage -> (params as CPU tensors, cfg,
    tokenizer_info, quantisation_mode | None), as the JAX package's
    ``load_first_stage_npz``. Takes the quantize CLI's files (a full
    ``config`` dict and the mode) and the trainer's (reference-style
    ``model_args`` with n_embd-style names, honoured so that a finetuned
    architecture never loads as the stock one); with neither, the stock
    first stage."""
    params, meta = load_npz(path)
    tok_info = meta.get("tokenizer") or (meta.get("meta") or {}).get("tokenizer") or {}
    if meta.get("config") and "n_layer" in meta["config"]:
        cfg_dict = dict(meta["config"])
        for key in ("vocab_sizes", "target_vocab_sizes"):
            if cfg_dict.get(key) is not None:
                cfg_dict[key] = tuple(cfg_dict[key])
        cfg = TransformerConfig(**cfg_dict)
    elif meta.get("model_args"):
        args = meta["model_args"]
        overrides = {dst: args[src] for src, dst in _MODEL_ARGS if src in args}
        if args.get("vocab_sizes"):
            overrides["vocab_sizes"] = tuple(args["vocab_sizes"])
        speaker_emb = (meta.get("meta") or {}).get("speaker_emb_size")
        if speaker_emb:
            overrides["speaker_emb_dim"] = speaker_emb
        cfg = first_stage_config(**overrides)
    else:
        cfg = first_stage_config()
    return params, cfg, tok_info, meta.get("quantisation_mode")


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a load_npz tree
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# the key sets of a quantized weight leaf, whose arrays keep their dtypes
_QUANTIZED_LEAVES = ({"pw", "sc"}, {"p8", "sc8"}, {"q", "scales"}, {"q", "scales", "zeros"},
                     {"p", "scales", "zeros"})


def params_from_numpy(tree: Any, device="cuda", dtype: torch.dtype | None = None) -> Any:
    """JAX-package parameter pytree (numpy leaves) -> the port's tree of
    tensors on ``device``. ``dtype``, if given, casts the float leaves, but
    not those of quantized weights: packed int4 ``{"pw", "sc"}`` (layer
    weights and ``lm_head_q``) and packed int8 ``{"p8", "sc8"}``, whose bf16
    scale tables are part of the serving format, nor plain int8 ``{"q",
    "scales"}`` and the groupwise int4 ``{"q"|"p", "scales", "zeros"}``,
    whose scales stay f32 as the JAX package writes them."""
    dev = resolve_device(device)

    def convert(node, cast):
        if isinstance(node, dict):
            cast = cast and not any(kind <= node.keys() for kind in _QUANTIZED_LEAVES)
            return {k: convert(v, cast) for k, v in node.items()}
        if hasattr(node, "_asdict"):  # NamedTuple (SpeakerEncoderParams)
            return {k: convert(v, cast) for k, v in node._asdict().items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, cast) for v in node]
        t = _to_tensor(node)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, True)
