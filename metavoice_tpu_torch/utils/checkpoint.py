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

The reference's pickled ``.pt`` checkpoints (first_stage.pt, second_stage.pt,
speaker_encoder.pt; schema {model, model_args, meta: {speaker_emb_size,
tokenizer}, ...}) load through ``load_first_stage_pt``,
``load_second_stage_pt`` and ``load_speaker_encoder_pt``: the training-format
names (``transformer.h.{i}.attn.c_attn.weight`` ...) are stacked over layers
and torch's (out, in) linear weights transposed once, as the JAX package's
loaders do, tensor to tensor (an f32 read of any stored dtype is exact), so
every leaf has the JAX loader's bits. ``load_second_stage_npz`` reads an
in-repo second stage, ``save_npz`` writes the JAX package's generic archive,
and ``save_``/``load_``/``apply_spec_teacher_delta`` carry the speculative
demo's teacher delta in the JAX package's format. ``train_state_from_numpy``
carries a JAX finetuning state (params, Adam moments, step) across to the
port's trainer.
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
from metavoice_tpu_torch.models.speaker_encoder import MODEL_NUM_LAYERS


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


def _widen_bf16(flat: dict[str, torch.Tensor]) -> tuple[dict[str, np.ndarray], list[str]]:
    """.npy has no bfloat16: bf16 leaves are stored widened to f32 (exact),
    and their keys returned sorted, to be recorded for the reader."""
    bf16_keys = sorted(k for k, t in flat.items() if t.dtype == torch.bfloat16)
    return {k: (t.float() if t.dtype == torch.bfloat16 else t).numpy() for k, t in flat.items()}, bf16_keys


def save_npz(path: str, params: Any, meta: dict | None = None) -> None:
    """The JAX package's generic ``save_npz``: a flat ``key/path`` archive,
    the bf16 leaves widened to f32 and listed in ``__bf16_keys__``."""
    flat, bf16_keys = _widen_bf16(_flatten(params))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta or {}), __bf16_keys__=np.asarray(bf16_keys), **flat)


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


# A checkpoint vocabulary's ranks are keyed by bytes, which JSON cannot hold: a
# quantized file stores them as latin-1 strings (one char a byte) under this key.
_RANKS, _RANKS_LATIN1 = "mergeable_ranks", "mergeable_ranks_latin1"


def _tokenizer_to_json(info: dict | None) -> dict:
    info = dict(info or {})
    if info.get(_RANKS) and any(isinstance(k, bytes) for k in info[_RANKS]):
        info[_RANKS_LATIN1] = {k.decode("latin-1"): int(v) for k, v in info.pop(_RANKS).items()}
    return info


def _tokenizer_from_json(info: dict) -> dict:
    info = dict(info)
    if _RANKS_LATIN1 in info:
        info[_RANKS] = {k.encode("latin-1"): v for k, v in info.pop(_RANKS_LATIN1).items()}
    return info


def save_first_stage_quantized(path: str, params: Any, cfg: TransformerConfig, tokenizer_info: dict | None,
                               quantisation_mode: str) -> None:
    """Write a quantized first stage as the JAX package's
    ``save_first_stage_quantized`` does: bf16 leaves widened to f32 and
    listed in ``__meta__["bf16_keys"]``, beside the config, the tokenizer
    info and the mode. A checkpoint vocabulary (``mergeable_ranks`` keyed by
    bytes, on which the JAX writer's ``json.dumps`` raises) is stored as
    latin-1 strings under ``mergeable_ranks_latin1``, and
    ``load_first_stage_npz`` turns it back."""
    flat, bf16_keys = _widen_bf16(_flatten(params))
    meta = {
        "format": "first_stage_quantized",
        "quantisation_mode": quantisation_mode,
        "config": dataclasses.asdict(cfg),
        "tokenizer": _tokenizer_to_json(tokenizer_info),
        "bf16_keys": bf16_keys,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **flat)


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
    tok_info = _tokenizer_from_json(meta.get("tokenizer") or (meta.get("meta") or {}).get("tokenizer") or {})
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
    whose scales stay f32 as the JAX package writes them. A ``None`` leaf
    stays ``None``."""
    dev = resolve_device(device)

    def convert(node, cast):
        if isinstance(node, dict):
            cast = cast and not any(kind <= node.keys() for kind in _QUANTIZED_LEAVES)
            return {k: convert(v, cast) for k, v in node.items()}
        if hasattr(node, "_asdict"):  # NamedTuple (SpeakerEncoderParams)
            return {k: convert(v, cast) for k, v in node._asdict().items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, cast) for v in node]
        if node is None:  # an empty subtree (an MBD UNet's "bilstm", "embeddings")
            return None
        t = _to_tensor(node)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(dev)

    return convert(tree, True)


def _adam_state(node):
    """The node of an optax state that holds Adam's ``count``, ``mu`` and ``nu``."""
    if hasattr(node, "_asdict"):
        fields = node._asdict()
        if {"count", "mu", "nu"} <= fields.keys():
            return node
        node = tuple(fields.values())
    if isinstance(node, (list, tuple)):
        for sub in node:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def train_state_from_numpy(state: Any, device="cuda"):
    """A JAX ``training.finetune.TrainState`` as numpy arrays (``jax.tree.map(
    np.asarray, state)``) -> the port's ``TrainState`` on ``device``: the
    params, optax's Adam moments and count (the port's AdamW state) and the
    step, so that a run started in the JAX package continues in the port."""
    from metavoice_tpu_torch.training.finetune import TrainState

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam moments (count, mu, nu)")
    opt_state = {"count": int(adam.count), "mu": params_from_numpy(adam.mu, device=device),
                 "nu": params_from_numpy(adam.nu, device=device)}
    return TrainState(params_from_numpy(state.params, device=device), opt_state, int(state.step))


# --------------------------------------------------------------------------------------
# The reference's pickled .pt checkpoints
# --------------------------------------------------------------------------------------

_UNWANTED_PREFIX = "_orig_mod."  # a torch.compile artifact in finetuned checkpoints


def _strip_compile_prefix(state_dict: dict) -> dict:
    return {(k[len(_UNWANTED_PREFIX):] if k.startswith(_UNWANTED_PREFIX) else k): v for k, v in state_dict.items()}


def _read_pt(path: str) -> dict:
    """The whole pickle (tensors memory-mapped where the file allows)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False, mmap=True)
    except RuntimeError:  # a legacy (non-zip) file cannot be memory-mapped
        return torch.load(path, map_location="cpu", weights_only=False)


def load_first_stage_pt(path: str, cfg: TransformerConfig | None = None, dtype: torch.dtype = torch.float32,
                        device="cuda"):
    """first_stage.pt -> (params on ``device``, cfg, tokenizer_info), as the
    JAX package's ``load_first_stage_pt``. Without ``cfg`` the checkpoint's
    ``model_args`` and ``meta`` are honoured (a finetuned checkpoint may have
    another architecture: ``n_local_heads``, ``rmsnorm_eps``,
    ``speaker_emb_size`` ...), and the stock 1B shape fills every arg it does
    not carry."""
    ckpt = _read_pt(path)
    sd = _strip_compile_prefix(ckpt["model"])
    if cfg is None:
        args = ckpt.get("model_args", {}) or {}
        meta = ckpt.get("meta", {}) or {}
        overrides = {dst: args[src] for src, dst in _MODEL_ARGS if src in args}
        if args.get("vocab_sizes"):
            overrides["vocab_sizes"] = tuple(args["vocab_sizes"])
        if args.get("rmsnorm_eps"):
            overrides["norm_eps"] = args["rmsnorm_eps"]
        if meta.get("speaker_emb_size"):
            overrides["speaker_emb_dim"] = meta["speaker_emb_size"]
        cfg = first_stage_config(**overrides)
    # lm_heads.0.weight is tied to wtes.0: the forward reuses wtes
    params = _extract_gpt_params(sd, cfg, dtype, resolve_device(device))
    return params, cfg, ckpt.get("meta", {}).get("tokenizer", {})


def _extract_gpt_params(sd: dict, cfg: TransformerConfig, dtype: torch.dtype, dev: torch.device) -> dict:
    """Training-format state dict -> the stacked-layer tree, for every variant
    the reference trainer writes: rmsnorm/layernorm (+bias), swiglu/gelu,
    biased or unbiased linears, tied or separate heads."""

    def g(name):  # an f32 read, then dtype (the JAX loader's two roundings), on the device
        return sd[name].detach().to(dev).float().to(dtype)

    def stack(fmt, transpose=False):
        mats = [g(fmt.format(i=i)) for i in range(cfg.n_layer)]
        return torch.stack([m.T if transpose else m for m in mats])

    h = "transformer.h.{i}."
    layers = {
        "attn_norm_w": stack(h + "ln_1.weight"),
        "wqkv": stack(h + "attn.c_attn.weight", True),
        "wo": stack(h + "attn.c_proj.weight", True),
        "ffn_norm_w": stack(h + "ln_2.weight"),
    }
    if "transformer.h.0.ln_1.bias" in sd:
        layers["attn_norm_b"] = stack(h + "ln_1.bias")
        layers["ffn_norm_b"] = stack(h + "ln_2.bias")
    if "transformer.h.0.attn.c_attn.bias" in sd:
        layers["wqkv_b"] = stack(h + "attn.c_attn.bias")
    if "transformer.h.0.attn.c_proj.bias" in sd:
        layers["wo_b"] = stack(h + "attn.c_proj.bias")
    if "transformer.h.0.mlp.swiglu.w1.weight" in sd:
        layers["w1"] = stack(h + "mlp.swiglu.w1.weight", True)
        layers["w3"] = stack(h + "mlp.swiglu.w3.weight", True)
        layers["w2"] = stack(h + "mlp.c_proj.weight", True)
    else:
        layers["w_fc"] = stack(h + "mlp.c_fc.weight", True)
        layers["w_proj"] = stack(h + "mlp.c_proj.weight", True)
        if "transformer.h.0.mlp.c_fc.bias" in sd:
            layers["w_fc_b"] = stack(h + "mlp.c_fc.bias")
            layers["w_proj_b"] = stack(h + "mlp.c_proj.bias")
    params = {
        "wtes": [g(f"transformer.wtes.{i}.weight") for i in range(len(cfg.vocab_sizes))],
        "wpe": g("transformer.wpe.weight"),
        "layers": layers,
        "ln_f_w": g("transformer.ln_f.weight"),
    }
    if "transformer.ln_f.bias" in sd:
        params["ln_f_b"] = g("transformer.ln_f.bias")
    if "speaker_cond_pos.weight" in sd:
        params["speaker_cond"] = g("speaker_cond_pos.weight").T.contiguous()
    if cfg.target_vocab_sizes is not None:
        params["lm_heads"] = [g(f"lm_heads.{i}.weight").T.contiguous() for i in range(len(cfg.target_vocab_sizes))]
    return params


def _second_stage_config(args: dict, speaker_emb_dim: int, causal: bool, norm_eps: float | None) -> TransformerConfig:
    kw = {} if norm_eps is None else {"norm_eps": norm_eps}
    return TransformerConfig(
        block_size=args["block_size"], n_layer=args["n_layer"], n_head=args["n_head"], dim=args["n_embd"],
        vocab_sizes=tuple(args["vocab_sizes"]),
        target_vocab_sizes=tuple(args["target_vocab_sizes"]) if args.get("target_vocab_sizes") else None,
        causal=causal, norm_type=args.get("norm_type", "layernorm"),
        nonlinearity_type=args.get("nonlinearity_type", "gelu"), bias=args.get("bias", True),
        speaker_emb_dim=speaker_emb_dim, **kw,
    )


def load_second_stage_pt(path: str, dtype: torch.dtype = torch.float32, device="cuda"):
    """second_stage.pt -> (params on ``device``, cfg, tokenizer_info), the
    config from the checkpoint's ``model_args`` (and ``config["causal"]``)."""
    ckpt = _read_pt(path)
    sd = _strip_compile_prefix(ckpt["model"])
    args = ckpt["model_args"]
    meta = ckpt.get("meta", {})
    causal = ckpt.get("config", {}).get("causal", args.get("causal", False))
    cfg = _second_stage_config(args, meta.get("speaker_emb_size", 256), causal, args.get("rmsnorm_eps") or 1e-5)
    return _extract_gpt_params(sd, cfg, dtype, resolve_device(device)), cfg, meta.get("tokenizer", {})


def load_second_stage_npz(path: str, device="cuda"):
    """An in-repo ``.npz`` second stage -> (params on ``device``, cfg,
    tokenizer_info); the leaves keep their stored dtypes."""
    params, meta = load_npz(path)
    args = meta["model_args"]
    m = meta.get("meta", {})
    cfg = _second_stage_config(args, m.get("speaker_emb_size", 256), args.get("causal", False), None)
    return params_from_numpy(params, device=device), cfg, m.get("tokenizer", {})


def load_speaker_encoder_pt(path: str, dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """speaker_encoder.pt ({model_state: ...} or the bare state dict) -> the
    speaker encoder's params on ``device``: torch's LSTM weights transposed,
    its two biases summed (f32, as the JAX loader sums them), layer 0's
    input rows zero-padded to stack with the others."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model_state", ckpt)

    def f32(name):
        return sd[name].detach().float()

    w_ih = [f32(f"lstm.weight_ih_l{k}").T.to(dtype) for k in range(MODEL_NUM_LAYERS)]
    w_hh = [f32(f"lstm.weight_hh_l{k}").T.to(dtype) for k in range(MODEL_NUM_LAYERS)]
    b = [(f32(f"lstm.bias_ih_l{k}") + f32(f"lstm.bias_hh_l{k}")).to(dtype) for k in range(MODEL_NUM_LAYERS)]
    in_max = max(w.shape[0] for w in w_ih + w_hh)
    w_ih = [torch.nn.functional.pad(w, (0, 0, 0, in_max - w.shape[0])) for w in w_ih]
    dev = resolve_device(device)
    return {
        "w_ih": torch.stack(w_ih).to(dev), "w_hh": torch.stack(w_hh).to(dev), "b": torch.stack(b).to(dev),
        "linear_w": f32("linear.weight").T.to(dtype).contiguous().to(dev),
        "linear_b": f32("linear.bias").to(dtype).to(dev),
    }


# --------------------------------------------------------------------------------------
# The speculative demo's teacher delta (the JAX package's format)
# --------------------------------------------------------------------------------------
#
# The last ``tail`` blocks and the final norm of an int4-in-int32 first stage,
# written as the JAX package's ``save_spec_teacher_delta`` writes them
# (meta {"format": "spec_teacher_delta", "tail", "bf16_keys"}), so that either
# package reads the other's file. The JAX writer takes every dict leaf as an
# int4 {"pw", "sc"} pair and leaves out ln_f_b; this one refuses any tree it
# would write wrongly that way.

_INT4_LEAF = {"pw", "sc"}


def save_spec_teacher_delta(path: str, qparams: Any, tail: int) -> None:
    """Write the last ``tail`` blocks (and the final norm) of an int4-packed
    tree. Raises ``ValueError`` for a quantized leaf of another kind, or a
    final-norm bias, which the format cannot carry."""
    if "ln_f_b" in qparams:
        raise ValueError("the spec teacher delta carries ln_f_w only; this tree has ln_f_b (a layernorm model)")
    layers = {}
    for k, v in qparams["layers"].items():
        if isinstance(v, dict):
            if set(v) != _INT4_LEAF:
                raise ValueError(f"the spec teacher delta holds int4 {{'pw', 'sc'}} leaves; layers/{k} has {sorted(v)}")
            layers[k] = {"pw": v["pw"][-tail:], "sc": v["sc"][-tail:]}
        else:
            layers[k] = v[-tail:]
    flat, bf16_keys = _widen_bf16(_flatten({"layers": layers, "ln_f_w": qparams["ln_f_w"]}))
    meta = {"format": "spec_teacher_delta", "tail": tail, "bf16_keys": bf16_keys}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_spec_teacher_delta(path: str):
    """-> (delta tree of CPU tensors, bf16 leaves narrowed back, tail)."""
    delta, meta = load_npz(path)
    if meta.get("format") != "spec_teacher_delta":
        raise ValueError(f"{path} is not a spec teacher delta (format {meta.get('format')!r})")
    return delta, int(meta["tail"])


def apply_spec_teacher_delta(qparams: Any, delta: Any, tail: int) -> Any:
    """A new tree: ``qparams`` with the delta's blocks in the last ``tail``
    positions of every stacked layer leaf and the delta's final norm, on
    ``qparams``' devices. ``qparams`` itself is left as it was."""

    def graft(cur, new):
        out = cur.clone()
        out[-tail:] = new.to(out.device, out.dtype)
        return out

    layers = dict(qparams["layers"])
    for name, v in delta["layers"].items():
        if isinstance(v, dict):
            layers[name] = dict(layers[name]) | {k: graft(layers[name][k], v[k]) for k in ("pw", "sc")}
        else:
            layers[name] = graft(layers[name], v)
    return dict(qparams) | {"layers": layers, "ln_f_w": delta["ln_f_w"].to(qparams["ln_f_w"].device)}
