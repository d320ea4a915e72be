"""Weights in and out of the port: the JAX package's ``.npz`` files and
parameter pytrees.

``load_npz`` reads what ``metavoice_tpu/utils/checkpoint.py:save_npz`` writes:
a flat ``key/path -> array`` archive whose bf16 leaves are stored widened to
f32 and listed in the reserved ``__bf16_keys__`` entry, narrowed back here
(without ml_dtypes: torch rounds f32 to bf16 to nearest even, as ml_dtypes
does, and the stored values were bf16 to begin with).

``params_from_numpy`` turns the JAX package's parameter pytrees, as numpy
arrays (ml_dtypes bf16 included) or the tensors of a ``load_npz`` tree,
into the port's parameter trees on a device: the
first and second stage transformers, the speaker encoder and EnCodec all use
the same nesting of dicts and lists, with NamedTuples turned into dicts.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np
import torch

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


def load_npz(path: str) -> tuple[Any, dict]:
    """-> (tree of CPU tensors, meta). Leaves listed in ``__bf16_keys__`` come
    back as torch.bfloat16; the reserved entries never reach the tree."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"])) if "__meta__" in data.files else {}
        bf16 = set(data["__bf16_keys__"].tolist()) if "__bf16_keys__" in data.files else set()
        flat = {}
        for k in data.files:
            if k in ("__meta__", "__bf16_keys__"):
                continue
            t = torch.from_numpy(np.array(data[k]))
            flat[k] = t.to(torch.bfloat16) if k in bf16 else t
    return _unflatten(flat), meta


def _to_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):  # a load_npz tree
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: same bits as torch's
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


# the key sets of a quantized weight leaf, whose arrays keep their dtypes
_QUANTIZED_LEAVES = ({"pw", "sc"}, {"p8", "sc8"}, {"q", "scales"}, {"p", "scales", "zeros"})


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
