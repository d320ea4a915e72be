"""Second-stage (non-causal hierarchy completion) training.

Port of metavoice_tpu/training/second_stage.py. The reference ships its
second stage pretrained and never trains it; this trains the non-causal
model that maps (text, coarse h0/h1) to the other 6 EnCodec codebooks,
teacher-forced over every timestep at once (the single forward inference
uses, fam/llm/mixins/non_causal.py:30-67), and writes the ``.npz`` that
``utils/checkpoint.load_second_stage_npz`` and ``TTS.from_checkpoints`` load.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.training.finetune import AdamW, apply_updates, mean_grads, to_device, tree_leaves
from metavoice_tpu_torch.utils import checkpoint as ck


def build_example(text_tokens: list[int], codes: np.ndarray,
                  cfg: TransformerConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(text, the 8-codebook grid) -> (x, y, mask) teacher-forcing arrays:
    ``x`` the (2, ctx) input inference builds (core/tokens.
    build_second_stage_input: text+h0 / pad+h1); ``y`` the (6, ctx) targets,
    hierarchies 2..7 on the audio positions; ``mask`` 1.0 on the audio
    positions only (the region the reference's inference slices,
    fam/llm/inference.py:329-340)."""
    ctx = cfg.block_size
    n_text = len(text_tokens)
    n_audio = min(codes.shape[1], ctx - n_text)
    coarse = [codes[0, :n_audio].tolist(), codes[1, :n_audio].tolist()]
    x = T.build_second_stage_input(text_tokens, coarse, ctx)
    y = np.zeros((len(cfg.target_vocab_sizes), ctx), np.int32)
    y[:, n_text : n_text + n_audio] = codes[2 : 2 + y.shape[0], :n_audio]
    mask = np.zeros((ctx,), np.float32)
    mask[n_text : n_text + n_audio] = 1.0
    return np.asarray(x), y, mask


def loss_fn(params: Any, cfg: TransformerConfig, batch: dict, compute_dtype=torch.float32) -> torch.Tensor:
    """Masked mean cross-entropy over the output hierarchies."""
    logits_list, _ = tfm.forward(params, cfg, batch["x"], spk_emb=batch["spk_emb"], compute_dtype=compute_dtype)
    denom = torch.clamp(batch["mask"].sum(), min=1.0)
    loss = 0.0
    for i, lg in enumerate(logits_list):
        lp = torch.log_softmax(lg.float(), dim=-1)
        ll = torch.gather(lp, -1, batch["y"][:, i, :, None].long())[..., 0]
        loss = loss + -(ll * batch["mask"]).sum() / denom
    return loss / len(logits_list)


@dataclasses.dataclass(frozen=True)
class SecondStageTrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    max_iters: int = 300
    seed: int = 0


def train_second_stage(params: Any, cfg: TransformerConfig, batch: dict[str, np.ndarray],
                       tcfg: SecondStageTrainConfig = SecondStageTrainConfig(), compute_dtype=torch.float32,
                       log_every: int = 0):
    """Full-batch overfit loop (the whole tiny dataset is one batch): every
    leaf trains, clipped by global norm, then AdamW (optax's defaults b1 0.9,
    b2 0.999, eps 1e-8; a constant rate; decay on rank >= 2 leaves). The
    params are updated in place. -> (params, final loss)."""
    opt = AdamW(tcfg.learning_rate, weight_decay=tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    opt_state = opt.init(params)
    b = to_device(batch, tree_leaves(params)[0].device)
    trained = [True] * len(tree_leaves(params))
    loss = None
    for i in range(tcfg.max_iters):
        loss, grads = mean_grads(params, trained, lambda mb, gen: loss_fn(params, cfg, mb, compute_dtype), [b], [0])
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        if log_every and (i % log_every == 0 or i == tcfg.max_iters - 1):
            print(f"second-stage step {i}: loss {float(loss):.4f}")
    return params, float(loss)


def save_second_stage(path: str, params: Any, cfg: TransformerConfig, tokenizer_info: dict | None = None) -> str:
    """The native ``.npz`` second stage, with the meta schema of the
    reference's second_stage.pt (model_args + meta,
    fam/llm/inference.py:124-131), so the config round-trips exactly."""
    meta = {
        "model_args": {
            "block_size": cfg.block_size,
            "n_layer": cfg.n_layer,
            "n_head": cfg.n_head,
            "n_embd": cfg.dim,
            "vocab_sizes": list(cfg.vocab_sizes),
            "target_vocab_sizes": list(cfg.target_vocab_sizes),
            "causal": cfg.causal,
            "norm_type": cfg.norm_type,
            "nonlinearity_type": cfg.nonlinearity_type,
            "bias": cfg.bias,
        },
        "meta": {
            "speaker_cond": True,
            "speaker_emb_size": cfg.speaker_emb_dim,
            "tokenizer": tokenizer_info or {},
        },
    }
    ck.save_npz(path, params, meta=meta)
    return path
