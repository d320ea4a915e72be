"""Second-stage non-causal hierarchy completion.

Port of metavoice_tpu/models/second_stage.py:29-100: the 2 coarse EnCodec
hierarchies (plus text) go through one non-causal forward, and every
(hierarchy, time) cell of the 6 remaining hierarchies is sampled at once
(temperature, top-k, Gumbel-max; reference fam/llm/mixins/non_causal.py).
"""

from __future__ import annotations

import numpy as np
import torch

from metavoice_tpu_torch.core import sampling as S
from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import transformer as tfm


def non_causal_sample(
    params: tfm.Params,
    cfg: TransformerConfig,
    idx: torch.Tensor,  # (B, C_in, T) input hierarchies, T == cfg.block_size
    spk_emb: torch.Tensor | None,  # (B, spk_dim)
    temperature: float,
    top_k: int = 200,
    compute_dtype=torch.bfloat16,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One forward pass, sample every cell -> (B, C_out, T) int64.
    ``noise`` (B, C_out, T, V) replaces the Gumbel draws from ``generator``."""
    logits_list, _ = tfm.forward(params, cfg, idx, spk_emb=spk_emb, compute_dtype=compute_dtype)
    logits = torch.stack(logits_list, dim=1)  # (B, C_out, T, V)
    return S.sample_from_logits(
        logits, temperature, top_k=top_k, generator=generator, noise=noise
    )


@torch.inference_mode()
def complete_hierarchies(
    params: tfm.Params,
    cfg: TransformerConfig,
    text_tokens: list[int],
    coarse_hierarchies: list[list[int]],
    spk_emb,
    *,
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    top_k: int = 200,
    compute_dtype=torch.bfloat16,
    noise: torch.Tensor | None = None,
) -> np.ndarray:
    """Coarse 2 hierarchies -> full (8, T_audio) EnCodec code grid (int32).

    Builds the (2, ctx) input (text+h0 / pad+h1), samples the other 6, cuts
    the audio region after the text prefix, restores the true coarse rows and
    clips every code to [0, 1023] (the fine rows may sample the pad id).
    """
    device = params["wpe"].device
    ctx = cfg.block_size
    x = T.build_second_stage_input(text_tokens, coarse_hierarchies, ctx)
    idx = torch.as_tensor(x, dtype=torch.int64, device=device)[None]  # (1, 2, ctx)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)
    sampled = non_causal_sample(
        params, cfg, idx, spk, temperature, top_k=top_k, compute_dtype=compute_dtype,
        generator=generator, noise=noise,
    )  # (1, 6, ctx)
    full = np.concatenate([x[None], sampled.cpu().numpy()], axis=1)[0]  # (8, ctx)

    n_text = len(text_tokens)
    n_audio = min(len(coarse_hierarchies[0]), ctx - n_text)
    out = full[:, n_text : n_text + n_audio].copy()
    out[0] = np.asarray(coarse_hierarchies[0])[:n_audio]
    out[1] = np.asarray(coarse_hierarchies[1])[:n_audio]
    return np.clip(out, 0, T.CODEBOOK_SIZE - 1).astype(np.int32)
