"""Second-stage non-causal hierarchy completion.

Port of metavoice_tpu/models/second_stage.py:29-100: the 2 coarse EnCodec
hierarchies (plus text) go through one non-causal forward, and every
(hierarchy, time) cell of the 6 remaining hierarchies is sampled at once
(temperature, top-k, Gumbel-max; reference fam/llm/mixins/non_causal.py).
The audio region's cut, the true coarse rows and the clip to the codebook
are done on the device by ``runtime/tts.stage2_vocode``.
"""

from __future__ import annotations

import torch

from metavoice_tpu_torch.core import sampling as S
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
