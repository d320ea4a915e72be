"""First-stage 1.2B causal LLM: prefill + decode loop with speaker CFG.

Port of the single-utterance path of metavoice_tpu/models/first_stage.py:

  * CFG as a leading batch pair: row 0 speaker-conditioned, row 1
    unconditioned through a zeroing mask on the speaker projection
    (reference fam/llm/fast_model.py:132-134,156);
  * prompts right-padded to a 128 bucket; prefill masks against the full
    cache length and samples from the hidden state at ``prompt_len - 1``;
  * temperature -> top-p -> Gumbel-max sampling on the device;
  * an end-of-audio latch on the device: rows that are done keep emitting
    EOA. The host reads the latch only every ``DONE_CHECK_EVERY`` steps, not
    every token; the steps it runs past the end cannot change the output,
    since finished rows only emit EOA and are not counted.

Each decode step runs every layer's attention through
ops/attention.py:decode_attention (the CUDA kernel on the card), or, with
int4 weights, the whole step through ops/decode_stack.py:decode_stack_int4,
whose fused int4 tied head gives the logits directly; with int8 weights,
the whole step through its int8 form where its conditions hold, then the
bf16 tied head (``apply_blocks`` says head_done=False). Prefill keeps the
bf16 tied head, as in the JAX package. Only the 2-row (speaker) CFG is
ported; the 3-row prompt guidance is a later PR.
"""

from __future__ import annotations

import numpy as np
import torch

from metavoice_tpu_torch.core import sampling as S
from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import transformer as tfm

DONE_CHECK_EVERY = 16  # decode steps between host reads of the EOA latch


def _cfg_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (2B, ...): both CFG groups consume the same tokens."""
    return torch.cat([x, x], dim=0)


def _normalize_guidance(guidance_scale) -> tuple[float, float, int]:
    """float | None -> (spk_scale, prompt_scale, cfg_rows), 2-row CFG only."""
    if guidance_scale is None:
        return 1.0, 1.0, 2
    if isinstance(guidance_scale, (tuple, list)):
        raise NotImplementedError(
            "(speaker, prompt) guidance tuples (3-row CFG) are not ported; pass a float"
        )
    return float(guidance_scale), 1.0, 2


def make_spk_cond_mask(batch_size: int, device="cpu") -> torch.Tensor:
    """(2B, 1, 1) mask: 1 for the speaker-conditioned rows, 0 for the rest."""
    ones = torch.ones((batch_size, 1, 1), device=device)
    return torch.cat([ones, torch.zeros_like(ones)], dim=0)


def prefill(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,  # (B, T_pad) int, right-padded
    prompt_len: int,  # true length (uniform across batch)
    spk_emb: torch.Tensor,  # (B, spk_dim)
    kv_cache: tfm.KVCache,
    temperature: float,
    top_p: float,
    guidance_scale: float,
    compute_dtype=torch.bfloat16,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fill the cache with the prompt and sample the first new token -> (B,).

    The cache is filled in place; the mask covers the whole cache length, and
    the logits come from the hidden state at ``prompt_len - 1``.
    """
    b, t = prompt.shape
    idx2 = _cfg_rows(prompt)
    spk2 = _cfg_rows(spk_emb)
    mask2 = make_spk_cond_mask(b, device=prompt.device)
    positions = torch.arange(t, device=prompt.device)
    x = tfm.embed_inputs(params, cfg, idx2, positions, spk2, mask2, compute_dtype)
    attn_mask = tfm.causal_mask_for(positions, kv_cache.max_seq_len)[None, None]
    x, _ = tfm.apply_blocks(params, cfg, x, attn_mask, kv_cache, 0)
    x_last = x[:, prompt_len - 1 : prompt_len]  # (2B, 1, D)
    logits = tfm.output_logits(params, cfg, x_last)[0][:, 0, :]
    return S.sample_cfg(
        logits, guidance_scale, temperature, top_p, generator=generator, noise=noise
    )


def pad_to_bucket(tokens, multiple: int = 128, max_len: int | None = None):
    """Right-pad a 1-D token list/array to the next multiple (static bucket)."""
    tokens = np.asarray(tokens, dtype=np.int32)
    t = len(tokens)
    bucket = -(-t // multiple) * multiple
    if max_len is not None:
        bucket = min(bucket, max_len)
    out = np.zeros((bucket,), np.int32)
    out[:t] = tokens[:bucket]
    return out, t


@torch.inference_mode()
def generate(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompt_tokens,  # 1-D int sequence (BPE-offset text ids)
    spk_emb,  # (spk_dim,) or (1, spk_dim), numpy or tensor
    *,
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    top_p: float = 0.95,
    guidance_scale: float = 3.0,
    max_new_tokens: int | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    prompt_pad_multiple: int = 128,
    kv_cache: tfm.KVCache | None = None,
    compute_dtype=torch.bfloat16,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Single-utterance generation (batch 1): prefill, then decode until
    end-of-audio, ``max_new_tokens`` or the block size. Returns
    [prompt ++ generated] as a 1-D int32 numpy array (EOA included if emitted).

    ``noise`` (n, 1, V): Gumbel noise for the n-th sampled token (row 0 for
    the prefill's), in place of draws from ``generator``. ``stats``, if
    given, receives ``decode_steps``: the T=1 forwards run (each launches the
    decode-attention kernel once per layer on the card, or the decode-stack
    kernel once with int4 weights and with int8 ones that meet its
    conditions).
    """
    spk_g, _, _ = _normalize_guidance(guidance_scale)
    device = params["wpe"].device
    padded, t_true = pad_to_bucket(prompt_tokens, prompt_pad_multiple, max_len=cfg.block_size)
    max_steps = cfg.block_size - t_true
    if max_new_tokens is not None:
        max_steps = min(max_steps, max_new_tokens)
    if max_steps <= 0:
        raise ValueError("Prompt is too long to generate more tokens")
    if noise is not None and noise.shape[0] < max_steps:
        raise ValueError(f"noise holds {noise.shape[0]} draws, generation may need {max_steps}")
    if kv_cache is None or kv_cache.batch_size != 2:
        kv_cache = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=compute_dtype, device=device)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)

    first = prefill(
        params, cfg,
        torch.as_tensor(padded, dtype=torch.int64, device=device)[None, :],
        t_true, spk, kv_cache, temperature, top_p, spk_g, compute_dtype,
        generator=generator, noise=None if noise is None else noise[0],
    )

    spk2 = _cfg_rows(spk)
    mask2 = make_spk_cond_mask(1, device=device)
    positions = torch.arange(cfg.block_size, device=device)
    eoa = torch.full_like(first, end_of_audio_token)
    n_loop = max_steps - 1
    out_buf = torch.full((1, max(n_loop, 1)), end_of_audio_token, dtype=torch.int64, device=device)
    out_len = torch.zeros_like(first)
    done = first == end_of_audio_token
    cur = first
    steps = 0
    for step in range(n_loop):
        if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        pos = t_true + step
        x = tfm.embed_inputs(
            params, cfg, _cfg_rows(cur)[:, None], positions[pos : pos + 1], spk2, mask2,
            compute_dtype,
        )
        out, _, head_done = tfm.apply_blocks(params, cfg, x, None, kv_cache, pos, fused_head=True)
        # head_done: the int4 stack fused the final norm and the int4 tied
        # head, and `out` is already the (2, V) f32 logits
        logits = out if head_done else tfm.output_logits(params, cfg, out)[0][:, 0, :]
        sampled = S.sample_cfg(
            logits, spk_g, temperature, top_p,
            generator=generator, noise=None if noise is None else noise[step + 1],
        )
        nxt = torch.where(done, eoa, sampled)  # finished rows stay frozen on EOA
        out_buf[:, step] = nxt
        out_len += (~done).to(out_len.dtype)
        done = done | (nxt == end_of_audio_token)
        cur = nxt
        steps += 1
    if stats is not None:
        stats["decode_steps"] = steps
    n = int(out_len[0])
    return np.concatenate([
        np.asarray(prompt_tokens, np.int32),
        first.cpu().numpy().astype(np.int32),
        out_buf[0, :n].cpu().numpy().astype(np.int32),
    ])
