"""First-stage 1.2B causal LLM: prefill + decode loop with speaker CFG.

Port of the single-utterance path of metavoice_tpu/models/first_stage.py:

  * CFG as a leading batch of row groups: row 0 speaker-conditioned, row 1
    unconditioned through a zeroing mask on the speaker projection
    (reference fam/llm/fast_model.py:132-134,156); with a (speaker, prompt)
    guidance tuple whose prompt scale is above 1, a third group keeps the
    speaker but sees its text tokens replaced by end-of-text (reference
    fam/llm/mixins/causal.py:89-105,229-262);
  * prompts right-padded to a 128 bucket; prefill masks against the full
    cache length and samples from the hidden state at ``prompt_len - 1``;
  * temperature -> top-p -> Gumbel-max sampling on the device;
  * an end-of-audio latch on the device: rows that are done keep emitting
    EOA. The host reads the latch only every ``DONE_CHECK_EVERY`` steps, not
    every token; the steps it runs past the end cannot change the output,
    since finished rows only emit EOA and are not counted.

Each decode step runs every layer's attention through
ops/attention.py:decode_attention (the CUDA kernel on the card; a GQA first
stage's through the multi-query kernel), or, with int4 weights, the whole
step through ops/decode_stack.py:decode_stack_int4, whose fused int4 tied
head gives the logits directly; with int8 weights, the whole step through
its int8 form where its conditions hold, then the bf16 tied head
(``apply_blocks`` says head_done=False). A quantized KV cache
(``cache_dtype``) takes, with int4 weights, the per-layer attention-block
and FFN kernels and the bf16 tied head; with other weights the dequantizing
plain path. Prefill keeps the bf16 tied head, as in the JAX package.
Speculative decoding is models/spec_decode.py.
"""

from __future__ import annotations

import numpy as np
import torch

from metavoice_tpu_torch.core import sampling as S
from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import transformer as tfm

DONE_CHECK_EVERY = 16  # decode steps between host reads of the EOA latch


def _cfg_rows(x: torch.Tensor, n: int = 2) -> torch.Tensor:
    """(B, ...) -> (nB, ...): every guidance group consumes the same tokens."""
    return torch.cat([x] * n, dim=0)


def _uncond_prompt_rows(tokens: torch.Tensor, end_of_text_token: int,
                        end_of_audio_token: int = T.END_OF_AUDIO_TOKEN) -> torch.Tensor:
    """Replace text tokens (> EOA) with end-of-text for prompt unconditioning
    (reference fam/llm/mixins/causal.py:259-262)."""
    return torch.where(tokens > end_of_audio_token, torch.full_like(tokens, end_of_text_token), tokens)


def guidance_rows(tokens: torch.Tensor, cfg_rows: int, end_of_text_token: int) -> torch.Tensor:
    """(B, T) tokens -> (cfg_rows*B, T): the guidance groups' inputs, the
    third (prompt-unconditioned) group with its text replaced by end-of-text."""
    if cfg_rows == 3:
        return torch.cat([tokens, tokens, _uncond_prompt_rows(tokens, end_of_text_token)], dim=0)
    return _cfg_rows(tokens, cfg_rows)


def _normalize_guidance(guidance_scale) -> tuple[float, float, int]:
    """float | (spk, prompt) tuple -> (spk_scale, prompt_scale, cfg_rows).

    The reference slow path takes a (spkemb_guidance, prompt_guidance) tuple
    (fam/llm/inference.py:646) and only triples the batch when
    prompt_guidance > 1 (mixins/causal.py:254-256); only the tuple form
    asserts both scales >= 1 (causal.py:90-92).
    """
    if guidance_scale is None:
        return 1.0, 1.0, 2
    if isinstance(guidance_scale, (tuple, list)):
        spk_g, prompt_g = float(guidance_scale[0]), float(guidance_scale[1])
        if spk_g < 1.0 or prompt_g < 1.0:
            raise ValueError("guidance scales must be >= 1 (reference causal.py:90-92)")
        return spk_g, prompt_g, 3 if prompt_g > 1.0 else 2
    return float(guidance_scale), 1.0, 2


def make_spk_cond_mask(batch_size: int, cfg_rows: int = 2, *, device) -> torch.Tensor:
    """(cfg_rows*B, 1, 1) mask: 1 for the speaker-conditioned row groups.

    2-row: [cond, spk-uncond]; 3-row adds the prompt-uncond group, which
    keeps the speaker (reference causal.py:229-235); 1-row (a CFG-free
    draft) is the conditioned group alone.
    """
    ones = torch.ones((batch_size, 1, 1), device=device)
    groups = [ones] if cfg_rows == 1 else [ones, torch.zeros_like(ones)] + [ones] * (cfg_rows == 3)
    return torch.cat(groups, dim=0)


def sample_guided(logits, spk_g: float, prompt_g: float, cfg_rows: int, temperature: float,
                  top_p: float, *, generator=None, noise=None) -> torch.Tensor:
    """(cfg_rows*B, V) logits -> (B,) tokens through the guidance merge."""
    if cfg_rows == 3:
        return S.sample_cfg3(logits, spk_g, prompt_g, temperature, top_p, generator=generator, noise=noise)
    return S.sample_cfg(logits, spk_g, temperature, top_p, generator=generator, noise=noise)


def fill_cache(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,  # (B, T_pad) int, right-padded
    spk_emb: torch.Tensor,  # (B, spk_dim)
    kv_cache: tfm.KVCache,
    compute_dtype=torch.bfloat16,
    *,
    cfg_rows: int = 2,
    end_of_text_token: int = 0,
) -> torch.Tensor:
    """Run the prompt's guidance rows through the blocks, writing the cache
    in place -> the (cfg_rows*B, T_pad, D) normed hidden states. The mask
    covers the whole cache length; pad rows past the true prompt are
    harmless, since a query at position p attends [0, p] and row p is
    overwritten by that step's own write before it is read."""
    b, t = prompt.shape
    x = tfm.embed_inputs(
        params, cfg, guidance_rows(prompt, cfg_rows, end_of_text_token),
        torch.arange(t, device=prompt.device), _cfg_rows(spk_emb, cfg_rows),
        make_spk_cond_mask(b, cfg_rows, device=prompt.device), compute_dtype,
    )
    attn_mask = tfm.causal_mask_for(torch.arange(t, device=prompt.device), kv_cache.max_seq_len)[None, None]
    x, _ = tfm.apply_blocks(params, cfg, x, attn_mask, kv_cache, 0)
    return x


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
    cfg_rows: int = 2,
    prompt_guidance_scale: float = 1.0,
    end_of_text_token: int = 0,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fill the cache with the prompt and sample the first new token -> (B,).

    The logits come from the hidden state at ``prompt_len - 1``. ``cfg_rows=3``
    is double guidance (speaker + prompt): the third group sees the prompt
    with its text replaced by ``end_of_text_token``.
    """
    x = fill_cache(params, cfg, prompt, spk_emb, kv_cache, compute_dtype,
                   cfg_rows=cfg_rows, end_of_text_token=end_of_text_token)
    logits = tfm.output_logits(params, cfg, x[:, prompt_len - 1 : prompt_len])[0][:, 0, :]
    return sample_guided(logits, guidance_scale, prompt_guidance_scale, cfg_rows, temperature, top_p,
                         generator=generator, noise=noise)


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


def check_guidance(guidance_scale, end_of_text_token: int, end_of_audio_token: int):
    """-> (spk_scale, prompt_scale, cfg_rows); raises when prompt guidance
    has no end-of-text token to replace the text with."""
    spk_g, prompt_g, cfg_rows = _normalize_guidance(guidance_scale)
    if cfg_rows == 3 and end_of_text_token <= end_of_audio_token:
        raise ValueError("prompt guidance > 1 requires end_of_text_token (tokenizer.eot_token)")
    return spk_g, prompt_g, cfg_rows


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
    guidance_scale: float | tuple[float, float] = 3.0,
    max_new_tokens: int | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    end_of_text_token: int = 0,
    prompt_pad_multiple: int = 128,
    kv_cache: tfm.KVCache | None = None,
    compute_dtype=torch.bfloat16,
    cache_dtype=None,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
) -> np.ndarray:
    """Single-utterance generation (batch 1): prefill, then decode until
    end-of-audio, ``max_new_tokens`` or the block size. Returns
    [prompt ++ generated] as a 1-D int32 numpy array (EOA included if emitted).

    ``guidance_scale`` is a float (speaker CFG, 2 cache rows) or the
    reference's (speaker, prompt) tuple; a prompt scale above 1 takes 3
    cache rows and needs ``end_of_text_token`` (tokenizer.eot_token).
    ``cache_dtype``: the format of the cache made here when ``kv_cache`` is
    not given or holds other rows (``torch.int8``, ``"int8"`` or
    ``"int8_packed"`` for a quantized cache; default ``compute_dtype``).
    ``noise`` (n, 1, V): Gumbel noise for the n-th sampled token (row 0 for
    the prefill's), in place of draws from ``generator``. ``stats``, if
    given, receives ``decode_steps``: the T=1 forwards run (each launches the
    decode-attention kernel once per layer on the card, or the decode-stack
    kernel once with int4 weights and with int8 ones that meet its
    conditions).
    """
    spk_g, prompt_g, cfg_rows = check_guidance(guidance_scale, end_of_text_token, end_of_audio_token)
    device = params["wpe"].device
    padded, t_true = pad_to_bucket(prompt_tokens, prompt_pad_multiple, max_len=cfg.block_size)
    max_steps = cfg.block_size - t_true
    if max_new_tokens is not None:
        max_steps = min(max_steps, max_new_tokens)
    if max_steps <= 0:
        raise ValueError("Prompt is too long to generate more tokens")
    if noise is not None and noise.shape[0] < max_steps:
        raise ValueError(f"noise holds {noise.shape[0]} draws, generation may need {max_steps}")
    if kv_cache is None or kv_cache.batch_size != cfg_rows:
        kv_cache = tfm.KVCache.create(cfg, cfg_rows, cfg.block_size, dtype=cache_dtype or compute_dtype,
                                      device=device)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)
    guided = dict(cfg_rows=cfg_rows, prompt_guidance_scale=prompt_g, end_of_text_token=end_of_text_token)

    first = prefill(
        params, cfg,
        torch.as_tensor(padded, dtype=torch.int64, device=device)[None, :],
        t_true, spk, kv_cache, temperature, top_p, spk_g, compute_dtype,
        generator=generator, noise=None if noise is None else noise[0], **guided,
    )

    spk_rows = _cfg_rows(spk, cfg_rows)
    mask = make_spk_cond_mask(1, cfg_rows, device=device)
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
            params, cfg, guidance_rows(cur[:, None], cfg_rows, end_of_text_token),
            positions[pos : pos + 1], spk_rows, mask, compute_dtype,
        )
        out, _, head_done = tfm.apply_blocks(params, cfg, x, None, kv_cache, pos, fused_head=True)
        # head_done: the int4 stack fused the final norm and the int4 tied
        # head, and `out` is already the (cfg_rows, V) f32 logits
        logits = out if head_done else tfm.output_logits(params, cfg, out)[0][:, 0, :]
        sampled = sample_guided(
            logits, spk_g, prompt_g, cfg_rows, temperature, top_p,
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
