"""First-stage 1.2B causal LLM: prefill + decode loop with speaker CFG.

Port of metavoice_tpu/models/first_stage.py: single-utterance generation
(``generate``), the ragged batch (``generate_batch``) and streaming segments
(``generate_segments``), all three on one resumable loop (``decode``):

  * CFG as a leading batch of row groups: row 0 speaker-conditioned, row 1
    unconditioned through a zeroing mask on the speaker projection
    (reference fam/llm/fast_model.py:132-134,156); with a (speaker, prompt)
    guidance tuple whose prompt scale is above 1, a third group keeps the
    speaker but sees its text tokens replaced by end-of-text (reference
    fam/llm/mixins/causal.py:89-105,229-262);
  * prompts right-padded to a 128 bucket; prefill masks against the full
    cache length and samples from the hidden state at ``prompt_len - 1``
    (a batch: left-padded to one bucket, per-row positions and windows,
    the first token from the last column);
  * temperature -> top-p -> Gumbel-max sampling on the device;
  * an end-of-audio latch on the device: rows that are done keep emitting
    EOA. The host reads the latch only every ``DONE_CHECK_EVERY`` steps, not
    every token; the steps it runs past the end cannot change the output,
    since finished rows only emit EOA and are not counted. A batch row has
    its own latch and may take per-row temperature, top-p and guidance.

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
def decode(
    params: tfm.Params,
    cfg: TransformerConfig,
    cur_token: torch.Tensor,  # (B,) the last sampled token of each row, not yet in the cache
    pos: int,  # the slot of the next cache write
    kv_cache: tfm.KVCache,
    spk_emb: torch.Tensor,  # (B, spk_dim)
    max_steps: int,
    *,
    temperature=1.0,
    top_p=0.95,
    guidance_scale=3.0,
    cfg_rows: int = 2,
    prompt_guidance_scale: float = 1.0,
    pad_lens: torch.Tensor | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    end_of_text_token: int = 0,
    compute_dtype=torch.bfloat16,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The resumable decode loop (JAX ``decode`` and ``decode_batch``): from
    ``(cur_token, pos, kv_cache)`` run at most ``max_steps`` T=1 steps, never
    past the cache's last slot -> ``(tokens (B, max_steps), lengths (B,))``
    on the device; ``tokens[b, :lengths[b]]`` are row b's sampled tokens,
    the end-of-audio token included when it came. Rows that are done emit
    EOA; the host reads the latch every ``DONE_CHECK_EVERY`` steps and stops
    when every row is done. The cache is written in place; the last sampled
    token is not in it yet (it is the next call's ``cur_token``).

    ``pad_lens`` (B,) makes it the ragged batch's loop: row b's left
    padding, so its logical position is ``pos - pad_lens[b]`` and it
    attends ``[pad_lens[b], pos]`` (the kernels' ``starts``).
    ``temperature``, ``top_p`` and ``guidance_scale`` are scalars or (B, 1)
    tensors (per row). ``noise`` (n >= steps, B, V): the Gumbel noise of
    each step's draw. ``stats["decode_steps"]`` adds the steps run.
    """
    b = cur_token.shape[0]
    device = cur_token.device
    spk_rows = _cfg_rows(spk_emb, cfg_rows)
    mask = make_spk_cond_mask(b, cfg_rows, device=device)
    starts = None if pad_lens is None else _cfg_rows(pad_lens.to(device=device, dtype=torch.int32), cfg_rows)
    slots = torch.arange(kv_cache.max_seq_len, device=device)
    eoa = torch.full_like(cur_token, end_of_audio_token)
    tokens = torch.full((b, max_steps), end_of_audio_token, dtype=torch.int64, device=device)
    lengths = torch.zeros_like(cur_token)
    done = cur_token == end_of_audio_token
    cur = cur_token
    steps = 0
    for step in range(max(0, min(max_steps, kv_cache.max_seq_len - pos))):
        if step % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        p = pos + step
        positions = slots[p : p + 1] if starts is None else (p - starts).long()[:, None]
        x = tfm.embed_inputs(
            params, cfg, guidance_rows(cur[:, None], cfg_rows, end_of_text_token),
            positions, spk_rows, mask, compute_dtype,
        )
        out, _, head_done = tfm.apply_blocks(params, cfg, x, None, kv_cache, p, attn_starts=starts, fused_head=True)
        # head_done: the int4 stack fused the final norm and the int4 tied
        # head, and `out` is already the (rows, V) f32 logits
        logits = out if head_done else tfm.output_logits(params, cfg, out)[0][:, 0, :]
        sampled = sample_guided(
            logits, guidance_scale, prompt_guidance_scale, cfg_rows, temperature, top_p,
            generator=generator, noise=None if noise is None else noise[step],
        )
        nxt = torch.where(done, eoa, sampled)  # finished rows stay frozen on EOA
        tokens[:, step] = nxt
        lengths += (~done).to(lengths.dtype)
        done = done | (nxt == end_of_audio_token)
        cur = nxt
        steps += 1
    if stats is not None:
        stats["decode_steps"] = stats.get("decode_steps", 0) + steps
    return tokens, lengths


def _budget(cfg: TransformerConfig, used: int, max_new_tokens: int | None, noise, what: str) -> int:
    """New tokens a prompt of ``used`` slots may take; checks the noise."""
    budget = cfg.block_size - used
    if max_new_tokens is not None:
        budget = min(budget, max_new_tokens)
    if budget <= 0:
        raise ValueError(f"{what} too long to generate more tokens")
    if noise is not None and noise.shape[0] < budget:
        raise ValueError(f"noise holds {noise.shape[0]} draws, generation may need {budget}")
    return budget


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
    """Single-utterance generation (batch 1): prefill, then :func:`decode`
    until end-of-audio, ``max_new_tokens`` or the block size. Returns
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
    max_steps = _budget(cfg, t_true, max_new_tokens, noise, "Prompt is")
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
    run = {}
    tokens, lengths = decode(
        params, cfg, first, t_true, kv_cache, spk, max_steps - 1,
        temperature=temperature, top_p=top_p, guidance_scale=spk_g, end_of_audio_token=end_of_audio_token,
        compute_dtype=compute_dtype, generator=generator, noise=None if noise is None else noise[1:],
        stats=run, **guided,
    )
    if stats is not None:
        stats["decode_steps"] = run["decode_steps"]
    n = int(lengths[0])
    return np.concatenate([
        np.asarray(prompt_tokens, np.int32),
        first.cpu().numpy().astype(np.int32),
        tokens[0, :n].cpu().numpy().astype(np.int32),
    ])


# --------------------------------------------------------------------------------------
# Ragged batched generation
# --------------------------------------------------------------------------------------
#
# As in the JAX package: every prompt is LEFT-padded to one bucket T, each
# row gets its logical positions max(arange(T) - pad_len, 0) and the
# attention window [pad_len_row, pos] (the decode kernels' ``starts``), so
# all rows prefill and decode in lockstep at one physical position.


def left_pad_prompts(prompts: list, bucket: int, pad_id: int = 0):
    """list of 1-D int sequences -> ((B, bucket) int32, pad_lens (B,) int32);
    a prompt longer than the bucket keeps its last ``bucket`` tokens."""
    b = len(prompts)
    out = np.full((b, bucket), pad_id, np.int32)
    pad_lens = np.zeros((b,), np.int32)
    for i, p in enumerate(prompts):
        p = np.asarray(p, np.int32)[-bucket:]
        out[i, bucket - len(p):] = p
        pad_lens[i] = bucket - len(p)
    return out, pad_lens


def _batch_masks(pad_lens2: torch.Tensor, t: int, s: int) -> torch.Tensor:
    """(2B, 1, T, S) prefill mask: the query at slot i sees slot j iff j <= i
    and j >= the row's pad length. A query inside the padding sees no slot;
    the -1e30 fill spreads its softmax over the whole (finite) cache layer,
    as in the JAX package, and no real query reads its rows."""
    q_pos = torch.arange(t, device=pad_lens2.device)
    kv_pos = torch.arange(s, device=pad_lens2.device)
    causal = q_pos[:, None] >= kv_pos[None, :]
    valid = kv_pos[None, :] >= pad_lens2[:, None]
    return causal[None, None] & valid[:, None, None, :]


@torch.inference_mode()
def prefill_batch(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompts: torch.Tensor,  # (B, T) left-padded
    pad_lens: torch.Tensor,  # (B,)
    spk_emb: torch.Tensor,  # (B, spk_dim)
    kv_cache: tfm.KVCache,  # 2B rows
    temperature,
    top_p,
    guidance_scale,
    compute_dtype=torch.bfloat16,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Ragged prefill of the CFG rows ``[B cond; B uncond]``, the cache
    written in place; samples each row's first token from the last column
    -> (B,). Knobs: scalars or (B, 1) tensors. A bucket of at most
    ``MULTI_MAX_T`` (16) tokens is refused: such a cached forward takes the
    short-window route, whose window starts at ``min(start, cache_pos)``,
    so it cannot hide the left padding at slot 0."""
    b, t = prompts.shape
    if t <= tfm.MULTI_MAX_T:
        raise ValueError(f"a batch prompt bucket must exceed {tfm.MULTI_MAX_T} tokens, got {t}")
    pad2 = _cfg_rows(pad_lens)
    positions = (torch.arange(t, device=prompts.device)[None, :] - pad_lens[:, None].long()).clamp(min=0)
    x = tfm.embed_inputs(params, cfg, _cfg_rows(prompts), _cfg_rows(positions), _cfg_rows(spk_emb),
                         make_spk_cond_mask(b, device=prompts.device), compute_dtype)
    x, _ = tfm.apply_blocks(params, cfg, x, _batch_masks(pad2, t, kv_cache.max_seq_len), kv_cache, 0)
    logits = tfm.output_logits(params, cfg, x[:, -1:, :])[0][:, 0, :]
    return sample_guided(logits, guidance_scale, 1.0, 2, temperature, top_p, generator=generator, noise=noise)


def _per_row(v, b: int, device) -> torch.Tensor:
    """A scalar or a length-B sequence -> a (B, 1) f32 tensor."""
    return torch.broadcast_to(torch.as_tensor(np.asarray(v, np.float32).reshape(-1)), (b,)).reshape(b, 1).to(device)


@torch.inference_mode()
def generate_batch(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompts: list,  # B ragged int sequences
    spk_embs,  # (B, spk_dim), numpy or tensor
    *,
    generator: torch.Generator | None = None,
    temperature=1.0,  # scalar or a length-B sequence
    top_p=0.95,  # scalar or per row
    guidance_scale=3.0,  # scalar or per row (speaker CFG on 2 cache rows)
    max_new_tokens: int | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    prompt_pad_multiple: int = 128,
    compute_dtype=torch.bfloat16,
    cache_dtype=None,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
) -> list[np.ndarray]:
    """Decode a ragged batch -> B int32 arrays of generated tokens (prompt
    not included, EOA included when emitted).

    The prompts are left-padded to one bucket (:func:`left_pad_prompts`),
    prefilled together (:func:`prefill_batch`) and decoded in lockstep
    (:func:`decode` with ``pad_lens``) on ``2B`` cache rows; each row has
    its own EOA latch. The knobs take per-row sequences, as (B, 1) tensors
    through the temperature, top-p and CFG math. ``noise`` (n, B, V): the
    Gumbel noise of the n-th sampled token of every row (n = 0: the
    prefill's). ``stats["decode_steps"]``: the T=1 forwards run.
    """
    device = params["wpe"].device
    b = len(prompts)
    longest = max(len(p) for p in prompts)
    bucket = min(-(-longest // prompt_pad_multiple) * prompt_pad_multiple, cfg.block_size)
    padded, pad_lens = left_pad_prompts(prompts, bucket)
    max_steps = _budget(cfg, bucket, max_new_tokens, noise, "Prompts are")
    knobs = dict(temperature=_per_row(temperature, b, device), top_p=_per_row(top_p, b, device),
                 guidance_scale=_per_row(guidance_scale, b, device))
    kv = tfm.KVCache.create(cfg, 2 * b, cfg.block_size, dtype=cache_dtype or compute_dtype, device=device)
    spk = torch.as_tensor(np.asarray(spk_embs, np.float32)).reshape(b, -1).to(device)
    pads = torch.as_tensor(pad_lens, device=device)
    first = prefill_batch(params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=device), pads, spk, kv,
                          compute_dtype=compute_dtype, generator=generator,
                          noise=None if noise is None else noise[0], **knobs)
    tokens, lengths = decode(
        params, cfg, first, bucket, kv, spk, max_steps - 1, pad_lens=pads, end_of_audio_token=end_of_audio_token,
        compute_dtype=compute_dtype, generator=generator, noise=None if noise is None else noise[1:],
        stats=stats, **knobs,
    )
    # one host transfer for the whole batch
    fetch = torch.cat([first[:, None], lengths[:, None], tokens], dim=1).cpu().numpy().astype(np.int32)
    return [np.concatenate([fetch[i, :1], fetch[i, 2 : 2 + fetch[i, 1]]]) for i in range(b)]


# --------------------------------------------------------------------------------------
# Streaming segment generation (time to first audio)
# --------------------------------------------------------------------------------------


@torch.inference_mode()
def generate_segments(
    params: tfm.Params,
    cfg: TransformerConfig,
    prompt_tokens,
    spk_emb,
    *,
    generator: torch.Generator | None = None,
    segment_tokens: int = 150,  # 75 frames = 1 s of audio a segment
    first_segment_tokens: int | None = None,  # a smaller first segment: sooner first audio
    temperature: float = 1.0,
    top_p: float = 0.95,
    guidance_scale: float | tuple[float, float] = 3.0,
    max_new_tokens: int | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    end_of_text_token: int = 0,
    prompt_pad_multiple: int = 128,
    compute_dtype=torch.bfloat16,
    cache_dtype=None,
    kv_cache: tfm.KVCache | None = None,
    noise: torch.Tensor | None = None,
    stats: dict | None = None,
):
    """Yield the generated tokens in segments (int32 arrays) instead of one
    final array; joined they are :func:`generate`'s tokens after the prompt
    under the same draws.

    Each segment resumes :func:`decode` from the carried ``(cur, pos,
    cache)`` with one host read; the first ``first_segment_tokens`` (then
    ``segment_tokens``) tokens make a segment, both even so the h0/h1
    interleaving splits into whole EnCodec frames. The prefill's token is
    not read before the first decode runs; if it was EOA, that decode is
    dropped and the stream is that token alone. The stream ends at EOA
    (included) or when the budget runs out. ``kv_cache``, ``noise`` and
    ``stats`` as in :func:`generate`.
    """
    if segment_tokens % 2 != 0:
        raise ValueError("segment_tokens must be even (whole interleaved frames)")
    if first_segment_tokens is None:
        first_segment_tokens = segment_tokens
    if first_segment_tokens % 2 != 0:
        raise ValueError("first_segment_tokens must be even")
    spk_g, prompt_g, cfg_rows = check_guidance(guidance_scale, end_of_text_token, end_of_audio_token)
    device = params["wpe"].device
    padded, t_true = pad_to_bucket(prompt_tokens, prompt_pad_multiple, max_len=cfg.block_size)
    budget = _budget(cfg, t_true, max_new_tokens, noise, "Prompt is")
    kv = kv_cache
    if kv is None or kv.batch_size != cfg_rows:
        kv = tfm.KVCache.create(cfg, cfg_rows, cfg.block_size, dtype=cache_dtype or compute_dtype, device=device)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)
    guided = dict(cfg_rows=cfg_rows, prompt_guidance_scale=prompt_g, end_of_text_token=end_of_text_token)
    cur = prefill(
        params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=device)[None, :], t_true, spk, kv,
        temperature, top_p, spk_g, compute_dtype, generator=generator,
        noise=None if noise is None else noise[0], **guided,
    )
    pos = t_true
    pending: list[int] = []
    seed_pending = 1  # the unread prefill token heads `pending`
    emitted = 1
    target = first_segment_tokens  # then segment_tokens
    while emitted < budget and pos < cfg.block_size:
        step_budget = min(target - len(pending) - seed_pending, budget - emitted, cfg.block_size - pos)
        if step_budget <= 0:
            break
        tokens, lengths = decode(
            params, cfg, cur, pos, kv, spk, step_budget, temperature=temperature, top_p=top_p,
            guidance_scale=spk_g, end_of_audio_token=end_of_audio_token, compute_dtype=compute_dtype,
            generator=generator, noise=None if noise is None else noise[emitted : emitted + step_budget],
            stats=stats, **guided,
        )
        next_cur = tokens[:, (lengths[0] - 1).clamp(min=0)]  # stays on the device
        fetch = torch.cat([cur.reshape(-1), lengths.reshape(-1), tokens[0]]).cpu().numpy().astype(np.int32)
        seed_tok, n = int(fetch[0]), int(fetch[1])
        toks = fetch[2 : 2 + n]
        if seed_pending:
            if seed_tok == end_of_audio_token:
                yield np.asarray([seed_tok], np.int32)
                return
            pending.append(seed_tok)
            seed_pending = 0
        pending.extend(int(t) for t in toks)
        emitted += n
        pos += n
        done = n > 0 and toks[-1] == end_of_audio_token
        if len(pending) >= target or done or emitted >= budget:
            yield np.asarray(pending, np.int32)
            pending = []
            target = segment_tokens
        if done or n == 0:
            return
        cur = next_cur
    if seed_pending:  # the loop never ran (a budget of 1): the prefill token alone
        pending = [int(cur[0])] + pending
    if pending:
        yield np.asarray(pending, np.int32)


# --------------------------------------------------------------------------------------
# Mid-flight batch joining and group rebase (continuous serving)
# --------------------------------------------------------------------------------------
#
# As in the JAX package: the slot-pool engine (runtime/engine.py) decodes one
# shared cache in lockstep at one PHYSICAL position while each row keeps its
# own LOGICAL timeline (``decode(pad_lens=...)`` embeds ``pos - pad_len``). A
# request joins mid-decode by prefilling a 2-row temp cache and landing those
# rows so that its prompt ENDS at the group's position P (``merge_slot_*``);
# a group near the block's end slides its valid prefix toward the origin
# (``shift_*_left``). Both are in-place writes to the cache's tensors, with
# the JAX functions' names, arguments and bits (their start indices clamped
# as ``dynamic_slice`` clamps them).

REBASE_ALIGN = 128  # rebase shifts are multiples of this (see _shift_seq_left)


def _clamp_start(start: int, size: int, dim: int) -> int:
    """A dynamic_slice start: clamped so that the ``size`` span fits ``dim``."""
    return min(max(int(start), 0), dim - size)


def _land(big: torch.Tensor, part: torch.Tensor, starts: tuple) -> None:
    """``big`` = dynamic_update_slice(big, part, starts), in place."""
    idx = tuple(slice(s0, s0 + n) for s0, n in
                ((_clamp_start(s, n, d), n) for s, n, d in zip(starts, part.shape, big.shape)))
    big[idx] = part


@torch.inference_mode()
def merge_slot_cache(k, v, tk, tv, phys_start: int, row_c: int, row_u: int):
    """Copy a joining request's prefilled KV rows into the shared cache, in
    place: the temp cache's (L, Tpad, 2, H, Dh) row 0 to row ``row_c`` and
    row 1 to ``row_u`` of the (L, S, 2B, H, Dh) cache at positions
    ``[phys_start, phys_start + Tpad)`` -> (k, v)."""
    for big, tmp in ((k, tk), (v, tv)):
        _land(big, tmp[:, :, 0:1], (0, phys_start, row_c, 0, 0))
        _land(big, tmp[:, :, 1:2], (0, phys_start, row_u, 0, 0))
    return k, v


@torch.inference_mode()
def merge_slot_scales(ks, vs, tks, tvs, phys_start: int, row_c: int, row_u: int, n_head: int):
    """int8-cache variant: land the temp's (L, Tpad, 1, bhpad) scale columns
    ``[0, h)`` and ``[h, 2h)`` at columns ``row_c * h`` and ``row_u * h``
    of the (L, S, 1, BHpad) tables, in place -> (ks, vs)."""
    h = n_head
    for big, tmp in ((ks, tks), (vs, tvs)):
        _land(big, tmp[..., 0:h], (0, phys_start, 0, row_c * h))
        _land(big, tmp[..., h : 2 * h], (0, phys_start, 0, row_u * h))
    return ks, vs


def _merge_window(sw: int, tw: int, phys_start: int) -> tuple[int, int, int, int]:
    """The packed merge's word window, as the JAX package cuts it: ``nw``
    words from ``wbase`` -> (wbase, nw, lo, hi), the absolute positions
    ``[lo, hi)`` of the window that take a temp position."""
    nw = min(tw + 1, sw)
    wbase = min(max(phys_start // tfm.KV_PACK, 0), sw - nw)
    lo = max(phys_start, tfm.KV_PACK * wbase)
    hi = min(phys_start + tfm.KV_PACK * tw, tfm.KV_PACK * (wbase + nw))
    return wbase, nw, lo, hi


def _merge_packed_words(big: torch.Tensor, tmp: torch.Tensor, phys_start: int, row: int) -> None:
    """Byte-granular landing of one temp row, in place: ``big`` (L, Sw, 2B,
    H, Dh) int32 words, ``tmp`` (L, Tw, H, Dh) the temp row's words holding
    positions ``[0, 4*Tw)``, landed at ``[phys_start, phys_start + 4*Tw)``
    of batch row ``row`` at ANY alignment of ``phys_start``: the window's
    words are unpacked, the span written, and the words packed again, so
    the other bytes of the edge words and every other row keep their bits."""
    wbase, nw, lo, hi = _merge_window(big.shape[1], tmp.shape[1], phys_start)
    if hi <= lo:
        return
    old = big[:, wbase : wbase + nw, row]  # (L, NW, H, Dh)
    vals = tfm.unpack_kv_s(old.transpose(0, 1))  # (4*NW, L, H, Dh)
    src = tfm.unpack_kv_s(tmp.transpose(0, 1))  # (4*Tw, L, H, Dh)
    base = tfm.KV_PACK * wbase
    vals[lo - base : hi - base] = src[lo - phys_start : hi - phys_start]
    big[:, wbase : wbase + nw, row] = tfm.pack_kv_s(vals).transpose(0, 1)


@torch.inference_mode()
def merge_slot_cache_packed(k, v, tk, tv, phys_start: int, row_c: int, row_u: int):
    """Packed-cache variant of :func:`merge_slot_cache`: the temp's (L, Tw,
    2, H, Dh) words land byte by byte at any ``phys_start`` -> (k, v)."""
    for big, tmp in ((k, tk), (v, tv)):
        _merge_packed_words(big, tmp[:, :, 0], phys_start, row_c)
        _merge_packed_words(big, tmp[:, :, 1], phys_start, row_u)
    return k, v


def _merge_packed_scales(big: torch.Tensor, tmp: torch.Tensor, phys_start: int, col: int, h: int) -> None:
    """Residue-split table merge, in place: ``big`` (L, 4, Sw, 1, BHpad),
    ``tmp`` (L, 4, Tw, 1, h) one temp row's head columns; temp position t
    lands at absolute ``phys_start + t`` (residue row ``p % 4``, word
    ``p // 4``), columns ``[col, col + h)``."""
    wbase, nw, lo, hi = _merge_window(big.shape[2], tmp.shape[2], phys_start)
    if hi <= lo:
        return
    col = _clamp_start(col, h, big.shape[-1])
    p = torch.arange(lo, hi, device=big.device)
    t = p - phys_start
    cols = big[..., col : col + h]  # a view: the index_put below writes big
    cols[:, p % tfm.KV_PACK, p // tfm.KV_PACK] = tmp[:, t % tfm.KV_PACK, t // tfm.KV_PACK]


@torch.inference_mode()
def merge_slot_scales_packed(ks, vs, tks, tvs, phys_start: int, row_c: int, row_u: int, n_head: int):
    """Packed-cache variant of :func:`merge_slot_scales` -> (ks, vs)."""
    h = n_head
    for big, tmp in ((ks, tks), (vs, tvs)):
        _merge_packed_scales(big, tmp[..., 0:h], phys_start, row_c * h, h)
        _merge_packed_scales(big, tmp[..., h : 2 * h], phys_start, row_u * h, h)
    return ks, vs


def _shift_seq_left(arrs: tuple, s: int, chunk: int, pos: int | None, axis: int = 1) -> tuple:
    """Shift ``axis`` of every tensor left by ``s``, in place, chunk by chunk.

    Iteration i copies ``[s + i*C, s + (i+1)*C)`` to ``[i*C, (i+1)*C)``, the
    read start clamped to ``S - C`` as JAX's dynamic_slice clamps it. Going
    up, no read overlaps an earlier write, and a chunk whose read overlaps
    its own write (``s < C``, or a clamped read at the end) is copied out
    first: ``Tensor.copy_`` between overlapping slices of one tensor is not
    defined. Only one chunk is ever held apart; the prefix is never cloned.
    ``s`` must be a multiple of ``chunk`` (the engine floors it to
    ``REBASE_ALIGN``) for the valid prefix to come out exact. ``pos`` (the end
    of the valid prefix) bounds the copy to ``ceil((pos - s) / C)`` chunks,
    else the whole axis is swept. A sequence length that is not a multiple
    of the chunk (toy configurations) takes JAX's roll, exact for any ``s``.
    """
    size = arrs[0].shape[axis]
    if size % chunk:
        for a in arrs:
            a.copy_(torch.roll(a, -s, dims=axis))
        return arrs
    n = size // chunk
    if pos is not None:
        n = min(max(-(-(pos - s) // chunk), 0), n)
    for a in arrs:
        for i in range(n):
            src = _clamp_start(s + i * chunk, chunk, size)
            dst = i * chunk
            if src == dst:
                continue
            block = a.narrow(axis, src, chunk)
            if abs(src - dst) < chunk:
                block = block.clone()
            a.narrow(axis, dst, chunk).copy_(block)
    return arrs


@torch.inference_mode()
def shift_cache_left(k, v, s: int, pos: int | None = None):
    """Slide the valid prefix of the (L, S, B, H, Dh) cache left by ``s``,
    in place; ``pos`` (the end of the valid prefix) bounds the copy ->
    (k, v)."""
    return _shift_seq_left((k, v), int(s), 128, None if pos is None else int(pos))


@torch.inference_mode()
def shift_scales_left(ks, vs, s: int, pos: int | None = None):
    """int8-cache variant: slide the (L, S, 1, BHpad) scale tables too."""
    return _shift_seq_left((ks, vs), int(s), 128, None if pos is None else int(pos))


@torch.inference_mode()
def shift_cache_left_packed(k, v, s: int, pos: int | None = None):
    """Packed-cache variant: the (L, S/4, B, H, Dh) words shift by ``s // 4``.
    ``s`` must be a multiple of 4 (``REBASE_ALIGN`` is), which keeps every
    byte lane in place: the shifted prefix is that of the int8 cache
    shifted and packed again."""
    return _shift_seq_left((k, v), int(s) // tfm.KV_PACK, 32,
                           None if pos is None else (int(pos) + 3) // tfm.KV_PACK)


@torch.inference_mode()
def shift_scales_left_packed(ks, vs, s: int, pos: int | None = None):
    """Packed-cache variant: the residue-split (L, 4, S/4, 1, BHpad) tables
    shift along their word axis (axis 2) by ``s // 4``."""
    return _shift_seq_left((ks, vs), int(s) // tfm.KV_PACK, 32,
                           None if pos is None else (int(pos) + 3) // tfm.KV_PACK, axis=2)
