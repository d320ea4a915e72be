"""Speculative decoding for the first stage: draft-propose, verify-in-one-pass.

Port of metavoice_tpu/models/spec_decode.py. A small draft model proposes
``gamma`` tokens one at a time; the target scores all of them in ONE cached
forward of T = gamma tokens (its attention is the multi-query decode kernel,
ops/attention.py:decode_attention_multi, on the card; packed int4/int8
projections run through their matmul kernels); a rejection-sampling step
accepts a prefix whose marginal distribution equals ordinary sampling from
the target (Leviathan et al., "Fast Inference from Transformers via
Speculative Decoding").

Semantics kept from the JAX package:

  * a round is gamma draft steps then one verify; there is no bonus token,
    so a round yields at most gamma tokens, and rounds run while
    ``pos + gamma <= min(block sizes)``; the emission budget of a round is
    what ``max_new_tokens`` leaves;
  * an end-of-audio token emitted within a round truncates it there;
  * stale cache rows need no rollback: rows above ``pos`` after a rejection
    stay in both caches, the causal window never reads them, and the next
    round overwrites them;
  * CFG comes along: the target runs its 2- or 3-row guidance batch and the
    accept test works on the final sampled distribution (guidance-merged,
    temperature-scaled, top-p-masked: core/sampling.logits_to_probs). A
    CFG-free draft (``draft_use_cfg=False``) runs one conditioned row;
    ``draft_temperature``/``draft_top_p`` shape the proposal q only, and q
    is what the accept test records.

Unlike the JAX package's single ``while_loop`` program, the rounds are a host
loop: the host reads ``n_emit`` (with the tokens and the done latch, one
small transfer) once per round to advance ``pos``, so each round costs one
host sync. A device-resident loop or a CUDA graph of the round is later
work. Random draws come from an explicit ``torch.Generator``, or are injected
(``SpecDraws``) so that tests can hand both packages the same numbers.

Scope: batch size 1 (single-stream latency).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from metavoice_tpu_torch.core import sampling as S
from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm


class SpecDraws(NamedTuple):
    """Injected random draws of one speculative generation, in place of the
    generator's, indexed by round: the prefill's Gumbel noise (1, V), the
    draft's Gumbel noise (R, gamma, V), the accept test's uniforms
    (R, gamma) and the residual draw's Gumbel noise (R, V)."""

    prefill: torch.Tensor
    draft: torch.Tensor
    uniform: torch.Tensor
    residual: torch.Tensor

    @classmethod
    def sample(cls, rounds: int, gamma: int, vocab: int, *, device="cpu", generator=None) -> "SpecDraws":
        def g(*shape):
            return S.gumbel_noise(shape, device=device, generator=generator)

        u = torch.rand((rounds, gamma), device=device, generator=generator)
        return cls(prefill=g(1, vocab), draft=g(rounds, gamma, vocab), uniform=u, residual=g(rounds, vocab))

    def to(self, device) -> "SpecDraws":
        return SpecDraws(*(t.to(device) for t in self))


def accept_emit(
    drafted: torch.Tensor,  # (..., G) int: draft proposals d_1..d_G
    q: torch.Tensor,  # (..., G, V) f32: the distributions each d_i was drawn from
    p: torch.Tensor,  # (..., G, V) f32: the target's at the same positions
    end_of_audio_token: int,
    limit=None,  # int or (...) int tensor: the emission budget
    *,
    generator: torch.Generator | None = None,
    uniforms: torch.Tensor | None = None,  # (..., G) in [0, 1)
    residual_noise: torch.Tensor | None = None,  # (..., V) Gumbel
):
    """Rejection sampling over one speculation window (any leading dims).

    Accept d_i with probability min(1, p_i(d_i) / q_i(d_i)); at the first
    rejection j, emit a replacement drawn from normalize(max(p_j - q_j, 0))
    (Gumbel-max over its logs, as ``jax.random.categorical``) and stop.
    Returns (emitted (..., G), n_emit (...), done (...), n_accepted (...)):
    the first ``n_emit`` of ``emitted`` are valid; ``done`` latches when an
    end-of-audio token lands inside the emitted prefix (which then stops at
    it); ``n_accepted`` counts draft acceptances before EOA/limit truncation.
    ``uniforms`` and ``residual_noise`` replace the generator's draws.
    """
    g = drafted.shape[-1]
    dev = p.device
    if uniforms is None:
        uniforms = torch.rand(drafted.shape, device=dev, generator=generator)
    if residual_noise is None:
        residual_noise = S.gumbel_noise(p.shape[:-2] + p.shape[-1:], device=dev, generator=generator)
    idx = drafted.long()[..., None]
    q_d = torch.gather(q, -1, idx)[..., 0]
    p_d = torch.gather(p, -1, idx)[..., 0]
    acc = uniforms < torch.clamp(p_d / torch.clamp(q_d, min=1e-30), max=1.0)
    keep = torch.cumprod(acc.to(torch.int64), dim=-1)  # longest accepted prefix
    n_acc = keep.sum(-1)
    rej = n_acc < g
    j = torch.clamp(n_acc, max=g - 1)
    at_j = j[..., None, None].expand(*j.shape, 1, p.shape[-1])
    pj = torch.gather(p, -2, at_j)[..., 0, :]
    qj = torch.gather(q, -2, at_j)[..., 0, :]
    r = torch.clamp(pj - qj, min=0.0)
    rs = r.sum(-1, keepdim=True)
    # p == q leaves the residual empty, but rejection then has probability
    # 0; the fallback to pj only guards numerical dust
    r_dist = torch.where(rs > 1e-12, r / torch.clamp(rs, min=1e-30), pj)
    repl = torch.argmax(torch.log(r_dist + 1e-30) + residual_noise.to(dev), dim=-1)
    rows = torch.arange(g, device=dev)
    emitted = torch.where((rows == j[..., None]) & rej[..., None], repl[..., None], drafted.long())
    n_emit = torch.where(rej, j + 1, torch.full_like(j, g))
    if limit is not None:
        n_emit = torch.minimum(n_emit, torch.as_tensor(limit, device=dev))
    is_eoa = (emitted == end_of_audio_token) & (rows < n_emit[..., None])
    eoa_pos = torch.where(is_eoa, rows, torch.full_like(rows, g)).amin(-1)
    done = eoa_pos < n_emit
    n_emit = torch.where(done, eoa_pos + 1, n_emit)
    return emitted, n_emit, done, n_acc


def _guided_probs(logits, cfg_rows: int, spk_g: float, prompt_g: float, temperature: float, top_p: float):
    """(cfg_rows, ..., V) raw logits -> (..., V) final sampled distribution."""
    if cfg_rows == 3:
        merged = S.cfg_merge3(logits, spk_g, prompt_g)
    elif cfg_rows == 2:
        merged = S.cfg_merge(logits, spk_g)
    else:
        merged = logits
    return S.logits_to_probs(merged[0], temperature, top_p)


@torch.inference_mode()
def generate_spec(
    params_t: tfm.Params,
    cfg_t: TransformerConfig,
    params_d: tfm.Params,
    cfg_d: TransformerConfig,
    prompt_tokens,
    spk_emb,
    *,
    generator: torch.Generator | None = None,
    gamma: int = 4,
    temperature: float = 1.0,
    top_p: float = 0.95,
    guidance_scale: float | tuple[float, float] = 3.0,
    max_new_tokens: int | None = None,
    end_of_audio_token: int = T.END_OF_AUDIO_TOKEN,
    end_of_text_token: int = 0,
    prompt_pad_multiple: int = 128,
    compute_dtype=torch.bfloat16,
    return_stats: bool = False,
    draft_use_cfg: bool = True,
    draft_temperature: float | None = None,
    draft_top_p: float | None = None,
    kv_cache: tfm.KVCache | None = None,
    draws: SpecDraws | None = None,
):
    """Speculative generation (batch 1) with :func:`first_stage.generate`'s
    contract: returns [prompt ++ first ++ emitted] as a 1-D int32 numpy array
    (EOA included if emitted).

    Both models prefill the prompt (the target's prefill samples the first
    token; the draft's only fills its cache). Near the context limit a
    generation can come up to ``gamma - 1`` tokens shorter than
    ``first_stage.generate``'s, since a round needs ``gamma`` free cache rows.
    ``return_stats=True`` also returns ``{"accepted", "proposed", "rounds",
    "emitted"}``: ``accepted / proposed`` is the draft acceptance rate,
    ``emitted / rounds`` the tokens per target forward.

    ``draft_use_cfg=False`` runs the draft on one conditioned row (exact for
    any proposal distribution). ``draft_temperature``/``draft_top_p``
    (default: the target's) shape the proposal only. ``kv_cache``: the
    target's cache to reuse (it must hold the guidance rows); the draft's is
    made here. Both caches are bf16 or whatever ``compute_dtype`` is, as in
    the JAX package: a quantized ``kv_cache`` is left untouched and a float
    one made in its place.
    ``draws`` replaces every random draw (tests).
    """
    spk_g, prompt_g, cfg_rows = fs.check_guidance(guidance_scale, end_of_text_token, end_of_audio_token)
    device = params_t["wpe"].device
    padded, t_true = fs.pad_to_bucket(prompt_tokens, prompt_pad_multiple, max_len=cfg_t.block_size)
    max_steps = cfg_t.block_size - t_true
    if max_new_tokens is not None:
        max_steps = min(max_steps, max_new_tokens)
    if max_steps <= 0:
        raise ValueError("Prompt is too long to generate more tokens")
    draft_rows = cfg_rows if draft_use_cfg else 1
    if kv_cache is None or kv_cache.batch_size != cfg_rows or kv_cache.quantized:
        kv_cache = tfm.KVCache.create(cfg_t, cfg_rows, cfg_t.block_size, dtype=compute_dtype, device=device)
    kv_d = tfm.KVCache.create(cfg_d, draft_rows, cfg_d.block_size, dtype=compute_dtype, device=device)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)
    prompt = torch.as_tensor(padded, dtype=torch.int64, device=device)[None, :]
    if draws is not None:
        draws = draws.to(device)

    first = fs.prefill(
        params_t, cfg_t, prompt, t_true, spk, kv_cache, temperature, top_p, spk_g, compute_dtype,
        cfg_rows=cfg_rows, prompt_guidance_scale=prompt_g, end_of_text_token=end_of_text_token,
        generator=generator, noise=None if draws is None else draws.prefill,
    )
    fs.fill_cache(params_d, cfg_d, prompt, spk, kv_d, compute_dtype,
                  cfg_rows=draft_rows, end_of_text_token=end_of_text_token)

    d_temp = temperature if draft_temperature is None else draft_temperature
    d_top_p = top_p if draft_top_p is None else draft_top_p
    spk_t = fs._cfg_rows(spk, cfg_rows)
    spk_d = fs._cfg_rows(spk, draft_rows)
    mask_t = fs.make_spk_cond_mask(1, cfg_rows, device=device)
    mask_d = fs.make_spk_cond_mask(1, draft_rows, device=device)
    positions = torch.arange(cfg_t.block_size, device=device)
    block_limit = min(cfg_t.block_size, cfg_d.block_size)
    budget = max_steps - 1  # tokens after the prefill's

    out: list[int] = []
    cur = first  # (1,) on the device
    pos = t_true
    done = int(first[0]) == end_of_audio_token
    n_accepted = rounds = 0
    while not done and len(out) < budget and pos + gamma <= block_limit:
        if draws is not None and rounds >= draws.uniform.shape[0]:
            raise ValueError(f"draws hold {draws.uniform.shape[0]} rounds, generation needs more")
        drafted, qs = [], []
        cur_d = cur
        for i in range(gamma):
            x = tfm.embed_inputs(params_d, cfg_d, fs.guidance_rows(cur_d[:, None], draft_rows, end_of_text_token),
                                 positions[pos + i : pos + i + 1], spk_d, mask_d, compute_dtype)
            h, _ = tfm.apply_blocks(params_d, cfg_d, x, None, kv_d, pos + i)
            logits = tfm.output_logits(params_d, cfg_d, h)[0][:, 0, :]
            qdist = _guided_probs(logits, draft_rows, spk_g, prompt_g, d_temp, d_top_p)  # (V,)
            noise = (S.gumbel_noise(qdist.shape, device=device, generator=generator)
                     if draws is None else draws.draft[rounds, i])
            cur_d = torch.argmax(torch.log(qdist + 1e-30) + noise, dim=-1, keepdim=True)
            drafted.append(cur_d)
            qs.append(qdist)
        drafted = torch.cat(drafted)  # (G,)
        # verify: the target consumes [cur, d_1..d_{G-1}] at [pos, pos+G)
        tok_v = torch.cat([cur, drafted[:-1]])[None, :]
        x = tfm.embed_inputs(params_t, cfg_t, fs.guidance_rows(tok_v, cfg_rows, end_of_text_token),
                             positions[pos : pos + gamma], spk_t, mask_t, compute_dtype)
        h, _ = tfm.apply_blocks(params_t, cfg_t, x, None, kv_cache, pos)
        ps = _guided_probs(tfm.output_logits(params_t, cfg_t, h)[0], cfg_rows, spk_g, prompt_g,
                           temperature, top_p)  # (G, V)
        emitted, n_emit, done_t, n_acc = accept_emit(
            drafted, torch.stack(qs), ps, end_of_audio_token, limit=budget - len(out),
            generator=generator,
            uniforms=None if draws is None else draws.uniform[rounds],
            residual_noise=None if draws is None else draws.residual[rounds],
        )
        # the round's one host sync: n_emit, done, n_accepted and the tokens
        fetched = torch.cat([torch.stack([n_emit, done_t.long(), n_acc]), emitted]).tolist()
        n, done, acc = fetched[0], bool(fetched[1]), fetched[2]
        out += fetched[3 : 3 + n]
        cur = emitted[n - 1 : n]
        pos += n
        n_accepted += acc
        rounds += 1
    seq = np.concatenate([
        np.asarray(prompt_tokens, np.int32),
        first.cpu().numpy().astype(np.int32),
        np.asarray(out, np.int32),
    ])
    if return_stats:
        return seq, {"accepted": n_accepted, "proposed": rounds * gamma, "rounds": rounds,
                     "emitted": len(out)}
    return seq
