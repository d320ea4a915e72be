"""Sampling primitives over tensors: temperature, top-k, top-p, CFG, Gumbel-max.

Port of metavoice_tpu/core/sampling.py with the same semantics (reference
fam/llm/fast_inference_utils.py): temperature floor 1e-5, top-k keeps ties
with the k-th value, the sort-free top-p with its tie rule, CFG
``g * cond + (1 - g) * uncond`` and its 3-row (speaker, prompt) form.
Sampling is Gumbel-max, as
``jax.random.categorical`` is: ``argmax(logits + G)`` with standard Gumbel
noise G, drawn from an explicit ``torch.Generator``. Tests inject the noise
(``noise=``) so both packages see the same draws.

``temperature``, ``top_p`` and the guidance scales are Python scalars or
tensors that broadcast against the logits' leading axes, as the JAX
package's traced operands do: a ragged batch passes (B, 1) tensors, one
value a row (models/first_stage.generate_batch). Inside a CUDA-graph
capture they must be tensors (the decode step's, refilled before each
replay): a Python scalar would be baked into the graph, and a later call
at another value would replay the old one, so it raises there.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite "-inf" that keeps softmax numerics exact in bf16/f32


def knob(value, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A sampling knob (a Python scalar or a tensor) as a tensor on
    ``like``'s device in ``dtype`` (default ``like``'s); a tensor that is
    already so is returned as it is. A Python scalar during a CUDA-graph
    capture raises: the graph would keep its value for every replay."""
    dtype = dtype or like.dtype
    if not isinstance(value, torch.Tensor) and like.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a sampling knob captured in a CUDA graph must be a device tensor refilled before "
                           f"each replay, not the Python value {value!r}")
    return torch.as_tensor(value, dtype=dtype, device=like.device)


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """logits / max(temperature, 1e-5); reference fast_inference_utils.py:92.
    ``temperature``: a scalar or a (B, 1) tensor for (B, V) logits."""
    t = torch.clamp(knob(temperature, logits), min=1e-5)
    return logits / t


def top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but the top-k logits (last axis); ties with the k-th are kept."""
    k = min(int(k), logits.shape[-1])
    pivot = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < pivot, torch.full_like(logits, NEG_INF), logits)


def top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filtering over the last axis, the JAX package's sort-free form.

    Keep token i iff the exclusive cumulative probability of all
    strictly-higher-ranked tokens is < top_p; the top token is always kept.
    At a tie on the boundary value the lowest vocabulary ids are kept
    (metavoice_tpu/core/sampling.py:47-80). ``top_p``: a scalar or a (B, 1)
    tensor; the cut and the tie rule hold row by row.
    """
    top_p = knob(top_p, logits, torch.float32)
    lf = logits.float()
    sorted_desc = torch.sort(lf, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    cum_excl = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_excl < top_p
    keep_sorted[..., :1] = True  # a slice, not a 0-d element: a 1-D row fills in place under a CUDA-graph capture
    k = keep_sorted.sum(dim=-1, keepdim=True)  # >= 1
    c = torch.gather(sorted_desc, -1, k - 1)  # smallest kept value
    gt = lf > c
    eq = lf == c
    n_gt = gt.sum(dim=-1, keepdim=True)
    m = k - n_gt  # ties at c to keep (lowest vocab ids first)
    tie_rank = torch.cumsum(eq.to(torch.int64), dim=-1) - 1
    keep = gt | (eq & (tie_rank < m))
    return torch.where(keep, logits, torch.full_like(logits, NEG_INF))


def cfg_merge(logits: torch.Tensor, guidance_scale: float) -> torch.Tensor:
    """(2B, V) [cond; uncond] -> (B, V): g * cond + (1 - g) * uncond; g a
    scalar or a (B, 1) tensor."""
    cond, uncond = torch.chunk(logits, 2, dim=0)
    g = knob(guidance_scale, logits)
    return g * cond + (1.0 - g) * uncond


def cfg_merge3(logits: torch.Tensor, spkemb_guidance_scale: float, prompt_guidance_scale: float) -> torch.Tensor:
    """(3B, V) [cond; speaker-uncond; prompt-uncond] -> (B, V):
    ``base * cond + (1 - g_spk) * uncond_spk + (1 - g_prompt) * uncond_prompt``
    with ``base = g_spk + g_prompt - 1`` (reference fam/llm/mixins/causal.py:89-105)."""
    cond, uncond_spk, uncond_prompt = torch.chunk(logits, 3, dim=0)
    g_s = knob(spkemb_guidance_scale, logits)
    g_p = knob(prompt_guidance_scale, logits)
    base = g_s + g_p - 1.0
    return base * cond + (1.0 - g_s) * uncond_spk + (1.0 - g_p) * uncond_prompt


def logits_to_probs(
    logits: torch.Tensor, temperature: float = 1.0, top_p: float | None = None, top_k: int | None = None
) -> torch.Tensor:
    """Temperature -> top-k -> top-p -> softmax in f32: the distribution that
    ``sample_from_logits`` draws from."""
    logits = apply_temperature(logits, temperature)
    if top_k is not None:
        logits = top_k_mask(logits, top_k)
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    return torch.softmax(logits.float(), dim=-1)


def gumbel_noise(shape, *, device, generator: torch.Generator | None = None) -> torch.Tensor:
    """Standard Gumbel noise, -log(E) with E ~ Exp(1), in f32."""
    e = torch.empty(shape, dtype=torch.float32, device=device).exponential_(generator=generator)
    return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))


def sample_from_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_p: float | None = None,
    top_k: int | None = None,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One token per row of ``logits`` (..., V) -> (...,) int64.

    ``noise`` (same shape as logits) replaces the Gumbel draw from
    ``generator``; tests pass the noise the JAX side uses.
    """
    logits = apply_temperature(logits, temperature)
    if top_k is not None:
        logits = top_k_mask(logits, top_k)
    if top_p is not None:
        logits = top_p_mask(logits, top_p)
    if noise is None:
        noise = gumbel_noise(logits.shape, device=logits.device, generator=generator)
    return torch.argmax(logits.float() + noise.to(logits.device), dim=-1)


def sample_cfg(
    logits: torch.Tensor,
    guidance_scale: float,
    temperature: float = 1.0,
    top_p: float | None = None,
    top_k: int | None = None,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """CFG merge then sample. ``logits``: (2B, V) -> (B,) int64 tokens."""
    merged = cfg_merge(logits, guidance_scale)
    return sample_from_logits(
        merged, temperature, top_p, top_k, generator=generator, noise=noise
    )


def sample_cfg3(
    logits: torch.Tensor,
    spkemb_guidance_scale: float,
    prompt_guidance_scale: float,
    temperature: float = 1.0,
    top_p: float | None = None,
    top_k: int | None = None,
    *,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Double-CFG merge then sample. ``logits``: (3B, V) -> (B,) int64 tokens."""
    merged = cfg_merge3(logits, spkemb_guidance_scale, prompt_guidance_scale)
    return sample_from_logits(
        merged, temperature, top_p, top_k, generator=generator, noise=noise
    )
