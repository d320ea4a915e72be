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

As in the JAX package's single ``while_loop`` program, the loop's carry is a
``SpecState`` of device tensors and ``spec_round`` is its round body: gamma
draft steps, the verify and the accept test, in place on the carry and the
caches, reading nothing back to the host. A round that JAX's ``cond`` would
not run (after end-of-audio, with the budget spent, or with ``pos + gamma``
past the block limit) emits and counts nothing. On the card each round is
one replay of a CUDA graph (``RoundGraphs``, one a window bucket), and the
host reads ``[done, out_len, pos, rounds]`` every ``SPEC_CHECK_EVERY``
rounds, more often only where a round could pass the budget or the block
limit (``_Cadence``). ``generate_spec_eager`` is the host loop, one read a
round, the plain version the device loop is held to: it plans every round
at the window bucket the device loop would, so both give the same bits.
Random draws come from an explicit ``torch.Generator``, or are injected
(``SpecDraws``) so that tests can hand both packages the same numbers.

Scope: batch size 1 (single-stream latency).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from metavoice_tpu_torch.core import sampling as S
from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import TransformerConfig
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops.attention import MULTI_MAX_T, attention_window

SPEC_CHECK_EVERY = 4  # speculative rounds between host reads of the carry


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


def _guided_probs(logits, cfg_rows: int, spk_g, prompt_g, temperature, top_p):
    """(cfg_rows, ..., V) raw logits -> (..., V) final sampled distribution;
    the knobs are scalars or 0-d tensors."""
    if cfg_rows == 3:
        merged = S.cfg_merge3(logits, spk_g, prompt_g)
    elif cfg_rows == 2:
        merged = S.cfg_merge(logits, spk_g)
    else:
        merged = logits
    return S.logits_to_probs(merged[0], temperature, top_p)


# --------------------------------------------------------------------------------------
# The round on device tensors, captured in a CUDA graph on the card
# --------------------------------------------------------------------------------------


class RoundSpec(NamedTuple):
    """What a round bakes in."""

    gamma: int
    cfg_rows: int  # the target's guidance rows
    draft_rows: int  # the draft's: cfg_rows, or 1 (a CFG-free draft)
    block_limit: int  # the smaller block size: a round needs pos + gamma <= block_limit
    end_of_audio_token: int
    end_of_text_token: int
    compute_dtype: torch.dtype


@dataclass
class SpecState:
    """The speculative loop's carry on the device (JAX's ``_SpecState``).
    :func:`spec_round` updates every field in place, so a round captured in
    a CUDA graph on a state replays on it; the knobs, speaker rows and
    injected draws are refilled before a call, never baked in."""

    cur: torch.Tensor  # (1,) int64: the last emitted token, not yet in either cache
    pos: torch.Tensor  # () int32: the slot of both caches' next write
    out: torch.Tensor  # (block_limit + gamma,) int64: the tokens emitted after the first, EOA past out_len
    out_len: torch.Tensor  # () int64
    done: torch.Tensor  # () bool: the end-of-audio latch
    n_accepted: torch.Tensor  # () int64: draft proposals accepted
    rounds: torch.Tensor  # () int64: rounds that ran (the row of the injected draws a round reads)
    budget: torch.Tensor  # () int64: tokens the rounds may emit
    temperature: torch.Tensor  # () f32, the target's
    top_p: torch.Tensor  # () f32
    draft_temperature: torch.Tensor  # () f32, the proposal's
    draft_top_p: torch.Tensor  # () f32
    guidance: torch.Tensor  # () f32: the speaker scale
    prompt_guidance: torch.Tensor  # () f32: the prompt scale (3 rows)
    spk_t: torch.Tensor  # (cfg_rows, spk_dim): the target's guidance rows' speaker embeddings
    spk_d: torch.Tensor  # (draft_rows, spk_dim)
    mask_t: torch.Tensor  # (cfg_rows, 1, 1): 1 on the speaker-conditioned rows
    mask_d: torch.Tensor  # (draft_rows, 1, 1)
    draft_noise: torch.Tensor | None  # (R, gamma, V): injected draws (SpecDraws), in place of a generator's
    uniform: torch.Tensor | None  # (R, gamma)
    residual: torch.Tensor | None  # (R, V)


def init_spec_state(first: torch.Tensor, pos: int, spk: torch.Tensor, budget: int, spec: RoundSpec, *,
                    temperature, top_p, draft_temperature, draft_top_p, guidance, prompt_guidance,
                    draws: SpecDraws | None = None) -> SpecState:
    """A fresh carry on ``first``'s device after the prefill's ``first``
    (1,) token at slot ``pos``; ``spk`` (1, spk_dim)."""
    dev = first.device

    def knob(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    def zero():
        return torch.zeros((), dtype=torch.int64, device=dev)

    return SpecState(
        cur=first.to(torch.int64).reshape(1).clone(),
        pos=torch.full((), pos, dtype=torch.int32, device=dev),
        out=torch.full((spec.block_limit + spec.gamma,), spec.end_of_audio_token, dtype=torch.int64, device=dev),
        out_len=zero(),
        done=first.reshape(()) == spec.end_of_audio_token,
        n_accepted=zero(),
        rounds=zero(),
        budget=torch.full((), budget, dtype=torch.int64, device=dev),
        temperature=knob(temperature), top_p=knob(top_p),
        draft_temperature=knob(draft_temperature), draft_top_p=knob(draft_top_p),
        guidance=knob(guidance), prompt_guidance=knob(prompt_guidance),
        spk_t=fs._cfg_rows(spk, spec.cfg_rows), spk_d=fs._cfg_rows(spk, spec.draft_rows),
        mask_t=fs.make_spk_cond_mask(1, spec.cfg_rows, device=dev),
        mask_d=fs.make_spk_cond_mask(1, spec.draft_rows, device=dev),
        draft_noise=None if draws is None else draws.draft.to(dev),
        uniform=None if draws is None else draws.uniform.to(dev),
        residual=None if draws is None else draws.residual.to(dev),
    )


def _positions(pos, n: int, device) -> torch.Tensor:
    """The (n,) positions ``[pos, pos + n)`` of an int or a 0-d tensor ``pos``."""
    first = pos.long().reshape(1) if isinstance(pos, torch.Tensor) else torch.full((1,), pos, device=device)
    return first + torch.arange(n, device=device)


def _draft_steps(params_d, cfg_d, kv_d, st: SpecState, spec: RoundSpec, cur, pos, window: int, noise, generator):
    """gamma T = 1 draft steps from ``cur`` (1,) at slots ``[pos, pos +
    gamma)`` (an int or the carry's device ``pos``), the attention planned
    at ``window`` -> (drafted (G,) int64, q (G, V)): each proposal drawn by
    Gumbel-max from the proposal distribution it records, the noise
    ``noise[i]`` or the generator's."""
    drafted, qs = [], []
    for i in range(spec.gamma):
        p = pos + i
        x = tfm.embed_inputs(params_d, cfg_d, fs.guidance_rows(cur[:, None], spec.draft_rows, spec.end_of_text_token),
                             _positions(p, 1, cur.device), st.spk_d, st.mask_d, spec.compute_dtype)
        h, _ = tfm.apply_blocks(params_d, cfg_d, x, None, kv_d, p, attn_window=window)
        logits = tfm.output_logits(params_d, cfg_d, h)[0][:, 0, :]
        qdist = _guided_probs(logits, spec.draft_rows, st.guidance, st.prompt_guidance, st.draft_temperature,
                              st.draft_top_p)  # (V,)
        nz = S.gumbel_noise(qdist.shape, device=qdist.device, generator=generator) if noise is None else noise[i]
        cur = torch.argmax(torch.log(qdist + 1e-30) + nz, dim=-1, keepdim=True)
        drafted.append(cur)
        qs.append(qdist)
    return torch.cat(drafted), torch.stack(qs)


def _verify(params_t, cfg_t, kv_t, st: SpecState, spec: RoundSpec, cur, drafted, pos, window: int):
    """The target's T = gamma forward over ``[cur, d_1..d_{G-1}]`` at
    ``[pos, pos + G)``, K4 planned at ``window`` -> p (G, V)."""
    tok_v = torch.cat([cur, drafted[:-1]])[None, :]
    x = tfm.embed_inputs(params_t, cfg_t, fs.guidance_rows(tok_v, spec.cfg_rows, spec.end_of_text_token),
                         _positions(pos, spec.gamma, cur.device), st.spk_t, st.mask_t, spec.compute_dtype)
    h, _ = tfm.apply_blocks(params_t, cfg_t, x, None, kv_t, pos, attn_window=window)
    return _guided_probs(tfm.output_logits(params_t, cfg_t, h)[0], spec.cfg_rows, st.guidance, st.prompt_guidance,
                         st.temperature, st.top_p)


def spec_round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, st: SpecState, spec: RoundSpec, window: int,
               generator: torch.Generator | None = None) -> None:
    """One round of the loop (JAX's ``round_body`` under its ``cond``), in
    place on ``st`` and both caches; it reads nothing back to the host.
    gamma draft steps and the T = gamma verify at the carry's ``pos``
    (read on the device, every attention planned at the window bucket
    ``window``, which must hold ``pos + gamma``), then ``accept_emit`` with
    the budget left: the emitted tokens go to ``out`` at ``out_len``, and
    ``cur``, ``pos``, ``out_len``, ``n_accepted``, ``rounds`` and the latch
    advance. A round that JAX's ``cond`` would not run (done, the budget
    spent, ``pos + gamma`` past the block limit) changes no field; it still
    writes cache rows ``[pos, pos + gamma)``, above ``pos`` like rejected
    rows, which no window reads before a later round rewrites them. The
    draws: the injected ones of row ``rounds`` (the last row past the end),
    else the generator's, gamma Gumbel draws, gamma uniforms, the residual's
    Gumbel draw, in that order."""
    g = spec.gamma
    active = ~st.done & (st.out_len < st.budget) & (st.pos + g <= spec.block_limit)
    noise = uniforms = residual = None
    if st.uniform is not None:
        r = st.rounds.clamp(max=st.uniform.shape[0] - 1).reshape(1)
        noise, uniforms, residual = (t.index_select(0, r)[0] for t in (st.draft_noise, st.uniform, st.residual))
    drafted, qs = _draft_steps(params_d, cfg_d, kv_d, st, spec, st.cur, st.pos, window, noise, generator)
    ps = _verify(params_t, cfg_t, kv_t, st, spec, st.cur, drafted, st.pos, window)
    emitted, n_emit, done, n_acc = accept_emit(drafted, qs, ps, spec.end_of_audio_token, st.budget - st.out_len,
                                               generator=generator, uniforms=uniforms, residual_noise=residual)
    n = torch.where(active, n_emit, torch.zeros_like(n_emit))
    rows = torch.arange(g, device=st.out.device)
    slots = st.out_len + rows
    st.out.index_copy_(0, slots, torch.where(rows < n, emitted, st.out.index_select(0, slots)))
    st.cur.copy_(torch.where(active, emitted.index_select(0, (n_emit - 1).clamp(min=0).reshape(1)), st.cur))
    st.pos.add_(n.to(st.pos.dtype))
    st.out_len.add_(n)
    st.n_accepted.add_(torch.where(active, n_acc, torch.zeros_like(n_acc)))
    st.rounds.add_(active.to(st.rounds.dtype))
    st.done.logical_or_(active & done)


class _Cadence:
    """The device loop's host reads and each round's window bucket, from
    what the host last read: ``pos``, ``out_len`` and ``rounds``, and the
    rounds ``k`` run since. A round emits at most gamma tokens, so after k
    rounds ``pos <= pos_read + k * gamma``: round k is planned at the bucket
    ``attention_window(pos_read + (k + 1) * gamma)``, which holds it. A read
    comes every ``SPEC_CHECK_EVERY`` rounds, and before a round that could
    pass the block limit (no replay writes past a cache), the budget (no
    round is run that could only be idle) or the injected draws' rows.
    The host loop keeps one too, so that it plans every round at the device
    loop's bucket."""

    def __init__(self, pos: int, spec: RoundSpec, budget: int, n_draws: int | None):
        self.gamma, self.limit, self.budget, self.n_draws = spec.gamma, spec.block_limit, budget, n_draws
        self.read(pos, 0, 0)

    def read(self, pos: int, out_len: int, rounds: int) -> None:
        self.pos, self.out_len, self.rounds, self.k = pos, out_len, rounds, 0

    def window(self) -> int | None:
        """The next round's window bucket, or None where a read comes first."""
        k, g = self.k, self.gamma
        upper = self.pos + (k + 1) * g
        if (k == SPEC_CHECK_EVERY or upper > self.limit or self.out_len + k * g >= self.budget
                or (self.n_draws is not None and self.rounds + k >= self.n_draws)):
            return None
        return attention_window(upper, self.limit)

    def ran(self) -> None:
        self.k += 1


class RoundGraphs:
    """The CUDA graphs of one round shape: both weight trees and both
    caches, the guidance rows, the draws' source; one graph a window
    bucket, all on one static :class:`SpecState` that a call loads and
    reads back. As ``first_stage.StepGraphs``: weak references to what the
    graphs bake in, one private memory pool, replays on the caller's
    stream, an eager warm round before each capture, each replay credited
    with the launches its capture counted, and a generator of the set's own
    registered with every graph, the caller's state copied in and back out."""

    def __init__(self, spec: RoundSpec, template: SpecState, tensors: list, generator: torch.Generator | None):
        self.spec = spec
        self._refs = [weakref.ref(t) for t in tensors]
        self.state = SpecState(**{f.name: None if getattr(template, f.name) is None
                                  else torch.zeros_like(getattr(template, f.name)) for f in fields(SpecState)})
        self.generator = None if generator is None else torch.Generator(device=template.cur.device)
        self.graphs: dict[int, tuple] = {}  # window -> (CUDAGraph, [(wrapper, counter, launches a replay)])

    def alive(self) -> bool:
        return all(r() is not None for r in self._refs)

    def load(self, state: SpecState, generator: torch.Generator | None) -> None:
        """Copy a fresh carry (and the caller's generator's state) in."""
        for f in fields(SpecState):
            dst = getattr(self.state, f.name)
            if dst is not None:
                dst.copy_(getattr(state, f.name))
        if self.generator is not None:
            self.generator.set_state(generator.get_state())

    def unload(self, generator: torch.Generator | None) -> None:
        """The caller's generator takes the set's state back."""
        if self.generator is not None:
            generator.set_state(self.generator.get_state())

    def round(self, params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, window: int) -> None:
        """One round at the window bucket ``window``: a replay, or, the
        first time, an eager warm round, then the capture of the next."""
        entry = self.graphs.get(window)
        if entry is None:
            spec_round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, self.state, self.spec, window, self.generator)
            self.graphs[window] = self.capture(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, window)
            return
        fs.replay_graph(entry)

    def capture(self, params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, window: int) -> tuple:
        """Capture one round at ``window`` (``first_stage.capture_graph``)."""
        return fs.capture_graph(
            lambda: spec_round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, self.state, self.spec, window,
                               self.generator),
            self.state.cur.device, self.graphs, self.generator)


def round_graphs(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, spec: RoundSpec, state: SpecState,
                 generator: torch.Generator | None) -> RoundGraphs:
    """The graph set of this round shape (``first_stage.graph_set``),
    made on first use."""
    tensors = fs._leaves(params_t) + fs._leaves(params_d) + fs.cache_leaves(kv_t) + fs.cache_leaves(kv_d)
    draws = None if state.uniform is None else tuple(
        tuple(t.shape) for t in (state.draft_noise, state.uniform, state.residual))
    key = ("spec", cfg_t, cfg_d, spec, draws, generator is not None, str(state.cur.device))
    return fs.graph_set(key, tensors, lambda: RoundGraphs(spec, state, tensors, generator))


def round_route(params_d, cfg_d, kv_d, draft_rows: int) -> str:
    """How the round runs on the card (``first_stage.DECODE_ROUTES["spec"]``):
    "graph" where the draft's T = 1 route is a graph route, which every
    single-card route is; a draft on any other raises, never falling back
    to the host loop."""
    route = fs.step_route(params_d, cfg_d, draft_rows, kv_d)
    if fs.DECODE_ROUTES[route] != "graph":
        raise ValueError(f"the draft's decode route {route} is {fs.DECODE_ROUTES[route]}: the speculative round is "
                         "captured in a CUDA graph only on a draft whose steps are")
    return fs.DECODE_ROUTES["spec"]


# --------------------------------------------------------------------------------------
# Generation: the device loop and the host loop
# --------------------------------------------------------------------------------------


def _start(params_t, cfg_t, params_d, cfg_d, prompt_tokens, spk_emb, *, generator, gamma, temperature, top_p,
           guidance_scale, max_new_tokens, end_of_audio_token, end_of_text_token, prompt_pad_multiple,
           compute_dtype, draft_use_cfg, draft_temperature, draft_top_p, kv_cache, draft_kv_cache, draws):
    """Both loops' start: the caches, both prefills and the carry -> (the
    round's spec, the carry, the target's and the draft's caches, the
    budget, the prefill's first token (1,), the prompt's length)."""
    spk_g, prompt_g, cfg_rows = fs.check_guidance(guidance_scale, end_of_text_token, end_of_audio_token)
    if not 1 <= gamma <= MULTI_MAX_T:
        raise ValueError(f"gamma must be in 1..{MULTI_MAX_T} (the verify is one cached forward of K4), got {gamma}")
    device = params_t["wpe"].device
    padded, t_true = fs.pad_to_bucket(prompt_tokens, prompt_pad_multiple, max_len=cfg_t.block_size)
    max_steps = cfg_t.block_size - t_true
    if max_new_tokens is not None:
        max_steps = min(max_steps, max_new_tokens)
    if max_steps <= 0:
        raise ValueError("Prompt is too long to generate more tokens")
    draft_rows = cfg_rows if draft_use_cfg else 1
    spec = RoundSpec(gamma, cfg_rows, draft_rows, min(cfg_t.block_size, cfg_d.block_size), end_of_audio_token,
                     end_of_text_token, compute_dtype)
    if kv_cache is None or kv_cache.batch_size != cfg_rows or kv_cache.quantized:
        kv_cache = tfm.KVCache.create(cfg_t, cfg_rows, cfg_t.block_size, dtype=compute_dtype, device=device)
    if (draft_kv_cache is None or draft_kv_cache.batch_size != draft_rows or draft_kv_cache.quantized
            or draft_kv_cache.max_seq_len < spec.block_limit):
        draft_kv_cache = tfm.KVCache.create(cfg_d, draft_rows, cfg_d.block_size, dtype=compute_dtype, device=device)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(device)
    prompt = torch.as_tensor(padded, dtype=torch.int64, device=device)[None, :]
    first = fs.prefill(
        params_t, cfg_t, prompt, t_true, spk, kv_cache, temperature, top_p, spk_g, compute_dtype,
        cfg_rows=cfg_rows, prompt_guidance_scale=prompt_g, end_of_text_token=end_of_text_token,
        generator=generator, noise=None if draws is None else draws.prefill.to(device),
    )
    fs.fill_cache(params_d, cfg_d, prompt, spk, draft_kv_cache, compute_dtype,
                  cfg_rows=draft_rows, end_of_text_token=end_of_text_token)
    budget = max_steps - 1  # tokens after the prefill's
    st = init_spec_state(first, t_true, spk, budget, spec, temperature=temperature, top_p=top_p,
                         draft_temperature=temperature if draft_temperature is None else draft_temperature,
                         draft_top_p=top_p if draft_top_p is None else draft_top_p, guidance=spk_g,
                         prompt_guidance=prompt_g, draws=draws)
    return spec, st, kv_cache, draft_kv_cache, budget, first, t_true


def _result(prompt_tokens, tokens: list, return_stats: bool, n_accepted: int, rounds: int, gamma: int):
    """[prompt ++ tokens] (the first token and the emitted ones) and the ledger."""
    seq = np.concatenate([np.asarray(prompt_tokens, np.int32), np.asarray(tokens, np.int32)])
    if return_stats:
        return seq, {"accepted": n_accepted, "proposed": rounds * gamma, "rounds": rounds,
                     "emitted": len(tokens) - 1}
    return seq


def _draws_short(n: int) -> ValueError:
    return ValueError(f"draws hold {n} rounds, generation needs more")


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
    draft_kv_cache: tfm.KVCache | None = None,
    draws: SpecDraws | None = None,
    stats: dict | None = None,
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

    The rounds are :func:`spec_round` on a :class:`SpecState`: on the card
    each a replay of the round's CUDA graph (:class:`RoundGraphs`, one a
    window bucket, made on first use), elsewhere the same round run
    eagerly; the host reads the carry every ``SPEC_CHECK_EVERY`` rounds
    (:class:`_Cadence`). A round past the end (end-of-audio met inside an
    interval) emits nothing; its draws are given back, so the generator
    ends where :func:`generate_spec_eager`'s does, and its launches count.
    ``stats`` (a dict) gets ``decode_route`` "spec", ``spec_loop`` ("graph"
    on the card, "eager" elsewhere), and adds ``spec_reads`` (host reads)
    and ``spec_rounds_run`` (rounds run, idle ones included).

    ``draft_use_cfg=False`` runs the draft on one conditioned row (exact for
    any proposal distribution). ``draft_temperature``/``draft_top_p``
    (default: the target's) shape the proposal only. ``kv_cache`` /
    ``draft_kv_cache``: the target's and the draft's caches to reuse (each
    must hold its guidance rows; a round's graphs bake their addresses in,
    so a caller that keeps them keeps its graphs), else made here. Both
    caches are bf16 or whatever ``compute_dtype`` is, as in the JAX
    package: a quantized ``kv_cache`` is left untouched and a float one
    made in its place. ``gamma`` is at most 16 (K4's most query tokens).
    ``draws`` replaces every random draw (tests).
    """
    spec, st, kv_t, kv_d, budget, first, t_true = _start(
        params_t, cfg_t, params_d, cfg_d, prompt_tokens, spk_emb, generator=generator, gamma=gamma,
        temperature=temperature, top_p=top_p, guidance_scale=guidance_scale, max_new_tokens=max_new_tokens,
        end_of_audio_token=end_of_audio_token, end_of_text_token=end_of_text_token,
        prompt_pad_multiple=prompt_pad_multiple, compute_dtype=compute_dtype, draft_use_cfg=draft_use_cfg,
        draft_temperature=draft_temperature, draft_top_p=draft_top_p, kv_cache=kv_cache,
        draft_kv_cache=draft_kv_cache, draws=draws)
    n_draws = None if draws is None else draws.uniform.shape[0]
    cad = _Cadence(t_true, spec, budget, n_draws)
    graphs = None
    gen = generator
    if fs.graphs_on(first.device) and round_route(params_d, cfg_d, kv_d, spec.draft_rows) == "graph":
        graphs = round_graphs(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, spec, st, generator)
        graphs.load(st, generator)
        st, gen = graphs.state, graphs.generator
    snapshots: list = []  # the generator's state before each round since the last read
    reads = runs = 0
    while True:
        window = cad.window()
        if window is None:
            done, out_len, pos, rounds, n_accepted = torch.stack(
                [st.done.long(), st.out_len, st.pos.long(), st.rounds, st.n_accepted]).tolist()
            reads += 1
            if done or out_len >= budget or pos + spec.gamma > spec.block_limit:
                if gen is not None and rounds - cad.rounds < len(snapshots):  # idle rounds: their draws back
                    gen.set_state(snapshots[rounds - cad.rounds])
                break
            if n_draws is not None and rounds >= n_draws:
                raise _draws_short(n_draws)
            cad.read(pos, out_len, rounds)
            snapshots.clear()
            continue
        if gen is not None:
            snapshots.append(gen.get_state())
        if graphs is not None:
            graphs.round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, window)
        else:
            spec_round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, st, spec, window, gen)
        cad.ran()
        runs += 1
    if graphs is not None:
        graphs.unload(generator)
    if stats is not None:
        stats.update(decode_route="spec", spec_loop="eager" if graphs is None else "graph")
        stats["spec_reads"] = stats.get("spec_reads", 0) + reads
        stats["spec_rounds_run"] = stats.get("spec_rounds_run", 0) + runs
    tokens = torch.cat([first.to(torch.int64), st.out[:out_len]]).tolist()
    return _result(prompt_tokens, tokens, return_stats, n_accepted, rounds, spec.gamma)


@torch.inference_mode()
def generate_spec_eager(params_t: tfm.Params, cfg_t: TransformerConfig, params_d: tfm.Params,
                        cfg_d: TransformerConfig, prompt_tokens, spk_emb, *, generator=None, gamma: int = 4,
                        return_stats: bool = False, draws: SpecDraws | None = None, **kw):
    """:func:`generate_spec`'s plain version: the same keyword arguments
    (but ``stats``) and result, the rounds a host loop that reads
    ``n_emit``, the latch, ``n_accepted`` and the tokens back once a round
    (one small transfer) and gives every draft step and verify the host's
    int ``pos``. It runs no idle round. It plans each round at the window
    bucket the device loop would (a :class:`_Cadence` of its own), so on
    the card its kernels give the replays' bits."""
    unknown = set(kw) - set(_START_DEFAULTS)
    if unknown:
        raise TypeError(f"generate_spec_eager got unexpected keyword arguments {sorted(unknown)}")
    spec, st, kv_t, kv_d, budget, first, t_true = _start(
        params_t, cfg_t, params_d, cfg_d, prompt_tokens, spk_emb, generator=generator, gamma=gamma, draws=draws,
        **(_START_DEFAULTS | kw))
    cad = _Cadence(t_true, spec, budget, None if draws is None else draws.uniform.shape[0])
    head = int(first[0])
    out: list[int] = []
    cur = st.cur
    pos = t_true
    done = head == spec.end_of_audio_token
    n_accepted = rounds = 0
    while not done and len(out) < budget and pos + gamma <= spec.block_limit:
        if draws is not None and rounds >= draws.uniform.shape[0]:
            raise _draws_short(draws.uniform.shape[0])
        window = cad.window()
        if window is None:
            cad.read(pos, len(out), rounds)
            window = cad.window()
        drafted, qs = _draft_steps(params_d, cfg_d, kv_d, st, spec, cur, pos, window,
                                   None if draws is None else st.draft_noise[rounds], generator)
        ps = _verify(params_t, cfg_t, kv_t, st, spec, cur, drafted, pos, window)
        emitted, n_emit, done_t, n_acc = accept_emit(
            drafted, qs, ps, spec.end_of_audio_token, limit=budget - len(out), generator=generator,
            uniforms=None if draws is None else st.uniform[rounds],
            residual_noise=None if draws is None else st.residual[rounds],
        )
        # the round's one host sync: n_emit, done, n_accepted and the tokens
        fetched = torch.cat([torch.stack([n_emit, done_t.long(), n_acc]), emitted]).tolist()
        n, done, acc = fetched[0], bool(fetched[1]), fetched[2]
        out += fetched[3 : 3 + n]
        cur = emitted[n - 1 : n]
        pos += n
        n_accepted += acc
        rounds += 1
        cad.ran()
    return _result(prompt_tokens, [head] + out, return_stats, n_accepted, rounds, gamma)


# generate_spec's keyword arguments that _start takes, and their defaults
_START_DEFAULTS = dict(
    temperature=1.0, top_p=0.95, guidance_scale=3.0, max_new_tokens=None, end_of_audio_token=T.END_OF_AUDIO_TOKEN,
    end_of_text_token=0, prompt_pad_multiple=128, compute_dtype=torch.bfloat16, draft_use_cfg=True,
    draft_temperature=None, draft_top_p=None, kv_cache=None, draft_kv_cache=None,
)


@torch.inference_mode()
def capture_spec_graphs(params_t, cfg_t, params_d, cfg_d, kv_cache: tfm.KVCache, draft_kv_cache: tfm.KVCache,
                        spk_emb, *, gamma: int, cfg_rows: int = 2, draft_use_cfg: bool = True,
                        end_of_audio_token: int = T.END_OF_AUDIO_TOKEN, end_of_text_token: int = 0,
                        compute_dtype=torch.bfloat16, generator: torch.Generator | None = None) -> int:
    """Capture the round on these caches at every window bucket, each
    after its eager warm round: up to two rounds from ``window - 2 *
    gamma``, the second a replay. Those slots of both caches are
    overwritten (a prefill and the rounds rewrite every slot before a
    window reads it). ``spk_emb`` (spk_dim,). Returns the rounds run;
    nothing runs off the card."""
    dev = kv_cache.k.device
    draft_rows = cfg_rows if draft_use_cfg else 1
    if not fs.graphs_on(dev) or round_route(params_d, cfg_d, draft_kv_cache, draft_rows) != "graph":
        return 0
    spec = RoundSpec(gamma, cfg_rows, draft_rows, min(cfg_t.block_size, cfg_d.block_size), end_of_audio_token,
                     end_of_text_token, compute_dtype)
    spk = torch.as_tensor(np.asarray(spk_emb, np.float32)).reshape(1, -1).to(dev)
    first = torch.zeros((1,), dtype=torch.int64, device=dev)  # not end-of-audio: the rounds run
    n = 0
    window = attention_window(gamma, spec.block_limit)
    while True:
        rounds = min(2, window // gamma)
        st = init_spec_state(first, window - rounds * gamma, spk, rounds * gamma, spec, temperature=1.0,
                             top_p=0.95, draft_temperature=1.0, draft_top_p=0.95, guidance=3.0, prompt_guidance=1.0)
        graphs = round_graphs(params_t, cfg_t, params_d, cfg_d, kv_cache, draft_kv_cache, spec, st, generator)
        graphs.load(st, generator)
        for _ in range(rounds):
            graphs.round(params_t, cfg_t, params_d, cfg_d, kv_cache, draft_kv_cache, window)
        graphs.unload(generator)
        n += rounds
        if window >= spec.block_limit:
            return n
        window = attention_window(window + 1, spec.block_limit)
