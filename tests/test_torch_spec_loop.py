"""The speculative round as a device loop, on the CPU at a small size.

* ``generate_spec`` (the round on a ``SpecState`` of device tensors, run
  eagerly off the card) against the JAX package's ``spec_decode.generate_spec``:
  greedy, and at temperature 1 under JAX's own draws replayed through
  ``SpecDraws``, at 2 and 3 guidance rows, with a CFG and a CFG-free draft;
* the device loop against the host loop (``generate_spec_eager``) bit for
  bit where a generation ends: end-of-audio inside a round, the budget, the
  block limit, an end-of-audio first token, under injected draws and under
  a generator (whose state ends where the host loop leaves it);
* a round that JAX's ``cond`` would not run changes no field of the carry,
  and a round reads nothing back to the host;
* the graph loop (a stub capture whose replay runs the round eagerly)
  gives the host loop's tokens, one capture a window bucket, each replay
  credited with the round's launches, and ``TTS.warmup`` with a draft
  captures every bucket;
* K4's plain version with a device ``pos`` at T = 2..16 gives the host
  int's bits in one window, and JAX's Pallas K4 (interpret mode) within
  ``Y_TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.models import spec_decode as jsd  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import spec_decode as sd  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402
from test_torch_graph_decode import _StubGraph, no_host_reads, stub_capture  # noqa: E402,F401

_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

# EOA 96, text ids 97..., eot 120: the scaled-down token space of tests/test_torch_spec_decode.py
EOA, EOT, VOCAB = 96, 120, 121
TINY = jfirst_stage_config(n_layer=2, n_head=4, dim=64, block_size=128, vocab_sizes=(VOCAB,))
DRAFT = jfirst_stage_config(n_layer=1, n_head=2, dim=32, block_size=128, vocab_sizes=(VOCAB,))
PROMPT = [100, 101, 102, 103, 5, 17]
SPK = np.ones((256,), np.float32)
# the port-only pair of the loop cases: 512 slots, so that rounds cross the window buckets 384 and 512
LOOP_T = dict(n_layer=2, n_head=4, dim=64, block_size=512, vocab_sizes=(VOCAB,))
LOOP_D = dict(n_layer=1, n_head=2, dim=32, block_size=512, vocab_sizes=(VOCAB,))
Y_TOL = 1e-5  # K4 in f32 against JAX's Pallas K4: of max |ref|, only the summation order differs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(key, cfg):
    params = _jax_init(jax.random.PRNGKey(key), cfg=cfg, dtype=jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu", dtype=torch.float32)
    return params, port, TransformerConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_models():
    return _pair(0, TINY), _pair(7, DRAFT)


@pytest.fixture(scope="module")
def models():
    gen = torch.Generator().manual_seed(3)
    cfg_t, cfg_d = first_stage_config(**LOOP_T), first_stage_config(**LOOP_D)
    return (tfm.init_params(cfg_t, device="cpu", generator=gen, dtype=torch.float32), cfg_t,
            tfm.init_params(cfg_d, device="cpu", generator=gen, dtype=torch.float32), cfg_d)


# ------------------------------------------------------------------ against the JAX package


def _jax_draws(key, rounds: int, gamma: int) -> sd.SpecDraws:
    """The draws JAX's generate_spec takes from ``key``, as SpecDraws: the
    prefill's Gumbel noise, then each round's split (draft keys, accept
    key), every ``jax.random.categorical`` a Gumbel-max over its noise."""
    k_prefill, k = jax.random.split(key)
    draft, uniform, residual = [], [], []
    for _ in range(rounds):
        k, k_draft, k_acc = jax.random.split(k, 3)
        draft.append(np.stack([np.asarray(jax.random.gumbel(dk, (VOCAB,))) for dk in jax.random.split(k_draft, gamma)]))
        ku, kr = jax.random.split(k_acc)
        uniform.append(np.asarray(jax.random.uniform(ku, (gamma,))))
        residual.append(np.asarray(jax.random.gumbel(kr, (VOCAB,))))
    return sd.SpecDraws(*(torch.from_numpy(np.array(a, np.float32)) for a in (
        jax.random.gumbel(k_prefill, (1, VOCAB)), draft, uniform, residual)))


@pytest.mark.parametrize("draft_use_cfg", [True, False])
@pytest.mark.parametrize("guidance", [3.0, (2.0, 1.5)])
@pytest.mark.parametrize("sampling", ["greedy", "jax-draws"])
def test_device_loop_matches_jax_generate_spec(jax_models, sampling, guidance, draft_use_cfg):
    (jp, p, cfg), (jdp, dp, dcfg) = jax_models
    gamma, max_new = (4, 16) if draft_use_cfg else (3, 14)
    knobs = dict(temperature=1e-6, top_p=1.0) if sampling == "greedy" else dict(temperature=1.0, top_p=0.95)
    common = dict(gamma=gamma, guidance_scale=guidance, max_new_tokens=max_new, end_of_audio_token=EOA,
                  end_of_text_token=EOT, prompt_pad_multiple=16, return_stats=True, draft_use_cfg=draft_use_cfg,
                  **knobs)
    key = jax.random.PRNGKey(21)
    want, want_stats = jsd.generate_spec(jp, TINY, jdp, DRAFT, PROMPT, jnp.asarray(SPK), key=key,
                                         compute_dtype=jnp.float32, **common)
    draws = _jax_draws(key, max_new, gamma)
    stats = {}
    got, got_stats = sd.generate_spec(p, cfg, dp, dcfg, PROMPT, SPK, compute_dtype=torch.float32, stats=stats,
                                      draws=draws if sampling == "jax-draws" else None,
                                      generator=torch.Generator().manual_seed(5), **common)
    np.testing.assert_array_equal(got, want)
    assert got_stats == want_stats
    assert stats["decode_route"] == "spec" and stats["spec_loop"] == "eager"  # the CPU has no graphs


# ------------------------------------------------------------------ the device loop against the host loop


def _draws(rounds, gamma, seed, *, eoa_free=True, forced=(), first_eoa=False) -> sd.SpecDraws:
    """Injected draws; ``eoa_free``: end-of-audio is never drawn; ``forced``:
    (round, k) pairs where the round accepts its first k proposals (uniform
    0, top-p 1 keeps every p > 0), rejects the next and replaces it by
    end-of-audio (its residual noise); ``first_eoa``: the prefill draws it."""
    d = sd.SpecDraws.sample(rounds, gamma, VOCAB, generator=torch.Generator().manual_seed(seed))
    if eoa_free:
        for t in (d.prefill, d.draft, d.residual):
            t[..., EOA] = -1e4
    for r, k in forced:
        d.uniform[r, :k] = 0.0
        d.uniform[r, k:] = 1.0  # never below min(1, p / q)
        d.residual[r, EOA] = 1e4
    if first_eoa:
        d.prefill[..., EOA] = 1e4
    return d


# name: (prompt length, max_new_tokens, gamma, guidance, draft_use_cfg, draws or None: the generator's)
LOOP_CASES = {
    "eoa-mid-round": (40, None, 4, 3.0, True, dict(forced=((5, 2),))),
    "eoa-first-in-round": (40, None, 4, 3.0, True, dict(forced=((8, 0),))),
    "budget-cut": (40, 23, 4, 3.0, True, {}),
    "block-limit": (360, None, 4, 3.0, True, {}),
    "prefill-eoa": (40, None, 4, 3.0, True, dict(first_eoa=True)),
    "three-rows-cfg-free": (370, 40, 3, (2.0, 1.5), False, dict(forced=((6, 1),))),
    "generator": (360, 48, 4, 3.0, True, None),
    "generator-cfg-free-eoa": (40, None, 5, 3.0, False, None),
}


def _caches(cfg_t, cfg_d, rows, draft_rows):
    return (tfm.KVCache.create(cfg_t, rows, cfg_t.block_size, dtype=torch.float32, device="cpu"),
            tfm.KVCache.create(cfg_d, draft_rows, cfg_d.block_size, dtype=torch.float32, device="cpu"))


def _run_both(models, name):
    """One case through the host loop and ``generate_spec`` -> ((tokens,
    stats, caches, generator state) of each, ``generate_spec``'s ``stats``
    dict)."""
    p, cfg_t, dp, cfg_d = models
    n_prompt, max_new, gamma, guidance, use_cfg, draws = LOOP_CASES[name]
    prompt = (np.arange(n_prompt) % 20 + 97).tolist()
    rows = fs._normalize_guidance(guidance)[2]
    knobs = dict(gamma=gamma, guidance_scale=guidance, max_new_tokens=max_new, end_of_audio_token=EOA,
                 end_of_text_token=EOT, prompt_pad_multiple=8, compute_dtype=torch.float32, return_stats=True,
                 draft_use_cfg=use_cfg, temperature=1.0, top_p=1.0 if draws else 0.9)
    runs, loop_stats = [], {}
    for fn in (sd.generate_spec_eager, sd.generate_spec):
        kv_t, kv_d = _caches(cfg_t, cfg_d, rows, rows if use_cfg else 1)
        gen = torch.Generator().manual_seed(9)
        extra = {} if fn is sd.generate_spec_eager else dict(stats=loop_stats)
        tokens, stats = fn(p, cfg_t, dp, cfg_d, prompt, SPK, generator=gen, kv_cache=kv_t, draft_kv_cache=kv_d,
                           draws=None if draws is None else _draws(cfg_t.block_size, gamma, 4, **draws),
                           **knobs, **extra)
        runs.append((tokens, stats, (kv_t, kv_d), gen.get_state()))
    return runs, loop_stats


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_device_loop_equals_the_host_loop(models, name):
    ((te, se, (kt_e, kd_e), ge), (tg, sg, (kt_g, kd_g), gg)), stats = _run_both(models, name)
    n_prompt, max_new, gamma, *_ = LOOP_CASES[name]
    np.testing.assert_array_equal(tg, te)
    assert sg == se
    assert torch.equal(gg, ge)  # the idle rounds' draws were given back
    pos = n_prompt + se["emitted"]  # both caches hold the same rows below pos (idle rounds write only above it)
    for a, b in ((kt_g, kt_e), (kd_g, kd_e)):
        assert torch.equal(a.k[:, :pos], b.k[:, :pos]) and torch.equal(a.v[:, :pos], b.v[:, :pos])
    ended = {"eoa-mid-round": te[-1] == EOA, "eoa-first-in-round": te[-1] == EOA, "prefill-eoa": len(te) == n_prompt + 1,
             "budget-cut": len(te) == n_prompt + max_new if max_new else True,
             "block-limit": pos + gamma > 512 and te[-1] != EOA}
    assert ended.get(name, True), (name, len(te), te[-3:])
    assert stats["spec_rounds_run"] >= se["rounds"] and stats["spec_reads"] >= 1
    if name in ("budget-cut", "block-limit"):  # no idle round: a round that could pass the end waits for a read
        assert stats["spec_rounds_run"] == se["rounds"]
    if se["rounds"] >= 16:  # a read every SPEC_CHECK_EVERY rounds, more often only near the end
        assert stats["spec_reads"] <= se["rounds"] // sd.SPEC_CHECK_EVERY + gamma + 2, stats


def test_draws_shorter_than_the_generation_raise(models):
    p, cfg_t, dp, cfg_d = models
    kw = dict(max_new_tokens=40, end_of_audio_token=EOA, compute_dtype=torch.float32, prompt_pad_multiple=8)
    for fn in (sd.generate_spec_eager, sd.generate_spec):
        with pytest.raises(ValueError, match="draws hold 3 rounds"):
            fn(p, cfg_t, dp, cfg_d, PROMPT, SPK, gamma=4, draws=_draws(3, 4, 1), **kw)
        with pytest.raises(ValueError, match="gamma must be in 1..16"):
            fn(p, cfg_t, dp, cfg_d, PROMPT, SPK, gamma=17, **kw)


# ------------------------------------------------------------------ one round on the carry


def _carry(models, pos, *, budget=64, done=False, out_len=0, block_limit=None, gamma=4):
    p, cfg_t, dp, cfg_d = models
    spec = sd.RoundSpec(gamma, 2, 2, block_limit or cfg_t.block_size, EOA, 0, torch.float32)
    first = torch.tensor([7])
    st = sd.init_spec_state(first, pos, torch.ones(1, 256), budget, spec, temperature=1.0, top_p=0.9,
                            draft_temperature=0.8, draft_top_p=0.9, guidance=3.0, prompt_guidance=1.0,
                            draws=_draws(8, gamma, 2, eoa_free=False))
    st.done.fill_(done)
    st.out_len.fill_(out_len)
    st.rounds.fill_(2)
    kv_t, kv_d = _caches(cfg_t, cfg_d, 2, 2)
    for t in (kv_t.k, kv_t.v, kv_d.k, kv_d.v):
        t.copy_(torch.randn(t.shape, generator=torch.Generator().manual_seed(8)))
    return spec, st, kv_t, kv_d


@pytest.mark.parametrize("why", ["done", "budget-spent", "block-limit", "active"])
def test_a_round_jax_would_not_run_changes_no_field(models, why):
    p, cfg_t, dp, cfg_d = models
    pos = 300
    spec, st, kv_t, kv_d = _carry(models, pos, done=why == "done", budget=20, out_len=20 if why == "budget-spent" else 5,
                                  block_limit=pos + 3 if why == "block-limit" else None)
    before = {f.name: getattr(st, f.name).clone() for f in dataclasses.fields(st) if getattr(st, f.name) is not None}
    with no_host_reads():
        sd.spec_round(p, cfg_t, dp, cfg_d, kv_t, kv_d, st, spec, A.attention_window(pos + 4, 512))
    changed = {k for k, v in before.items() if not torch.equal(v, getattr(st, k))}
    if why == "active":
        n = int(st.pos) - pos
        assert 1 <= n <= 4 and changed >= {"pos", "out_len", "rounds", "cur", "out"}
        assert int(st.out_len) == 5 + n and int(st.rounds) == 3 and (st.out[5 : 5 + n] != EOA).any()
    else:
        assert not changed, changed


# ------------------------------------------------------------------ the graph loop, a stub capture


@pytest.fixture
def stub_round_capture(monkeypatch):
    """``RoundGraphs.capture`` on the CPU: no graph, a replay that runs the
    round eagerly, credited with what a capture of the round counts on the
    card (K4 once a target layer, K1 gamma times a draft layer); records the
    windows captured. ``graphs_on`` says yes."""
    captured = []

    def capture(self, params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, window):
        captured.append(window)
        credits = []
        with fs.uncounted(credits):
            A.decode_attention_multi.launches += cfg_t.n_layer
            A.decode_attention.launches += self.spec.gamma * cfg_d.n_layer
        graph = _StubGraph(lambda: sd.spec_round(params_t, cfg_t, params_d, cfg_d, kv_t, kv_d, self.state, self.spec,
                                                 window, self.generator))
        return graph, credits

    monkeypatch.setattr(sd.RoundGraphs, "capture", capture)
    monkeypatch.setattr(fs, "graphs_on", lambda device: True)
    fs.release_graphs()
    yield captured
    fs.release_graphs()


def test_graph_loop_equals_the_host_loop_and_credits_launches(models, stub_round_capture):
    p, cfg_t, dp, cfg_d = models
    before = (A.decode_attention_multi.launches, A.decode_attention.launches)
    runs, stats = _run_both(models, "block-limit")
    (te, se, *_), (tg, sg, *_) = runs
    np.testing.assert_array_equal(tg, te)
    assert sg == se and stats["spec_loop"] == "graph"
    assert stub_round_capture == [384, 512]  # one capture a bucket, each after an eager warm round
    replays = stats["spec_rounds_run"] - len(stub_round_capture)
    assert A.decode_attention_multi.launches - before[0] == cfg_t.n_layer * replays
    assert A.decode_attention.launches - before[1] == 4 * cfg_d.n_layer * replays


def test_graph_sets_keyed_by_both_caches(models, stub_round_capture):
    p, cfg_t, dp, cfg_d = models
    kv_t, kv_d = _caches(cfg_t, cfg_d, 2, 2)
    kw = dict(gamma=4, max_new_tokens=12, end_of_audio_token=EOA, compute_dtype=torch.float32, prompt_pad_multiple=8,
              kv_cache=kv_t, generator=torch.Generator().manual_seed(1))
    outs = [sd.generate_spec(p, cfg_t, dp, cfg_d, PROMPT, SPK, draft_kv_cache=kv_d, **kw) for _ in range(2)]
    assert stub_round_capture == [384]  # the second call replays the first one's graph
    sd.generate_spec(p, cfg_t, dp, cfg_d, PROMPT, SPK, draft_kv_cache=_caches(cfg_t, cfg_d, 2, 2)[1], **kw)
    assert stub_round_capture == [384, 384]  # another draft cache: another set
    assert len(outs[0]) > len(PROMPT) + 1


def test_tts_warmup_with_a_draft_captures_every_round_bucket(stub_round_capture, stub_capture, tmp_path):
    from metavoice_tpu_torch.runtime.tts import TTS

    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    tts = TTS(small.c, device="cpu", output_dir=str(tmp_path), draft_params=small.c.first_stage_params,
              draft_cfg=small.c.first_stage_cfg, speculative_gamma=4, draft_use_cfg=False)
    tts.warmup(prompt_buckets=(128,), vocoder_frame_buckets=(25,), guidance_variants=(3.0,))
    assert stub_round_capture == [384, 512] and stub_capture == [384]  # the warm generate's own step
    assert tts._draft_kv_cache(3.0).batch_size == 1 and tts._draft_kv_cache(3.0) is tts._draft_kv_caches[1]


# ------------------------------------------------------------------ K4 with a device pos at T > 1


def _k4(t, h_kv, pos, *, s=1024, starts=None, nan=False, seed=0):
    rng = np.random.default_rng(seed)
    b, h, dh = 2, 4, 64
    arrays = [rng.normal(size=shape).astype(np.float32) for shape in
              ((b, h, t, dh), (b, h_kv, t, dh), (b, h_kv, t, dh), (2, s, b, h_kv, dh), (2, s, b, h_kv, dh))]
    if nan:  # garbage past the new rows
        for c in arrays[3:]:
            c[:, pos + t :] = np.nan
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    return arrays, st


def _port_k4(arrays, pos, st, window):
    t = [torch.from_numpy(a.copy()) for a in arrays]
    y, kc, vc = A.decode_attention_multi(*t, 1, pos, st, window=window)
    return y, kc, vc


@pytest.mark.parametrize("t", [2, 4, 8, 16])
@pytest.mark.parametrize("pos,bigger", [(250, False), (380, False), (500, True), (1000, False)])
def test_k4_device_pos_at_t_gives_the_host_int_bits(t, pos, bigger):
    h_kv = 2 if t in (4, 16) else 4
    arrays, st = _k4(t, h_kv, pos, starts=(0, 200) if t > 4 else None, nan=t == 8)
    window = A.attention_window(pos + t, 1024)
    window = 1024 if bigger else window  # a bucket larger than needed plans the same way both ways
    host = _port_k4(arrays, pos, st, window)
    dev = _port_k4(arrays, torch.tensor(pos, dtype=torch.int32), st, window)
    for a, b in zip(host, dev):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
    assert torch.isfinite(dev[0]).all()
    # the exact window [0, pos + T) of the int call without a bucket: the same attention within rounding
    exact = _port_k4(arrays, pos, st, None)[0]
    torch.testing.assert_close(dev[0], exact, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("t,pos", [(2, 370), (8, 380), (16, 368), (4, 505)])
def test_k4_device_pos_at_t_matches_jax_kernel_interpret(t, pos):
    arrays, st = _k4(t, 2, pos, s=512, starts=(5, 300), seed=t)
    y, kc, vc = _port_k4(arrays, torch.tensor(pos, dtype=torch.int32), st, A.attention_window(pos + t, 512))
    want, kc_j, vc_j = JA.decode_attention_multi(*(jnp.asarray(a) for a in arrays), jnp.asarray(1, jnp.int32),
                                                 jnp.asarray(pos, jnp.int32), starts=jnp.asarray(st.numpy()),
                                                 interpret=True)
    want = np.asarray(want)
    assert np.abs(y.numpy() - want).max() <= Y_TOL * np.abs(want).max()
    np.testing.assert_array_equal(kc.numpy(), np.asarray(kc_j))
    np.testing.assert_array_equal(vc.numpy(), np.asarray(vc_j))


def test_k4_device_pos_window_is_checked():
    arrays, _ = _k4(4, 2, 100, s=512)
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="window 2 of 4 new rows"):
        A.decode_attention_multi(*t, 0, torch.tensor(100, dtype=torch.int32), window=2)
    with pytest.raises(ValueError, match=r"must hold rows \[382, 386\)"):
        A.decode_attention_multi(*t, 0, 382, window=384)
