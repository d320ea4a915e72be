"""The port's continuous-batching engine (runtime/engine.py).

Function level, on a 2-layer f32 first stage under greedy sampling
(temperature and top-p 0.01: the argmax, whatever the draws), 32-token
buckets: a request joined at physical offset P decodes the tokens of
``generate_batch`` of that request alone, and a rebased group those of the
unrebased one, on the float, int8 and packed caches; the join schedule gives
the JAX package's tokens on the same weights. Engine level, on
``TTS.from_random(small=True, device="cpu")``: the scheduling behaviours of
the JAX package's tests/test_engine.py, each wait with a timeout.
"""

import os
import random
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core import tokens as T  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine, land_rows, shift_rows  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import phases  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

DIMS = dict(n_layer=2, n_head=4, dim=128, block_size=256, vocab_sizes=(97,), intermediate_size=256)
EOA = 10**6  # never sampled: fixed-length decodes
BUCKET = 32
SLOTS = 2
GREEDY = 0.01  # temperature and top-p
PROMPT_A = [90, 91, 92, 93]
PROMPT_B = [94, 95, 96, 90, 91]
FORMATS = {"float": torch.float32, "int8": "int8", "packed": "int8_packed"}
WAIT = 300  # seconds any engine wait may take


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jfirst_stage_config(**DIMS)
    jparams = _jax_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    spk = np.random.default_rng(1).normal(size=(2, 256)).astype(np.float32)  # A's and B's speakers
    return jcfg, jparams, first_stage_config(**DIMS), params, spk


def _knobs(b):
    return [torch.full((b, 1), v) for v in (GREEDY, GREEDY, 3.0)]


def _prefill(params, cfg, prompts, spk, kv, bucket=BUCKET):
    padded, pads = fs.left_pad_prompts(prompts, bucket)
    first = fs.prefill_batch(params, cfg, torch.as_tensor(padded, dtype=torch.int64), torch.as_tensor(pads),
                             torch.as_tensor(spk), kv, *_knobs(len(prompts)), torch.float32)
    return first, pads


def _decode(params, cfg, cur, pos, pads, spk, kv, steps):
    buf, lens = fs.decode(params, cfg, torch.as_tensor(cur, dtype=torch.int64), pos, kv, torch.as_tensor(spk),
                          steps, pad_lens=torch.as_tensor(pads), end_of_audio_token=EOA,
                          compute_dtype=torch.float32, temperature=_knobs(len(cur))[0],
                          top_p=_knobs(len(cur))[1], guidance_scale=_knobs(len(cur))[2])
    return buf.numpy(), lens.numpy()


def _group_with_join(model, fmt, steps_before):
    """A starts alone in slot 0, decodes ``steps_before`` steps, then B joins
    slot 1 at that physical position -> (kv, pos, pads, spk, cur)."""
    _, _, cfg, params, spk_ab = model
    kv = tfm.KVCache.create(cfg, 2 * SLOTS, cfg.block_size, dtype=FORMATS[fmt], device="cpu")
    spk = np.stack([spk_ab[0], np.zeros_like(spk_ab[0])])
    first, pads = _prefill(params, cfg, [PROMPT_A, [0]], spk, kv)
    # slot 1 holds no request yet: it decodes junk until B's landing overwrites its rows
    buf, _ = _decode(params, cfg, [int(first[0]), 0], BUCKET, pads, spk, kv, steps_before)
    pos = BUCKET + steps_before
    temp = tfm.KVCache.create(cfg, 2, BUCKET, dtype=FORMATS[fmt], device="cpu")
    first_b, _ = _prefill(params, cfg, [PROMPT_B], spk_ab[1:], temp)
    land_rows(kv, temp, pos - BUCKET, 1, SLOTS + 1, DIMS["n_head"])
    spk[1] = spk_ab[1]
    pads = pads.copy()
    pads[1] = pos - len(PROMPT_B)
    return kv, pos, pads, spk, [int(buf[0, -1]), int(first_b[0])]


@pytest.mark.parametrize("fmt,steps_before", [("float", 16), ("int8", 17), ("packed", 16), ("packed", 17),
                                              ("packed", 18), ("packed", 19)])
def test_join_matches_fresh_decode(model, fmt, steps_before):
    """Joined at P = 32 + steps_before (the packed cache at every residue of
    P - bucket), B decodes generate_batch's tokens of B alone."""
    _, _, cfg, params, spk_ab = model
    n = 24
    solo = fs.generate_batch(params, cfg, [PROMPT_B], spk_ab[1:], temperature=GREEDY, top_p=GREEDY,
                             max_new_tokens=n, end_of_audio_token=EOA, prompt_pad_multiple=BUCKET,
                             compute_dtype=torch.float32, cache_dtype=FORMATS[fmt])[0]
    kv, pos, pads, spk, cur = _group_with_join(model, fmt, steps_before)
    joined = [cur[1]]
    for _ in range(3):
        buf, lens = _decode(params, cfg, cur, pos, pads, spk, kv, 8)
        joined += buf[1, : lens[1]].tolist()
        cur = [int(buf[0, -1]), int(buf[1, -1])]
        pos += 8
    np.testing.assert_array_equal(np.asarray(joined[:n]), solo[:n])


def test_join_schedule_matches_jax(model):
    """The join schedule (group prefill, decode, temp prefill, merge, decode)
    gives the JAX package's tokens on the same weights: both slots, every
    segment."""
    jcfg, jparams, cfg, params, spk_ab = model
    kv, pos, pads, spk, cur = _group_with_join(model, "float", 16)
    ours = [cur]
    for _ in range(2):
        buf, _ = _decode(params, cfg, cur, pos, pads, spk, kv, 8)
        cur = [int(buf[0, -1]), int(buf[1, -1])]
        ours.append(buf.tolist())
        pos += 8

    jk = [jnp.full((SLOTS, 1), v, jnp.float32) for v in (GREEDY, GREEDY, 3.0)]
    key = jax.random.PRNGKey(0)
    jkv = jtfm.KVCache.create(jcfg, 2 * SLOTS, jcfg.block_size, dtype=jnp.float32)
    jspk = jnp.asarray(np.stack([spk_ab[0], np.zeros_like(spk_ab[0])]))
    padded, jpads = jfs.left_pad_prompts([PROMPT_A, [0]], BUCKET)
    first, jkv = jfs.prefill_batch(jparams, jcfg, jnp.asarray(padded), jnp.asarray(jpads), jspk, jkv, key, *jk,
                                   compute_dtype=jnp.float32)
    buf, _, jkv = jfs.decode_batch(jparams, jcfg, jnp.asarray([int(first[0]), 0], jnp.int32),
                                   jnp.int32(BUCKET), jnp.asarray(jpads), jspk, jkv, key, *jk, jnp.int32(16), 16,
                                   EOA, jnp.float32)
    jpos = BUCKET + 16
    temp = jtfm.KVCache.create(jcfg, 2, BUCKET, dtype=jnp.float32)
    pb, pbl = jfs.left_pad_prompts([PROMPT_B], BUCKET)
    first_b, temp = jfs.prefill_batch(jparams, jcfg, jnp.asarray(pb), jnp.asarray(pbl), jnp.asarray(spk_ab[1:]),
                                      temp, key, jk[0][:1], jk[1][:1], jk[2][:1], compute_dtype=jnp.float32)
    k, v = jfs.merge_slot_cache(jkv.k, jkv.v, temp.k, temp.v, jnp.int32(jpos - BUCKET), jnp.int32(1),
                                jnp.int32(SLOTS + 1))
    jkv = jtfm.KVCache(k=k, v=v)
    jspk = jspk.at[1].set(jnp.asarray(spk_ab[1]))
    jpads = np.asarray(jpads).copy()
    jpads[1] = jpos - len(PROMPT_B)
    jcur = [int(np.asarray(buf)[0, -1]), int(np.asarray(first_b)[0])]
    theirs = [jcur]
    for _ in range(2):
        buf, _, jkv = jfs.decode_batch(jparams, jcfg, jnp.asarray(jcur, jnp.int32), jnp.int32(jpos),
                                       jnp.asarray(jpads), jspk, jkv, key, *jk, jnp.int32(8), 8, EOA, jnp.float32)
        b = np.asarray(buf)
        jcur = [int(b[0, -1]), int(b[1, -1])]
        theirs.append(b.tolist())
        jpos += 8
    assert ours == theirs


@pytest.mark.parametrize("fmt,steps_before", [("float", 128), ("int8", 128), ("packed", 129)])
def test_rebase_matches_unrebased_decode(model, fmt, steps_before):
    """A retires after B joins at 160 (161 on the packed cache, a landing off
    the word grid); sliding the cache left by 128 (<= B's start) leaves B's
    tokens as they were."""
    _, _, cfg, params, _ = model
    kv, pos, pads, spk, cur = _group_with_join(model, fmt, steps_before)
    pads[0] = pos  # A retires: its window is empty (its tokens are not read)
    snap = [None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)]

    def continue_decode(kv, pos, pads):
        toks, c = [], list(cur)
        for _ in range(2):
            buf, lens = _decode(params, cfg, c, pos, pads, spk, kv, 16)
            toks += buf[1, : lens[1]].tolist()
            c = [int(buf[0, -1]), int(buf[1, -1])]
            pos += 16
        return toks

    plain = continue_decode(kv, pos, pads)
    kv2 = tfm.KVCache(*snap)
    s = fs.REBASE_ALIGN
    assert s <= min(pads)
    shift_rows(kv2, s, pos)
    assert len(plain) == 32 and continue_decode(kv2, pos - s, pads - s) == plain


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    sr = 16000
    t = np.arange(31 * sr) / sr
    path = str(tmp_path_factory.mktemp("refs") / "ref.wav")
    aio.write_wav(path, (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32), sr)
    return path


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    return TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path_factory.mktemp("outputs")))


@pytest.fixture
def make_engine(tts):
    made = []

    def make(**kw):
        made.append(ContinuousBatchingEngine(tts, **kw))
        return made[-1]

    yield make
    for eng in made:
        eng.shutdown()


@pytest.fixture
def fake_render(tts, monkeypatch):
    """Renders that take no time: a wav of one sample a token, so the tests
    see which tokens each render got."""

    def install(render=None):
        monkeypatch.setattr(type(tts), "_tokens_to_wav", render or (
            lambda self, text, prompt, toks, *a, **kw: np.zeros(len(toks), np.float32)))

    return install


@pytest.fixture
def endless(monkeypatch):
    """Decodes that never sample end-of-audio (its guided score far below
    every other), so requests run to max_new_tokens or forever."""
    sample = fs.sample_guided

    def no_eoa(logits, *a, **kw):
        logits = logits.clone()
        logits[:, T.END_OF_AUDIO_TOKEN] = -1e4
        return sample(logits, *a, **kw)

    monkeypatch.setattr(fs, "sample_guided", no_eoa)


def test_concurrent_requests_complete(make_engine, ref_wav):
    eng = make_engine(slots=4, segment_tokens=16)
    eng.warmup(warm_tts=False)
    futs = [eng.submit(f"Concurrent request number {i}.", ref_wav, max_new_tokens=48) for i in range(4)]
    paths = [f.result(timeout=WAIT) for f in futs]
    assert len(set(paths)) == 4
    for p in paths:
        wav, _ = aio.read_wav(p)
        assert len(wav) > 0 and np.isfinite(wav).all()
    assert eng.stats["groups"] >= 1 and eng.stats["decode_steps"] > 0


def test_errors_reach_the_future_and_the_worker_recovers(make_engine, ref_wav, tts, monkeypatch):
    eng = make_engine(slots=2, segment_tokens=16)
    with pytest.raises(ValueError):
        eng.submit("日本語テキスト", ref_wav)  # refused before it is queued
    real = type(tts)._tokens_to_wav

    def broken(self, *a, **kw):
        raise ValueError("render failed")

    monkeypatch.setattr(type(tts), "_tokens_to_wav", broken)
    with pytest.raises(ValueError, match="render failed"):
        eng.submit("A render that fails.", ref_wav, max_new_tokens=16).result(timeout=WAIT)
    monkeypatch.setattr(type(tts), "_tokens_to_wav", real)
    # a failure in the worker fails the request in flight, the cache is rebuilt, and the engine serves on
    calls = {"n": 0}
    decode = fs.decode

    def failing_decode(*a, **kw):
        calls["n"] += 1
        raise RuntimeError("injected decode failure")

    monkeypatch.setattr(fs, "decode", failing_decode)
    old_k = eng._kv.k
    with pytest.raises(RuntimeError, match="injected"):
        eng.submit("This request fails.", ref_wav, max_new_tokens=16).result(timeout=WAIT)
    monkeypatch.setattr(fs, "decode", decode)
    assert calls["n"] >= 1
    assert os.path.exists(eng.submit("Back to life.", ref_wav, max_new_tokens=16).result(timeout=WAIT))
    assert eng._kv.k is not old_k and eng._kv.k.device == tts.device


def test_mixed_sampling_params_in_one_batch(make_engine, ref_wav):
    eng = make_engine(slots=2, segment_tokens=16)
    f1 = eng.submit("Mixed settings one.", ref_wav, temperature=0.7, top_p=0.9, guidance_scale=2.0,
                    max_new_tokens=32)
    f2 = eng.submit("Mixed settings two.", ref_wav, temperature=1.3, top_p=0.99, guidance_scale=4.0,
                    max_new_tokens=32)
    p1, p2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
    assert os.path.exists(p1) and os.path.exists(p2) and p1 != p2


def test_streaming_rides_the_batch_in_order(make_engine, ref_wav, fake_render):
    """A stream beside a plain request: its renders tile its tokens in order
    (the render wav here is one sample a token, valued by its position)."""
    done = {}  # text -> tokens rendered so far

    def tagged(self, text, prompt, toks, *a, **kw):
        start = done.get(text, 0)
        done[text] = start + len(toks)
        return np.arange(start, start + len(toks), dtype=np.float32)

    fake_render(tagged)
    eng = make_engine(slots=2, segment_tokens=8)
    other = eng.submit("A plain request beside the stream.", ref_wav, max_new_tokens=40)
    h = eng.submit("Order must hold under queued renders.", ref_wav, stream=True, max_new_tokens=64)
    segs = list(h)
    other.result(timeout=WAIT)
    assert segs and all(len(s) > 0 for s in segs)
    joined = np.concatenate(segs)
    np.testing.assert_array_equal(joined, np.arange(len(joined)))  # in order, no gap, no duplicate
    assert len(joined) <= 64


def test_stream_render_backlog_coalesces(make_engine, ref_wav, fake_render, endless):
    """Renders slower than the decode coalesce: fewer, larger renders, no
    token lost or rendered twice; the decode never waits for them."""

    def slow(self, text, prompt, toks, *a, **kw):
        time.sleep(0.3)
        return np.zeros(len(toks), np.float32)

    fake_render(slow)
    eng = make_engine(slots=2, segment_tokens=8)
    segs = list(eng.submit("Backlog must coalesce.", ref_wav, stream=True, max_new_tokens=96))
    assert sum(len(s) for s in segs) == 96
    assert len(segs) < 9, f"no coalescing: {len(segs)} renders for 12 chunks"


def test_deferred_requests_complete_without_new_submits(make_engine, ref_wav):
    eng = make_engine(slots=1, segment_tokens=8)
    futs = [eng.submit(t, ref_wav, max_new_tokens=24)
            for t in ("First occupies the only slot.", "Second must wait then run.", "Third in line.")]
    for f in futs:
        assert os.path.exists(f.result(timeout=WAIT))


def test_engine_rebases_under_sustained_load(make_engine, ref_wav, fake_render, endless):
    """Sustained submissions against a 512 block: the engine rebases the
    shared timeline instead of truncating late joiners."""
    fake_render()
    eng = make_engine(slots=2, segment_tokens=16, rebase_margin=448, pad_multiple=32)
    futs = [eng.submit(f"Sustained load {i}.", ref_wav, max_new_tokens=32 + (i % 4) * 24) for i in range(10)]
    for f in futs:
        assert os.path.exists(f.result(timeout=WAIT))
    assert eng.stats["rebases"] >= 1 and eng.stats["joins"] >= 1, eng.stats
    assert eng.stats["truncations"] == 0, eng.stats


def test_engine_tokens_equal_each_request_alone(make_engine, ref_wav, fake_render, endless):
    """Through the engine's entry point, greedy: every request, those in the
    group prefill, those that joined and one across a rebase, gives at
    every step the logits and tokens of that request alone (chip_smoke.py's
    check of phases 43 and 44, on the CPU)."""
    import chip_smoke as cs

    fake_render()
    eng = make_engine(slots=2, segment_tokens=16, rebase_margin=448, pad_multiple=32)
    with cs.tracked_engine(eng) as (kept, seen):
        futs = [eng.submit(f"Held against alone {i}.", ref_wav, max_new_tokens=n, **cs.GREEDY_KNOBS)
                for i, n in enumerate((32, 56, 96, 104, 96))]
        for f in futs:
            assert os.path.exists(f.result(timeout=WAIT))
    assert any(r["joined"] for r in kept.values()) and any(r["rebased"] for r in kept.values()), eng.stats
    shown, held = cs.engine_tokens_agree(torch, "engine", eng, kept, seen, tol=1e-5)
    assert len(held) == 5 and not any(r["flips"] for r in held), shown


def test_closed_stream_frees_its_slot(make_engine, ref_wav, fake_render, endless):
    fake_render()
    eng = make_engine(slots=1, segment_tokens=8)
    h = eng.submit("A stream whose client goes away.", ref_wav, stream=True)
    assert isinstance(h._q.get(timeout=WAIT), np.ndarray)
    h.close()
    # the only slot frees at the next boundary, so a later request runs
    assert os.path.exists(eng.submit("Next in line.", ref_wav, max_new_tokens=16).result(timeout=WAIT))
    assert eng.stats["truncations"] == 0


def test_shutdown_fails_what_is_in_flight(make_engine, ref_wav, fake_render, endless):
    fake_render()
    eng = make_engine(slots=1, segment_tokens=8)
    h = eng.submit("Endless stream.", ref_wav, stream=True)
    queued = eng.submit("Never gets a slot.", ref_wav)
    assert isinstance(h._q.get(timeout=WAIT), np.ndarray)
    eng.shutdown()
    assert not eng._thread.is_alive()
    with pytest.raises(RuntimeError, match="shut down"):
        queued.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="shut down"):
        for _ in h:
            pass


def test_a_shut_down_engine_and_its_cache_are_freed(tts, ref_wav):
    """After ``shutdown()`` and ``del`` nothing holds the engine or its cache,
    without a GC pass: its render pool's threads hold only the device (a
    bound-method initializer kept the engine alive for as long as they
    lived, and then in a reference cycle)."""
    eng = ContinuousBatchingEngine(tts, slots=2, segment_tokens=16)
    assert os.path.exists(eng.submit("Free me.", ref_wav, max_new_tokens=16).result(timeout=WAIT))
    assert all(np.isfinite(c).all() for c in eng.submit("Stream me.", ref_wav, max_new_tokens=16, stream=True))
    engine, cache = weakref.ref(eng), weakref.ref(eng._kv.k)
    eng.shutdown()
    del eng
    assert engine() is None and cache() is None


@pytest.mark.parametrize("stop", ["shutdown", "fatal"])
def test_no_request_is_queued_after_the_engine_stops(make_engine, ref_wav, tts, monkeypatch, tmp_path, stop):
    """A submit whose speaker embedding is still running when the engine
    stops (shut down, or a failure the cache rebuild cannot survive) raises
    instead of queueing a request that no worker would take; so does every
    later submit."""
    eng = make_engine(slots=1, segment_tokens=8)
    late_ref = str(tmp_path / "late.wav")
    aio.write_wav(late_ref, *aio.read_wav(ref_wav))
    embed, started, release = tts._get_speaker_embedding, threading.Event(), threading.Event()

    def slow_embedding(path):
        if path == late_ref:
            started.set()
            release.wait(WAIT)
        return embed(path)

    monkeypatch.setattr(tts, "_get_speaker_embedding", slow_embedding)
    late = {}

    def submit_late():
        try:
            late["out"] = eng.submit("Submitted as the engine stops.", late_ref, max_new_tokens=8)
        except RuntimeError as e:
            late["out"] = e

    th = threading.Thread(target=submit_late)
    th.start()
    assert started.wait(WAIT)
    if stop == "shutdown":
        eng.shutdown()
        match = "shut down"
    else:
        def failing_decode(*a, **kw):
            raise RuntimeError("injected decode failure")

        def no_cache():
            raise RuntimeError("injected: the cache cannot be rebuilt")

        monkeypatch.setattr(fs, "decode", failing_decode)
        monkeypatch.setattr(eng, "_new_cache", no_cache)
        with pytest.raises(RuntimeError, match="injected decode"):
            eng.submit("This request breaks the engine.", ref_wav, max_new_tokens=8).result(timeout=WAIT)
        eng._thread.join(WAIT)
        assert not eng._thread.is_alive() and eng._broken is not None
        match = "unrecoverable"
    release.set()
    th.join(WAIT)
    assert isinstance(late.get("out"), RuntimeError) and eng._queue.empty(), late
    with pytest.raises(RuntimeError, match=match):
        eng.submit("And after.", ref_wav)


def test_concurrent_clients_lose_no_token(make_engine, ref_wav, fake_render, endless):
    """More client threads than cores, a short switch interval: plain
    requests, streams and streams abandoned after their first chunk, each
    with its own budget. Every request that is not abandoned gets exactly its
    budget's tokens (the render's wav is one sample a token: a lost or
    doubled chunk shows), the abandoned ones free their slots, and the
    engine serves on."""
    fake_render()
    eng = make_engine(slots=3, segment_tokens=8)
    rng = random.Random(7)
    plan = [[(rng.choice(["plain", "plain", "stream", "abandon"]), rng.choice([16, 24])) for _ in range(2)]
            for _ in range(12)]
    results, lock = [], threading.Lock()

    def client(cid):
        for j, (kind, budget) in enumerate(plan[cid]):
            text = f"Client {cid} request {j}."
            try:
                if kind == "plain":
                    got = len(aio.read_wav(eng.submit(text, ref_wav, max_new_tokens=budget).result(timeout=WAIT))[0])
                else:
                    h = eng.submit(text, ref_wav, stream=True, max_new_tokens=budget)
                    if kind == "stream":
                        got = sum(len(c) for c in h)
                    else:
                        got = len(next(h))
                        h.close()
            except Exception as e:  # recorded and asserted below
                got = e
            with lock:
                results.append((kind, budget, got))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(plan))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads), "a client hung"
    assert len(results) == 24
    wrong = [r for r in results if isinstance(r[2], Exception) or (r[0] != "abandon" and r[2] != r[1])]
    assert not wrong, wrong
    assert os.path.exists(eng.submit("Still alive.", ref_wav, max_new_tokens=16).result(timeout=WAIT))
    assert eng.load == 0 and eng.stats["truncations"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8", "int8_packed"])
def test_engine_gqa_on_every_cache_format(tmp_path, ref_wav, kv_dtype):
    """A GQA first stage (2 kv heads) on each cache format: the warmed
    envelope, a group and a join (the scale tables keyed on n_local_heads),
    32-token buckets (the packed landing off the word grid)."""
    gqa = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path), kv_cache_dtype=kv_dtype,
                          first_stage_overrides={"n_local_heads": 2})
    eng = ContinuousBatchingEngine(gqa, slots=2, segment_tokens=8, pad_multiple=32)
    try:
        eng.warmup(warm_tts=False)
        assert eng._pos == 0 and not eng._actives()
        f1 = eng.submit("GQA request one.", ref_wav, max_new_tokens=24)
        f2 = eng.submit("GQA request two joins later.", ref_wav, max_new_tokens=24)
        for f in (f1, f2):
            wav, _ = aio.read_wav(f.result(timeout=WAIT))
            assert len(wav) > 0 and np.isfinite(wav).all()
    finally:
        eng.shutdown()


def test_construction_refuses_what_the_port_cannot_serve(tts):
    with pytest.raises(ValueError, match="exceed 16"):
        ContinuousBatchingEngine(tts, pad_multiple=16)
    with pytest.raises(ValueError, match="pass a slot count"):  # no device memory to plan from on the CPU
        ContinuousBatchingEngine(tts, slots="auto")
    with pytest.raises(ValueError, match="even"):
        ContinuousBatchingEngine(tts, segment_tokens=7)
    packed = TTS.from_random(small=True, device="cpu", kv_cache_dtype="int8_packed",
                             output_dir=tts.output_dir)
    with pytest.raises(ValueError, match="multiple of 4"):
        ContinuousBatchingEngine(packed, pad_multiple=34)


def test_phase_timers_count_every_add_across_threads():
    """Many threads adding at once under a short switch interval lose no count."""
    phases.reset()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [phases.add("t.x", 0.5) for _ in range(500)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert phases.report()["t.x"] == {"total_s": 4000.0, "count": 8000}
    assert "t.x" in phases.format_report(wall_s=1.0)
    phases.reset()
