"""Streaming synthesis of the port against the JAX package on the same
weights and the same Gumbel noise: ``first_stage.generate_segments`` (the
resumable ``decode``), the render of a stream (the second stage + vocoder
of ``runtime/tts.stage2_vocode``), ``TTS.synthesise_streaming``, and the rest
of the TTS surface this slice adds (``get_tokens``, ``render_tokens``,
``warmup``).

The JAX side is test-side code over the JAX package's own functions: a
jitted prefill and T=1 step (``tfm.forward``, ``tfm.apply_blocks``) with the
sampling functions, and the second stage forward, EnCodec and the enhancer,
with the noise added where ``jax.random.categorical`` would draw it.
"""

import types
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core import tokens as JT  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.core.config import second_stage_config as jsecond_stage_config  # noqa: E402
from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import enhancer as jenh  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.runtime.tts import TTS as JTTS  # noqa: E402
from metavoice_tpu.utils import audio_io as jaio  # noqa: E402
from metavoice_tpu_torch.core.config import RuntimeConfig, first_stage_config, second_stage_config  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import speaker_encoder as se  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.models.enhancer import get_enhancer  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS, TTSComponents  # noqa: E402
from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402

TINY = dict(n_layer=2, n_head=4, dim=64, block_size=128, vocab_sizes=(97,))
TINY_EOA = 96
SMALL1 = dict(n_layer=2, n_head=4, dim=128, block_size=512)
SMALL2 = dict(n_layer=2, n_head=2, dim=64, block_size=256)
SMALL_CODEC = dict(n_filters=8, dimension=32)
TEXT = "Hello there, a streaming test."
WAV_TOL = 1e-4  # the port's wav against the JAX oracle's (tests/test_torch_tts.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@partial(jax.jit, static_argnames=("cfg",))
def _jax_prefill(params, cfg, tokens2, spk2, mask, kv):
    logits, kv = jtfm.forward(params, cfg, tokens2, spk_emb=spk2, spk_cond_mask=mask, kv_cache=kv, cache_pos=0,
                              compute_dtype=jnp.float32)
    return logits[0], kv


@partial(jax.jit, static_argnames=("cfg",))
def _jax_step(params, cfg, tokens2, pos, spk2, mask, kv):
    x = jtfm.embed_inputs(params, cfg, tokens2, pos[None], spk2, mask, jnp.float32)
    y, kv = jtfm.apply_blocks(params, cfg, x, jtfm.causal_mask_for(pos[None], kv.max_seq_len)[None, None], kv, pos)
    return jtfm.output_logits(params, cfg, y)[0][:, 0, :], kv


@jax.jit
def _jax_sample(logits, noise, temperature, top_p, guidance):
    merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge(logits, guidance), temperature), top_p)
    return jnp.argmax(merged + noise, axis=-1)[0]


def _jax_generate(jcfg, jparams, prompt, spk, noise, n_tokens, pad_multiple, eoa, temperature, top_p=0.95,
                  guidance=3.0):
    """JAX prefill + T=1 steps of one utterance (2 CFG rows) -> the new tokens."""
    padded, t_true = jfs.pad_to_bucket(prompt, pad_multiple, max_len=jcfg.block_size)
    kv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.float32)
    spk2 = jnp.repeat(jnp.asarray(spk, jnp.float32).reshape(1, -1), 2, axis=0)
    mask = jfs.make_spk_cond_mask(1)
    knobs = (jnp.float32(temperature), jnp.float32(top_p), jnp.float32(guidance))
    logits, kv = _jax_prefill(jparams, jcfg, jnp.repeat(jnp.asarray(padded)[None], 2, axis=0), spk2, mask, kv)
    out = [int(_jax_sample(logits[:, t_true - 1], jnp.asarray(noise[0]), *knobs))]
    for i in range(1, n_tokens):
        if out[-1] == eoa:
            break
        logits, kv = _jax_step(jparams, jcfg, jnp.full((2, 1), out[-1], jnp.int32), jnp.int32(t_true + i - 1),
                               spk2, mask, kv)
        out.append(int(_jax_sample(logits, jnp.asarray(noise[i]), *knobs)))
    return np.asarray(out, np.int32)


# ------------------------------------------------------------------ generate_segments (a tiny model)


def _jax_tree(tree):
    """The port's tree of CPU tensors (the JAX package's layout) as JAX arrays."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def tiny():
    # weights drawn by the port's init (the JAX package's layout and scales), not by JAX's eager init
    params = tfm.init_params(first_stage_config(**TINY), device="cpu", generator=torch.Generator().manual_seed(0))
    return jfirst_stage_config(**TINY), _jax_tree(params), first_stage_config(**TINY), params


def _tiny_noise(n, seed, scale=0.1, eoa_at=None):
    noise = (np.random.default_rng(seed).gumbel(size=(n, 1, 97)) * scale).astype(np.float32)
    if eoa_at is not None:
        noise[eoa_at, 0, TINY_EOA] = 1e4
    return noise


def _segments(tiny, noise, **kw):
    _, _, cfg, params = tiny
    kw = dict(dict(temperature=0.1, end_of_audio_token=TINY_EOA, prompt_pad_multiple=32,
                   compute_dtype=torch.float32), **kw)
    return list(fs.generate_segments(params, cfg, list(range(40, 50)), np.ones(256, np.float32),
                                     noise=torch.from_numpy(noise), **kw))


def _generate(tiny, noise, n, temperature=0.1):
    _, _, cfg, params = tiny
    out = fs.generate(params, cfg, list(range(40, 50)), np.ones(256, np.float32), temperature=temperature,
                      max_new_tokens=n, end_of_audio_token=TINY_EOA, prompt_pad_multiple=32,
                      compute_dtype=torch.float32, noise=torch.from_numpy(noise))
    return out[10:]


def test_segments_joined_equal_generate_and_jax(tiny):
    """Even segments (a first of 4, then 6) of a 17-token budget, joined:
    generate's tokens and the JAX loop's under the same noise."""
    jcfg, jparams, _, _ = tiny
    noise = _tiny_noise(17, 0)
    stats = {}
    segs = _segments(tiny, noise, segment_tokens=6, first_segment_tokens=4, max_new_tokens=17, stats=stats)
    assert [len(s) for s in segs] == [4, 6, 6, 1]
    joined = np.concatenate(segs)
    np.testing.assert_array_equal(joined, _generate(tiny, noise, 17))
    want = _jax_generate(jcfg, jparams, list(range(40, 50)), np.ones(256), noise, 17, 32, TINY_EOA, 0.1)
    np.testing.assert_array_equal(joined, want)
    assert stats["decode_steps"] == 16  # one T=1 forward a token after the prefill's


def test_first_segment_ramp(tiny):
    """first_segment_tokens < segment_tokens: a small first yield, then full
    segments; the budget counts the prefill's token."""
    segs = _segments(tiny, _tiny_noise(30, 1), segment_tokens=12, first_segment_tokens=4, max_new_tokens=30)
    assert [len(s) for s in segs] == [4, 12, 12, 2]


@pytest.mark.parametrize("eoa_at", [9, 4])
def test_segments_stop_at_eoa(tiny, eoa_at):
    """EOA forced at the (eoa_at+1)-th token: the stream ends with it, as
    generate does (at 4: on a segment's last token)."""
    noise = _tiny_noise(40, 2, scale=1.0, eoa_at=eoa_at)
    segs = _segments(tiny, noise, temperature=1.0, segment_tokens=6, first_segment_tokens=4, max_new_tokens=40)
    joined = np.concatenate(segs)
    assert len(joined) == eoa_at + 1 and joined[-1] == TINY_EOA
    np.testing.assert_array_equal(joined, _generate(tiny, noise, 40, temperature=1.0))


def test_prefill_eoa_is_the_whole_stream(tiny):
    segs = _segments(tiny, _tiny_noise(20, 3, scale=1.0, eoa_at=0), temperature=1.0, segment_tokens=6,
                     max_new_tokens=20)
    assert len(segs) == 1 and segs[0].tolist() == [TINY_EOA]


def test_a_budget_of_one_yields_the_prefill_token(tiny):
    segs = _segments(tiny, _tiny_noise(1, 4), segment_tokens=6, max_new_tokens=1)
    assert len(segs) == 1 and len(segs[0]) == 1
    np.testing.assert_array_equal(segs[0], _generate(tiny, _tiny_noise(1, 4), 1))


def test_kv_cache_argument(tiny):
    """A caller's cache with the guidance rows is written in place; one with
    other rows is left alone (a cache of the right rows is made)."""
    _, _, cfg, _ = tiny
    own = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.float32, device="cpu")
    other = tfm.KVCache.create(cfg, 3, cfg.block_size, dtype=torch.float32, device="cpu")
    noise = _tiny_noise(12, 5)
    a = np.concatenate(_segments(tiny, noise, segment_tokens=6, max_new_tokens=12, kv_cache=own))
    b = np.concatenate(_segments(tiny, noise, segment_tokens=6, max_new_tokens=12, kv_cache=other))
    np.testing.assert_array_equal(a, b)
    assert own.k[:, :20].abs().sum() > 0 and other.k.abs().sum() == 0


def test_odd_segments_refused(tiny):
    for kw in ({"segment_tokens": 5}, {"segment_tokens": 6, "first_segment_tokens": 3}):
        with pytest.raises(ValueError, match="even"):
            _segments(tiny, _tiny_noise(8, 6), max_new_tokens=8, **kw)


# ------------------------------------------------------------------ the TTS (a small system)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    """One first stage, second stage and EnCodec for a port TTS (f32) and the
    JAX oracle, drawn by the port's init (the JAX package's layouts and
    scales; JAX's eager init of the codec alone takes about 20 s); the port's
    own speaker encoder (its output feeds both sides)."""
    jcfg1, jcfg2 = jfirst_stage_config(**SMALL1), jsecond_stage_config(**SMALL2)
    jecfg = jec.EncodecConfig(**SMALL_CODEC)
    gen = torch.Generator().manual_seed(7)
    ported = {"fs": tfm.init_params(first_stage_config(**SMALL1), device="cpu", generator=gen),
              "ss": tfm.init_params(second_stage_config(**SMALL2), device="cpu", generator=gen),
              "ec": ec.init_params(ec.EncodecConfig(**SMALL_CODEC), device="cpu", generator=gen)}
    jp = {k: _jax_tree(v) for k, v in ported.items()}
    comps = TTSComponents(
        first_stage_params=ported["fs"],
        first_stage_cfg=first_stage_config(**SMALL1),
        second_stage_params=ported["ss"],
        second_stage_cfg=second_stage_config(**SMALL2),
        spk_params=se.init_params(device="cpu", generator=torch.Generator().manual_seed(0)),
        encodec_params=ported["ec"],
        encodec_cfg=ec.EncodecConfig(**SMALL_CODEC),
        tokenizer=TrainedBPETokeniser(),
        enhancer=get_enhancer("spectral_gate"),
    )
    out = str(tmp_path_factory.mktemp("out"))
    tts = TTS(comps, device="cpu", output_dir=out, runtime=RuntimeConfig(dtype="float32"),
              enforce_min_ref_duration=False)
    sr = 16000
    t = np.arange(3 * sr) / sr
    ref = str(tmp_path_factory.mktemp("ref") / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32),
                  sr)
    return types.SimpleNamespace(tts=tts, jp=jp, jcfg1=jcfg1, jcfg2=jcfg2, jecfg=jecfg, ref=ref)


@partial(jax.jit, static_argnames=("cfg",))
def _jax_stage2_logits(params, cfg, x, spk):
    logits, _ = jtfm.forward(params, cfg, x, spk_emb=spk, compute_dtype=jnp.float32)
    return JS.top_k_mask(JS.apply_temperature(jnp.stack(logits, axis=1), 1.0), 200)


def _jax_render(system, prompt, tokens, spk, noise2):
    """The JAX package's render of one first-stage stream with the second
    stage's noise injected: ``_stage2_vocode_jit``'s semantics (the codes cut
    at the text, the true coarse rows put back, clipped, zero past the
    frames, decoded at the vocoder bucket, trimmed), which its two-call path
    shares above 75 frames; then the enhancer."""
    _, coarse = JT.split_flattened_interleaved(tokens, JT.HIERARCHY_EOA)
    ctx = system.jcfg2.block_size
    x = JT.build_second_stage_input(prompt, coarse, ctx)
    masked = _jax_stage2_logits(system.jp["ss"], system.jcfg2, jnp.asarray(x)[None],
                                jnp.asarray(spk, jnp.float32).reshape(1, -1))
    sampled = np.asarray(jnp.argmax(masked + jnp.asarray(noise2), axis=-1))
    full = np.concatenate([x[None], sampled], axis=1)[0]
    n_text, n_audio = len(prompt), min(len(coarse[0]), ctx - len(prompt))
    bucket = max(25, -(-n_audio // 25) * 25) if n_audio <= 75 else -(-n_audio // 75) * 75
    codes = np.zeros((8, bucket), np.int32)
    codes[:, :n_audio] = np.clip(full[:, n_text : n_text + n_audio], 0, 1023)
    codes[0, :n_audio], codes[1, :n_audio] = coarse[0][:n_audio], coarse[1][:n_audio]
    wav = np.asarray(jec.decode_codes(system.jp["ec"], system.jecfg, jnp.asarray(codes)))[0]
    return jenh.get_enhancer("spectral_gate")(wav[: n_audio * system.jecfg.hop_length], 24000)


def _stage2_noise(system, seed):
    ctx = system.jcfg2.block_size
    return (np.random.default_rng(seed).gumbel(size=(1, 6, ctx, 1025)) * 0.1).astype(np.float32)


def _stream(frames: int) -> np.ndarray:
    """A first-stage stream of ``frames`` interleaved (h0, h1) pairs and EOA."""
    h0, h1 = list(range(frames)), [900 + i % 100 for i in range(frames)]
    return np.asarray([t for pair in zip(h0, [v + 1024 for v in h1]) for t in pair] + [2048], np.int32)


@pytest.mark.parametrize("frames", [10, 30, 40, 75, 80, 160])
def test_render_matches_jax_under_noise(system, frames):
    """One render path at every length (vocoder buckets 25, 50, 75, 150,
    225): the second stage + vocoder on the device, on the same second-stage
    noise as the JAX package's render, timed as one stage."""
    tts = system.tts
    spk = tts._get_speaker_embedding(system.ref)
    prompt = tts.c.tokenizer.encode("Render parity.")
    noise2 = _stage2_noise(system, frames)
    tts.timings = {}
    ours = tts._tokens_to_wav("x", prompt, _stream(frames), spk, noise=torch.from_numpy(noise2))
    ref = _jax_render(system, prompt, _stream(frames), spk, noise2)
    assert ours.shape == ref.shape == (frames * 320,)
    np.testing.assert_allclose(ours, ref, atol=WAV_TOL)
    assert "stage2_vocode_fused" in tts.timings and "second_stage" not in tts.timings


def test_streaming_lets_a_render_failure_through(system, monkeypatch):
    """A render that fails (on the card: a CUDA error or an out-of-memory,
    both RuntimeErrors) ends the stream with its error; only a segment
    without audio tokens is skipped, and before any render."""
    tts = system.tts
    budget = system.jcfg1.block_size - len(tts.c.tokenizer.encode(TEXT))
    noise = np.random.default_rng(45).gumbel(size=(budget, 1, 2562)).astype(np.float32)
    noise[45, 0, JT.END_OF_AUDIO_TOKEN] = 1e4  # the first segment holds audio tokens (see the test above)
    rendered = []

    def broken(prompt, coarse, *args, **kwargs):
        rendered.append(len(coarse[0]))
        raise RuntimeError("render failed")

    monkeypatch.setattr(tts, "_render", broken)
    with pytest.raises(RuntimeError, match="render failed"):
        list(tts.synthesise_streaming(TEXT, system.ref, top_p=0.95, temperature=1.0, segment_tokens=40,
                                      first_segment_tokens=20, noise=torch.from_numpy(noise)))
    assert len(rendered) == 1 and rendered[0] > 0


@pytest.mark.parametrize("eoa_at,n_chunks", [(45, 2), (20, 1)])
def test_synthesise_streaming_matches_jax_under_noise(system, eoa_at, n_chunks):
    """synthesise_streaming (a first segment of 20 tokens, then 40) on the same
    first- and second-stage noise as the JAX oracle, EOA forced at token
    ``eoa_at + 1``: the same chunks. At 20 the second segment holds only the
    end-of-audio token and yields nothing."""
    tts = system.tts
    spk = tts._get_speaker_embedding(system.ref)
    prompt = tts.c.tokenizer.encode(TEXT)
    budget = system.jcfg1.block_size - len(prompt)
    noise = np.random.default_rng(eoa_at).gumbel(size=(budget, 1, 2562)).astype(np.float32)
    noise[eoa_at, 0, JT.END_OF_AUDIO_TOKEN] = 1e4
    noise2 = _stage2_noise(system, 2)
    chunks = list(tts.synthesise_streaming(TEXT, system.ref, top_p=0.95, temperature=1.0, segment_tokens=40,
                                           first_segment_tokens=20, noise=torch.from_numpy(noise),
                                           stage2_noise=torch.from_numpy(noise2)))
    tokens = _jax_generate(system.jcfg1, system.jp["fs"], prompt, spk, noise, budget, 128, JT.END_OF_AUDIO_TOKEN,
                           1.0)
    assert len(tokens) == eoa_at + 1
    want = [_jax_render(system, prompt, seg, spk, noise2) for seg in (tokens[:20], tokens[20:])
            if len(seg) > 1 or seg[0] != JT.END_OF_AUDIO_TOKEN]
    assert len(chunks) == len(want) == n_chunks
    for ours, ref in zip(chunks, want):
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, atol=WAV_TOL)
    assert {"spk_emb", "first_stage", "stage2_vocode_fused", "enhancer"} <= set(tts.timings)
    assert tts.stats["decode_steps"] >= eoa_at and tts.stats["k1_launches"] == 0


def test_get_tokens_matches_jax(system, tmp_path):
    """The wav loaded at 24 kHz (from 16 kHz), trimmed to whole frames,
    encoded: the JAX package's TTS.get_tokens on the same codec weights."""
    tts = system.tts
    ours = tts.get_tokens(system.ref)
    stand_in = types.SimpleNamespace(c=types.SimpleNamespace(encodec_params=system.jp["ec"],
                                                             encodec_cfg=system.jecfg))
    ref = JTTS.get_tokens(stand_in, system.ref)
    frames = len(jaio.load_audio(system.ref, target_sr=24000)[0]) // 320
    assert np.shape(ours) == (8, frames) and isinstance(ours[0][0], int)
    assert min(map(min, ours)) >= 0 and max(map(max, ours)) < 1024
    assert ours == ref


def test_render_tokens_writes_a_wav(system):
    tts = system.tts
    spk = tts._get_speaker_embedding(system.ref)
    wav, sr = aio.read_wav(tts.render_tokens("x", tts.c.tokenizer.encode("x"), _stream(12), spk))
    assert sr == 24000 and len(wav) == 12 * 320 and np.isfinite(wav).all()


def test_warmup_runs_and_leaves_the_generator(system):
    """warmup on the CPU: every bucket and guidance variant (the 3-row cache
    made), the render at every vocoder bucket; the TTS's own draws stay
    where they were, and a synthesise follows."""
    tts = system.tts
    tts._kv_cache3 = None
    state = tts._gen.get_state()
    tts.warmup()
    assert torch.equal(tts._gen.get_state(), state)
    assert tts._kv_cache3 is not None and tts._kv_cache3.batch_size == 3
    wav, sr = aio.read_wav(tts.synthesise("Warm.", system.ref, max_new_tokens=8))
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
