"""The slice: the port's ``TTS(vocoder="mbd")`` (metavoice_tpu_torch/
runtime/tts.py) against the JAX package's ``TTS`` (metavoice_tpu/runtime/
tts.py) on the same second stage, EnCodec and MBD: the render of a coarse
stream through the bucket's codes and ``mbd.tokens_to_wav`` under JAX's
replayed draws (1e-4 of max |ref|), the 400 ms guard on a whole utterance
and its skip for a streaming segment in both packages, and the user's entry
points on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import tokens as JT  # noqa: E402
from metavoice_tpu.core.config import TransformerConfig as JTransformerConfig  # noqa: E402
from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import mbd as jmbd  # noqa: E402
from metavoice_tpu.runtime import tts as jtts  # noqa: E402
from metavoice_tpu_torch.models import mbd  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from test_torch_mbd import _close, _jax_draws, _np  # noqa: E402

SR = 24_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def mbd_tts(tmp_path_factory):
    """The small port TTS with the MBD vocoder (one band of JAX's small
    config: the sum over bands is held above) and the 400 ms guard on, and a
    JAX TTS holding the same second stage, EnCodec and MBD."""
    out = str(tmp_path_factory.mktemp("mbd_tts"))
    tts = TTS.from_random(small=True, device="cpu", seed=5, vocoder="mbd", output_dir=out,
                          enforce_min_output_duration=True)
    c = tts.c
    c.enhancer = None
    c.mbd_cfg = dataclasses.replace(c.mbd_cfg, n_processes=1)
    c.mbd_params = {"processes": c.mbd_params["processes"][:1]}

    def jtree(tree):
        return jax.tree.map(jnp.asarray, _np(jax.tree.map(lambda t: t.float(), tree)))

    jecfg = jec.EncodecConfig(**dataclasses.asdict(c.encodec_cfg))
    u = c.mbd_cfg.unet
    jmcfg = jmbd.MBDConfig(n_processes=c.mbd_cfg.n_processes, unet=jmbd.UNetConfig(**dataclasses.asdict(u)),
                           step_list=c.mbd_cfg.step_list, processor_bands=c.mbd_cfg.processor_bands,
                           eq_bands=c.mbd_cfg.eq_bands)
    comps = jtts.TTSComponents(
        first_stage_params=jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree(c.first_stage_params)),
        first_stage_cfg=JTransformerConfig(**dataclasses.asdict(c.first_stage_cfg)),
        second_stage_params=jax.tree.map(lambda a: a.astype(jnp.bfloat16), jtree(c.second_stage_params)),
        second_stage_cfg=JTransformerConfig(**dataclasses.asdict(c.second_stage_cfg)), spk_params=None, encodec_params=jtree(c.encodec_params), encodec_cfg=jecfg,
        tokenizer=None, enhancer=None, vocoder="mbd", mbd_params=jtree(c.mbd_params), mbd_cfg=jmcfg)
    return tts, jtts.TTS(comps, output_dir=out, enforce_min_ref_duration=False)


def _stream(coarse) -> np.ndarray:
    """Two coarse rows as the first stage's flattened interleaved stream."""
    return np.stack([np.asarray(coarse[0]), np.asarray(coarse[1]) + JT.HIERARCHY_EOA], 1).reshape(-1)


def test_tts_mbd_render_matches_jax_on_the_bucket_codes(mbd_tts, monkeypatch):
    """The port's MBD render of a coarse stream (20 frames, bucket 25) is
    JAX's ``mbd.tokens_to_wav`` of the same bucket codes under the same
    draws, trimmed to the frames; the bucket codes are ``stage2_codes``'.
    (JAX runs eagerly at the guard test's bucket: the two share compiles.)"""
    tts, jt = mbd_tts
    rng = np.random.default_rng(51)
    coarse = [rng.integers(0, 1024, 20).tolist(), rng.integers(0, 1024, 20).tolist()]
    prompt = list(range(JT.TEXT_OFFSET, JT.TEXT_OFFSET + 7))
    spk = rng.normal(size=256).astype(np.float32)
    hop, bucket = tts.c.encodec_cfg.hop_length, 25
    key = jax.random.PRNGKey(52)
    init, steps = _jax_draws(key, tts.c.mbd_cfg, 1, bucket * hop)
    seen = {}
    real = mbd.tokens_to_wav

    def injected(params, cfg, eparams, codes, ecfg, generator=None):
        seen["codes"] = codes.clone()
        return real(params, cfg, eparams, codes, ecfg, initial_noise=init, step_noise=steps)

    monkeypatch.setattr(mbd, "tokens_to_wav", injected)
    # a streaming segment: the whole-utterance guard (tested below) would refuse a 25-frame bucket
    wav = tts._render(prompt, coarse, spk, torch.Generator().manual_seed(54), streaming_segment=True)
    codes = seen["codes"]
    assert codes.shape == (8, bucket) and (codes[:, 20:] == 0).all()
    assert torch.equal(codes[:2, :20], torch.tensor(coarse))
    assert set(tts.timings) >= {"stage2", "vocoder_mbd"}
    want = jmbd.tokens_to_wav(jt.c.mbd_params, jt.c.mbd_cfg, jt.c.encodec_params, jnp.asarray(codes.numpy()), key,
                              encodec_cfg=jt.c.encodec_cfg)
    assert wav.shape == (20 * hop,)
    _close(wav, np.asarray(want)[0, : 20 * hop], 1e-4)


def test_tts_mbd_guard_refuses_a_short_utterance_and_skips_a_streaming_segment(mbd_tts):
    """4 frames pad to a 25-frame bucket, 8000 samples (333 ms): both
    packages refuse the whole utterance and render the streaming segment."""
    tts, jt = mbd_tts
    rng = np.random.default_rng(61)
    coarse = [rng.integers(0, 1024, 4).tolist(), rng.integers(0, 1024, 4).tolist()]
    prompt = list(range(JT.TEXT_OFFSET, JT.TEXT_OFFSET + 5))
    spk = rng.normal(size=256).astype(np.float32)
    stream = np.concatenate([_stream(coarse), [JT.HIERARCHY_EOA]])
    with pytest.raises(RuntimeError, match="shorter than 400ms"):
        tts._tokens_to_wav("short", prompt, stream, spk)
    with pytest.raises(RuntimeError, match="shorter than 400ms"):
        jt._tokens_to_wav("short", prompt, stream, spk, jax.random.PRNGKey(0))
    hop = tts.c.encodec_cfg.hop_length
    got = tts._tokens_to_wav("short", prompt, stream, spk, streaming_segment=True)
    want = jt._tokens_to_wav("short", prompt, stream, spk, jax.random.PRNGKey(0), streaming_segment=True)
    assert got.shape == want.shape == (4 * hop,)
    assert np.isfinite(got).all()
    # off by default on random weights, as in JAX's from_random
    assert TTS.from_random(small=True, device="cpu", vocoder="mbd", output_dir=tts.output_dir)._min_output_s == 0.0


def test_tts_mbd_synthesise_and_stream(mbd_tts, tmp_path):
    """synthesise and synthesise_streaming run through the MBD route; the
    stream's short first segment passes the guard."""
    from metavoice_tpu_torch.utils import audio_io as aio

    tts, _ = mbd_tts
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR)).astype(np.float32), SR)
    segs = list(tts.synthesise_streaming("hello", ref, max_new_tokens=40, segment_tokens=16, first_segment_tokens=8))
    assert segs and all(np.isfinite(s).all() for s in segs)
    assert tts.timings.get("vocoder_mbd", 0) > 0
    unguarded = TTS(tts.c, device="cpu", output_dir=tts.output_dir, enforce_min_ref_duration=False,
                    enforce_min_output_duration=False)
    path = unguarded.synthesise("hello", ref, max_new_tokens=40)
    assert path.endswith(".wav") and unguarded.timings["vocoder_mbd"] > 0
