"""The slice as a whole: the port's TTS against the JAX package's on the same
weights (the JAX ``TTS.from_random(small=True)`` params through the
converter), the same reference wav, f32 compute and the same Gumbel noise.

The JAX side is a test-side loop over the JAX package's own functions
(``tfm.forward`` with a ``KVCache``, the sampling functions, the second stage
forward, EnCodec, the enhancer), with the noise injected where
``jax.random.categorical`` would draw it.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core import tokens as JT  # noqa: E402
from metavoice_tpu.core.config import RuntimeConfig as JRuntimeConfig  # noqa: E402
from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.core.config import second_stage_config as j_second_stage_config  # noqa: E402
from metavoice_tpu.models import speaker_encoder as jse  # noqa: E402
from metavoice_tpu.models.enhancer import get_enhancer as jget_enhancer  # noqa: E402
from metavoice_tpu.runtime.tts import TTS as JTTS  # noqa: E402
from metavoice_tpu.runtime.tts import TTSComponents as JTTSComponents  # noqa: E402
from metavoice_tpu.tokenizer import TrainedBPETokeniser as JTrainedBPETokeniser  # noqa: E402
from metavoice_tpu_torch.core.config import RuntimeConfig, TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.models import mbd  # noqa: E402
from metavoice_tpu_torch.models.enhancer import DFConfig, get_enhancer  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS, TTSComponents  # noqa: E402
from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX forward compiled once a shape and shared by every step (cache_pos is traced)
_jax_forward = jax.jit(jtfm.forward, static_argnames=("cfg", "compute_dtype"))

TEXT = "Hello there, this is a parity test."
N_TOKENS = 32
# A low temperature and scaled-down noise keep the random small models'
# logits, and not the noise alone, deciding the draws.
GUIDANCE, TEMPERATURE, TOP_P = 3.0, 0.1, 0.95
NOISE_SCALE = 0.1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The first stage and speaker encoder of JAX's ``TTS.from_random(
    PRNGKey(0), small=True)``, their inits run under ``jax.jit`` (the same
    draws; XLA may round a bf16 weight apart from the eager init; JAX's
    eager init of the small system takes about 60 s on one core), the second
    stage and EnCodec drawn by the port's init (the JAX package's layouts and
    scales), a JAX TTS on them and the port's TTS on the same weights."""
    out = str(tmp_path_factory.mktemp("out"))
    k1, _, k3, _, _ = jax.random.split(jax.random.PRNGKey(0), 5)  # as JAX's from_random splits its key
    cfg1 = j_first_stage_config(n_layer=2, n_head=4, dim=128, block_size=512)
    cfg2 = j_second_stage_config(n_layer=2, n_head=2, dim=64, block_size=256)
    ecfg = jec.EncodecConfig(n_filters=8, dimension=32, codebook_size=1024)
    gen = torch.Generator().manual_seed(0)
    p2 = tfm.init_params(TransformerConfig(**dataclasses.asdict(cfg2)), device="cpu", generator=gen,
                         dtype=torch.bfloat16)
    pec = ec.init_params(ec.EncodecConfig(**dataclasses.asdict(ecfg)), device="cpu", generator=gen)
    jcomps = JTTSComponents(
        first_stage_params=jax.jit(lambda k: jtfm.init_params(k, cfg1, dtype=jnp.bfloat16))(k1),
        first_stage_cfg=cfg1,
        second_stage_params=jax.tree.map(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), p2),
        second_stage_cfg=cfg2,
        spk_params=jax.jit(jse.init_params)(k3),
        encodec_params=jax.tree.map(lambda t: jnp.asarray(t.numpy()), pec),
        encodec_cfg=ecfg,
        tokenizer=JTrainedBPETokeniser(),
        enhancer=jget_enhancer("spectral_gate"),
    )
    jtts = JTTS(jcomps, output_dir=out, runtime=JRuntimeConfig(dtype="float32", output_dir=out),
                enforce_min_ref_duration=False)
    c = jtts.c
    comps = TTSComponents(
        first_stage_params=params_from_numpy(_np(c.first_stage_params), device="cpu"),
        first_stage_cfg=TransformerConfig(**dataclasses.asdict(c.first_stage_cfg)),
        second_stage_params=params_from_numpy(_np(c.second_stage_params), device="cpu"),
        second_stage_cfg=TransformerConfig(**dataclasses.asdict(c.second_stage_cfg)),
        spk_params=params_from_numpy(_np(c.spk_params), device="cpu"),
        encodec_params=params_from_numpy(_np(c.encodec_params), device="cpu"),
        encodec_cfg=ec.EncodecConfig(**dataclasses.asdict(c.encodec_cfg)),
        tokenizer=TrainedBPETokeniser(),
        enhancer=get_enhancer("spectral_gate"),
    )
    tts = TTS(comps, device="cpu", output_dir=out, runtime=RuntimeConfig(dtype="float32"),
              enforce_min_ref_duration=False)
    return jtts, tts


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    sr = 16000
    t = np.arange(4 * sr) / sr
    rng = np.random.default_rng(0)
    wav = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    path = str(tmp_path_factory.mktemp("ref") / "ref.wav")
    aio.write_wav(path, (wav + 0.02 * rng.normal(size=len(t))).astype(np.float32), sr)
    return path


def _jax_first_stage(params, cfg, prompt, spk, noise, temperature, guidance=GUIDANCE, eot=0,
                     n_tokens=N_TOKENS):
    """Prefill + T=1 cached steps with the JAX package's forward and sampling;
    a (speaker, prompt) ``guidance`` tuple runs the 3-row batch, whose third
    group sees its text tokens replaced by ``eot``."""
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=cfg.block_size)
    spk_g, prompt_g, rows = jfs._normalize_guidance(guidance)
    kv = jtfm.KVCache.create(cfg, rows, cfg.block_size, dtype=jnp.float32)
    spk2 = jnp.repeat(jnp.asarray(spk).reshape(1, -1), rows, axis=0)
    mask = jfs.make_spk_cond_mask(1, rows)

    def batch(tokens):
        tokens = jnp.asarray(tokens)[None]
        groups = [tokens, tokens, jfs._uncond_prompt_rows(tokens, eot)]
        return jnp.concatenate(groups[:rows], axis=0)

    def sample(logits, i):
        merged = JS.cfg_merge3(logits, spk_g, prompt_g) if rows == 3 else JS.cfg_merge(logits, spk_g)
        merged = JS.top_p_mask(JS.apply_temperature(merged, temperature), TOP_P)
        return int(jnp.argmax(merged + jnp.asarray(noise[i]), axis=-1)[0])

    logits, kv = _jax_forward(params, cfg, batch(padded), spk_emb=spk2,
                              spk_cond_mask=mask, kv_cache=kv, cache_pos=0, compute_dtype=jnp.float32)
    out = [sample(logits[0][:, t_true - 1], 0)]
    for i in range(1, n_tokens):
        if out[-1] == JT.END_OF_AUDIO_TOKEN:
            break
        logits, kv = _jax_forward(params, cfg, batch(np.array([out[-1]], np.int32)), spk_emb=spk2,
                                  spk_cond_mask=mask, kv_cache=kv, cache_pos=t_true + i - 1,
                                  compute_dtype=jnp.float32)
        out.append(sample(logits[0][:, 0], i))
    return np.concatenate([np.asarray(prompt, np.int32), np.asarray(out, np.int32)])


def _jax_tokens_to_wav(jtts, prompt, tokens, spk, noise):
    """Second stage (with injected noise), vocoder bucket, EnCodec, enhancer."""
    c = jtts.c
    _, coarse = JT.split_flattened_interleaved(tokens, JT.HIERARCHY_EOA)
    x = JT.build_second_stage_input(prompt, coarse, c.second_stage_cfg.block_size)
    logits, _ = jtfm.forward(c.second_stage_params, c.second_stage_cfg, jnp.asarray(x)[None],
                             spk_emb=jnp.asarray(spk).reshape(1, -1), compute_dtype=jnp.float32)
    masked = JS.top_k_mask(JS.apply_temperature(jnp.stack(logits, axis=1), 1.0), 200)
    sampled = np.asarray(jnp.argmax(masked + jnp.asarray(noise), axis=-1))
    full = np.concatenate([x[None], sampled], axis=1)[0]
    n_text, n_audio = len(prompt), len(coarse[0])
    codes = full[:, n_text : n_text + n_audio].copy()
    codes[0], codes[1] = coarse[0], coarse[1]
    codes = np.clip(codes, 0, 1023)
    bucket = max(25, -(-n_audio // 25) * 25) if n_audio <= 75 else -(-n_audio // 75) * 75
    codes = np.pad(codes, ((0, 0), (0, bucket - n_audio)))
    wav = np.asarray(jec.decode_codes(c.encodec_params, c.encodec_cfg, jnp.asarray(codes)))[0]
    return c.enhancer(wav[: n_audio * c.encodec_cfg.hop_length], c.encodec_cfg.sample_rate)


def _run_first_stage(pair, ref_wav, temperature=TEMPERATURE, noise_scale=NOISE_SCALE, eoa_at=None,
                     guidance=GUIDANCE, n_tokens=N_TOKENS):
    """Port and JAX first stage on the same noise; ``eoa_at`` makes the noise
    force the end-of-audio token at that sampled token."""
    jtts, tts = pair
    spk = jtts._get_speaker_embedding(ref_wav)
    prompt = tts.c.tokenizer.encode(TEXT)
    assert prompt == jtts.c.tokenizer.encode(TEXT)
    noise = np.random.default_rng(1).gumbel(size=(n_tokens, 1, 2562)) * noise_scale
    noise = noise.astype(np.float32)
    if eoa_at is not None:
        noise[eoa_at, 0, JT.END_OF_AUDIO_TOKEN] = 1e4
    stats = {}
    eot = tts.c.tokenizer.eot_token
    ours = fs.generate(
        tts.c.first_stage_params, tts.c.first_stage_cfg, prompt, spk,
        temperature=temperature, top_p=TOP_P, guidance_scale=guidance, max_new_tokens=n_tokens,
        end_of_text_token=eot, compute_dtype=torch.float32, noise=torch.from_numpy(noise), stats=stats,
    )
    ref = _jax_first_stage(jtts.c.first_stage_params, jtts.c.first_stage_cfg, prompt, spk, noise,
                           temperature, guidance, eot, n_tokens)
    return spk, prompt, ours, ref, stats


@pytest.fixture(scope="module")
def first_stage_run(pair, ref_wav):
    return _run_first_stage(pair, ref_wav)


def test_speaker_embedding_matches_jax(pair, ref_wav):
    jtts, tts = pair
    ours, ref = tts._get_speaker_embedding(ref_wav), jtts._get_speaker_embedding(ref_wav)
    assert float(np.dot(ours, ref) / (np.linalg.norm(ours) * np.linalg.norm(ref))) >= 0.99999


def test_first_stage_tokens_match_jax_loop(first_stage_run):
    _, prompt, ours, ref, stats = first_stage_run
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) - len(prompt) == N_TOKENS or ours[-1] == JT.END_OF_AUDIO_TOKEN
    assert stats["decode_steps"] >= len(ours) - len(prompt) - 1


def test_end_of_audio_latch_matches_jax_loop(pair, ref_wav):
    """EOA forced at the 6th sampled token: both stop there (the port's loop
    may run on to its next latch check, without emitting more). At
    temperature 1 top-p keeps the EOA token, so the noise can force it."""
    _, prompt, ours, ref, stats = _run_first_stage(pair, ref_wav, 1.0, 1.0, eoa_at=5)
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) == len(prompt) + 6 and ours[-1] == JT.END_OF_AUDIO_TOKEN
    assert 5 <= stats["decode_steps"] < 5 + fs.DONE_CHECK_EVERY


def test_prompt_guidance_tokens_match_jax_loop(pair, ref_wav):
    """(speaker, prompt) guidance: the 3-row batch, its third group's text
    replaced by end-of-text, the double-CFG merge, on the same noise."""
    _, prompt, ours, ref, _ = _run_first_stage(pair, ref_wav, guidance=(2.0, 1.5), n_tokens=12)
    assert max(prompt) > JT.END_OF_AUDIO_TOKEN  # the third group's text is replaced
    np.testing.assert_array_equal(ours, ref)


def test_second_stage_vocoder_enhancer_match_jax(pair, first_stage_run):
    jtts, tts = pair
    spk, prompt, tokens, _, _ = first_stage_run
    ctx = tts.c.second_stage_cfg.block_size
    noise = (np.random.default_rng(2).gumbel(size=(1, 6, ctx, 1025)) * NOISE_SCALE).astype(np.float32)
    ours = tts._tokens_to_wav(TEXT, prompt, tokens, spk, noise=torch.from_numpy(noise))
    ref = _jax_tokens_to_wav(jtts, prompt, tokens, spk, noise)
    assert ours.shape == ref.shape and len(ours) > 0
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_port_synthesise_writes_wav(pair, ref_wav):
    _, tts = pair
    path = tts.synthesise(TEXT, ref_wav, max_new_tokens=24)
    wav, sr = aio.read_wav(path)
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert np.abs(wav).max() <= 1.0
    assert {"spk_emb", "first_stage", "stage2_vocode_fused"} <= set(tts.timings)
    assert 0 < tts.stats["decode_steps"] <= 23


def test_port_synthesise_with_draft_and_prompt_guidance(pair, ref_wav, tmp_path):
    """A draft (speculative decoding) and a (speaker, prompt) guidance tuple
    through the user's entry point, on the CPU."""
    _, tts = pair
    spec = TTS(tts.c, device="cpu", output_dir=str(tmp_path), runtime=RuntimeConfig(dtype="float32"),
               enforce_min_ref_duration=False, draft_params=tts.c.first_stage_params,
               draft_cfg=tts.c.first_stage_cfg, speculative_gamma=3, seed=1)
    wav, sr = aio.read_wav(spec.synthesise(TEXT, ref_wav, max_new_tokens=16, guidance_scale=(2.0, 1.5)))
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    st = spec.spec_stats
    assert st["rounds"] >= 2 and st["proposed"] == 3 * st["rounds"] and st["accepted"] <= st["proposed"]
    assert spec.stats["spec_rounds"] >= 1 and spec.stats["decode_steps"] == 0
    assert spec._kv_cache3 is not None and spec._kv_cache3.batch_size == 3


def test_unported_options_and_missing_card_raise(pair):
    _, tts = pair
    # tensor parallelism is ported (tests/test_torch_tts_tp.py): it needs ranks in a process group
    with pytest.raises(RuntimeError, match="spawn"):
        TTS(tts.c, device="cpu", tensor_parallel=2)
    # the MBD vocoder is ported (tests/test_torch_mbd.py): it needs its params, as in JAX
    small_mbd = mbd.MBDConfig(n_processes=1, unet=mbd.UNetConfig(hidden=4, depth=2, num_steps=16,
                                                                  codec_dim=tts.c.encodec_cfg.dimension),
                              step_list=(15, 7, 0), processor_bands=4, eq_bands=8)
    with_mbd = dataclasses.replace(tts.c, vocoder="mbd", mbd_cfg=small_mbd,
                                   mbd_params=mbd.init_params(small_mbd, device="cpu",
                                                              generator=torch.Generator().manual_seed(0)))
    assert TTS(with_mbd, device="cpu").c.vocoder == "mbd"
    with pytest.raises(RuntimeError, match="spawn"):
        TTS(with_mbd, device="cpu", tensor_parallel=2)
    with pytest.raises(ValueError, match="mbd_params"):
        TTS(dataclasses.replace(tts.c, vocoder="mbd"), device="cpu")
    with pytest.raises(ValueError, match="Unknown vocoder"):
        TTS(dataclasses.replace(tts.c, vocoder="hifigan"), device="cpu")
    # every enhancer of the JAX factory is ported (tests/test_torch_df_enhancer.py)
    with pytest.warns(UserWarning, match="UNTRAINED"):
        get_enhancer("df", device="cpu", cfg=DFConfig(n_fft=64, hop=32, n_erb=8, df_bins=8, gru_dim=8))
    x = np.ones(10, np.float32)
    assert get_enhancer("none")(x, 24000) is x
    with pytest.raises(ValueError, match="Unknown enhancer"):
        get_enhancer("bogus")
    # int4 at the small model's width decodes through the unfused route, on a quantized cache too
    # (tests/test_torch_int4_unfused.py)
    for kw in ({"quantisation_mode": "int4"}, {"quantisation_mode": "int4", "kv_cache_dtype": "int8"}):
        assert TTS(tts.c, device="cpu", **kw).decode_route == "unfused"
    # plain int8 is ported (tests/test_torch_int8_plain_slice.py), on a quantized cache too
    for kw in ({"quantisation_mode": "int8_plain"}, {"quantisation_mode": "int8_plain", "kv_cache_dtype": "int8"}):
        assert TTS(tts.c, device="cpu", **kw).quantisation_mode == "int8_plain"
    # the quantized KV cache is ported (tests/test_torch_kv_cache.py); an unknown format is refused
    assert TTS(tts.c, device="cpu", kv_cache_dtype="int8_packed")._kv_cache.packed
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        TTS(tts.c, device="cpu", kv_cache_dtype="int4")
    # a draft is ported: it needs its config, and refuses tensor parallelism as in JAX
    draft = dict(draft_params=tts.c.first_stage_params, draft_cfg=tts.c.first_stage_cfg)
    TTS(tts.c, device="cpu", **draft)
    with pytest.raises(ValueError, match="draft_cfg"):
        TTS(tts.c, device="cpu", draft_params=tts.c.first_stage_params)
    with pytest.raises(ValueError, match="tensor_parallel"):
        TTS(tts.c, device="cpu", tensor_parallel=2, **draft)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TTS(tts.c)  # the default device is cuda: no silent CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            TTS(with_mbd)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import metavoice_tpu_torch.runtime.tts\n"
        "import metavoice_tpu_torch.utils.checkpoint\n"
        "import metavoice_tpu_torch.ops.quantized\n"
        "import metavoice_tpu_torch.ops.decode_stack\n"
        "import metavoice_tpu_torch.ops._build\n"
        "import metavoice_tpu_torch.models.transformer\n"
        "import metavoice_tpu_torch.models.first_stage\n"
        "import metavoice_tpu_torch.models.spec_decode\n"
        "import metavoice_tpu_torch.runtime.engine\n"
        "import metavoice_tpu_torch.runtime.server\n"
        "import metavoice_tpu_torch.runtime.replicas\n"
        "import metavoice_tpu_torch.utils.phases\n"
        "import metavoice_tpu_torch.utils.audio_io\n"
        "import metavoice_tpu_torch.utils.capacity\n"
        "import metavoice_tpu_torch.utils.convert_external\n"
        "import metavoice_tpu_torch.utils.profiling\n"
        "import metavoice_tpu_torch.native\n"
        "import metavoice_tpu_torch.telemetry\n"
        "import metavoice_tpu_torch.cli\n"
        "import metavoice_tpu_torch.training.finetune\n"
        "import metavoice_tpu_torch.training.data\n"
        "import metavoice_tpu_torch.training.trainer\n"
        "import metavoice_tpu_torch.training.second_stage\n"
        "import metavoice_tpu_torch.training.mbd_trainer\n"
        "import metavoice_tpu_torch.training.df_trainer\n"
        "import metavoice_tpu_torch.models.mbd\n"
        "import metavoice_tpu_torch.models.enhancer\n"
        "import metavoice_tpu_torch.parallel.mesh\n"
        "import metavoice_tpu_torch.parallel.sharding\n"
        "import metavoice_tpu_torch.parallel.tp_decode\n"
        "import metavoice_tpu_torch.parallel.aot\n"
        "import metavoice_tpu_torch.parallel.dryrun\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'metavoice_tpu', 'optax', 'orbax', 'pandas')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
