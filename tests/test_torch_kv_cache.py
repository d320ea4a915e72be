"""The quantized KV cache of the port, on the CPU, against
metavoice_tpu/models/transformer.py (the ``tests/test_kv8_packed.py`` setups):

* the cache helpers bit for bit: ``quantize_kv_rows``, ``pack_kv_s`` /
  ``unpack_kv_s``, ``packed_kv_update`` and ``packed_scale_update`` at any
  alignment (the port writes in place), ``packed_kv_dequant``, and
  ``KVCache.create`` for the three formats;
* f32 weights on an int8 or packed cache (the plain dequantizing path):
  prefill and decode logits against JAX ``forward`` within 1e-5, greedy
  tokens equal to JAX ``generate(cache_dtype=...)``; such a cache never
  reaches the decode-attention kernels K1 and K4;
* the speculative path keeps float caches whatever ``kv_cache_dtype`` is.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import spec_decode as sd  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

JAX_FORMAT = {"int8": jnp.int8, "int8_packed": "int8_packed"}
# EOA=96, text ids 97..: the scaled-down token space of tests/test_spec_decode.py
TINY = jfirst_stage_config(n_layer=2, n_head=4, dim=128, block_size=64, vocab_sizes=(121,), intermediate_size=256)
EOA = 96
PROMPT = [100, 101, 102, 103, 5, 17]
SPK = np.ones((256,), np.float32)
GREEDY = dict(temperature=1e-6, top_p=1.0, end_of_audio_token=EOA, prompt_pad_multiple=16)
# one compiled program per window length, not one per primitive
_KV_UPDATE = jax.jit(jtfm.packed_kv_update)
_SCALE_UPDATE = jax.jit(jtfm.packed_scale_update)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(rng, shape):
    """Random packed words and the int8 values they hold (JAX packs them)."""
    base8 = rng.integers(-127, 128, size=shape, dtype=np.int8)
    return np.array(jax.vmap(jtfm.pack_kv_s)(jnp.asarray(base8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_rows_bit_identical(dtype):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(5, 2, 3, 128)) * 3).astype(np.float32)
    w[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    w[1, 1, 1, :4] = [0.5, -0.5, 1.5, 127.0]  # ties of round-half-even
    t = torch.from_numpy(w).to(dtype)
    jq, js = jtfm.quantize_kv_rows(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                                        else jnp.float32))
    q, s = tfm.quantize_kv_rows(t)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (5, 2, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_pack_unpack_round_trip_matches_jax():
    rng = np.random.default_rng(1)
    q8 = rng.integers(-127, 128, size=(16, 2, 3, 8), dtype=np.int8)
    words = tfm.pack_kv_s(torch.from_numpy(q8))
    assert words.shape == (4, 2, 3, 8) and words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy(), np.asarray(jtfm.pack_kv_s(jnp.asarray(q8))))
    np.testing.assert_array_equal(tfm.unpack_kv_s(words).numpy(), q8.astype(np.int32))
    np.testing.assert_array_equal(tfm.unpack_kv_s(words).numpy(), np.asarray(jtfm.unpack_kv_s(jnp.asarray(words))))


@pytest.mark.parametrize("t", [1, 5, 16])
@pytest.mark.parametrize("pos", [0, 1, 3, 4, 77])
def test_packed_updates_match_jax(pos, t):
    """Both read-modify-writes in place at any alignment: the words and the
    residue-split scale table bit-identical to JAX's functional update."""
    rng = np.random.default_rng(10 * pos + t)
    L, S, B, H, Dh = 2, 96, 1, 2, 8
    words = _words(rng, (L, S, B, H, Dh))
    rows = rng.integers(-127, 128, size=(t, B, H, Dh), dtype=np.int8)
    want = _KV_UPDATE(jnp.asarray(words), jnp.asarray(rows), jnp.asarray(1), jnp.asarray(pos))
    got = torch.from_numpy(words.copy())
    assert tfm.packed_kv_update(got, torch.from_numpy(rows), 1, pos) is got
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    table = rng.random((L, 4, S // 4, 1, 128)).astype(np.float32)
    s_rows = rng.random((t, B * H)).astype(np.float32)
    want = _SCALE_UPDATE(jnp.asarray(table), jnp.asarray(s_rows), jnp.asarray(0), jnp.asarray(pos))
    got = torch.from_numpy(table.copy())
    tfm.packed_scale_update(got, torch.from_numpy(s_rows), 0, pos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_packed_kv_dequant_matches_jax():
    rng = np.random.default_rng(2)
    words = _words(rng, (2, 32, 2, 3, 8))
    table = rng.random((2, 4, 8, 1, 128)).astype(np.float32)
    want = jax.jit(jtfm.packed_kv_dequant)(jnp.asarray(words), jnp.asarray(table), jnp.asarray(1))
    got = tfm.packed_kv_dequant(torch.from_numpy(words), torch.from_numpy(table), 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", [torch.bfloat16, torch.int8, "int8", "int8_packed"])
def test_create_matches_jax_layouts(fmt):
    jcfg = jfirst_stage_config(n_layer=2, n_head=4, n_local_heads=2, dim=128, block_size=64)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    jfmt = {torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}.get(fmt, fmt)
    want = jtfm.KVCache.create(jcfg, 3, 64, dtype=jfmt)
    kv = tfm.KVCache.create(cfg, 3, 64, dtype=fmt, device="cpu")
    assert kv.quantized == want.quantized and kv.packed == want.packed
    assert kv.max_seq_len == want.max_seq_len == 64 and kv.batch_size == 3
    for got, ref in ((kv.k, want.k), (kv.v, want.v), (kv.k_scale, want.k_scale), (kv.v_scale, want.v_scale)):
        if ref is None:
            assert got is None
            continue
        assert tuple(got.shape) == ref.shape and str(got.dtype).split(".")[-1] == str(ref.dtype)
        assert not got.any()


def test_create_refuses_unknown_formats():
    cfg = TransformerConfig(**dataclasses.asdict(TINY))
    with pytest.raises(ValueError, match="unknown KV cache dtype string"):
        tfm.KVCache.create(cfg, 2, 64, dtype="int9", device="cpu")
    with pytest.raises(ValueError, match="seq len"):
        tfm.KVCache.create(cfg, 2, 62, dtype="int8_packed", device="cpu")
    with pytest.raises(ValueError):
        tfm.KVCache.create(cfg, 2, 64, dtype=torch.int16, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    params = _jax_init(jax.random.PRNGKey(0), cfg=TINY, dtype=jnp.float32)
    port = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu", dtype=torch.float32)
    return params, port, TransformerConfig(**dataclasses.asdict(TINY))


def _refuse(*_a, **_k):
    raise AssertionError("a quantized cache reached a bf16-cache decode-attention kernel")


@pytest.mark.parametrize("fmt", ["int8", "int8_packed"])
def test_f32_weights_on_quantized_cache_match_jax_forward(tiny, fmt, monkeypatch):
    """Prefill (T = 8) and a decode step at a position that is not a
    multiple of 4 (the packed word read-modify-write): logits within 1e-5
    of JAX's XLA path in f32, and neither K1 nor K4 is called."""
    jp, p, cfg = tiny
    monkeypatch.setattr(tfm, "decode_attention", _refuse)
    monkeypatch.setattr(tfm, "decode_attention_multi", _refuse)
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (1, 8), 0, 97))
    spk = np.ones((1, 256), np.float32)
    jkv = jtfm.KVCache.create(TINY, 1, 64, dtype=JAX_FORMAT[fmt])
    kv = tfm.KVCache.create(cfg, 1, 64, dtype=fmt, device="cpu")
    for tokens, pos in ((idx, 0), (idx[:, :1], 9)):
        jlogits, jkv = jtfm.forward(jp, TINY, jnp.asarray(tokens), spk_emb=jnp.asarray(spk), kv_cache=jkv,
                                    cache_pos=pos, compute_dtype=jnp.float32)
        logits, kv = tfm.forward(p, cfg, torch.from_numpy(tokens).long(), spk_emb=torch.from_numpy(spk),
                                 kv_cache=kv, cache_pos=pos, compute_dtype=torch.float32)
        np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fmt", ["int8", "int8_packed"])
def test_greedy_generate_on_quantized_cache_matches_jax(tiny, fmt):
    jp, p, cfg = tiny
    ref = jfs.generate(jp, TINY, PROMPT, jnp.asarray(SPK), key=jax.random.PRNGKey(11), max_new_tokens=20,
                       compute_dtype=jnp.float32, cache_dtype=JAX_FORMAT[fmt], **GREEDY)
    ours = fs.generate(p, cfg, PROMPT, SPK, generator=torch.Generator().manual_seed(12), max_new_tokens=20,
                       compute_dtype=torch.float32, cache_dtype=fmt, **GREEDY)
    np.testing.assert_array_equal(ours, np.asarray(ref))


def test_speculative_path_keeps_float_caches(tiny, tmp_path):
    """A quantized target cache handed to generate_spec is left as it is
    (the tokens are those of a run with no cache given), and TTS with a draft
    makes float persistent caches whatever kv_cache_dtype says."""
    _, p, cfg = tiny
    kw = dict(gamma=3, guidance_scale=3.0, max_new_tokens=12, compute_dtype=torch.float32, **GREEDY)
    quantized = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype="int8", device="cpu")
    ours = sd.generate_spec(p, cfg, p, cfg, PROMPT, SPK, kv_cache=quantized, **kw)
    np.testing.assert_array_equal(ours, sd.generate_spec(p, cfg, p, cfg, PROMPT, SPK, **kw))
    assert not quantized.k.any() and not quantized.k_scale.any()

    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    draft = dict(draft_params=small.c.first_stage_params, draft_cfg=small.c.first_stage_cfg)
    for fmt in ("int8", "int8_packed"):
        spec = TTS(small.c, device="cpu", output_dir=str(tmp_path), kv_cache_dtype=fmt, **draft)
        plain = TTS(small.c, device="cpu", output_dir=str(tmp_path), kv_cache_dtype=fmt)
        assert not spec._kv_cache.quantized and spec._kv_cache.k.dtype == torch.bfloat16
        assert plain._kv_cache.quantized and plain._kv_cache.packed == (fmt == "int8_packed")
