"""The plain-int8 slice (``quantisation_mode="int8_plain"``) as a whole, on
the CPU: 2-layer, 4-head, 512-wide first stages (FFN 1536) with
JAX-initialised weights quantized by the JAX package's
``quantize_params_int8``, converted to the port, against the JAX package on
the same inputs.

* Prefill logits (T = 128, K11's plain version for every projection)
  against JAX ``forward``, whose CPU route runs the int8 reference matmul
  (the same arithmetic on bf16 activations): atol 3e-2 * max |ref|, the
  bf16 residual stream and prefill attention rounding apart over 2 layers.
* Three teacher-forced T = 1 steps of the MHA model (``apply_blocks``: norm,
  K9, residual, norm, K10, residual, in their plain versions) against an
  oracle of JAX ``embed_inputs``, its ``body`` composed from the
  interpret-mode K9 and K10 kernels, ``_norm`` and ``output_logits``: atol
  3e-2 * max |ref|, each side on its own prefill's cache.
* A GQA model (2 kv heads) misses K9, so its T = 1 layers take K11, the
  multi-query attention and K10: prefill and three steps against JAX
  ``forward`` within 5e-2 * max |ref| (JAX's CPU route rounds the FFN's
  hidden products to bf16 where K10 keeps them in f32).
* ``TTS`` takes a JAX-quantised tree as ``int8_plain`` from its leaves and
  writes a wav; ``quantisation_mode="int8_plain"`` quantizes a bf16 tree.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

PROMPT_LEN = 53
STEPS = 3
TOL = 3e-2
GQA_TOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(n_local_heads, seed):
    jcfg = j_first_stage_config(n_layer=2, n_head=4, n_local_heads=n_local_heads, dim=512, intermediate_size=1536,
                                block_size=256)
    jq = jax.jit(jqz.quantize_params_int8)(_jax_init(jax.random.PRNGKey(seed), cfg=jcfg, dtype=jnp.bfloat16))
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jq, cfg, ckpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu", dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def model():
    return _build(4, 0)


def _inputs(jcfg, seed=0):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, jcfg.vocab_size, size=PROMPT_LEN)
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=jcfg.block_size)
    spk = rng.normal(size=(1, 256)).astype(np.float32)
    steps = rng.integers(0, 1024, size=STEPS)  # teacher-forced audio tokens
    return np.stack([padded] * 2), t_true, np.repeat(spk, 2, axis=0), steps


def _max_close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _prefill(model, inputs):
    jcfg, jq, cfg, params = model
    idx, _, spk2, _ = inputs
    jkv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.bfloat16)
    jlogits, jkv = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2),
                                spk_cond_mask=jfs.make_spk_cond_mask(1), kv_cache=jkv, cache_pos=0,
                                compute_dtype=jnp.bfloat16)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.bfloat16, device="cpu")
    logits, kv = tfm.forward(params, cfg, torch.from_numpy(idx).long(), spk_emb=torch.from_numpy(spk2),
                             spk_cond_mask=fs.make_spk_cond_mask(1, device="cpu"), kv_cache=kv, cache_pos=0,
                             compute_dtype=torch.bfloat16)
    return np.asarray(jlogits[0]), jkv, logits[0].numpy(), kv


@pytest.fixture(scope="module")
def prefilled(model):
    inputs = _inputs(model[0])
    return inputs, _prefill(model, inputs)


def test_prefill_logits_match_jax_forward(prefilled):
    (_, t_true, _, _), (jlogits, _, logits, _) = prefilled
    assert logits.shape == jlogits.shape
    _max_close(logits[:, :t_true], jlogits[:, :t_true])


_K9 = jax.jit(JA.decode_attention_block_int8, static_argnames=("n_head", "interpret"))
_K10 = jax.jit(jqz.ffn_int8, static_argnames=("tile_i", "interpret"))


def _jax_step(jq, jcfg, x, k, v, pos: int):
    """JAX's T = 1 ``body`` with the int8 attention-block kernel
    (metavoice_tpu/models/transformer.py:889-918) and the fused FFN of
    ``_mlp`` (:460-476), both in interpret mode, then the final norm."""
    lay = jq["layers"]
    for li in range(jcfg.n_layer):
        xa = jtfm._norm(x, lay["attn_norm_w"][li], None, jcfg.norm_type, jcfg.norm_eps)
        y2, k, v = _K9(xa[:, 0], lay["wqkv"]["q"][li], lay["wqkv"]["scales"][li], lay["wo"]["q"][li],
                       lay["wo"]["scales"][li], k, v, jnp.asarray(li, jnp.int32), jnp.asarray(pos, jnp.int32),
                       n_head=jcfg.n_head, interpret=True)
        h = x + y2[:, None, :].astype(x.dtype)
        hn = jtfm._norm(h, lay["ffn_norm_w"][li], None, jcfg.norm_type, jcfg.norm_eps)
        mats = [lay[key][f][li] for key in ("w1", "w3", "w2") for f in ("q", "scales")]
        f = _K10(hn[:, 0], *mats, tile_i=512, interpret=True)
        x = h + f[:, None, :].astype(x.dtype)
    return jtfm._norm(x, jq["ln_f_w"], None, jcfg.norm_type, jcfg.norm_eps), k, v


def test_decode_steps_match_jax_k9_k10(model, prefilled, monkeypatch):
    jcfg, jq, cfg, params = model
    (_, t_true, spk2, steps), (_, jkv, _, kv) = prefilled
    assert tfm.int8_block_ok(params, cfg, 2, torch.bfloat16)
    calls = []
    monkeypatch.setattr(tfm, "decode_attention", lambda *a, **k: calls.append("K1"))
    jk, jv = jkv.k, jkv.v
    jmask = jfs.make_spk_cond_mask(1)
    for i, tok in enumerate(steps):
        pos = t_true + i
        idx = np.full((2, 1), tok, np.int64)
        jx = jtfm.embed_inputs(jq, jcfg, jnp.asarray(idx), jnp.asarray([pos]), jnp.asarray(spk2), jmask,
                               jnp.bfloat16)
        jh, jk, jv = _jax_step(jq, jcfg, jx, jk, jv, pos)
        jlg = jtfm.output_logits(jq, jcfg, jh)[0][:, 0, :]
        x = tfm.embed_inputs(params, cfg, torch.from_numpy(idx), torch.tensor([pos]),
                             torch.from_numpy(spk2), fs.make_spk_cond_mask(1, device="cpu"), torch.bfloat16)
        out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
        assert not head_done and out.shape == (2, 1, cfg.dim)  # the bf16 tied head stays with the caller
        logits = tfm.output_logits(params, cfg, out)[0][:, 0, :]
        _max_close(logits.numpy(), np.asarray(jlg))
    assert not calls  # every layer went through K9


def test_gqa_model_misses_k9_and_matches_jax_forward(monkeypatch):
    gqa = _build(2, 1)
    jcfg, jq, cfg, params = gqa
    assert not tfm.int8_block_ok(params, cfg, 2, torch.bfloat16)
    counts = {"k9": 0, "k10": 0}
    monkeypatch.setattr(tfm, "decode_attention_block_int8", lambda *a, **k: pytest.fail("K9 ran"))

    def k10(*a, **k):
        counts["k10"] += 1
        return Q.ffn_int8(*a, **k)

    monkeypatch.setattr(tfm, "ffn_int8", k10)
    inputs = _inputs(jcfg, seed=1)
    _, t_true, spk2, steps = inputs
    jlogits, jkv, logits, kv = _prefill(gqa, inputs)
    _max_close(logits[:, :t_true], jlogits[:, :t_true], GQA_TOL)
    mask, jmask = fs.make_spk_cond_mask(1, device="cpu"), jfs.make_spk_cond_mask(1)
    for i, tok in enumerate(steps):
        pos = t_true + i
        idx = np.full((2, 1), tok, np.int64)
        jlg, jkv = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2), spk_cond_mask=jmask,
                                kv_cache=jkv, cache_pos=pos, compute_dtype=jnp.bfloat16)
        lg, kv = tfm.forward(params, cfg, torch.from_numpy(idx), spk_emb=torch.from_numpy(spk2),
                             spk_cond_mask=mask, kv_cache=kv, cache_pos=pos, compute_dtype=torch.bfloat16)
        _max_close(lg[0].numpy(), np.asarray(jlg[0]), GQA_TOL)
    assert counts["k10"] == cfg.n_layer * STEPS


def _ref_wav(tmp_path) -> str:
    sr = 16000
    t = np.arange(4 * sr) / sr
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    return ref


def test_jax_quantized_tree_tts_writes_wav(model, tmp_path):
    """A JAX ``quantize_params_int8`` tree (what ``cli quantize --mode
    int8_plain`` writes) is taken as int8_plain from its leaves."""
    _, _, cfg, params = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), enforce_min_ref_duration=False)
    assert tts.quantisation_mode == "int8_plain" and tts.c.first_stage_params is params
    out = tts.synthesise("Hello there, plain int eight.", _ref_wav(tmp_path), max_new_tokens=12)
    wav, wav_sr = aio.read_wav(out)
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert 0 < tts.stats["decode_steps"] <= 11
    # CPU tensors take the plain versions, which launch nothing
    assert all(tts.stats[f"k{i}_launches"] == 0 for i in range(1, 12))


def test_int8_plain_mode_quantizes_and_refuses_mixed_trees(tmp_path):
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    tts = TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode="int8_plain")
    lay = tts.c.first_stage_params["layers"]
    assert tts.quantisation_mode == "int8_plain" and all(Q.is_int8_plain(lay[k]) for k in ("wqkv", "wo", "w2"))
    assert small.c.first_stage_params["layers"]["wqkv"].dtype == torch.bfloat16  # caller's tree kept
    for mode in ("int4", "int8"):
        with pytest.raises(ValueError, match="int8_plain"):
            TTS(tts.c, device="cpu", output_dir=str(tmp_path), quantisation_mode=mode)
    mixed = dict(tts.c.first_stage_params, layers=dict(lay, w2=Q.quantize_params_int8_i32(
        {"layers": {"w2": small.c.first_stage_params["layers"]["w2"]}})["layers"]["w2"]))
    with pytest.raises(ValueError, match="int8_plain"):
        TTS(dataclasses.replace(tts.c, first_stage_params=mixed), device="cpu", output_dir=str(tmp_path))
