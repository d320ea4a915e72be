"""The int4 serving slice as a whole, on the CPU: a 2-layer, 8-head,
1024-wide first stage with JAX-initialised weights quantized by the JAX
package, converted to the port, against the JAX package on the same inputs.

* Prefill logits (T = 128, the port's int4 matmul in its plain version)
  against JAX ``forward``, whose CPU route runs the dense-dequant reference
  matmul: atol 3e-2 * max |ref| (that reference neither rounds x nor the
  group sums to bf16, and the bf16 residual stream carries the difference).
* Three teacher-forced T=1 steps through ``apply_blocks(fused_head=True)``
  (the port's decode stack and fused int4 head, in its plain version)
  against an oracle of JAX ``embed_inputs`` plus the JAX decode-stack kernel
  in interpret mode with the same head: atol 3e-2 * max |ref|, each side on
  its own prefill's cache.

The port follows the decode-stack kernel's semantics on every device, so the
steps are held against JAX's kernel and not against JAX's CPU ``generate``
(per-layer reference matmuls and the bf16 head).
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
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu.ops.decode_stack import decode_stack_int4 as jax_decode_stack  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX kernel in interpret mode, compiled once a shape (pos is traced) and shared by the cases
_jax_stack = jax.jit(jax_decode_stack, static_argnames=("n_head", "n_kv_head", "norm_eps", "wfmt", "interpret"))
# the JAX init and quantizer as one program (eagerly, op by op, they take about 20 s on one core)
_jax_int4_model = jax.jit(lambda key, cfg: jqz.quantize_params_int4_i32(jtfm.init_params(key, cfg, dtype=jnp.bfloat16)),
                          static_argnames=("cfg",))

PROMPT_LEN = 53
STEPS = 3
TOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = j_first_stage_config(n_layer=2, n_head=8, dim=1024, block_size=512)
    jq = _jax_int4_model(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    return jcfg, jq, cfg, params


@pytest.fixture(scope="module")
def inputs(model):
    jcfg = model[0]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, size=PROMPT_LEN)
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=jcfg.block_size)
    spk = rng.normal(size=(1, 256)).astype(np.float32)
    steps = rng.integers(0, 1024, size=STEPS)  # teacher-forced audio tokens
    return np.stack([padded] * 2), t_true, np.repeat(spk, 2, axis=0), steps


def _max_close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol * np.abs(ref).max(), rtol=0)


@pytest.fixture(scope="module")
def prefilled(model, inputs):
    jcfg, jq, cfg, params = model
    idx, _, spk2, _ = inputs
    mask = jfs.make_spk_cond_mask(1)
    jkv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.bfloat16)
    jlogits, jkv = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2),
                                spk_cond_mask=mask, kv_cache=jkv, cache_pos=0,
                                compute_dtype=jnp.bfloat16)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.bfloat16, device="cpu")
    logits, kv = tfm.forward(params, cfg, torch.from_numpy(idx).long(), spk_emb=torch.from_numpy(spk2),
                             spk_cond_mask=fs.make_spk_cond_mask(1, device="cpu"), kv_cache=kv, cache_pos=0,
                             compute_dtype=torch.bfloat16)
    return np.asarray(jlogits[0]), jkv, logits[0].numpy(), kv


def test_prefill_logits_match_jax_forward(prefilled, inputs):
    jlogits, _, logits, _ = prefilled
    t_true = inputs[1]
    assert logits.shape == jlogits.shape
    _max_close(logits[:, :t_true], jlogits[:, :t_true])


def test_decode_steps_match_jax_stack_kernel(model, inputs, prefilled):
    jcfg, jq, cfg, params = model
    _, t_true, spk2, steps = inputs
    _, jkv, _, kv = prefilled
    jk, jv = jkv.k, jkv.v
    jmask = jfs.make_spk_cond_mask(1)
    lay, head = jq["layers"], jq["lm_head_q"]
    mats = [lay[k][f] for k in ("wqkv", "wo", "w1", "w3", "w2") for f in ("pw", "sc")]
    for i, tok in enumerate(steps):
        pos = t_true + i
        idx = np.full((2, 1), tok, np.int64)
        jx = jtfm.embed_inputs(jq, jcfg, jnp.asarray(idx), jnp.asarray([pos]), jnp.asarray(spk2),
                               jmask, jnp.bfloat16)
        _, jk, jv, jlg = _jax_stack(
            jx[:, 0], lay["attn_norm_w"], lay["ffn_norm_w"], *mats, jk, jv,
            jnp.asarray(pos, jnp.int32), jcfg.n_head, n_kv_head=jcfg.n_local_heads,
            norm_eps=jcfg.norm_eps, ln_f_w=jq["ln_f_w"], head_pw=head["pw"], head_sc=head["sc"],
            interpret=True,
        )
        x = tfm.embed_inputs(params, cfg, torch.from_numpy(idx), torch.tensor([pos]),
                             torch.from_numpy(spk2), fs.make_spk_cond_mask(1, device="cpu"), torch.bfloat16)
        logits, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
        assert head_done and logits.shape == (2, cfg.vocab_size)
        _max_close(logits.numpy(), np.asarray(jlg)[:, : cfg.vocab_size])


def test_int4_tts_on_cpu_writes_wav(model, tmp_path):
    _, _, cfg, params = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), enforce_min_ref_duration=False)
    assert tts.quantisation_mode == "int4"  # taken from the packed leaves
    sr = 16000
    t = np.arange(4 * sr) / sr
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    path = tts.synthesise("Hello there, int four.", ref, max_new_tokens=12)
    wav, wav_sr = aio.read_wav(path)
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert 0 < tts.stats["decode_steps"] <= 11
    # CPU tensors take the plain versions, which launch nothing
    assert tts.stats["k1_launches"] == tts.stats["k2_launches"] == tts.stats["k3_launches"] == 0


def test_int4_mode_quantizes_a_dense_first_stage(tmp_path):
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    cfg = first_stage_config(n_layer=1, n_head=8, dim=1024, block_size=256)
    gen = torch.Generator().manual_seed(1)
    dense = tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16)
    comps = dataclasses.replace(small.c, first_stage_params=dense, first_stage_cfg=cfg)
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), quantisation_mode="int4")
    got = tts.c.first_stage_params
    assert Q.is_int4(got["layers"]["wqkv"]) and "lm_head_q" in got
    assert comps.first_stage_params["layers"]["wqkv"] is dense["layers"]["wqkv"]  # caller's tree kept


def test_int4_decode_at_dim_128_raises():
    """A 128-wide int4 first stage, off the fused kernels' 1024 grid, decodes
    through the unfused route (``_linear`` per projection, activations
    padded to the packed K, and the decode attention) and raises nothing: a
    prefill and one T=1 step against JAX's ``apply_blocks`` (its CPU route)
    from the same cache, within TOL (its reason as at prefill above)."""
    jcfg = j_first_stage_config(n_layer=2, n_head=4, dim=128, block_size=256)
    jq = _jax_int4_model(jax.random.PRNGKey(1), jcfg)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    assert tfm.int4_decode_route(params, cfg, 2) == "unfused"
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, device="cpu")
    # prefill runs through the int4 matmul (activations padded to K 1024)
    xp = tfm.embed_inputs(params, cfg, torch.zeros((2, 8), dtype=torch.long), torch.arange(8), None)
    mask = tfm.causal_mask_for(torch.arange(8), cfg.block_size)[None, None]
    out, _ = tfm.apply_blocks(params, cfg, xp, mask, kv, 0)
    assert out.shape == (2, 8, 128) and torch.isfinite(out.float()).all()
    jkv = jtfm.KVCache(*[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (kv.k, kv.v)], None, None)
    idx = np.array([[5], [9]])
    jx = jtfm.embed_inputs(jq, jcfg, jnp.asarray(idx), jnp.asarray([8]), None, None, jnp.bfloat16)
    jmask = jtfm.causal_mask_for(jnp.asarray([8]), jcfg.block_size)[None, None]
    jout, _ = jtfm.apply_blocks(jq, jcfg, jx, jmask, jkv, jnp.asarray(8, jnp.int32))
    x = tfm.embed_inputs(params, cfg, torch.from_numpy(idx), torch.tensor([8]), None)
    out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, 8, fused_head=True)
    assert not head_done and out.shape == (2, 1, 128)
    _max_close(out.float().numpy(), jout)


@pytest.mark.parametrize("mode", ["int8", "int8_packed", "int8_plain"])
def test_int8_modes_still_raise(model, tmp_path, mode):
    """Every int8 mode is ported (tests/test_torch_int8_slice.py,
    tests/test_torch_int8_plain_slice.py), and each still raises on a first
    stage that holds int4 leaves: one tree has one format."""
    _, _, cfg, params = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    with pytest.raises(ValueError, match="int8"):
        TTS(comps, device="cpu", output_dir=str(tmp_path), quantisation_mode=mode)


def test_unknown_mode_is_refused(tmp_path):
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="Invalid quantisation mode"):
        TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode="int3")
