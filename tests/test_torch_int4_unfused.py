"""The unfused int4 decode route on the CPU: a T = 1 step of int4-in-int32
layers that neither the decode-stack kernel (K3) nor the per-layer kernels
(K5/K6) take runs the ordinary per-layer loop, each projection through
``_linear`` (K2's plain version here, the activations zero-padded to the
packed K) and the decode attention, as the JAX package's CPU route does.

* JAX's own configuration (``tests/test_int4_i32.py``: 2L/4H/128d, vocab
  97, FFN 256), the weights seeded with numpy and packed by JAX's
  ``quantize_params_int4_i32``: one cached step through ``apply_blocks`` in
  both packages from the same cache within ``STEP_TOL`` of max |ref|, the
  new cache rows within one bf16 ulp; then 8 generated tokens under the
  same injected Gumbel noise, identical.
* A 2-layer model at the full width (2048d/16H, FFN 5632): 16 rows on a
  bf16 cache and 12 rows on an int8 cache, one step against JAX's CPU route
  from the same cache, within ``STEP_TOL``.
* ``TTS(quantisation_mode="int4")`` builds on such a first stage and on
  such a draft, names the route and synthesises.

Tolerances: the port's projections follow the kernel's arithmetic (bf16
group sums times c), JAX's CPU reference keeps the group sums in f32, and
c (about -7.5 s) takes back most of the nibble products, so that rounding
shows in the output; f32 sums run in other orders too, and a bf16 rounding
of the residual stream or of an activation landing one ulp apart spreads
through the next layer. STEP_TOL holds outputs and new cache rows at 3e-2
of their max, the tolerance tests/test_torch_int4_slice.py gives the same
comparison at prefill (measured: 0.5% at dim 128, 1.0% at 16 rows and 1.05%
at 12 rows on the int8 cache at the full width).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX forward compiled once a shape and shared by every step (cache_pos is traced)
_jax_forward = jax.jit(jtfm.forward, static_argnames=("cfg", "compute_dtype"))

STEP_TOL = 3e-2
TINY = dict(n_layer=2, n_head=4, dim=128, block_size=64, vocab_sizes=(97,), intermediate_size=256)
WIDE = dict(n_layer=2, block_size=256)  # 2048d/16H, FFN 5632: the first stage's widths
EOA = 96  # the tiny vocab's end of audio, as in tests/test_int4_i32.py
N_TOKENS = 8
GUIDANCE, TEMPERATURE, TOP_P = 3.0, 0.5, 0.95


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed: int, **overrides):
    """Numpy-seeded weights in JAX's tree, packed by JAX's int4 quantizer ->
    (JAX config, JAX tree, port config, port tree)."""
    jcfg = j_first_stage_config(**overrides)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "norm_w" in name or "ln_f_w" in name:
            w = 1 + 0.1 * rng.standard_normal(s.shape, dtype=np.float32)
        else:
            w = rng.standard_normal(s.shape, dtype=np.float32) * (0.5 / np.sqrt(s.shape[-2] if len(s.shape) > 1 else 1))
        return jnp.asarray(w, jnp.bfloat16)

    jq = jax.jit(jqz.quantize_params_int4_i32)(jax.tree_util.tree_map_with_path(leaf, shapes))  # eagerly: seconds
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jq, cfg, params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _model(0, **TINY)


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _random_cache(cfg, rows: int, fmt, pos: int, rng):
    """A port cache whose slots [0, pos) hold seeded values, and the same for JAX."""
    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=fmt, device="cpu")
    shape = (cfg.n_layer, pos, rows, cfg.n_local_heads, cfg.head_dim)
    for t in (kv.k, kv.v):
        if fmt == "int8":
            t[:, :pos] = torch.from_numpy(rng.integers(-127, 128, size=shape, dtype=np.int8))
        else:
            t[:, :pos] = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(t.dtype)
    if fmt == "int8":
        bkv = rows * cfg.n_local_heads
        for t in (kv.k_scale, kv.v_scale):
            t[:, :pos, 0, :bkv] = torch.from_numpy(rng.uniform(0.002, 0.02, (cfg.n_layer, pos, bkv)).astype(np.float32))
    parts = [kv.k, kv.v] + ([kv.k_scale, kv.v_scale] if fmt == "int8" else [None, None])
    jkv = jtfm.KVCache(*[None if t is None else _to_jax(t.clone()) for t in parts])
    return kv, jkv


def _one_step(model, rows: int, fmt, pos: int, seed: int):
    """One T = 1 step of the port and of JAX from the same cache -> the normed
    hidden states and the caches (port, JAX)."""
    jcfg, jq, cfg, params = model
    rng = np.random.default_rng(seed)
    kv, jkv = _random_cache(cfg, rows, fmt, pos, rng)
    tokens = rng.integers(0, jcfg.vocab_size, size=(rows, 1))
    spk = rng.standard_normal((rows, 256), dtype=np.float32)
    assert tfm.int4_decode_route(params, cfg, rows, kv.k.dtype) == "unfused"
    jx = jtfm.embed_inputs(jq, jcfg, jnp.asarray(tokens), jnp.asarray([pos]), jnp.asarray(spk), None,
                           jnp.bfloat16)
    jmask = jtfm.causal_mask_for(jnp.asarray([pos]), jcfg.block_size)[None, None]
    jout, jkv = jtfm.apply_blocks(jq, jcfg, jx, jmask, jkv, jnp.asarray(pos, jnp.int32))
    x = tfm.embed_inputs(params, cfg, torch.from_numpy(tokens), torch.tensor([pos]), torch.from_numpy(spk), None,
                         torch.bfloat16)
    out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
    assert not head_done and out.shape == (rows, 1, cfg.dim)
    return out.float().numpy(), np.asarray(jout, np.float32), kv, jkv


def _close(got, ref, tol=STEP_TOL):
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0)


def test_step_at_dim_128_matches_jax(tiny):
    got, ref, kv, jkv = _one_step(tiny, 2, torch.bfloat16, 21, seed=1)
    _close(got, ref)
    # the new rows of every layer, written at pos 21, within STEP_TOL of
    # their max; no later slot written
    for new, jnew in ((kv.k, jkv.k), (kv.v, jkv.v)):
        for li in range(2):
            _close(new[li, 21].float().numpy(), np.asarray(jnew[li, 21], np.float32))
        np.testing.assert_array_equal(new[:, 22:].float().numpy(), 0)


def _jax_generate(model, prompt, spk, noise):
    """JAX's prefill and cached T = 1 forwards (its CPU route) with its sampling."""
    jcfg, jq = model[:2]
    padded, t_true = jfs.pad_to_bucket(prompt, 8, max_len=jcfg.block_size)
    kv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.float32)
    spk2 = jnp.repeat(jnp.asarray(spk).reshape(1, -1), 2, axis=0)
    mask = jfs.make_spk_cond_mask(1)

    def sample(logits, i):
        merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge(logits, GUIDANCE), TEMPERATURE), TOP_P)
        return int(jnp.argmax(merged + jnp.asarray(noise[i]), axis=-1)[0])

    logits, kv = _jax_forward(jq, jcfg, jnp.asarray(np.stack([padded] * 2)), spk_emb=spk2, spk_cond_mask=mask,
                              kv_cache=kv, cache_pos=0, compute_dtype=jnp.float32)
    out = [sample(logits[0][:, t_true - 1], 0)]
    for i in range(1, N_TOKENS):
        if out[-1] == EOA:
            break
        logits, kv = _jax_forward(jq, jcfg, jnp.full((2, 1), out[-1]), spk_emb=spk2, spk_cond_mask=mask,
                                  kv_cache=kv, cache_pos=t_true + i - 1, compute_dtype=jnp.float32)
        out.append(sample(logits[0][:, 0], i))
    return np.concatenate([np.asarray(prompt, np.int32), np.asarray(out, np.int32)])


def test_generate_at_dim_128_matches_jax_tokens(tiny, monkeypatch):
    """8 tokens in f32 under the same Gumbel noise: the same tokens, every
    step through the unfused route (no fused kernel's wrapper called)."""
    _, _, cfg, params = tiny
    for name in ("decode_stack_int4", "decode_attention_block_int4", "decode_ffn_int4"):
        monkeypatch.setattr(tfm, name, lambda *a, **k: pytest.fail("a fused int4 kernel ran"))
    rng = np.random.default_rng(2)
    prompt = (np.arange(5) + 50).tolist()
    spk = rng.standard_normal(256, dtype=np.float32)
    noise = rng.gumbel(size=(N_TOKENS, 1, cfg.vocab_size)).astype(np.float32)
    want = _jax_generate(tiny, prompt, spk, noise)
    stats = {}
    got = fs.generate(params, cfg, prompt, spk, temperature=TEMPERATURE, top_p=TOP_P, guidance_scale=GUIDANCE,
                      max_new_tokens=N_TOKENS, end_of_audio_token=EOA, prompt_pad_multiple=8,
                      compute_dtype=torch.float32, noise=torch.from_numpy(noise), stats=stats)
    assert stats["decode_steps"] == len(want) - len(prompt) - 1 > 0
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def wide():
    return _model(3, **WIDE)


@pytest.mark.parametrize("rows,fmt", [(16, torch.bfloat16), (12, "int8")], ids=["16-bf16", "12-int8"])
def test_full_width_step_matches_jax(wide, rows, fmt):
    """More rows than the fused kernels hold: the unfused route, on either cache."""
    got, ref, kv, jkv = _one_step(wide, rows, fmt, 37, seed=4)
    _close(got, ref)
    cfg = wide[2]
    for li in range(cfg.n_layer):  # the new rows, dequantized on the int8 cache
        for new, jnew, sc, jsc in ((kv.k, jkv.k, kv.k_scale, jkv.k_scale), (kv.v, jkv.v, kv.v_scale, jkv.v_scale)):
            row, jrow = new[li, 37].float().numpy(), np.asarray(jnew[li, 37], np.float32)
            if fmt == "int8":
                bkv = rows * cfg.n_local_heads
                row = row * sc[li, 37, 0, :bkv].numpy().reshape(rows, -1, 1)
                jrow = jrow * np.asarray(jsc[li, 37, 0, :bkv]).reshape(rows, -1, 1)
            _close(row, jrow)


def _ref_wav(tmp_path) -> str:
    sr = 16000
    t = np.arange(4 * sr) / sr
    path = str(tmp_path / "ref.wav")
    aio.write_wav(path, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    return path


def test_int4_tts_and_draft_at_dim_128_build_and_synthesise(tmp_path):
    """The small first stage (128 wide) in int4, alone and as an int4 draft
    of itself: both build, name the unfused route and write a finite wav."""
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    tts = TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode="int4",
              enforce_min_ref_duration=False)
    assert tts.decode_route == "unfused" and tts.draft_route is None
    ref = _ref_wav(tmp_path)
    wav, sr = aio.read_wav(tts.synthesise("Hello there.", ref, max_new_tokens=6))
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    draft = Q.quantize_params_int4_i32(small.c.first_stage_params)
    spec = TTS(small.c, device="cpu", output_dir=str(tmp_path), draft_params=draft,
               draft_cfg=small.c.first_stage_cfg, enforce_min_ref_duration=False)
    assert spec.draft_route == "unfused"
    wav, sr = aio.read_wav(spec.synthesise("Hello there.", ref, max_new_tokens=6))
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
