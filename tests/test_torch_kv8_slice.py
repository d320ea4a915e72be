"""The quantized-KV int4 slice as a whole, on the CPU: a 2-layer, 8-head,
1024-wide first stage (FFN 2048) with seeded weights packed by the port's
int4 quantizer (bit-identical to the JAX package's) and the same tree handed
to JAX, on an int8 and a packed KV cache.

* One decode step of the port's per-layer route (``apply_blocks`` at T = 1:
  norm, K5, residual, norm, K6, residual, in their plain versions) against
  the JAX package's ``body4`` composed from its interpret-mode kernels, both
  starting from the same cache (the port's prefill): the normed hidden state
  within 2e-2 of max |ref| (K5's and K6's own tolerances, carried through
  two layers); every cache byte and scale other than the new rows identical;
  layer 0's new rows (same input on both sides) within one int8 step and
  1e-6 relative in their scales; later layers' rows, whose inputs carry
  layer 0's bf16 rounding flips, within 5e-2 of max |row| dequantized (the
  depth tolerance of the decode stack's checks, chip_smoke.K3_TOL; 2.6%
  measured here).
* The routes: such a step takes K5/K6 and never the decode stack, greedy
  ``generate`` gives the same tokens on both formats (they hold the same
  int8 values), and ``TTS(quantisation_mode="int4", kv_cache_dtype=...)``
  synthesises a finite wav.
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
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402

PROMPT_LEN = 53
TOL = 2e-2
DEPTH_TOL = 5e-2


def _to_jax(node):
    if isinstance(node, dict):
        return {k: _to_jax(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_jax(v) for v in node]
    if node.dtype == torch.bfloat16:
        return jnp.asarray(node.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(node.numpy())


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
    """Seeded bf16 weights packed by the port's int4 quantizer, which is
    bit-identical to the JAX package's (tests/test_torch_quantized.py), and
    the same tree for JAX."""
    jcfg = j_first_stage_config(n_layer=2, n_head=8, dim=1024, intermediate_size=2048, block_size=256)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    gen = torch.Generator().manual_seed(0)
    dense = tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16)
    dense["layers"]["attn_norm_w"] = (1 + 0.1 * torch.randn((2, 1024), generator=gen)).to(torch.bfloat16)
    params = Q.quantize_params_int4_i32(dense)
    return jcfg, _to_jax(params), cfg, params


_K5 = jax.jit(JA.decode_attention_block_int4, static_argnames=("n_head", "n_kv_head", "interpret"))
_K6 = jax.jit(jqz.decode_ffn_int4, static_argnames=("interpret",))


def _jax_step(jq, jcfg, x, kv: "jtfm.KVCache", pos: int):
    """JAX's body4 (metavoice_tpu/models/transformer.py:850-887) from its
    interpret-mode kernels, then the final norm -> (x, cache)."""
    lay = jq["layers"]
    k, v, ks, vs = kv
    for li in range(jcfg.n_layer):
        xa = jtfm._norm(x, lay["attn_norm_w"][li], None, jcfg.norm_type, jcfg.norm_eps)
        y2, k, v, ks, vs = _K5(
            xa[:, 0], lay["wqkv"]["pw"], lay["wqkv"]["sc"], lay["wo"]["pw"], lay["wo"]["sc"], k, v,
            jnp.asarray(li, jnp.int32), jnp.asarray(pos, jnp.int32), n_head=jcfg.n_head,
            n_kv_head=jcfg.n_local_heads, k_scale=ks, v_scale=vs, interpret=True)
        h = x + y2[:, None, :].astype(x.dtype)
        hn = jtfm._norm(h, lay["ffn_norm_w"][li], None, jcfg.norm_type, jcfg.norm_eps)
        f = _K6(hn[:, 0], lay["w1"]["pw"], lay["w1"]["sc"], lay["w3"]["pw"], lay["w3"]["sc"],
                                lay["w2"]["pw"], lay["w2"]["sc"], jnp.asarray(li, jnp.int32), interpret=True)
        x = h + f[:, None, :].astype(x.dtype)
    x = jtfm._norm(x, jq["ln_f_w"], None, jcfg.norm_type, jcfg.norm_eps)
    return x, jtfm.KVCache(k=k, v=v, k_scale=ks, v_scale=vs)


def _positions(kv, packed: bool):
    """(values (L, S, B, H, Dh) int32, scales (L, S, W) f32) position-major."""
    k, v, ks, vs = (np.array(t.numpy() if isinstance(t, torch.Tensor) else t) for t in kv)
    if packed:
        unpack = lambda w: np.stack([(w << (24 - 8 * j)) >> 24 for j in range(4)], 2).reshape(  # noqa: E731
            w.shape[0], -1, *w.shape[2:])
        k, v = unpack(k), unpack(v)
        tab = lambda t: t[:, :, :, 0].transpose(0, 2, 1, 3).reshape(t.shape[0], -1, t.shape[-1])  # noqa: E731
        return k.astype(np.int32), v.astype(np.int32), tab(ks), tab(vs)
    return k.astype(np.int32), v.astype(np.int32), ks[:, :, 0], vs[:, :, 0]


@pytest.mark.parametrize("fmt", ["int8", "int8_packed"])
def test_one_step_matches_jax_body4(model, fmt, monkeypatch):
    jcfg, jq, cfg, params = model
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, size=PROMPT_LEN)
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=jcfg.block_size)
    idx = np.stack([padded] * 2)
    spk2 = np.repeat(rng.normal(size=(1, 256)).astype(np.float32), 2, axis=0)
    jmask = jfs.make_spk_cond_mask(1)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=fmt, device="cpu")
    tfm.forward(params, cfg, torch.from_numpy(idx).long(), spk_emb=torch.from_numpy(spk2),
                spk_cond_mask=fs.make_spk_cond_mask(1, device="cpu"), kv_cache=kv, cache_pos=0)
    # both sides start from the port's prefilled cache
    jkv = jtfm.KVCache(*[jnp.asarray(t.numpy()) for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)])
    tok, pos = 77, t_true
    jx = jtfm.embed_inputs(jq, jcfg, jnp.full((2, 1), tok), jnp.asarray([pos]), jnp.asarray(spk2), jmask,
                           jnp.bfloat16)
    jout, jkv2 = _jax_step(jq, jcfg, jx, jkv, pos)

    calls = []
    monkeypatch.setattr(tfm, "decode_stack_int4", lambda *a, **k: calls.append("K3"))
    x = tfm.embed_inputs(params, cfg, torch.full((2, 1), tok), torch.tensor([pos]), torch.from_numpy(spk2),
                         fs.make_spk_cond_mask(1, device="cpu"), torch.bfloat16)
    out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
    assert not calls and not head_done and out.shape == (2, 1, cfg.dim)
    ref = np.asarray(jout, np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL * np.abs(ref).max(), rtol=0)

    packed = fmt == "int8_packed"
    got = _positions((kv.k, kv.v, kv.k_scale, kv.v_scale), packed)
    want = _positions((jkv2.k, jkv2.v, jkv2.k_scale, jkv2.v_scale), packed)
    others = np.ones(cfg.block_size, bool)
    others[pos] = False
    bkv = 2 * cfg.n_local_heads
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[:, others], w[:, others])
    for i in range(2):  # k, v
        (gv, wv), (gs, ws) = (got[i], want[i]), (got[2 + i], want[2 + i])
        assert np.abs(gv[0, pos] - wv[0, pos]).max() <= 1
        np.testing.assert_allclose(gs[0, pos, :bkv], ws[0, pos, :bkv], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(gs[:, pos, bkv:], ws[:, pos, bkv:])  # the padding stays 0
        deq = lambda v, s: v[1:, pos] * s[1:, pos, :bkv].reshape(-1, 2, cfg.n_local_heads, 1)  # noqa: E731
        ref_rows = deq(wv, ws)
        np.testing.assert_allclose(deq(gv, gs), ref_rows, atol=DEPTH_TOL * np.abs(ref_rows).max(), rtol=0)


def test_generate_routes_and_formats_agree(model, monkeypatch):
    """Greedy generate through K5/K6's plain versions: each T = 1 step
    launches K5 and K6 once a layer and never the decode stack, and the two
    quantized formats give the same tokens."""
    _, _, cfg, params = model
    counts = {"k5": 0, "k6": 0}

    def counted(name, fn):
        def run(*a, **k):
            counts[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tfm, "decode_attention_block_int4", counted("k5", A.decode_attention_block_int4))
    monkeypatch.setattr(tfm, "decode_ffn_int4", counted("k6", Q.decode_ffn_int4))
    monkeypatch.setattr(tfm, "decode_stack_int4", lambda *a, **k: pytest.fail("the decode stack ran"))
    prompt = list(range(2100, 2120))
    spk = np.random.default_rng(3).normal(size=256).astype(np.float32)
    runs = {}
    for fmt in ("int8", "int8_packed"):
        stats = {}
        counts.update(k5=0, k6=0)
        runs[fmt] = fs.generate(params, cfg, prompt, spk, temperature=1e-6, top_p=1.0, max_new_tokens=6,
                                cache_dtype=fmt, stats=stats)
        assert counts == {"k5": cfg.n_layer * stats["decode_steps"], "k6": cfg.n_layer * stats["decode_steps"]}
        assert stats["decode_steps"] == 5
    np.testing.assert_array_equal(runs["int8"], runs["int8_packed"])


@pytest.mark.parametrize("fmt", ["int8", "int8_packed"])
def test_int4_tts_on_quantized_cache_writes_wav(model, tmp_path, fmt):
    _, _, cfg, params = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), enforce_min_ref_duration=False,
              quantisation_mode="int4", kv_cache_dtype=fmt)
    assert tts._kv_cache.quantized and tts._kv_cache.packed == (fmt == "int8_packed")
    sr = 16000
    t = np.arange(4 * sr) / sr
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    wav, wav_sr = aio.read_wav(tts.synthesise("Hello there, int eight cache.", ref, max_new_tokens=8))
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert 0 < tts.stats["decode_steps"] <= 7
    # CPU tensors take the plain versions, which launch nothing
    assert all(tts.stats[f"k{i}_launches"] == 0 for i in range(1, 9) if f"k{i}_launches" in tts.stats)
