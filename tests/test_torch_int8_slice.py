"""The int8 serving slice as a whole, on the CPU: a 2-layer, 8-head,
1024-wide first stage with JAX-initialised weights quantized by the JAX
package (``quantize_params_int8_i32``), converted to the port, against the
JAX package on the same inputs.

* Prefill logits (T = 128, the port's int8 matmul in its plain version)
  against JAX ``forward``, whose CPU route runs the int8 reference matmul:
  atol 3e-2 * max |ref|. That reference neither rounds x nor sum(x) to bf16,
  and the c term takes back about 128 * s * sum(x), so the bf16 sum moves
  each product by up to |c| * ulp(sum x)/2; the bf16 residual stream carries
  that into the logits.
* Three teacher-forced T=1 steps through ``apply_blocks(fused_head=True)``
  (the port's int8 decode stack in its plain version, head_done=False, then
  the bf16 tied head) against an oracle of JAX ``embed_inputs``, the JAX
  decode-stack kernel with ``wfmt="i8"`` in interpret mode, ``_norm`` and
  ``output_logits``: atol 3e-2 * max |ref|, each side on its own prefill's
  cache.
* A 128-wide int8 model misses the decode stack's conditions (dim is not a
  multiple of 1024), so each of its layers runs ``_linear`` (int8 matmul
  at M = B) and the decode attention, as the JAX package's CPU route does:
  prefill and three steps within 5e-2 * max |ref| (that route's reference
  matmul does not round sum(x) to bf16, and at this width its c term is
  a larger share of each product).
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
from metavoice_tpu.utils import checkpoint as jckpt  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

# the JAX kernel in interpret mode, compiled once a shape (pos is traced) and shared by the cases
_jax_stack = jax.jit(jax_decode_stack, static_argnames=("n_head", "n_kv_head", "norm_eps", "wfmt", "interpret"))

PROMPT_LEN = 53
STEPS = 3
TOL = 3e-2
NARROW_TOL = 5e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(jcfg, seed):
    jp = _jax_init(jax.random.PRNGKey(seed), cfg=jcfg, dtype=jnp.bfloat16)
    jq = jax.jit(jqz.quantize_params_int8_i32)(jp)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jq, cfg, ckpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _build(j_first_stage_config(n_layer=2, n_head=8, dim=1024, block_size=512), 0)


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


def test_decode_steps_match_jax_stack_kernel(model, prefilled):
    jcfg, jq, cfg, params = model
    (_, t_true, spk2, steps), (_, jkv, _, kv) = prefilled
    assert tfm.int8_stack_ok(params, cfg, 2, torch.bfloat16)
    jk, jv = jkv.k, jkv.v
    jmask = jfs.make_spk_cond_mask(1)
    lay = jq["layers"]
    mats = [lay[k][f] for k in ("wqkv", "wo", "w1", "w3", "w2") for f in ("p8", "sc8")]
    for i, tok in enumerate(steps):
        pos = t_true + i
        idx = np.full((2, 1), tok, np.int64)
        jx = jtfm.embed_inputs(jq, jcfg, jnp.asarray(idx), jnp.asarray([pos]), jnp.asarray(spk2),
                               jmask, jnp.bfloat16)
        jxo, jk, jv = _jax_stack(
            jx[:, 0], lay["attn_norm_w"], lay["ffn_norm_w"], *mats, jk, jv,
            jnp.asarray(pos, jnp.int32), jcfg.n_head, n_kv_head=jcfg.n_local_heads,
            norm_eps=jcfg.norm_eps, wfmt="i8", interpret=True,
        )
        jh = jtfm._norm(jxo[:, None, :], jq["ln_f_w"], None, jcfg.norm_type, jcfg.norm_eps)
        jlg = jtfm.output_logits(jq, jcfg, jh)[0][:, 0, :]
        x = tfm.embed_inputs(params, cfg, torch.from_numpy(idx), torch.tensor([pos]),
                             torch.from_numpy(spk2), fs.make_spk_cond_mask(1, device="cpu"), torch.bfloat16)
        out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
        assert not head_done and out.shape == (2, 1, cfg.dim)  # the int8 mode keeps the bf16 head
        logits = tfm.output_logits(params, cfg, out)[0][:, 0, :]
        _max_close(logits.numpy(), np.asarray(jlg))


def _ref_wav(tmp_path) -> str:
    sr = 16000
    t = np.arange(4 * sr) / sr
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    return ref


def test_jax_npz_int8_tts_writes_wav(model, tmp_path):
    """The file ``cli quantize --mode int8`` writes loads through load_npz
    and params_from_numpy, and TTS takes it as int8 from its packed leaves."""
    jcfg, jq, cfg, params = model
    path = str(tmp_path / "first_stage_int8.npz")
    jckpt.save_npz(path, jax.tree.map(np.asarray, jq), meta={"quantisation_mode": "int8"})
    tree, meta = ckpt.load_npz(path)
    loaded = ckpt.params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert meta["quantisation_mode"] == "int8" and Q.is_int8_i32(loaded["layers"]["w2"])
    assert torch.equal(loaded["layers"]["w2"]["p8"], params["layers"]["w2"]["p8"])
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=loaded, first_stage_cfg=cfg)
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), enforce_min_ref_duration=False)
    assert tts.quantisation_mode == "int8"  # taken from the packed leaves
    out = tts.synthesise("Hello there, int eight.", _ref_wav(tmp_path), max_new_tokens=12)
    wav, wav_sr = aio.read_wav(out)
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert 0 < tts.stats["decode_steps"] <= 11
    # CPU tensors take the plain versions, which launch nothing
    assert all(tts.stats[f"k{i}_launches"] == 0 for i in (1, 2, 3, 7, 8))


def test_int8_packed_is_int8(tmp_path):
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    trees = {}
    for mode in ("int8", "int8_packed"):
        tts = TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode=mode)
        assert tts.quantisation_mode == "int8"
        trees[mode] = tts.c.first_stage_params
    for key in ("wqkv", "wo", "w1", "w3", "w2"):
        for f in ("p8", "sc8"):
            a, b = trees["int8"]["layers"][key][f], trees["int8_packed"]["layers"][key][f]
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    assert small.c.first_stage_params["layers"]["wqkv"].dtype == torch.bfloat16  # caller's tree kept


def test_int8_plain_raises_naming_its_kernels(tmp_path):
    """``int8_plain`` is ported (tests/test_torch_int8_plain_slice.py): the
    mode builds plain {"q", "scales"} leaves, and a tree that mixes them with
    the packed int8 leaves, or with the JAX package's groupwise int4 leaves
    (K12, K13), is refused."""
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    plain = TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode="int8_plain")
    lay = plain.c.first_stage_params["layers"]
    assert plain.quantisation_mode == "int8_plain" and Q.is_int8_plain(lay["wqkv"]) and not Q.is_int8_i32(lay["wqkv"])
    packed = TTS(small.c, device="cpu", output_dir=str(tmp_path), quantisation_mode="int8")
    mixed = dict(lay, wo=packed.c.first_stage_params["layers"]["wo"])
    with pytest.raises(ValueError, match="int8"):
        TTS(dataclasses.replace(small.c, first_stage_params=dict(plain.c.first_stage_params, layers=mixed)),
            device="cpu", output_dir=str(tmp_path))
    grouped = Q.quantize_params_int4(small.c.first_stage_params, groupsize=64)["layers"]["wo"]
    for kernel, leaf in (("K12", grouped), ("K13", {"p": Q.pack_int4(grouped["q"][0])[None],
                                                    "scales": grouped["scales"], "zeros": grouped["zeros"]})):
        legacy = dict(plain.c.first_stage_params, layers=dict(lay, wo=leaf))
        with pytest.raises(ValueError, match="groupwise int4"):
            TTS(dataclasses.replace(small.c, first_stage_params=legacy), device="cpu", output_dir=str(tmp_path))


def test_narrow_int8_model_runs_per_layer_like_jax():
    narrow = _build(j_first_stage_config(n_layer=2, n_head=4, dim=128, block_size=256), 1)
    jcfg, jq, cfg, params = narrow
    assert not tfm.int8_stack_ok(params, cfg, 2, torch.bfloat16)
    inputs = _inputs(jcfg, seed=1)
    _, t_true, spk2, steps = inputs
    jlogits, jkv, logits, kv = _prefill(narrow, inputs)
    _max_close(logits[:, :t_true], jlogits[:, :t_true], NARROW_TOL)
    mask, jmask = fs.make_spk_cond_mask(1, device="cpu"), jfs.make_spk_cond_mask(1)
    for i, tok in enumerate(steps):
        pos = t_true + i
        idx = np.full((2, 1), tok, np.int64)
        jlg, jkv = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2),
                                spk_cond_mask=jmask, kv_cache=jkv, cache_pos=pos,
                                compute_dtype=jnp.bfloat16)
        lg, kv = tfm.forward(params, cfg, torch.from_numpy(idx), spk_emb=torch.from_numpy(spk2),
                             spk_cond_mask=mask, kv_cache=kv, cache_pos=pos, compute_dtype=torch.bfloat16)
        _max_close(lg[0].numpy(), np.asarray(jlg[0]), NARROW_TOL)
