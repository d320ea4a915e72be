"""The groupwise int4 slice as a whole, and the quantized first-stage
``.npz`` files, on the CPU.

* 2-layer, 4-head, 256-wide first stages (FFN 512) with JAX-initialised
  weights quantized by the JAX package's ``quantize_params_int4`` and
  ``_packed`` (groupsize 64), converted to the port: prefill logits (T = 128,
  M = 256 rows, every projection through K12's or K13's plain version) and
  8 teacher-forced T = 1 steps (five ``_linear`` calls and the decode
  attention a layer) against JAX ``forward``, whose CPU route runs the f32
  ``matmul_int4_reference``: within 1e-2 of max |ref| (the kernels round
  the weights to bf16, and the bf16 residual stream and attention round
  apart over 2 layers; 0.36% measured). A 256-token bucket (M = 512) takes the dense f32
  route, with no K12/K13 call.
* ``TTS`` takes either tree as it is (``quantisation_mode`` None) and writes
  a finite wav; a tree that mixes groupwise int4 with another quantized
  kind, or a requested mode, is refused.
* The quantize CLI's writer, JAX ``save_first_stage_quantized``, in four
  formats (int4-in-int32, int8-in-int32, plain int8, groupwise int4): each
  file loads through the port's ``load_first_stage_npz`` with every leaf's
  dtype and bits, the config and the mode of JAX's ``load_first_stage_npz``;
  a file the port's ``save_first_stage_quantized`` writes loads through
  JAX's loader identically; a trainer-style ``model_args`` file keeps its
  architecture; one int4-in-int32 file goes through ``TTS`` to a wav.
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
from metavoice_tpu.utils import checkpoint as jckpt  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

PROMPT_LEN = 53
STEPS = 8
TOL = 1e-2
GS = 64


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(packed: bool):
    jcfg = j_first_stage_config(n_layer=2, n_head=4, dim=256, intermediate_size=512, block_size=384)
    quantize = jqz.quantize_params_int4_packed if packed else jqz.quantize_params_int4
    jq = jax.jit(quantize, static_argnames=("groupsize",))(
        _jax_init(jax.random.PRNGKey(int(packed)), cfg=jcfg, dtype=jnp.bfloat16), groupsize=GS)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    return jcfg, jq, cfg, ckpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu", dtype=torch.bfloat16)


@pytest.fixture(scope="module", params=[False, True], ids=["K12", "K13"])
def model(request):
    return request.param, _build(request.param)


def _max_close(got, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _count_kernel(monkeypatch, packed: bool) -> list:
    name = "matmul_int4_packed" if packed else "matmul_int4"
    calls = []
    monkeypatch.setattr(tfm, name, lambda x, *a: calls.append(x.shape[0]) or getattr(Q, name)(x, *a))
    return calls


def test_prefill_and_steps_match_jax_forward(model, monkeypatch):
    packed, (jcfg, jq, cfg, params) = model
    assert all(Q.is_int4_grouped(params["layers"][k]) for k in ("wqkv", "wo", "w1", "w3", "w2"))
    calls = _count_kernel(monkeypatch, packed)
    attn = []
    monkeypatch.setattr(tfm, "decode_attention", lambda *a, **k: attn.append(1) or A.decode_attention(*a, **k))
    rng = np.random.default_rng(0)
    padded, t_true = jfs.pad_to_bucket(rng.integers(0, jcfg.vocab_size, size=PROMPT_LEN), 128,
                                       max_len=jcfg.block_size)
    idx = np.stack([padded] * 2)
    spk2 = np.repeat(rng.normal(size=(1, 256)).astype(np.float32), 2, axis=0)
    jmask, mask = jfs.make_spk_cond_mask(1), fs.make_spk_cond_mask(1, device="cpu")
    jkv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.bfloat16)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.bfloat16, device="cpu")
    jlg, jkv = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2), spk_cond_mask=jmask,
                            kv_cache=jkv, cache_pos=0, compute_dtype=jnp.bfloat16)
    lg, kv = tfm.forward(params, cfg, torch.from_numpy(idx).long(), spk_emb=torch.from_numpy(spk2),
                         spk_cond_mask=mask, kv_cache=kv, cache_pos=0, compute_dtype=torch.bfloat16)
    _max_close(lg[0][:, :t_true].numpy(), np.asarray(jlg[0])[:, :t_true])
    assert calls == [2 * 128] * 5 * cfg.n_layer and not attn
    calls.clear()
    for i, tok in enumerate(rng.integers(0, 1024, size=STEPS)):
        pos = t_true + i
        tok_idx = np.full((2, 1), tok, np.int64)
        jlg, jkv = jtfm.forward(jq, jcfg, jnp.asarray(tok_idx), spk_emb=jnp.asarray(spk2), spk_cond_mask=jmask,
                                kv_cache=jkv, cache_pos=pos, compute_dtype=jnp.bfloat16)
        lg, kv = tfm.forward(params, cfg, torch.from_numpy(tok_idx), spk_emb=torch.from_numpy(spk2),
                             spk_cond_mask=mask, kv_cache=kv, cache_pos=pos, compute_dtype=torch.bfloat16)
        _max_close(lg[0].numpy(), np.asarray(jlg[0]))
    assert calls == [2] * 5 * cfg.n_layer * STEPS and len(attn) == cfg.n_layer * STEPS


def test_long_prefill_takes_the_dense_route(model, monkeypatch):
    packed, (jcfg, jq, cfg, params) = model
    calls = _count_kernel(monkeypatch, packed)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jcfg.vocab_size, size=(2, 256))  # M = 512 rows
    spk2 = np.repeat(rng.normal(size=(1, 256)).astype(np.float32), 2, axis=0)
    jlg, _ = jtfm.forward(jq, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk2), compute_dtype=jnp.bfloat16)
    lg, _ = tfm.forward(params, cfg, torch.from_numpy(idx).long(), spk_emb=torch.from_numpy(spk2),
                        compute_dtype=torch.bfloat16)
    assert not calls
    _max_close(lg[0].numpy(), np.asarray(jlg[0]))


def _ref_wav(tmp_path) -> str:
    sr = 16000
    t = np.arange(4 * sr) / sr
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    return ref


def _synthesise(comps, tmp_path, expected_mode):
    tts = TTS(comps, device="cpu", output_dir=str(tmp_path), enforce_min_ref_duration=False)
    assert tts.quantisation_mode == expected_mode and tts.c.first_stage_params is comps.first_stage_params
    out = tts.synthesise("Hello there, group wise.", _ref_wav(tmp_path), max_new_tokens=12)
    wav, wav_sr = aio.read_wav(out)
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert 0 < tts.stats["decode_steps"] <= 11
    # CPU tensors take the plain versions, which launch nothing
    assert all(tts.stats[f"k{i}_launches"] == 0 for i in range(1, 14))


def test_groupwise_tree_tts_writes_wav(model, tmp_path):
    _, (_, _, cfg, params) = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    _synthesise(dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg), tmp_path, None)


def test_mixed_trees_and_requested_modes_are_refused(model, tmp_path):
    _, (_, _, cfg, params) = model
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    for mode in ("int4", "int8", "int8_plain"):
        with pytest.raises(ValueError, match="groupwise int4"):
            TTS(comps, device="cpu", output_dir=str(tmp_path), quantisation_mode=mode)
    w2 = {"layers": {"w2": torch.zeros(cfg.n_layer, cfg.intermediate_size, cfg.dim)}}
    lay = params["layers"]
    for other in (Q.quantize_params_int8(w2), Q.quantize_params_int8_i32(w2)):
        mixed = dict(params, layers=dict(lay, w2=other["layers"]["w2"]))
        with pytest.raises(ValueError, match="groupwise int4"):
            TTS(dataclasses.replace(comps, first_stage_params=mixed), device="cpu", output_dir=str(tmp_path))


# ------------------------------------------------------------------ quantized .npz files

FORMATS = {
    "int4": jqz.quantize_params_int4_i32,
    "int8": jqz.quantize_params_int8_i32,
    "int8_plain": jqz.quantize_params_int8,
    "groupwise_int4": jqz.quantize_params_int4,
}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """A 1-layer 1024-wide first stage (the int4 decode stack's width) in
    each format, written by the JAX package's quantize-CLI writer."""
    jcfg = j_first_stage_config(n_layer=1, n_head=8, dim=1024, intermediate_size=1024, block_size=256)
    jp = _jax_init(jax.random.PRNGKey(3), cfg=jcfg, dtype=jnp.bfloat16)
    tmp = tmp_path_factory.mktemp("npz")
    paths = {}
    for mode, quantize in FORMATS.items():
        paths[mode] = str(tmp / f"first_stage_{mode}.npz")
        jckpt.save_first_stage_quantized(paths[mode], jax.jit(quantize)(jp), jcfg, {"name": "bpe"}, mode)
    return jcfg, paths


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _leaves(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _assert_same_tree(port_tree, jax_tree):
    """Every leaf: the same dtype (torch bf16 for ml_dtypes bf16) and bits."""
    got, want = _leaves(port_tree), _leaves(jax_tree)
    assert got.keys() == want.keys()
    for key, t in got.items():
        ref = np.asarray(want[key])
        if ref.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, key
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), ref.view(np.int16), err_msg=key)
        else:
            assert t.dtype == torch.from_numpy(ref).dtype, key
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=key)


@pytest.mark.parametrize("mode", list(FORMATS))
def test_jax_written_npz_loads_as_jax_loads_it(written, mode):
    jcfg, paths = written
    jparams, j_cfg, j_tok, j_mode = jckpt.load_first_stage_npz(paths[mode])
    params, cfg, tok, got_mode = ckpt.load_first_stage_npz(paths[mode])
    _assert_same_tree(params, jparams)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg) == dataclasses.asdict(jcfg)
    assert (tok, got_mode) == (j_tok, j_mode) == ({"name": "bpe"}, mode)
    tree, meta = ckpt.load_npz(paths[mode])  # the generic reader narrows the same leaves
    _assert_same_tree(tree, jparams)
    assert meta["quantisation_mode"] == mode


def test_port_written_npz_loads_through_jax(written, tmp_path):
    jcfg, paths = written
    params, cfg, tok, mode = ckpt.load_first_stage_npz(paths["groupwise_int4"])
    path = str(tmp_path / "port.npz")
    ckpt.save_first_stage_quantized(path, params, cfg, tok, mode)
    jparams, j_cfg, j_tok, j_mode = jckpt.load_first_stage_npz(path)
    _assert_same_tree(params, jparams)
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(jcfg) and (j_tok, j_mode) == (tok, mode)


def test_trainer_model_args_keep_their_architecture(tmp_path):
    path = str(tmp_path / "ft.npz")
    args = {"n_layer": 3, "n_head": 4, "n_embd": 256, "block_size": 512, "vocab_sizes": [97]}
    jckpt.save_npz(path, {"wtes": [np.zeros((97, 256), np.float32)]},
                   meta={"model_args": args, "meta": {"speaker_emb_size": 128, "tokenizer": {"t": 1}}})
    _, j_cfg, j_tok, j_mode = jckpt.load_first_stage_npz(path)
    params, cfg, tok, mode = ckpt.load_first_stage_npz(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg) and (tok, mode) == (j_tok, j_mode) == ({"t": 1}, None)
    assert (cfg.n_layer, cfg.dim, cfg.vocab_sizes, cfg.speaker_emb_dim) == (3, 256, (97,), 128)
    assert set(params) == {"wtes"}


def test_int4_npz_through_tts_writes_wav(written, tmp_path):
    _, paths = written
    params, cfg, _, mode = ckpt.load_first_stage_npz(paths["int4"])
    params = ckpt.params_from_numpy(params, device="cpu")
    assert mode == "int4" and params["layers"]["wqkv"]["sc"].dtype == torch.bfloat16
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    _synthesise(dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg), tmp_path, "int4")
