"""The port's checkpoint loaders (utils/checkpoint.py, utils/convert_external.py)
against the JAX package's, each reading the same file: every leaf equal bit for
bit, every config field equal.

The files are written with torch.save in the reference's names (first and
second stage: the trainer's ``transformer.h.{i}...``; the speaker encoder:
torch.nn.LSTM's; EnCodec: the encodec package's, weight-normed) from arrays
that numpy draws from a seed, by the writers chip_smoke.py uses at full width.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from metavoice_tpu.core.config import TransformerConfig as JTransformerConfig  # noqa: E402
from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.utils import checkpoint as jck  # noqa: E402
from metavoice_tpu.utils import convert_external as jcx  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402
from metavoice_tpu_torch.utils import convert_external as cx  # noqa: E402

ECFG = dict(n_filters=2, dimension=8, codebook_size=64, n_q=8, ratios=(4, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drawer(seed):
    rng = np.random.default_rng(seed)
    return lambda *shape: torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))


def _seeded_tree(cfg, seed):
    """The port's transformer tree for ``cfg``, f32 leaves drawn by numpy."""
    draw = _drawer(seed)
    return jax.tree.map(lambda t: draw(*t.shape), tfm.init_params(cfg, device="meta"))


def _np_leaves(tree, prefix=""):
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _np_leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _np_leaves(sub, f"{prefix}{i}/").items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return {prefix[:-1]: t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()}
    a = np.asarray(tree)
    return {prefix[:-1]: a.view(np.int16) if a.dtype.name == "bfloat16" else a}


def assert_same_bits(port, ref):
    """Leaf for leaf: the same paths, dtypes, shapes and bits (bf16 as int16)."""
    p, r = _np_leaves(port), _np_leaves(ref)
    assert p.keys() == r.keys()
    for k in p:
        assert p[k].dtype == r[k].dtype and p[k].shape == r[k].shape, k
        assert p[k].tobytes() == r[k].tobytes(), k


def _same_cfg(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


FIRST_CASES = {
    # model_args and meta honoured: GQA, rmsnorm_eps, speaker_emb_size, vocab, the compile prefix
    "model_args": (dict(n_layer=2, n_head=4, n_local_heads=2, dim=64, block_size=32, vocab_sizes=(300,),
                        norm_eps=1e-6, speaker_emb_dim=128), "", True),
    "orig_mod_prefix": (dict(n_layer=2, n_head=4, dim=64, block_size=32, vocab_sizes=(300,)), "_orig_mod.", True),
    # only some args: the stock 1B shape fills the rest (vocab 2562, norm eps, the derived FFN width)
    "partial_args": (dict(n_layer=1, n_head=2, dim=32, block_size=16), "", "partial"),
    # no model_args at all: the caller's cfg
    "no_model_args": (dict(n_layer=1, n_head=2, dim=32, block_size=16, vocab_sizes=(100,),
                           intermediate_size=64), "", False),
}


@pytest.mark.parametrize("case", list(FIRST_CASES))
def test_first_stage_pt_matches_jax(case, tmp_path):
    kw, prefix, with_args = FIRST_CASES[case]
    cfg = first_stage_config(**kw)
    ckpt = cs.gpt_checkpoint(_seeded_tree(cfg, 1), cfg, {"name": "t", "special_tokens": {"<|x|>": 5}}, prefix)
    if with_args == "partial":
        ckpt["model_args"] = {k: ckpt["model_args"][k] for k in ("n_layer", "n_head", "n_embd", "block_size")}
        ckpt["meta"].pop("speaker_emb_size")
    elif not with_args:
        del ckpt["model_args"]
    path = str(tmp_path / "first_stage.pt")
    torch.save(ckpt, path)
    given = {} if with_args else {"cfg": cfg}
    jgiven = {} if with_args else {"cfg": JTransformerConfig(**dataclasses.asdict(cfg))}
    params, pcfg, tok = ck.load_first_stage_pt(path, device="cpu", **given)
    jparams, jcfg, jtok = jck.load_first_stage_pt(path, **jgiven)
    assert_same_bits(params, jparams)
    _same_cfg(pcfg, jcfg)
    assert pcfg == cfg and tok == jtok == {"name": "t", "special_tokens": {"<|x|>": 5}}


def test_second_stage_pt_and_npz_match_jax(tmp_path):
    """The layernorm/gelu/bias second stage with its six heads, as .pt and as
    the JAX package's save_npz archive (an in-repo second stage)."""
    cfg = second_stage_config(n_layer=2, n_head=2, dim=32, block_size=64)
    tree = _seeded_tree(cfg, 2)
    ckpt = cs.gpt_checkpoint(tree, cfg)
    pt = str(tmp_path / "second_stage.pt")
    torch.save(ckpt, pt)
    params, pcfg, tok = ck.load_second_stage_pt(pt, device="cpu")
    jparams, jcfg, jtok = jck.load_second_stage_pt(pt)
    assert_same_bits(params, jparams)
    assert_same_bits(params, tree)
    _same_cfg(pcfg, jcfg)
    assert tok == jtok

    npz = str(tmp_path / "second_stage.npz")
    jtree = jax.tree.map(lambda t: t.numpy(), tree)
    jtree["wpe"] = jtree["wpe"].astype(jnp_bf16())  # a bf16 leaf through __bf16_keys__
    jck.save_npz(npz, jtree, {"model_args": ckpt["model_args"], "meta": ckpt["meta"]})
    params, pcfg, _ = ck.load_second_stage_npz(npz, device="cpu")
    jparams, jcfg, _ = jck.load_second_stage_npz(npz)
    assert_same_bits(params, jparams)
    assert params["wpe"].dtype == torch.bfloat16
    _same_cfg(pcfg, jcfg)


def jnp_bf16():
    import ml_dtypes

    return ml_dtypes.bfloat16


@pytest.mark.parametrize("wrapped", [True, False])
def test_speaker_encoder_pt_matches_jax(wrapped, tmp_path):
    ckpt, want = cs.speaker_checkpoint(torch, _drawer(3))
    path = str(tmp_path / "speaker_encoder.pt")
    torch.save(ckpt if wrapped else ckpt["model_state"], path)
    got = ck.load_speaker_encoder_pt(path, device="cpu")
    assert_same_bits(got, jck.load_speaker_encoder_pt(path))
    assert_same_bits(got, want)


@pytest.mark.parametrize("best_state", [False, True])
def test_encodec_pt_matches_jax(best_state, tmp_path):
    """The encodec package's names, every conv weight-normed: the port's
    conversion is JAX's bit for bit, and the tree the writer expects (the
    weight norm folded in float64 apart from either converter)."""
    sd, want = cs.encodec_checkpoint(torch, ec.EncodecConfig(**ECFG), _drawer(4))
    path = str(tmp_path / "encodec.pt")
    torch.save({"best_state": sd} if best_state else sd, path)
    got = cx.load_encodec_pt(path, ec.EncodecConfig(**ECFG), device="cpu")
    assert_same_bits(got, jcx.load_encodec_pt(path, jec.EncodecConfig(**ECFG)))
    assert_same_bits(got, want)
    g, v = sd["decoder.model.0.conv.conv.weight_g"], sd["decoder.model.0.conv.conv.weight_v"]
    assert cx.fold_weight_norm(g, v).numpy().tobytes() == jcx.fold_weight_norm(g.numpy(), v.numpy()).tobytes()


def _int4_tree(seed=5):
    cfg = first_stage_config(n_layer=3, n_head=2, dim=256, block_size=32, intermediate_size=512)
    tree = jax.tree.map(lambda t: t.to(torch.bfloat16), _seeded_tree(cfg, seed))
    return Q.quantize_params_int4_i32(tree)


def _to_jax_np(tree):
    return jax.tree.map(lambda t: t.view(torch.int16).numpy().view(jnp_bf16()) if t.dtype == torch.bfloat16
                        else t.numpy(), tree)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spec_teacher_delta_crosses_packages(writer, tmp_path):
    """Either package reads the other's delta file; the grafted trees are the same bits."""
    qp = _int4_tree()
    path = str(tmp_path / "delta.npz")
    if writer == "port":
        ck.save_spec_teacher_delta(path, qp, 2)
    else:
        jck.save_spec_teacher_delta(path, _to_jax_np(qp), 2)
    delta, tail = ck.load_spec_teacher_delta(path)
    jdelta, jtail = jck.load_spec_teacher_delta(path)
    assert tail == jtail == 2
    assert_same_bits(delta, jdelta)
    base = _int4_tree(seed=6)
    got = ck.apply_spec_teacher_delta(base, delta, tail)
    want = jck.apply_spec_teacher_delta(_to_jax_np(base), jdelta, jtail)
    assert_same_bits(got, jax.tree.map(np.asarray, want))
    assert_same_bits(got["layers"]["wo"]["pw"][-2:], qp["layers"]["wo"]["pw"][-2:])
    assert_same_bits(got["layers"]["wo"]["pw"][:1], base["layers"]["wo"]["pw"][:1])


def test_spec_teacher_delta_refuses_what_it_would_write_wrongly(tmp_path):
    """The JAX writer drops ln_f_b and takes every quantized leaf as int4; the
    port's raises on both."""
    qp = _int4_tree()
    with pytest.raises(ValueError, match="ln_f_b"):
        ck.save_spec_teacher_delta(str(tmp_path / "a.npz"), qp | {"ln_f_b": qp["ln_f_w"]}, 2)
    jck.save_spec_teacher_delta(str(tmp_path / "j.npz"), _to_jax_np(qp) | {"ln_f_b": np.ones(256, np.float32)}, 2)
    assert "ln_f_b" not in jck.load_spec_teacher_delta(str(tmp_path / "j.npz"))[0]  # dropped without a word
    p8 = Q.quantize_params_int8_i32(jax.tree.map(lambda t: t.to(torch.bfloat16),
                                                 _seeded_tree(first_stage_config(n_layer=1, n_head=2, dim=256,
                                                                                 block_size=32), 7)))
    with pytest.raises(ValueError, match="p8"):
        ck.save_spec_teacher_delta(str(tmp_path / "b.npz"), p8, 1)


def test_save_npz_crosses_packages(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(torch.bfloat16),
            "b": [torch.ones(4, dtype=torch.int32), torch.zeros(2)]}
    path = str(tmp_path / "p.npz")
    ck.save_npz(path, tree, {"k": 1})
    jtree, jmeta = jck.load_npz(path)
    assert_same_bits(tree, jtree)
    assert jmeta == {"k": 1}
    jck.save_npz(str(tmp_path / "j.npz"), _to_jax_np(tree), {"k": 2})
    back, meta = ck.load_npz(str(tmp_path / "j.npz"))
    assert_same_bits(back, tree)
    assert meta == {"k": 2}


def test_quantized_file_keeps_a_bytes_vocabulary(tmp_path):
    """A checkpoint vocabulary is keyed by bytes: the JAX writer's json.dumps
    raises on it; the port stores it as latin-1 strings and reads it back."""
    qp = _int4_tree()
    cfg = first_stage_config(n_layer=3, n_head=2, dim=256, block_size=32, intermediate_size=512)
    tok = {"name": "bpe", "mergeable_ranks": {bytes([i]): i for i in range(256)} | {b"\xff\xfe": 256},
           "special_tokens": {"<|endoftext|>": 257}}
    path = str(tmp_path / "q.npz")
    ck.save_first_stage_quantized(path, qp, cfg, tok, "int4")
    params, cfg2, tok2, mode = ck.load_first_stage_npz(path)
    assert tok2 == tok and mode == "int4" and cfg2 == cfg
    assert_same_bits(params, qp)
    assert "mergeable_ranks_latin1" in json.loads(str(np.load(path)["__meta__"]))["tokenizer"]
    with pytest.raises(TypeError):
        jck.save_first_stage_quantized(str(tmp_path / "j.npz"), _to_jax_np(qp), cfg, tok, "int4")
