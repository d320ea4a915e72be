"""``TTS.from_checkpoints`` of the port against the JAX package's on the same
files: the components leaf for leaf (first stage from a reference ``.pt`` or a
``cli quantize`` ``.npz`` of each mode, with its dtypes kept; second stage,
speaker encoder, EnCodec, tokenizer), the mode's conflict and alias rules, both
kinds of draft and the one refused, the missing-EnCodec warning; then one
synthesise of the port on the CPU.

The files are reference-format ``.pt`` from numpy-seeded arrays (the writers
of chip_smoke.py), and the ``.npz`` of the port's ``cli quantize``, which
tests/test_torch_cli.py holds to the JAX package's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from metavoice_tpu.core.config import RuntimeConfig as JRuntimeConfig  # noqa: E402
from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.runtime.tts import TTS as JTTS  # noqa: E402
from metavoice_tpu_torch import cli  # noqa: E402
from metavoice_tpu_torch.core.config import RuntimeConfig, first_stage_config, second_stage_config  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402
from test_torch_checkpoint import assert_same_bits  # noqa: E402

FIRST = first_stage_config(n_layer=1, n_head=2, dim=256, block_size=256, intermediate_size=512)
DRAFT = first_stage_config(n_layer=1, n_head=2, dim=256, block_size=256, intermediate_size=256)
SECOND = second_stage_config(n_layer=1, n_head=2, dim=32, block_size=256)
ECFG = dict(n_filters=2, dimension=8, codebook_size=1024, n_q=8, ratios=(4, 2))
TOKENIZER = {"name": "bpe", "special_tokens": {"<|endoftext|>": 256}}
TEXT = "A checkpoint speaks."


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(cfg, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda t: torch.from_numpy((rng.standard_normal(t.shape) * 0.05).astype(np.float32)),
                        tfm.init_params(cfg, device="meta"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(9)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))

    f = {k: str(d / f"{k}.pt") for k in ("first", "second", "spk", "encodec", "draft")}
    torch.save(cs.gpt_checkpoint(_tree(FIRST, 1), FIRST, TOKENIZER), f["first"])
    torch.save(cs.gpt_checkpoint(_tree(SECOND, 2), SECOND), f["second"])
    torch.save(cs.speaker_checkpoint(torch, draw)[0], f["spk"])
    torch.save(cs.encodec_checkpoint(torch, ec.EncodecConfig(**ECFG), draw)[0], f["encodec"])
    draft = cs.gpt_checkpoint(_tree(DRAFT, 3), DRAFT)
    torch.save(draft, f["draft"])
    for src, mode, out in (("first", "int4", "int4"), ("first", "int8", "int8"), ("first", "int8_plain", "int8_plain"),
                           ("draft", "int4", "draft_int4"), ("draft", "int8", "draft_int8")):  # serving files
        f[out] = str(d / f"{out}.npz")
        assert cli.main(["quantize", "--first_stage_path", f[src], "--mode", mode, "--out", f[out],
                         "--device", "cpu"]) == 0
    f["draft_dense"] = str(d / "draft_dense.npz")  # a trainer-style dense .npz with model_args
    ck.save_npz(f["draft_dense"], jax.tree.map(lambda t: t.to(torch.bfloat16), _tree(DRAFT, 3)),
                {"model_args": draft["model_args"], "meta": draft["meta"]})
    f["out"] = str(d / "out")
    return f


def _both(files, first, draft=None, **kw):
    common = dict(encodec_path=files["encodec"], draft_checkpoint=draft, output_dir=files["out"])
    ours = TTS.from_checkpoints(first, files["second"], files["spk"], encodec_cfg=ec.EncodecConfig(**ECFG),
                                device="cpu", enforce_min_ref_duration=False, **common, **kw)
    theirs = JTTS.from_checkpoints(first, files["second"], files["spk"], encodec_cfg=jec.EncodecConfig(**ECFG),
                                   **common, **kw)
    return ours, theirs


@pytest.mark.parametrize("first,kw", [("first", {}), ("int4", {}), ("int8", {"quantisation_mode": "int8_packed"}),
                                      ("int8_plain", {})])
def test_components_match_jax(files, first, kw):
    """Every component leaf for leaf; a pre-quantized file keeps its packed
    arrays and their dtypes (the "int8_packed" alias names its int8 mode)."""
    ours, theirs = _both(files, files[first], **kw)
    jc, c = theirs.c, ours.c
    assert_same_bits(c.first_stage_params, jax.tree.map(np.asarray, jc.first_stage_params))
    assert_same_bits(c.second_stage_params, jax.tree.map(np.asarray, jc.second_stage_params))
    assert_same_bits(c.spk_params, jax.tree.map(np.asarray, jc.spk_params))
    assert_same_bits(c.encodec_params, jax.tree.map(np.asarray, jc.encodec_params))
    for mine, ref in ((c.first_stage_cfg, jc.first_stage_cfg), (c.second_stage_cfg, jc.second_stage_cfg),
                      (c.encodec_cfg, jc.encodec_cfg)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert c.tokenizer.encode(TEXT) == jc.tokenizer.encode(TEXT)
    assert c.tokenizer.eot_token == jc.tokenizer.eot_token == 256 + 2049
    if first == "first":
        assert c.first_stage_params["wpe"].dtype == torch.bfloat16
    else:
        assert ours.quantisation_mode == {"int4": "int4", "int8": "int8", "int8_plain": "int8_plain"}[first]


def test_pre_quantized_mode_conflicts_raise(files):
    for kw in ({"quantisation_mode": "int4"}, {"runtime": RuntimeConfig(quantisation_mode="int4")}):
        with pytest.raises(ValueError, match="pre-quantized"):
            TTS.from_checkpoints(files["int8"], files["second"], files["spk"], device="cpu",
                                 encodec_path=files["encodec"], encodec_cfg=ec.EncodecConfig(**ECFG), **kw)
    with pytest.raises(ValueError, match="pre-quantized"):
        JTTS.from_checkpoints(files["int8"], files["second"], files["spk"], encodec_path=files["encodec"],
                              encodec_cfg=jec.EncodecConfig(**ECFG), runtime=JRuntimeConfig(quantisation_mode="int4"),
                              output_dir=files["out"])
    # the matching mode in a runtime is taken, and nothing is quantized again
    tts = TTS.from_checkpoints(files["int8"], files["second"], files["spk"], device="cpu",
                               encodec_path=files["encodec"], encodec_cfg=ec.EncodecConfig(**ECFG),
                               runtime=RuntimeConfig(quantisation_mode="int8"))
    assert tts.c.first_stage_params["layers"]["wqkv"]["p8"].dtype == torch.int32


@pytest.mark.parametrize("draft", ["draft", "draft_dense", "draft_int4"])
def test_drafts_match_jax(files, draft):
    """A dense .pt, a dense .npz (bf16) and an int4 .npz (packed, dtypes kept)."""
    ours, theirs = _both(files, files["first"], draft=files[draft])
    assert_same_bits(ours._draft_params, jax.tree.map(np.asarray, theirs._draft_params))
    assert dataclasses.asdict(ours._draft_cfg) == dataclasses.asdict(theirs._draft_cfg)
    assert (ours.draft_route is not None) == (draft == "draft_int4")


def test_a_quantized_draft_of_another_mode_is_refused(files):
    with pytest.raises(ValueError, match="dense or int4"):
        TTS.from_checkpoints(files["first"], files["second"], files["spk"], draft_checkpoint=files["draft_int8"],
                             device="cpu")
    with pytest.raises(ValueError, match="dense or int4"):
        JTTS.from_checkpoints(files["first"], files["second"], files["spk"], draft_checkpoint=files["draft_int8"],
                              output_dir=files["out"])


def test_missing_encodec_warns_and_synthesise_writes_a_wav(files, tmp_path, monkeypatch):
    """Without encodec_path the port gives the JAX package's warning (the
    same words) and a random vocoder; its TTS from the int4 file then
    synthesises a wav on the CPU."""
    with pytest.warns(UserWarning, match="RANDOM-weight") as ours:
        tts = TTS.from_checkpoints(files["int4"], files["second"], files["spk"], device="cpu",
                                   encodec_cfg=ec.EncodecConfig(**ECFG), output_dir=str(tmp_path),
                                   enforce_min_ref_duration=False)
    monkeypatch.setattr(jec, "init_params", lambda key, cfg: {})  # JAX's random vocoder itself is not under test
    with pytest.warns(UserWarning, match="RANDOM-weight") as theirs:
        JTTS.from_checkpoints(files["int4"], files["second"], files["spk"], encodec_cfg=jec.EncodecConfig(**ECFG),
                              output_dir=files["out"])
    assert [str(w.message) for w in ours if "RANDOM" in str(w.message)] == \
        [str(w.message) for w in theirs if "RANDOM" in str(w.message)]
    assert tts.c.encodec_params["codebooks"].shape == (8, 1024, 8)
    sr = 16000
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * np.arange(2 * sr) / sr)).astype(np.float32), sr)
    wav, wav_sr = aio.read_wav(tts.synthesise(TEXT, ref, max_new_tokens=16))
    assert wav_sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    assert tts.stats["decode_steps"] > 0
