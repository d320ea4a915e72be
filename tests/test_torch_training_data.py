"""The port's finetuning dataset (metavoice_tpu_torch/training/data.py) against
the JAX package's (metavoice_tpu/training/data.py) on one CSV: the same
EnCodec (a small config) and speaker-encoder weights, from numpy.

Tolerances: every item's tokens bit for bit (the codes are the nearest
codewords of two f32 encoders; the clips are chosen so that none lies on a
tie); the speaker embedding within 1e-4 (an f32 LSTM summed in other
orders). The batches come in JAX's order for the same seed.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import speaker_encoder as jse  # noqa: E402
from metavoice_tpu.tokenizer import TrainedBPETokeniser as JTokeniser  # noqa: E402
from metavoice_tpu.training import data as jdata  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import speaker_encoder as se  # noqa: E402
from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser  # noqa: E402
from metavoice_tpu_torch.training import data  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

ECFG = dict(n_filters=4, dimension=16, codebook_size=64, n_q=8)
CTX_T = 64  # audio timesteps a row: ctx_window 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A CSV of four rows: wavs at 24, 16 and 22.05 kHz (relative and
    absolute paths), captions inline and from a .txt file."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    rows = ["audio|caption"]
    for i, (sr, text) in enumerate([(24000, "Hello there, one."), (16000, "caption.txt"),
                                    (22050, "A third clip; 3 words."), (24000, "Four, the last.")]):
        t = np.arange(int(0.4 * sr)) / sr
        wav = (0.3 * np.sin(2 * np.pi * (150 + 60 * i) * t) + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        name = f"clip{i}.wav"
        aio.write_wav(str(root / name), wav, sr)
        rows.append(f"{name if i % 2 else root / name}|{text}")
    (root / "caption.txt").write_text("  Read from a caption file.\n")
    csv = root / "train.csv"
    csv.write_text("\n".join(rows) + "\n\n")
    bad = root / "bad.csv"
    bad.write_text(f"audio|caption\n{root / 'clip0.wav'}|missing.txt\n")
    return str(csv), str(bad)


@pytest.fixture(scope="module")
def datasets(corpus):
    # the port's random init (the JAX package's layouts) as numpy arrays, for both
    jcfg = jec.EncodecConfig(**ECFG)
    jeparams = jax.tree.map(lambda t: t.numpy(), ec.init_params(ec.EncodecConfig(**ECFG), device="cpu",
                                                                generator=torch.Generator().manual_seed(3)))
    jspk = jse.SpeakerEncoderParams(**jax.tree.map(lambda t: t.numpy(), se.init_params(
        device="cpu", generator=torch.Generator().manual_seed(4))))
    jds = jdata.DynamicComputeDataset.from_csv(corpus[0], jeparams, jcfg, JTokeniser(), jspk,
                                               num_max_audio_tokens_timesteps=CTX_T)
    ds = data.DynamicComputeDataset.from_csv(corpus[0], ck.params_from_numpy(jeparams, device="cpu"),
                                             ec.EncodecConfig(**ECFG), TrainedBPETokeniser(),
                                             ck.params_from_numpy(jspk, device="cpu"),
                                             num_max_audio_tokens_timesteps=CTX_T)
    return jds, ds


def test_items_match_jax(datasets):
    jds, ds = datasets
    assert len(ds) == len(jds) == 4
    for i in range(len(ds)):
        got, want = ds[i], jds[i]
        assert got["tokens"].dtype == want["tokens"].dtype and got["tokens"].shape == (1, 2 * CTX_T + 1)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["spkemb"].shape == (1, 256) and got["spkemb"].dtype == np.float32
        np.testing.assert_allclose(got["spkemb"], want["spkemb"], atol=1e-4, rtol=0)


def test_batches_come_in_jax_order(datasets):
    """Two epochs of shuffled batches of 3 (the fourth row dropped each
    epoch): the same rows in the same order as JAX's for the seed."""
    jds, ds = datasets
    got = list(data.training_batches(ds, 3, seed=5, epochs=2))
    want = list(jdata.training_batches(jds, 3, seed=5, epochs=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("x", "y"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_allclose(g["spk_emb"], w["spk_emb"], atol=1e-4, rtol=0)


def test_missing_caption_file_raises(corpus, datasets):
    ds = datasets[1]
    bad = data.DynamicComputeDataset.from_csv(corpus[1], ds.encodec_params, ds.encodec_cfg, ds.tokenizer,
                                              ds.spk_params, num_max_audio_tokens_timesteps=CTX_T)
    with pytest.raises(FileNotFoundError, match="missing.txt"):
        bad[0]
