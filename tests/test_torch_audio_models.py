"""Audio models of the port against the JAX package on the same weights and
inputs: EnCodec decode, the mel frontend, the speaker encoder, the spectral
gate, the resampler, and ``.npz`` weights written by the JAX package."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import enhancer as jenh  # noqa: E402
from metavoice_tpu.models import speaker_encoder as jse  # noqa: E402
from metavoice_tpu.ops import audio as jaudio  # noqa: E402
from metavoice_tpu.utils import checkpoint as jck  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import enhancer as enh  # noqa: E402
from metavoice_tpu_torch.models import speaker_encoder as se  # noqa: E402
from metavoice_tpu_torch.ops import audio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    """One small codec for both sides, drawn by the port's init (the JAX
    package's layout and scales; JAX's eager init takes about 17 s)."""
    params = ec.init_params(ec.EncodecConfig(n_filters=8, dimension=32), device="cpu",
                            generator=torch.Generator().manual_seed(0))
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), params), params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _speech_like(seconds, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    wav = 0.3 * np.sin(2 * np.pi * 150 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    return (wav + 0.02 * rng.normal(size=len(t))).astype(np.float32)


@pytest.mark.parametrize("n_frames", [25, 40])
def test_encodec_decode_codes_matches_jax(codec, n_frames):
    jcfg = jec.EncodecConfig(n_filters=8, dimension=32)
    cfg = ec.EncodecConfig(n_filters=8, dimension=32)
    jparams, params = codec
    codes = np.random.default_rng(n_frames).integers(0, 1024, size=(8, n_frames))
    ref = np.asarray(jec.decode_codes(jparams, jcfg, jnp.asarray(codes)))
    ours = ec.decode_codes(params, cfg, codes).numpy()
    assert ours.shape == ref.shape == (1, n_frames * cfg.hop_length)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_mel_spectrogram_matches_jax():
    wav = _speech_like(2.0, 16000)
    ref = np.asarray(jaudio.mel_spectrogram(jnp.asarray(wav)))
    ours = audio.mel_spectrogram(wav)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    # rtol on the mel power; atol for bins ~1e-7 of the peak, where the f32
    # FFT (JAX) and the f64 FFT (numpy) differ in the last bits
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-7 * ref.max())


def test_speaker_embedding_matches_jax():
    jparams = jax.jit(jse.init_params)(jax.random.PRNGKey(3))  # eagerly, op by op: seconds
    params = ck.params_from_numpy(_np_tree(jparams), device="cpu")
    wav = _speech_like(3.0, 16000, seed=1)
    ref = jse.embed_utterance(jparams, wav)
    ours = se.embed_utterance(params, wav)
    assert ours.shape == ref.shape == (256,)
    cos = float(np.dot(ours, ref) / (np.linalg.norm(ours) * np.linalg.norm(ref)))
    assert cos >= 0.99999
    np.testing.assert_array_equal(se.trim_silence(wav), jse.trim_silence(wav))


def test_spectral_gate_matches_jax():
    wav = _speech_like(1.5, 24000, seed=2)
    np.testing.assert_allclose(
        enh.get_enhancer("spectral_gate")(wav, 24000),
        jenh.get_enhancer("spectral_gate")(wav, 24000), atol=1e-6,
    )


@pytest.mark.parametrize("orig_sr,target_sr", [(24000, 16000), (22050, 16000), (16000, 24000)])
def test_resample_matches_jax(orig_sr, target_sr):
    wav = _speech_like(0.5, orig_sr, seed=3)
    ref = np.asarray(jaudio.resample(wav, orig_sr, target_sr))
    ours = audio.resample(wav, orig_sr, target_sr)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_load_npz_reads_jax_save_npz_with_bf16(tmp_path):
    rng = np.random.default_rng(5)
    tree = {
        "layers": {"w": jnp.asarray(rng.normal(size=(2, 3, 4)), jnp.bfloat16),
                   "b": jnp.asarray(rng.normal(size=(2, 4)), jnp.float32)},
        "wtes": [jnp.asarray(rng.normal(size=(5, 4)), jnp.bfloat16)],
        "steps": np.arange(3, dtype=np.int32),
    }
    path = str(tmp_path / "w.npz")
    jck.save_npz(path, _np_tree(tree), meta={"format": "test"})
    ref, ref_meta = jck.load_npz(path)
    ours, meta = ck.load_npz(path)
    assert meta == ref_meta == {"format": "test"}
    assert set(ours) == {"layers", "wtes", "steps"}  # no reserved entries leak
    assert ours["layers"]["w"].dtype == torch.bfloat16 and ours["wtes"][0].dtype == torch.bfloat16
    assert ours["layers"]["b"].dtype == torch.float32 and ours["steps"].dtype == torch.int32
    for o, r in ((ours["layers"]["w"], ref["layers"]["w"]), (ours["wtes"][0], ref["wtes"][0])):
        np.testing.assert_array_equal(o.view(torch.int16).numpy(), np.asarray(r).view(np.int16))
    np.testing.assert_array_equal(ours["layers"]["b"].numpy(), ref["layers"]["b"])
    # the converter keeps the bf16 bits of the JAX tree as well
    conv = ck.params_from_numpy(_np_tree(tree), device="cpu")
    assert torch.equal(conv["layers"]["w"].view(torch.int16), ours["layers"]["w"].view(torch.int16))
