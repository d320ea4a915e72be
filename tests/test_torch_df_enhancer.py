"""The port's DF-style enhancer (metavoice_tpu_torch/models/enhancer.py:
``erb_filterbank``, ``init_df_params``, ``_gru``, ``df_enhance_spec``,
``DFEnhancer``, ``get_enhancer``) against the JAX package's
(metavoice_tpu/models/enhancer.py), on a small config.

The weights are drawn with the port's init (biases moved off their init) and
handed to JAX as numpy. Tolerances: the filterbank bit for bit; the GRU 1e-5
of max |ref|; ``df_enhance_spec`` (complex64) and ``DFEnhancer`` on a wav
1e-4 of max |ref|.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import enhancer as jenh  # noqa: E402
from metavoice_tpu_torch.models import enhancer as enh  # noqa: E402

SMALL = dict(sr=8000, n_fft=256, hop=128, n_erb=12, df_bins=16, df_order=3, conv_ch=16, gru_dim=24)
JCFG, CFG = jenh.DFConfig(**SMALL), enh.DFConfig(**SMALL)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    gen = torch.Generator().manual_seed(3)
    p = enh.init_df_params(CFG, device="cpu", generator=gen)
    for k in ("gru_b", "gain_b", "df_b"):  # off their init, so a misplaced bias shows
        p[k] = p[k] + 0.3 * torch.randn(p[k].shape, generator=gen)
    p["df_out"] = p["df_out"] * 5.0  # taps well away from the unit impulse
    return p


def _np(p):
    return {k: v.numpy() for k, v in p.items()}


def _close(got, want, tol: float):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"max |err| {err:.3e} > {tol} x {scale:.3e}"


def _spec(seed: int, frames: int = 40):
    rng = np.random.default_rng(seed)
    bins = CFG.n_fft // 2 + 1
    return (rng.normal(size=(2, frames, bins)) + 1j * rng.normal(size=(2, frames, bins))).astype(np.complex64)


@pytest.mark.parametrize("sr, n_fft, n_bands", [(24000, 960, 32), (8000, 256, 12), (16000, 64, 40)])
def test_erb_filterbank_is_jax_bit_for_bit(sr, n_fft, n_bands):
    """(16000, 64, 40) has empty bands: the nearest-bin fallback."""
    np.testing.assert_array_equal(enh.erb_filterbank(sr, n_fft, n_bands), jenh.erb_filterbank(sr, n_fft, n_bands))


def test_init_df_params_has_jax_tree():
    want = jax.eval_shape(lambda k: jenh.init_df_params(k, JCFG), jax.random.PRNGKey(0))
    got = enh.init_df_params(CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert torch.equal(got["df_b"].reshape(CFG.df_order, CFG.df_bins, 2)[0, :, 0], torch.ones(CFG.df_bins))


def test_gru_matches_jax(params):
    x = np.random.default_rng(4).normal(size=(2, 30, CFG.conv_ch)).astype(np.float32)
    p = _np(params)
    want = jax.jit(jenh._gru)(x, p["gru_w_ih"], p["gru_w_hh"], p["gru_b"])
    got = enh._gru(torch.from_numpy(x), params["gru_w_ih"], params["gru_w_hh"], params["gru_b"])
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("biases", [True, False])
def test_df_enhance_spec_matches_jax(params, biases):
    """Gains on every bin, the low bins replaced by the deep filter over
    frames that wrap around (jnp.roll); ``gain_b``/``df_b`` optional."""
    p = dict(params) if biases else {k: v for k, v in params.items() if k not in ("gain_b", "df_b")}
    spec = _spec(5)
    want = jenh.df_enhance_spec(_np(p), JCFG, jnp.asarray(spec))
    got = enh.df_enhance_spec(p, CFG, torch.from_numpy(spec))
    assert got.dtype == torch.complex64
    _close(got.numpy(), want, 1e-4)


def test_df_enhancer_on_a_wav_matches_jax(params):
    wav = (np.random.default_rng(6).normal(size=4000) * 0.1).astype(np.float32)
    want = jenh.DFEnhancer(_np(params), JCFG)(wav, CFG.sr)
    got = enh.DFEnhancer(params, CFG, device="cpu")(wav, CFG.sr)
    assert got.shape == wav.shape
    _close(got, want, 1e-4)
    short = wav[: CFG.n_fft - 1]  # shorter than a frame: returned as it is
    np.testing.assert_array_equal(enh.DFEnhancer(params, CFG, device="cpu")(short, CFG.sr), short)


def test_get_enhancer_factory_as_jax(params):
    with pytest.warns(UserWarning, match="UNTRAINED"):
        e = enh.get_enhancer("df", cfg=CFG, device="cpu")
    assert isinstance(e, enh.DFEnhancer) and e.cfg == CFG
    with pytest.warns(UserWarning, match="UNTRAINED"):
        jenh.get_enhancer("df", params=_np(params), cfg=JCFG)
    stamped = dict(e.params, trained_iters=torch.tensor(10, dtype=torch.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enh.get_enhancer("df", params=stamped, cfg=CFG, device="cpu")
    assert isinstance(enh.get_enhancer("spectral_gate"), enh.SpectralGateEnhancer)
    x = np.ones(10, np.float32)
    np.testing.assert_array_equal(enh.get_enhancer("none")(x, 24000), x)
    with pytest.raises(ValueError, match="Unknown enhancer"):
        enh.get_enhancer("bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            enh.get_enhancer("df", cfg=CFG)  # the default device is cuda: no silent CPU fallback
    assert dataclasses.asdict(enh.DFConfig()) == dataclasses.asdict(jenh.DFConfig())
