"""Speech enhancement after the vocoder.

Port of metavoice_tpu/models/enhancer.py:

  * ``SpectralGateEnhancer`` — the default: a classical Wiener-style
    spectral gate (host-side numpy) that needs no training;
  * ``DFEnhancer`` ("df") — the trainable DeepFilterNet-STYLE network (ERB
    log-power features -> GRU -> per-ERB gains + deep filtering of the low
    bins). It follows DFN's signal-processing recipe, not its module tree:
    real DeepFilterNet checkpoints do not load into it. Train it with
    training/df_trainer.py. The STFT and its inverse run on the host
    (``stft_np``/``istft_np``), the network on the enhancer's device (the
    JAX package pins it to the CPU);
  * ``get_enhancer(name)`` — the factory, API parity with
    fam/llm/enhancers.py:86-108.

Enhancers are callables ``(wav: np.ndarray, sr: int) -> np.ndarray``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.ops.audio import istft_np, stft_np

Params = dict[str, Any]


def erb_filterbank(sr: int, n_fft: int, n_bands: int = 32) -> np.ndarray:
    """(n_bands, n_bins) rectangular ERB-scale band matrix, rows normalized."""

    def hz_to_erb(f):
        return 21.4 * np.log10(1 + 0.00437 * f)

    def erb_to_hz(e):
        return (10 ** (e / 21.4) - 1) / 0.00437

    n_bins = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_bins)
    edges_erb = np.linspace(hz_to_erb(20.0), hz_to_erb(sr / 2), n_bands + 1)
    edges = erb_to_hz(edges_erb)
    fb = np.zeros((n_bands, n_bins), np.float32)
    for b in range(n_bands):
        lo, hi = edges[b], edges[b + 1]
        sel = (freqs >= lo) & (freqs < hi)
        if not sel.any():
            sel[np.abs(freqs - lo).argmin()] = True
        fb[b, sel] = 1.0 / sel.sum()
    return fb


# --------------------------------------------------------------------------------------
# Classical spectral-gate enhancer (works untrained)
# --------------------------------------------------------------------------------------


@dataclass
class SpectralGateEnhancer:
    """Wiener-style spectral gate: estimate a per-bin noise floor as a low
    percentile of the magnitude envelope, apply a smoothed oversubtraction
    gain. Removes the broadband hiss vocoders leave behind."""

    n_fft: int = 1024
    hop: int = 256
    noise_percentile: float = 10.0
    oversubtract: float = 1.5
    min_gain: float = 0.1

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if len(wav) < self.n_fft:
            return wav
        spec = stft_np(wav, self.n_fft, self.hop)
        mag = np.abs(spec)
        noise = np.percentile(mag, self.noise_percentile, axis=0, keepdims=True)
        gain = 1.0 - self.oversubtract * (noise / np.maximum(mag, 1e-8))
        gain = np.maximum(gain, self.min_gain)
        # temporal smoothing of the gain to avoid musical noise
        for t in range(1, gain.shape[0]):
            gain[t] = 0.6 * gain[t] + 0.4 * gain[t - 1]
        return istft_np(spec * gain, self.n_fft, self.hop, length=len(wav))


# --------------------------------------------------------------------------------------
# DeepFilterNet-style neural enhancer
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class DFConfig:
    sr: int = 24000  # the reference runs DFN at 48k; this stays at the pipeline's rate
    n_fft: int = 960
    hop: int = 480
    n_erb: int = 32
    df_bins: int = 96  # deep filtering applied to the lowest bins
    df_order: int = 5
    conv_ch: int = 64
    gru_dim: int = 256


def init_df_params(cfg: DFConfig = DFConfig(), *, device="cuda", generator: torch.Generator | None = None,
                   dtype=torch.float32) -> Params:
    """Random DF-style network with identity-biased heads: the gains start
    near 1 (sigmoid(2)) and the deep-filter taps as a unit impulse at order
    0, so the untrained net is near-transparent."""
    dev = resolve_device(device)

    def dense(i, o):
        return (torch.randn((i, o), device=dev, generator=generator) / np.sqrt(i)).to(dtype)

    h = cfg.gru_dim
    df_b = torch.zeros((cfg.df_order, cfg.df_bins, 2), dtype=dtype)
    df_b[0, :, 0] = 1.0
    return {
        "enc_in": dense(cfg.n_erb, cfg.conv_ch),
        "gru_w_ih": dense(cfg.conv_ch, 3 * h),
        "gru_w_hh": dense(h, 3 * h),
        "gru_b": torch.zeros((3 * h,), device=dev, dtype=dtype),
        "gain_out": dense(h, cfg.n_erb),
        "gain_b": torch.full((cfg.n_erb,), 2.0, device=dev, dtype=dtype),
        "df_out": dense(h, cfg.df_bins * cfg.df_order * 2) * 0.1,
        "df_b": df_b.reshape(-1).to(dev),
    }


def _gru(x, w_ih, w_hh, b):
    """(B, T, D) -> (B, T, H): a GRU with gates r, z, n in that order and one
    bias, on the input projection only."""
    h_dim = w_hh.shape[0]
    x_proj = torch.einsum("btd,dg->btg", x, w_ih) + b
    h = x.new_zeros((x.shape[0], h_dim))
    outs = []
    for t in range(x.shape[1]):
        xp, hh = x_proj[:, t], h @ w_hh
        r = torch.sigmoid(xp[:, :h_dim] + hh[:, :h_dim])
        z = torch.sigmoid(xp[:, h_dim : 2 * h_dim] + hh[:, h_dim : 2 * h_dim])
        n = torch.tanh(xp[:, 2 * h_dim :] + r * hh[:, 2 * h_dim :])
        h = (1 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=1)


def df_enhance_spec(params: Params, cfg: DFConfig, spec: torch.Tensor) -> torch.Tensor:
    """Enhance a complex64 STFT (B, T, bins): ERB gains on every bin, then
    the lowest ``df_bins`` replaced by their deep filter (complex taps over
    the ``df_order`` latest frames; the frame shift wraps around, as
    ``jnp.roll`` does). ``gain_b`` and ``df_b`` are optional."""
    fb = torch.from_numpy(erb_filterbank(cfg.sr, cfg.n_fft, cfg.n_erb)).to(spec.device)  # (E, bins)
    power = spec.abs() ** 2
    feat = torch.log10(torch.einsum("eb,xtb->xte", fb, power) + 1e-10)
    h = F.relu(feat @ params["enc_in"])
    h = _gru(h, params["gru_w_ih"], params["gru_w_hh"], params["gru_b"])

    gains = h @ params["gain_out"]
    if "gain_b" in params:
        gains = gains + params["gain_b"]
    # band membership (0/1): every bin of band e gets gain_e, clipped so a
    # bin the empty-band fallback gave two bands cannot pass unity
    bin_gains = torch.clamp(torch.einsum("xte,eb->xtb", torch.sigmoid(gains), (fb > 0).to(gains.dtype)), 0.0, 1.0)
    out = spec * bin_gains

    df = h @ params["df_out"]
    if "df_b" in params:
        df = df + params["df_b"]
    df = df.reshape(h.shape[0], h.shape[1], cfg.df_order, cfg.df_bins, 2)
    taps = torch.complex(df[..., 0], df[..., 1])  # (B, T, O, df_bins)
    low = spec[..., : cfg.df_bins]
    stacked = torch.stack([torch.roll(low, shifts=o, dims=1) for o in range(cfg.df_order)], dim=2)
    low_df = (taps * stacked).sum(dim=2)
    return torch.cat([low_df, out[..., cfg.df_bins :]], dim=-1)


class DFEnhancer:
    """Trainable DFN-style neural enhancer (recipe, not weight, parity). The
    params go to ``device`` once; each call runs the STFT on the host and the
    network there."""

    def __init__(self, params: Params, cfg: DFConfig = DFConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.params = {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}
        self.cfg = cfg

    @torch.inference_mode()
    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if len(wav) < self.cfg.n_fft:
            return wav
        spec = stft_np(wav, self.cfg.n_fft, self.cfg.hop)[None].astype(np.complex64)
        out = df_enhance_spec(self.params, self.cfg, torch.from_numpy(spec).to(self.device))
        return istft_np(out[0].cpu().numpy(), self.cfg.n_fft, self.cfg.hop, length=len(wav))


def get_enhancer(enhancer_name: str = "spectral_gate", *, params: Params | None = None,
                 cfg: DFConfig | None = None, seed: int = 0, device="cuda") -> Callable:
    """Factory, parity with reference get_enhancer (fam/llm/enhancers.py:86).

    "spectral_gate" (the default) works untrained; "none" is the identity;
    "df" is the DFN-style network on ``device``, with ``params`` (and their
    ``cfg``) or, without them, random weights drawn from ``seed``. Weights
    without a ``trained_iters`` stamp corrupt audio, so the factory warns."""
    if enhancer_name == "df":
        dcfg = cfg or DFConfig()
        if params is None:
            dev = resolve_device(device)
            params = init_df_params(dcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        if "trained_iters" not in params:
            warnings.warn(
                "get_enhancer('df') was given UNTRAINED weights: a random "
                "GRU corrupts audio instead of enhancing it. Train via "
                "metavoice_tpu_torch.training.df_trainer.train_df (stamps "
                "'trained_iters') or use enhancer='spectral_gate', which "
                "needs no training."
            )
        return DFEnhancer(params, dcfg, device)
    if enhancer_name == "spectral_gate":
        return SpectralGateEnhancer()
    if enhancer_name == "none":
        return lambda wav, sr: wav
    raise ValueError(f"Unknown enhancer name: {enhancer_name}")
