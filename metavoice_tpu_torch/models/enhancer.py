"""Speech enhancement after the vocoder: the classical spectral gate.

Port of the default enhancer of metavoice_tpu/models/enhancer.py
(``SpectralGateEnhancer``, host-side numpy). The trainable DeepFilterNet-style
network ("df_style") is not ported yet. Enhancers are callables
``(wav: np.ndarray, sr: int) -> np.ndarray``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from metavoice_tpu_torch.ops.audio import istft_np, stft_np


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


def get_enhancer(enhancer_name: str = "spectral_gate"):
    """Enhancer factory; only the spectral gate is ported."""
    if enhancer_name == "spectral_gate":
        return SpectralGateEnhancer()
    raise ValueError(f"enhancer {enhancer_name!r} is not ported; use 'spectral_gate'")
