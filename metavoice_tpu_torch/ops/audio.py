"""Host-side audio DSP: STFT, mel filterbank, mel spectrogram, resampling.

Port of metavoice_tpu/ops/audio.py. The JAX package runs these on the CPU
(its mel frontend is pinned to the CPU backend), so here they are numpy, with
the resampler's strided convolution in PyTorch on the CPU:

  * ``stft_np`` / ``istft_np`` — centered STFT and its COLA inverse;
  * ``mel_filterbank`` — Slaney-scale, Slaney-normalized triangular bank,
    equal to ``librosa.filters.mel(htk=False, norm="slaney")``;
  * ``mel_spectrogram`` — power mel spectrogram for the speaker encoder
    (sr=16000, n_fft=400, hop=160, n_mels=40);
  * ``resample`` — rational-ratio polyphase windowed-sinc resampler.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n_fft: int) -> np.ndarray:
    """Periodic Hann window (what librosa/scipy use for STFT)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))).astype(
        np.float32
    )


def stft_np(y: np.ndarray, n_fft: int, hop_length: int, center: bool = True) -> np.ndarray:
    """Complex STFT, (T,) -> (n_frames, n_fft//2 + 1); center reflect-pads."""
    y = np.asarray(y, np.float32)
    if center:
        y = np.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    frames = y[idx] * hann_window(n_fft)
    return np.fft.rfft(frames, n=n_fft, axis=-1)


def istft_np(spec: np.ndarray, n_fft: int, hop_length: int, length: int | None = None) -> np.ndarray:
    """Inverse STFT with Hann synthesis + COLA normalization."""
    window = hann_window(n_fft)
    frames = np.fft.irfft(spec, n=n_fft, axis=-1).astype(np.float64) * window
    n_frames = spec.shape[-2]
    t_total = n_fft + hop_length * (n_frames - 1)
    out = np.zeros(t_total, np.float64)
    norm = np.zeros(t_total, np.float64)
    for i in range(n_frames):
        sl = slice(i * hop_length, i * hop_length + n_fft)
        out[sl] += frames[i]
        norm[sl] += window.astype(np.float64) ** 2
    out = out / np.maximum(norm, 1e-8)
    out = out[n_fft // 2 :]
    if length is not None:
        out = out[:length]
    return out.astype(np.float32)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # f=0 resolves to the linear branch
        log_mels = min_log_mel + np.log(np.maximum(f, 1e-12) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_mels, mels)


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=16)
def mel_filterbank(
    sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax: float | None = None
) -> np.ndarray:
    """(n_mels, n_fft//2+1) Slaney triangular filterbank == librosa default."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: each filter integrates to ~2/bandwidth
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_spectrogram(
    y: np.ndarray,
    sr: int = 16000,
    n_fft: int = 400,
    hop_length: int = 160,
    n_mels: int = 40,
) -> np.ndarray:
    """Power mel spectrogram, (T,) -> (n_mels, n_frames) float32, not log-scaled
    (the speaker-encoder frontend, fam/quantiser/audio/speaker_encoder/audio.py)."""
    spec = stft_np(y, n_fft, hop_length)
    power = (np.abs(spec) ** 2).astype(np.float32)  # (frames, bins)
    return (mel_filterbank(sr, n_fft, n_mels) @ power.T).astype(np.float32)


@lru_cache(maxsize=32)
def _resample_kernel(
    up: int, down: int, zeros: int = 24, rolloff: float = 0.945
) -> np.ndarray:
    """Polyphase windowed-sinc kernels, shape (up, 1, kernel_width), each phase
    normalized to unit DC gain."""
    sr_ratio = up / down
    cutoff = 0.5 * rolloff * min(1.0, sr_ratio)
    width = int(np.ceil(zeros / (2 * cutoff)))
    idx = np.arange(-width, width + 1, dtype=np.float64)
    kernels = []
    for phase in range(up):
        t = idx - phase / up
        x = 2 * cutoff * t
        sinc = np.sinc(x)
        win = np.where(
            np.abs(x) < zeros, 0.5 * (1 + np.cos(np.pi * x / zeros)), 0.0
        )
        kernels.append(2 * cutoff * sinc * win)
    k = np.stack(kernels, axis=0)[:, None, :]  # (up, 1, W)
    k = k / k.sum(-1, keepdims=True)
    return k.astype(np.float32)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Rational polyphase resampling, (..., T) -> (..., ceil(T * target/orig))."""
    y = np.asarray(y, np.float32)
    if orig_sr == target_sr:
        return y
    g = np.gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    kernels = torch.from_numpy(_resample_kernel(up, down))  # (up, 1, W)
    half = kernels.shape[-1] // 2
    shape = y.shape
    t = shape[-1]
    x = torch.from_numpy(y.reshape(-1, 1, t))
    x = F.pad(x, (half, half + down))
    out = F.conv1d(x, kernels, stride=down)  # (N, up, T//down + 1)
    out = out.transpose(1, 2).reshape(x.shape[0], -1)  # interleave phases
    new_t = int(np.ceil(t * up / down))
    return out[:, :new_t].reshape(*shape[:-1], new_t).numpy()
