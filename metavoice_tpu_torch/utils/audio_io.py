"""Host-side audio file IO and loudness processing — no external deps.

Port of the file IO and loudness part of metavoice_tpu/utils/audio_io.py
(numpy/scipy; the streaming and upload helpers of the server are not ported).

The reference uses librosa/soundfile/audiocraft.audio_write/pydub/ffmpeg for
these (fam/llm/decoders.py:40-47, fam/llm/enhancers.py:9-24,
fam/llm/utils.py:55-74). None of those exist here; this module provides:

  * WAV read/write (PCM16/24/32, float32) via the stdlib ``wave`` module +
    numpy — covers the framework's own outputs and common inputs,
  * ffmpeg subprocess fallback for mp3/flac *when the binary exists*,
  * ITU-R BS.1770 loudness measurement (K-weighting + gating) and the
    loudness-normalized write audiocraft's ``audio_write(strategy="loudness")``
    performs, with clipping protection,
  * duration gate for the >= 30 s speaker-reference rule (utils.py:55-70).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import wave

import numpy as np
from scipy import signal as sp_signal


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Write float waveform in [-1, 1] as PCM16 WAV."""
    wav = np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
    pcm = (wav * 32767.0).astype("<i2")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def load_audio(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load any supported audio file as float32 mono; optional resample.

    WAV is read natively; other formats go through ffmpeg if available.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        wav, sr = read_wav(path)
    else:
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is None:
            # ValueError: it's a bad-input condition, and the server maps
            # ValueError to HTTP 400 (a .mp3 preset/reference on an
            # ffmpeg-less host is a client-fixable problem, not a crash)
            raise ValueError(
                f"Cannot decode {ext} without ffmpeg; provide a .wav file instead"
            )
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
            tmp_path = tmp.name
        try:
            subprocess.run(
                [ffmpeg, "-y", "-i", path, "-ac", "1", tmp_path],
                check=True,
                capture_output=True,
            )
            wav, sr = read_wav(tmp_path)
        finally:
            os.unlink(tmp_path)
    if target_sr is not None and sr != target_sr:
        from metavoice_tpu_torch.ops.audio import resample

        wav = np.asarray(resample(wav, sr, target_sr))
        sr = target_sr
    return wav, sr


def get_cached_file(file_or_uri: str, cache_dir: str | None = None) -> str:
    """Resolve a local path or download+cache an http(s) URI.

    Parity with reference get_cached_file (fam/llm/inference.py:392-416):
    URIs cache under ~/.cache/metavoice_tpu keyed by the md5 of the URI.
    Uses urllib instead of a curl subprocess.
    """
    import hashlib
    import urllib.request

    if not file_or_uri.startswith("http"):
        if os.path.exists(file_or_uri):
            return file_or_uri
        raise FileNotFoundError(f"File {file_or_uri} not found!")

    ext = os.path.splitext(file_or_uri.split("?")[0])[1] or ".wav"
    cache_dir = cache_dir or os.path.expanduser("~/.cache/metavoice_tpu")
    os.makedirs(cache_dir, exist_ok=True)
    name = "audio_" + hashlib.md5(file_or_uri.encode("utf-8")).hexdigest() + ext
    cache_path = os.path.join(cache_dir, name)
    if not os.path.exists(cache_path):
        urllib.request.urlretrieve(file_or_uri, cache_path)
    return cache_path


def duration_s(path: str) -> float:
    """Audio duration; header-only for WAV (no PCM decode — this runs per
    serving request for the >=30 s gate and the audio-seconds metric)."""
    try:
        with wave.open(path, "rb") as f:
            rate = f.getframerate()
            return f.getnframes() / rate if rate else 0.0
    except (wave.Error, EOFError):
        wav, sr = load_audio(path)
        return len(wav) / sr


def check_audio_file(path: str, threshold_s: float = 30.0) -> None:
    """>= 30 s speaker-reference gate (reference fam/llm/utils.py:55-70)."""
    d = duration_s(path)
    if d < threshold_s:
        raise ValueError(
            f"The audio file is too short ({d:.1f}s). Please provide an audio file "
            f"that is at least {threshold_s:.0f} seconds long to proceed."
        )


# --------------------------------------------------------------------------------------
# ITU-R BS.1770 loudness
# --------------------------------------------------------------------------------------


def _k_weighting_coeffs(sr: int):
    """BS.1770 K-weighting: stage-1 shelving + stage-2 RLB high-pass,
    bilinear-transformed to the target sample rate."""
    # Stage 1: high-shelf (f0=1681.97 Hz, G=+3.99 dB, Q=0.7071)
    f0, g_db, q = 1681.9744509742, 3.99984385397, 0.7071752369554196
    k = np.tan(np.pi * f0 / sr)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh**0.4996667741545416
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array([(vh + vb * k / q + k * k), 2.0 * (k * k - vh), (vh - vb * k / q + k * k)]) / a0
    a_shelf = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    # Stage 2: high-pass (f0=38.135 Hz, Q=0.5003)
    f0, q = 38.13547087602444, 0.5003270373238773
    k = np.tan(np.pi * f0 / sr)
    a0 = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0]) / a0
    a_hp = np.array([1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / q + k * k) / a0])
    return (b_shelf, a_shelf), (b_hp, a_hp)


def measure_loudness_lufs(wav: np.ndarray, sr: int) -> float:
    """Gated integrated loudness (mono) per ITU-R BS.1770-4, in LUFS."""
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    y = sp_signal.lfilter(b2, a2, sp_signal.lfilter(b1, a1, np.asarray(wav, np.float64)))
    block = int(0.400 * sr)
    hop = block // 4  # 75% overlap
    if len(y) < block:
        ms = np.mean(y**2) + 1e-12
        return float(-0.691 + 10 * np.log10(ms))
    n_blocks = 1 + (len(y) - block) // hop
    idx = np.arange(n_blocks)[:, None] * hop + np.arange(block)[None, :]
    power = np.mean(y[idx] ** 2, axis=1) + 1e-12
    lk = -0.691 + 10 * np.log10(power)
    # absolute gate at -70 LKFS
    mask = lk > -70.0
    if not mask.any():
        return -70.0
    # relative gate at (gated mean - 10 LU)
    ref = -0.691 + 10 * np.log10(np.mean(power[mask]))
    mask &= lk > (ref - 10.0)
    if not mask.any():
        return -70.0
    return float(-0.691 + 10 * np.log10(np.mean(power[mask])))


def normalize_loudness(
    wav: np.ndarray, sr: int, target_lufs: float = -14.0, clip_headroom: float = 0.99
) -> np.ndarray:
    """Gain to target LUFS with peak-clipping protection, the behavior of
    audiocraft audio_write(strategy='loudness', loudness_headroom_db=14)
    used by the reference decoder (fam/llm/decoders.py:40-47)."""
    loudness = measure_loudness_lufs(wav, sr)
    gain = 10.0 ** ((target_lufs - loudness) / 20.0)
    out = np.asarray(wav, np.float32) * gain
    peak = np.abs(out).max() + 1e-9
    if peak > clip_headroom:
        out = out * (clip_headroom / peak)
    return out


def write_wav_loudness_normalized(path: str, wav: np.ndarray, sr: int) -> None:
    write_wav(path, normalize_loudness(wav, sr), sr)
