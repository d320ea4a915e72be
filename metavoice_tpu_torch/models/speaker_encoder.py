"""Speaker encoder: 3-layer LSTM -> 256-d L2-normalized embedding.

Port of metavoice_tpu/models/speaker_encoder.py (reference
fam/quantiser/audio/speaker_encoder/model.py:21-117): LSTM(40 -> 256, 3
layers) over 40-channel mel frames, final hidden state of the last layer ->
Linear(256, 256) -> ReLU -> L2 norm; the utterance embedding is the
L2-normalized mean over sliding partial windows (160 frames, rate 1.3,
min_coverage 0.75). All windows run as one batch; the time loop is a plain
Python loop of (N, 256) matmuls on the params' device.

Params are a dict with the JAX package's ``SpeakerEncoderParams`` fields:
w_ih (L, 256, 4H) (layer 0 uses the first 40 rows), w_hh (L, H, 4H),
b (L, 4H) (= torch's b_ih + b_hh), linear_w (H, E), linear_b (E,).
Gate order i, f, g, o as in torch.
"""

from __future__ import annotations

import numpy as np
import torch

from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.ops.audio import mel_spectrogram

MEL_WINDOW_STEP_MS = 10
MEL_N_CHANNELS = 40
SAMPLING_RATE = 16000
PARTIALS_N_FRAMES = 160
MODEL_HIDDEN_SIZE = 256
MODEL_EMBEDDING_SIZE = 256
MODEL_NUM_LAYERS = 3

Params = dict[str, torch.Tensor]


def init_params(*, device="cuda", generator: torch.Generator | None = None) -> Params:
    """f32 uniform(-1/sqrt(H), 1/sqrt(H)) weights, zero biases (torch's LSTM init)."""
    dev = resolve_device(device)
    h, e, l = MODEL_HIDDEN_SIZE, MODEL_EMBEDDING_SIZE, MODEL_NUM_LAYERS
    in_max = max(MEL_N_CHANNELS, h)
    s = 1.0 / np.sqrt(h)

    def uniform(*shape):
        return torch.empty(shape, device=dev).uniform_(-s, s, generator=generator)

    return {
        "w_ih": uniform(l, in_max, 4 * h),
        "w_hh": uniform(l, h, 4 * h),
        "b": torch.zeros((l, 4 * h), device=dev),
        "linear_w": uniform(h, e),
        "linear_b": torch.zeros((e,), device=dev),
    }


def _lstm_layer(x, w_ih, w_hh, b):
    """One LSTM layer over time. x: (B, T, D_in) -> (outputs (B, T, H), h_T (B, H))."""
    w_ih = w_ih[: x.shape[-1]]  # trim padded input rows for layer 0
    x_proj = torch.einsum("btd,dg->btg", x, w_ih) + b  # (B, T, 4H)
    h = x.new_zeros((x.shape[0], w_hh.shape[0]))
    c = torch.zeros_like(h)
    outs = []
    for t in range(x.shape[1]):
        gates = x_proj[:, t] + h @ w_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def forward(params: Params, mels: torch.Tensor) -> torch.Tensor:
    """(B, T, 40) mel frames -> (B, 256) L2-normalized embeddings."""
    x = mels
    h_last = None
    for layer in range(MODEL_NUM_LAYERS):
        x, h_last = _lstm_layer(x, params["w_ih"][layer], params["w_hh"][layer], params["b"][layer])
    raw = torch.relu(h_last @ params["linear_w"] + params["linear_b"])
    return raw / torch.clamp(torch.linalg.norm(raw, dim=1, keepdim=True), min=1e-8)


def compute_partial_slices(
    n_samples: int, rate: float = 1.3, min_coverage: float = 0.75
) -> tuple[list[slice], list[slice]]:
    """Sliding partial-utterance windows (reference model.py:60-83)."""
    samples_per_frame = int(SAMPLING_RATE * MEL_WINDOW_STEP_MS / 1000)
    n_frames = int(np.ceil((n_samples + 1) / samples_per_frame))
    frame_step = int(np.round((SAMPLING_RATE / rate) / samples_per_frame))

    wav_slices, mel_slices = [], []
    steps = max(1, n_frames - PARTIALS_N_FRAMES + frame_step + 1)
    for i in range(0, steps, frame_step):
        mel_range = np.array([i, i + PARTIALS_N_FRAMES])
        wav_range = mel_range * samples_per_frame
        mel_slices.append(slice(*mel_range))
        wav_slices.append(slice(*wav_range))

    last_wav_range = wav_slices[-1]
    coverage = (n_samples - last_wav_range.start) / (
        last_wav_range.stop - last_wav_range.start
    )
    if coverage < min_coverage and len(mel_slices) > 1:
        mel_slices = mel_slices[:-1]
        wav_slices = wav_slices[:-1]
    return wav_slices, mel_slices


def embed_utterance(
    params: Params, wav: np.ndarray, rate: float = 1.3, min_coverage: float = 0.75
) -> np.ndarray:
    """16 kHz waveform -> (256,) utterance embedding (numpy f32).

    Mean of the partial-window embeddings, L2-normalized (reference
    model.py:85-106). As in the JAX package, the mel runs once over the
    utterance zero-padded to whole seconds, and each window slices it.
    """
    wav_slices, mel_slices = compute_partial_slices(len(wav), rate, min_coverage)
    max_wave_length = wav_slices[-1].stop
    if max_wave_length >= len(wav):
        wav = np.pad(wav, (0, max_wave_length - len(wav)), "constant")
    bucket = -(-len(wav) // SAMPLING_RATE) * SAMPLING_RATE
    wav_b = np.pad(wav, (0, bucket - len(wav)), "constant") if bucket != len(wav) else wav
    mel = mel_spectrogram(np.asarray(wav_b, np.float32)).T  # (T, 40)
    mels = np.stack([mel[s] for s in mel_slices])  # (N, 160, 40)
    w = params["w_ih"]
    partials = forward(params, torch.from_numpy(mels).to(w.device, w.dtype))
    raw = partials.float().mean(dim=0).cpu().numpy()
    return raw / max(np.linalg.norm(raw, 2), 1e-8)


def trim_silence(wav: np.ndarray, top_db: float = 20.0, frame_length: int = 2048, hop_length: int = 512) -> np.ndarray:
    """librosa.effects.trim equivalent: strip leading/trailing frames more
    than ``top_db`` below the peak RMS (reference model.py:113-114)."""
    if len(wav) == 0:
        return wav
    pad = frame_length // 2
    padded = np.pad(wav.astype(np.float32), (pad, pad), mode="reflect") if len(wav) >= pad else wav.astype(np.float32)
    n_frames = 1 + max(0, (len(padded) - frame_length)) // hop_length
    idx = np.arange(n_frames)[:, None] * hop_length + np.arange(frame_length)[None, :]
    frames = padded[np.minimum(idx, len(padded) - 1)]
    rms = np.sqrt(np.mean(frames**2, axis=1) + 1e-12)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10))
    threshold = db.max() - top_db
    keep = np.flatnonzero(db > threshold)
    if len(keep) == 0:
        return wav
    start = keep[0] * hop_length
    end = min(len(wav), (keep[-1] + 1) * hop_length + frame_length - hop_length)
    return wav[start:end]
