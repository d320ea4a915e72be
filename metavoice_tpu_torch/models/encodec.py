"""EnCodec 24 kHz codec: RVQ + SEANet decoder and encoder.

Port of metavoice_tpu/models/encodec.py (Defossez et al. 2022). Decode:
codes (n_q, T) -> latent (T, D) by summing per-stage codebook embeddings,
then Conv(D->C) -> 2-layer LSTM (residual) -> 4 upsampling stages
(ConvTranspose, ratios 8,5,4,2, halving channels) each followed by a
residual unit -> Conv(C/16 -> 1). All convs causal, ELU activations; 320x
upsampling from 75 Hz frames to 24 kHz samples. Encode (``get_tokens``):
the mirror image, Conv(1 -> C/16) -> 4 stages of a residual unit and a
strided conv (ratios 2,4,5,8, doubling channels) -> LSTM -> Conv(C -> D),
then the residual quantizer's nearest-codeword search, stage by stage.

Layouts stay the JAX package's at every function here: activations are
(B, T, C) and conv kernels (K, C_in, C_out); the functions transpose to
PyTorch's (B, C, T) / (C_out, C_in, K) around each ``F.conv1d``. JAX's
``lax.conv_transpose`` does not flip the kernel, so the transposed conv
passes the kernel flipped along K to ``F.conv_transpose1d``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from metavoice_tpu_torch.core.device import resolve_device

Params = dict[str, Any]


@dataclass(frozen=True)
class EncodecConfig:
    sample_rate: int = 24000
    channels: int = 1
    dimension: int = 128  # latent dim
    n_filters: int = 32
    ratios: tuple[int, ...] = (8, 5, 4, 2)  # decoder order: coarse->fine
    n_q: int = 8  # codebooks in use (bw = 6 kbps)
    codebook_size: int = 1024
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    lstm_layers: int = 2
    causal: bool = True

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out  # 320

    @property
    def frame_rate(self) -> int:
        return self.sample_rate // self.hop_length  # 75

    @property
    def max_channels(self) -> int:
        return self.n_filters * (2 ** len(self.ratios))  # 512


def _conv1d(x, w, b, stride: int = 1, dilation: int = 1, causal: bool = True):
    """x: (B, T, C_in), w: (K, C_in, C_out). Causal left-pad."""
    k = w.shape[0]
    pad_total = max(dilation * (k - 1) - (stride - 1), 0)
    pad = (pad_total, 0) if causal else (pad_total // 2, pad_total - pad_total // 2)
    y = F.conv1d(F.pad(x.transpose(1, 2), pad), w.permute(2, 1, 0), stride=stride, dilation=dilation)
    y = y.transpose(1, 2)
    if b is not None:
        y = y + b
    return y


def _conv_transpose1d(x, w, b, stride: int, causal: bool = True):
    """x: (B, T, C_in), w: (K, C_in, C_out) -> (B, T*stride, C_out).

    Full transposed conv ((T-1)*stride + K frames), then trim K - stride
    frames (all from the right when causal), as audiocraft's SConvTranspose1d.
    """
    k = w.shape[0]
    y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0), stride=stride)
    y = y.transpose(1, 2)
    trim = k - stride
    if trim > 0:
        if causal:
            y = y[:, : y.shape[1] - trim]
        else:
            left = trim // 2
            y = y[:, left : y.shape[1] - (trim - left)]
    if b is not None:
        y = y + b
    return y


def _lstm_stack(x, lstm: Params):
    """Stacked LSTM with residual skip (EnCodec's SLSTM). x: (B, T, C)."""
    y = x
    for i in range(lstm["w_ih"].shape[0]):
        w_ih, w_hh, b = lstm["w_ih"][i], lstm["w_hh"][i], lstm["b"][i]
        x_proj = torch.einsum("btd,dg->btg", y, w_ih) + b
        h = y.new_zeros((y.shape[0], w_hh.shape[0]))
        c = torch.zeros_like(h)
        outs = []
        for t in range(y.shape[1]):
            gates = x_proj[:, t] + h @ w_hh
            ii, ff, gg, oo = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(ff) * c + torch.sigmoid(ii) * torch.tanh(gg)
            h = torch.sigmoid(oo) * torch.tanh(c)
            outs.append(h)
        y = torch.stack(outs, dim=1)
    return x + y  # skip connection


def _residual_unit(x, unit: Params, cfg: EncodecConfig):
    """ELU -> Conv(k=3, C->C/2) -> ELU -> Conv(k=1, C/2->C), identity skip."""
    y = _conv1d(F.elu(x), unit["conv1_w"], unit.get("conv1_b"), causal=cfg.causal)
    y = _conv1d(F.elu(y), unit["conv2_w"], unit.get("conv2_b"), causal=cfg.causal)
    return x + y


def rvq_decode(codebooks, codes):
    """codebooks: (n_q, K, D); codes: (n_q, T) or (B, n_q, T) -> latent (B, T, D)."""
    if codes.dim() == 2:
        codes = codes[None]
    latent = codebooks[0][codes[:, 0]]
    for q in range(1, codes.shape[1]):
        latent = latent + codebooks[q][codes[:, q]]
    return latent


def rvq_encode(codebooks, latent, n_q: int):
    """latent (B, T, D) -> codes (B, n_q, T) int32: at each stage the
    codeword nearest the residual (argmax of 2 r.c - |c|^2, the first on a
    tie), then the residual less that codeword."""
    residual = latent
    codes = []
    for q in range(n_q):
        cb = codebooks[q]  # (K, D)
        dots = torch.einsum("btd,kd->btk", residual, cb)
        idx = torch.argmax(2 * dots - (cb * cb).sum(dim=-1), dim=-1)  # (B, T)
        codes.append(idx)
        residual = residual - cb[idx]
    return torch.stack(codes, dim=1).to(torch.int32)


def decode_latent(params: Params, cfg: EncodecConfig, latent):
    """latent (B, T, D) -> waveform (B, T * hop)."""
    dec = params["decoder"]
    x = _conv1d(latent, dec["conv_in_w"], dec.get("conv_in_b"), causal=cfg.causal)
    x = _lstm_stack(x, dec["lstm"])
    for i, ratio in enumerate(cfg.ratios):
        blk = dec["blocks"][i]
        x = _conv_transpose1d(F.elu(x), blk["convtr_w"], blk.get("convtr_b"), ratio, cfg.causal)
        x = _residual_unit(x, blk["res"], cfg)
    x = _conv1d(F.elu(x), dec["conv_out_w"], dec.get("conv_out_b"), causal=cfg.causal)
    return x[..., 0]


def decode_codes(params: Params, cfg: EncodecConfig, codes) -> torch.Tensor:
    """codes (n_q, T) or (B, n_q, T), int array or tensor -> waveform (B, samples)."""
    codebooks = params["codebooks"]
    codes = torch.as_tensor(np.asarray(codes) if not torch.is_tensor(codes) else codes)
    latent = rvq_decode(codebooks, codes.to(codebooks.device, torch.int64))
    return decode_latent(params, cfg, latent)


def encode_latent(params: Params, cfg: EncodecConfig, wav):
    """waveform (B, T) -> latent (B, T // hop, D)."""
    enc = params["encoder"]
    x = _conv1d(wav[..., None], enc["conv_in_w"], enc.get("conv_in_b"), causal=cfg.causal)
    for blk, ratio in zip(enc["blocks"], cfg.ratios[::-1]):  # downsampling runs fine -> coarse
        x = _residual_unit(x, blk["res"], cfg)
        x = _conv1d(F.elu(x), blk["conv_w"], blk.get("conv_b"), stride=ratio, causal=cfg.causal)
    x = _lstm_stack(x, enc["lstm"])
    return _conv1d(F.elu(x), enc["conv_out_w"], enc.get("conv_out_b"), causal=cfg.causal)


def encode_codes(params: Params, cfg: EncodecConfig, wav) -> torch.Tensor:
    """waveform (B, T), float array or tensor -> codes (B, n_q, T // hop) int32
    on the codebooks' device."""
    codebooks = params["codebooks"]
    wav = torch.as_tensor(np.asarray(wav, np.float32) if not torch.is_tensor(wav) else wav)
    latent = encode_latent(params, cfg, wav.to(codebooks.device, torch.float32))
    return rvq_encode(codebooks, latent, cfg.n_q)


def init_params(
    cfg: EncodecConfig = EncodecConfig(),
    *,
    device="cuda",
    generator: torch.Generator | None = None,
) -> Params:
    """Random f32 codec with the pretrained 24 kHz model's topology: normal
    kernels scaled by 1/sqrt(fan_in), zero biases, unit-normal codebooks.
    The encoder is drawn after the decoder and the codebooks, so a seed
    gives the same decoder and codebooks as before the encoder was ported."""
    dev = resolve_device(device)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=generator) * scale

    def conv(k, c_in, c_out):
        return normal(k, c_in, c_out, scale=1.0 / np.sqrt(k * c_in))

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    c = c_max = cfg.max_channels
    blocks = []
    for r in cfg.ratios:
        c_out = c // 2
        blocks.append({
            "convtr_w": conv(2 * r, c, c_out),
            "convtr_b": zeros(c_out),
            "res": {
                "conv1_w": conv(cfg.residual_kernel_size, c_out, c_out // 2),
                "conv1_b": zeros(c_out // 2),
                "conv2_w": conv(1, c_out // 2, c_out),
                "conv2_b": zeros(c_out),
            },
        })
        c = c_out
    decoder = {
        "conv_in_w": conv(cfg.kernel_size, cfg.dimension, c_max),
        "conv_in_b": zeros(c_max),
        "lstm": {
            "w_ih": normal(cfg.lstm_layers, c_max, 4 * c_max, scale=1.0 / np.sqrt(c_max)),
            "w_hh": normal(cfg.lstm_layers, c_max, 4 * c_max, scale=1.0 / np.sqrt(c_max)),
            "b": zeros(cfg.lstm_layers, 4 * c_max),
        },
        "blocks": blocks,
        "conv_out_w": conv(cfg.last_kernel_size, c, cfg.channels),
        "conv_out_b": zeros(cfg.channels),
    }
    codebooks = normal(cfg.n_q, cfg.codebook_size, cfg.dimension)

    enc_blocks = []  # 32 -> 64 -> 128 -> 256 -> 512 channels, downsampling 2, 4, 5, 8
    c = cfg.n_filters
    for r in cfg.ratios[::-1]:
        enc_blocks.append({
            "res": {
                "conv1_w": conv(cfg.residual_kernel_size, c, c // 2),
                "conv1_b": zeros(c // 2),
                "conv2_w": conv(1, c // 2, c),
                "conv2_b": zeros(c),
            },
            "conv_w": conv(2 * r, c, 2 * c),
            "conv_b": zeros(2 * c),
        })
        c *= 2
    encoder = {
        "conv_in_w": conv(cfg.kernel_size, cfg.channels, cfg.n_filters),
        "conv_in_b": zeros(cfg.n_filters),
        "blocks": enc_blocks,
        "lstm": {
            "w_ih": normal(cfg.lstm_layers, c_max, 4 * c_max, scale=1.0 / np.sqrt(c_max)),
            "w_hh": normal(cfg.lstm_layers, c_max, 4 * c_max, scale=1.0 / np.sqrt(c_max)),
            "b": zeros(cfg.lstm_layers, 4 * c_max),
        },
        "conv_out_w": conv(cfg.last_kernel_size, c_max, cfg.dimension),
        "conv_out_b": zeros(cfg.dimension),
    }
    return {"decoder": decoder, "encoder": encoder, "codebooks": codebooks}
