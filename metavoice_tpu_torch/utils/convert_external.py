"""External pretrained weights into the port's trees: the encodec package's
24 kHz EnCodec checkpoints -> models/encodec.py params.

Port of the EnCodec half of metavoice_tpu/utils/convert_external.py. The
checkpoint is a plain tensor state dict (``weights_only=True``); the known
module naming of the 24 kHz causal EnCodec (n_filters 32, ratios 8/5/4/2, a
2-layer LSTM, 128-d latent) maps onto the port's layout, which is the JAX
package's:

  * SConv1d ``NormConv1d``: the weight norm (dim 0) folded, torch (out, in,
    k) -> (k, in, out);
  * SConvTranspose1d: torch (in, out, k) -> (k, in, out), the kernel flipped
    along k (models/encodec._conv_transpose1d flips it back);
  * SLSTM: weight_ih/hh transposed, the two biases summed;
  * the RVQ codebooks ``quantizer.vq.layers.{i}._codebook.embed`` (K, D) as
    they are.

Every leaf has the bits of the JAX converter's: the weight norm is folded in
float64 with numpy, as there, and everything else is exact (f32 reads,
transposes, flips). The MultiBandDiffusion converters come with the MBD
vocoder.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.models.encodec import EncodecConfig

Params = dict[str, Any]


def fold_weight_norm(g, v) -> torch.Tensor:
    """torch's weight_norm (dim 0): w = g * v / ||v|| over the other dims, in
    float64 (numpy, the JAX converter's arithmetic), rounded to f32."""
    g64 = torch.as_tensor(g).detach().cpu().double().numpy()
    v64 = torch.as_tensor(v).detach().cpu().double().numpy()
    norm = np.sqrt(np.sum(v64 ** 2, axis=tuple(range(1, v64.ndim)), keepdims=True))
    return torch.from_numpy((g64 * v64 / np.maximum(norm, 1e-12)).astype(np.float32))


class _SD:
    """State-dict access with the weight norm folded."""

    def __init__(self, sd: dict):
        self.sd = sd

    def has(self, name: str) -> bool:
        return name in self.sd or f"{name}_g" in self.sd

    def conv_w(self, prefix: str) -> torch.Tensor:
        if f"{prefix}_g" in self.sd:
            return fold_weight_norm(self.sd[f"{prefix}_g"], self.sd[f"{prefix}_v"])
        return self.arr(prefix)

    def arr(self, name: str) -> torch.Tensor:
        return torch.as_tensor(self.sd[name]).detach().cpu().float()

    def bias(self, name: str) -> torch.Tensor | None:
        return self.arr(name) if name in self.sd else None


def _lstm(sd: _SD, prefix: str, layers: int) -> Params:
    return {
        "w_ih": torch.stack([sd.arr(f"{prefix}.weight_ih_l{i}").T for i in range(layers)]),
        "w_hh": torch.stack([sd.arr(f"{prefix}.weight_hh_l{i}").T for i in range(layers)]),
        "b": torch.stack([sd.arr(f"{prefix}.bias_ih_l{i}") + sd.arr(f"{prefix}.bias_hh_l{i}")
                          for i in range(layers)]),
    }


def convert_encodec_state_dict(state_dict: dict, cfg: EncodecConfig = EncodecConfig(), device="cuda") -> Params:
    """encodec-package 24 kHz state dict -> models/encodec params on ``device``.

    SEANet's module indices for ratios (8, 5, 4, 2) and a 2-layer LSTM:
      encoder.model: 0 conv_in; 1, 4, 7, 10 residual blocks; 3, 6, 9, 12
      strided convs (ELUs in the gaps); 13 LSTM; 15 conv_out.
      decoder.model: 0 conv_in; 1 LSTM; 3, 6, 9, 12 transposed convs; 4, 7,
      10, 13 residual blocks; 15 conv_out.
    """
    sd = _SD(state_dict)
    n_stages = len(cfg.ratios)

    def conv(prefix):
        # NormConv1d: {prefix}.conv.weight(_g/_v) + .conv.bias (older dumps {prefix}.conv.conv.*)
        for base in (f"{prefix}.conv.conv", f"{prefix}.conv"):
            if sd.has(f"{base}.weight"):
                return sd.conv_w(f"{base}.weight").permute(2, 1, 0).contiguous(), sd.bias(f"{base}.bias")
        raise KeyError(f"no conv weights under {prefix}")

    def convtr(prefix):
        for base in (f"{prefix}.convtr.convtr", f"{prefix}.convtr"):
            if sd.has(f"{base}.weight"):
                w = sd.conv_w(f"{base}.weight").flip(2).permute(2, 0, 1).contiguous()
                return w, sd.bias(f"{base}.bias")
        raise KeyError(f"no convtr weights under {prefix}")

    def resblock(prefix):
        w1, b1 = conv(f"{prefix}.block.1")
        w2, b2 = conv(f"{prefix}.block.3")
        return {"conv1_w": w1, "conv1_b": b1, "conv2_w": w2, "conv2_b": b2}

    enc_in_w, enc_in_b = conv("encoder.model.0")
    enc_blocks = []
    for i in range(n_stages):
        w, b = conv(f"encoder.model.{3 + 3 * i}")
        enc_blocks.append({"res": resblock(f"encoder.model.{1 + 3 * i}"), "conv_w": w, "conv_b": b})
    lstm_idx = 1 + 3 * n_stages
    enc_out_w, enc_out_b = conv(f"encoder.model.{lstm_idx + 2}")
    encoder = {
        "conv_in_w": enc_in_w, "conv_in_b": enc_in_b, "blocks": enc_blocks,
        "lstm": _lstm(sd, f"encoder.model.{lstm_idx}.lstm", cfg.lstm_layers),
        "conv_out_w": enc_out_w, "conv_out_b": enc_out_b,
    }

    dec_in_w, dec_in_b = conv("decoder.model.0")
    dec_blocks = []
    for i in range(n_stages):
        w, b = convtr(f"decoder.model.{3 + 3 * i}")
        dec_blocks.append({"convtr_w": w, "convtr_b": b, "res": resblock(f"decoder.model.{4 + 3 * i}")})
    dec_out_w, dec_out_b = conv(f"decoder.model.{3 + 3 * n_stages}")
    decoder = {
        "conv_in_w": dec_in_w, "conv_in_b": dec_in_b,
        "lstm": _lstm(sd, "decoder.model.1.lstm", cfg.lstm_layers),
        "blocks": dec_blocks, "conv_out_w": dec_out_w, "conv_out_b": dec_out_b,
    }
    codebooks = torch.stack([sd.arr(f"quantizer.vq.layers.{i}._codebook.embed") for i in range(cfg.n_q)])
    dev = resolve_device(device)

    def to_dev(node):
        if isinstance(node, dict):
            return {k: to_dev(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_dev(v) for v in node]
        return None if node is None else node.to(dev)

    return to_dev({"encoder": encoder, "decoder": decoder, "codebooks": codebooks})


def load_encodec_pt(path: str, cfg: EncodecConfig = EncodecConfig(), device="cuda") -> Params:
    """An encodec-package checkpoint file (a plain tensor dict, or one under
    ``best_state``) -> models/encodec params on ``device``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "best_state" in raw:
        raw = raw["best_state"]
    return convert_encodec_state_dict(raw, cfg, device)
