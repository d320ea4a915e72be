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
transposes, flips).

The MultiBandDiffusion half: audiocraft's ``mbd_comp_*.pt`` package ->
models/mbd.py params and ``MBDConfig`` (``convert_mbd_checkpoint``,
``load_mbd_pt``), the UNet's depth, widths, step count and conditioning
width inferred from the tensors' shapes.
"""

from __future__ import annotations

import re
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


def _to_dev(node, dev: torch.device):
    """A tree of CPU tensors (``None`` leaves kept) -> the same on ``dev``."""
    if isinstance(node, dict):
        return {k: _to_dev(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_dev(v, dev) for v in node]
    return None if node is None else node.to(dev)


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
    return _to_dev({"encoder": encoder, "decoder": decoder, "codebooks": codebooks}, resolve_device(device))


def load_encodec_pt(path: str, cfg: EncodecConfig = EncodecConfig(), device="cuda") -> Params:
    """An encodec-package checkpoint file (a plain tensor dict, or one under
    ``best_state``) -> models/encodec params on ``device``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "best_state" in raw:
        raw = raw["best_state"]
    return convert_encodec_state_dict(raw, cfg, device)


# --------------------------------------------------------------------------------------
# audiocraft MultiBandDiffusion checkpoints -> models/mbd.py trees
# --------------------------------------------------------------------------------------
#
# audiocraft packs the per-band diffusion models as
#   {"sample_rate": int, "n_bands": int,
#    i: {"model_state": {...}, "processor_state": {...}, "cfg": ...}}
# (audiocraft/models/loaders.py load_diffusion_models; the reference reads it
# through MultiBandDiffusion.get_mbd_24khz(bw=6.0), fam/llm/decoders.py:84-86).


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu().float()


def _convert_diffusion_unet(ms: dict) -> tuple[Params, dict]:
    """One DiffusionUnet model_state -> (params tree of CPU tensors, the
    inferred UNetConfig keywords)."""
    depth = 1 + max(int(m.group(1)) for k in ms if (m := re.match(r"encoders\.(\d+)\.conv\.weight", k)))
    res_blocks = 1 + max((int(m.group(1)) for k in ms if (m := re.match(r"encoders\.0\.res_blocks\.(\d+)\.", k))),
                         default=-1)

    def conv_w(name):  # (out, in, k) -> (k, in, out)
        return _f32(ms[name]).permute(2, 1, 0).contiguous()

    def convtr_w(name):  # (in, out, k) -> (k, in, out), the kernel flipped
        return _f32(ms[name]).flip(2).permute(2, 0, 1).contiguous()

    def resblock(prefix):
        return {
            "gn1_w": _f32(ms[f"{prefix}.block.0.weight"]), "gn1_b": _f32(ms[f"{prefix}.block.0.bias"]),
            "conv1_w": conv_w(f"{prefix}.block.2.weight"), "conv1_b": _f32(ms[f"{prefix}.block.2.bias"]),
            "gn2_w": _f32(ms[f"{prefix}.block.3.weight"]), "gn2_b": _f32(ms[f"{prefix}.block.3.bias"]),
            "conv2_w": conv_w(f"{prefix}.block.6.weight"), "conv2_b": _f32(ms[f"{prefix}.block.6.bias"]),
        }

    encoders, decoders = [], []
    for i in range(depth):
        encoders.append({
            "conv_w": conv_w(f"encoders.{i}.conv.weight"),
            "norm_w": _f32(ms[f"encoders.{i}.norm.weight"]), "norm_b": _f32(ms[f"encoders.{i}.norm.bias"]),
            "res": [resblock(f"encoders.{i}.res_blocks.{j}") for j in range(res_blocks)],
        })
        decoders.append({
            "convtr_w": convtr_w(f"decoders.{i}.convtr.weight"),
            "norm_w": _f32(ms[f"decoders.{i}.norm.weight"]), "norm_b": _f32(ms[f"decoders.{i}.norm.bias"]),
            "res": [resblock(f"decoders.{i}.res_blocks.{j}") for j in range(res_blocks)],
        })
    embeddings = None
    if any(k.startswith("embeddings.") for k in ms):
        embeddings = [_f32(ms[f"embeddings.{i}.weight"]) for i in range(depth - 1)
                      if f"embeddings.{i}.weight" in ms] or None
    params = {"encoders": encoders, "decoders": decoders, "embedding": _f32(ms["embedding.weight"]),
              "embeddings": embeddings, "bilstm": None}
    codec_dim = None
    if "conv_codec.weight" in ms:
        params["conv_codec_w"] = conv_w("conv_codec.weight")
        params["conv_codec_b"] = _f32(ms["conv_codec.bias"])
        codec_dim = params["conv_codec_w"].shape[1]

    enc0 = encoders[0]["conv_w"]  # (k, chin, hidden)
    enc_chs = [e["conv_w"].shape[2] for e in encoders]
    cfg_kwargs = dict(
        chin=enc0.shape[1],
        hidden=enc_chs[0],
        depth=depth,
        growth=(enc_chs[1] / enc_chs[0]) if depth > 1 else 1.0,
        num_steps=params["embedding"].shape[0],
        codec_dim=codec_dim,
        kernel=enc0.shape[0],
        res_blocks=res_blocks,
        emb_all_layers=params["embeddings"] is not None,
    )
    return params, cfg_kwargs


_SCHEDULE_KEYS = ("beta_t0", "beta_t1", "num_steps", "variance", "clip", "rescale", "beta_exp", "noise_scale")


def convert_mbd_checkpoint(pkg: dict, bottleneck: str = "auto", device="cuda"):
    """audiocraft MBD package -> (params on ``device``, MBDConfig).

    ``pkg`` is the loaded pickle (or a dict of the same shape). The schedule
    comes from the first band's ``cfg`` when it is a dict (``cfg["schedule"]``),
    else the defaults; the default step list (every 50th of 1000 steps) is
    rescaled to the schedule's ``num_steps``. ``bottleneck``: "auto" refuses
    a checkpoint with a recurrent or transformer bottleneck (converting it
    would drop those weights) and otherwise reads the bottleneck as
    "zeroed"; "zeroed" or "passthrough" choose a reading explicitly
    (models/mbd.UNetConfig)."""
    from metavoice_tpu_torch.models.mbd import MBDConfig, ScheduleConfig, UNetConfig

    if bottleneck not in ("auto", "zeroed", "passthrough"):
        raise ValueError(f"bottleneck must be auto|zeroed|passthrough, got {bottleneck!r}")
    dev = resolve_device(device)
    processes = []
    unet_kwargs = None
    for i in range(pkg["n_bands"]):
        ms = pkg[i]["model_state"]
        lstm_keys = [k for k in ms if "lstm" in k.lower() or "transformer" in k.lower()]
        if lstm_keys:
            raise NotImplementedError(
                "this MBD checkpoint has a recurrent/transformer bottleneck "
                f"core (keys like {lstm_keys[:3]}); converting it would "
                "silently drop those weights — extend _convert_diffusion_unet"
            )
        unet_params, kw = _convert_diffusion_unet(ms)
        unet_kwargs = unet_kwargs or kw
        ps = pkg[i]["processor_state"]
        processor = {"counts": _f32(ps["counts"]).reshape(-1), "sum_x": _f32(ps["sum_x"]),
                     "sum_x2": _f32(ps["sum_x2"]), "sum_target_x2": _f32(ps["sum_target_x2"])}
        processes.append({"unet": unet_params, "processor": processor})

    cfg0 = pkg[0].get("cfg")
    sch = cfg0.get("schedule", {}) if isinstance(cfg0, dict) else {}
    schedule = ScheduleConfig(**{k: sch[k] for k in _SCHEDULE_KEYS if k in sch})
    n_steps = schedule.num_steps
    stride = max(1, n_steps // 20)
    cfg = MBDConfig(
        sample_rate=pkg.get("sample_rate", 24_000),
        n_processes=pkg["n_bands"],
        unet=UNetConfig(**unet_kwargs, bottleneck="zeroed" if bottleneck == "auto" else bottleneck),
        schedule=schedule,
        processor_bands=processes[0]["processor"]["sum_x"].shape[0],
        step_list=tuple(range(n_steps - 1, 0, -stride)) + (0,),
    )
    return _to_dev({"processes": processes}, dev), cfg


def load_mbd_pt(path: str, bottleneck: str = "auto", device="cuda"):
    """An audiocraft ``mbd_comp_*.pt`` checkpoint -> (params on ``device``,
    MBDConfig). The package holds its config objects, so it is unpickled
    (``weights_only=False``): load only files you trust."""
    pkg = torch.load(path, map_location="cpu", weights_only=False)
    return convert_mbd_checkpoint(pkg, bottleneck=bottleneck, device=device)
