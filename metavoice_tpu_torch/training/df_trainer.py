"""Training recipe for the DFN-style enhancer (models/enhancer.DFEnhancer).

Port of metavoice_tpu/training/df_trainer.py: a denoising recipe on
synthetic clean/noisy pairs with the DeepFilterNet loss structure (a
magnitude loss on every bin + a complex loss on the deep-filtered low bins),
trained with plain Adam. ``train_df`` stamps ``params["trained_iters"]`` so
``get_enhancer("df")`` tells trained weights from random ones.

    params = train_df(None, cfg, DFTrainConfig(), device="cuda")
    enhancer = DFEnhancer(params, cfg, device="cuda")

The pairs come from a numpy generator seeded with ``tcfg.seed``, as in the
JAX package, so both packages train on the same data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.models.enhancer import DFConfig, df_enhance_spec, init_df_params
from metavoice_tpu_torch.ops.audio import stft_np
from metavoice_tpu_torch.training.finetune import AdamW, apply_updates, mean_grads

Params = dict[str, Any]


@dataclass(frozen=True)
class DFTrainConfig:
    learning_rate: float = 3e-4
    max_iters: int = 400
    batch_size: int = 4
    clip_s: float = 0.6  # training clip length in seconds
    snr_db_lo: float = 0.0
    snr_db_hi: float = 12.0
    mag_weight: float = 1.0  # magnitude-spectral loss weight
    df_weight: float = 1.0  # complex loss weight on the deep-filtered bins
    seed: int = 0


def synth_clean_noisy(rng: np.random.Generator, b: int, n: int, sr: int, snr_db_lo: float,
                      snr_db_hi: float) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic (clean, noisy) pairs: harmonic 'speech' + broadband noise.

    Clean = a few low-frequency harmonics with slow amplitude modulation;
    noise = white, scaled per clip to a random SNR."""
    t = np.arange(n) / sr
    clean = np.zeros((b, n), np.float32)
    for i in range(b):
        f0 = rng.uniform(90, 220)
        for h in range(1, 5):
            amp = rng.uniform(0.1, 0.4) / h
            mod = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(1.5, 4.0) * t + rng.uniform(0, 6))
            clean[i] += (amp * mod * np.sin(2 * np.pi * f0 * h * t)).astype(np.float32)
    noise = rng.standard_normal((b, n)).astype(np.float32)
    snr = rng.uniform(snr_db_lo, snr_db_hi, size=(b, 1)).astype(np.float32)
    p_c = np.mean(clean**2, axis=1, keepdims=True) + 1e-9
    p_n = np.mean(noise**2, axis=1, keepdims=True)
    noise *= np.sqrt(p_c / (p_n * 10 ** (snr / 10.0)))
    return clean, clean + noise


def df_loss(params: Params, cfg: DFConfig, noisy_spec: torch.Tensor, clean_spec: torch.Tensor,
            tcfg: DFTrainConfig) -> torch.Tensor:
    """DFN-structured loss: a magnitude term on every bin + a complex term on
    the deep-filtered low bins (DeepFilterNet2, eqs. 6-8 in spirit)."""
    out = df_enhance_spec(params, cfg, noisy_spec)
    mag = torch.mean(torch.abs(out.abs() - clean_spec.abs()))
    comp = torch.mean(torch.abs(out[..., : cfg.df_bins] - clean_spec[..., : cfg.df_bins]))
    return tcfg.mag_weight * mag + tcfg.df_weight * comp


def make_df_step(cfg: DFConfig, tcfg: DFTrainConfig):
    """-> (opt, step): ``step(params, opt_state, noisy_spec, clean_spec) ->
    (params, opt_state, loss)``, plain Adam (optax.adam: no clipping, no
    decay); the params and moments are updated in place."""
    opt = AdamW(tcfg.learning_rate, weight_decay=0.0, grad_clip=float("inf"))

    def step(params, opt_state, noisy_spec, clean_spec):
        loss, grads = mean_grads(params, [True] * len(params),
                                 lambda _b, _gen: df_loss(params, cfg, noisy_spec, clean_spec, tcfg), [None], [0])
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, loss

    return opt, step


def _specs(wavs: np.ndarray, cfg: DFConfig, dev: torch.device) -> torch.Tensor:
    spec = np.stack([stft_np(w, cfg.n_fft, cfg.hop) for w in wavs]).astype(np.complex64)
    return torch.from_numpy(spec).to(dev)


def train_df(params: Params | None, cfg: DFConfig, tcfg: DFTrainConfig = DFTrainConfig(), *,
             generator: torch.Generator | None = None, device="cuda", log_every: int = 100) -> Params:
    """Train the DF-style enhancer on synthetic pairs, printing the loss every
    ``log_every`` steps -> params with a ``trained_iters`` stamp (recognized
    by models/enhancer.get_enhancer). Without ``params`` the network is drawn
    on ``device`` from ``generator`` (else a generator seeded with
    ``tcfg.seed``); given params train on their device, in place."""
    if params is None:
        dev = resolve_device(device)
        gen = generator or torch.Generator(device=dev).manual_seed(tcfg.seed)
        params = init_df_params(cfg, device=dev, generator=gen)
    params = {k: v for k, v in params.items() if k != "trained_iters"}
    dev = next(iter(params.values())).device
    opt, step = make_df_step(cfg, tcfg)
    opt_state = opt.init(params)
    rng = np.random.default_rng(tcfg.seed)
    n = int(tcfg.clip_s * cfg.sr)
    for it in range(tcfg.max_iters):
        clean, noisy = synth_clean_noisy(rng, tcfg.batch_size, n, cfg.sr, tcfg.snr_db_lo, tcfg.snr_db_hi)
        params, opt_state, loss = step(params, opt_state, _specs(noisy, cfg, dev), _specs(clean, cfg, dev))
        if it % log_every == 0:
            print(f"df iter {it}: loss {float(loss):.4f}", flush=True)
    params = {k: v.detach() for k, v in params.items()}
    params["trained_iters"] = torch.tensor(tcfg.max_iters, dtype=torch.int32)
    return params
