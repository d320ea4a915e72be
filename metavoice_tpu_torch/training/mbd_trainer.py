"""Multi-band diffusion training: the in-repo path to MBD weights.

Port of metavoice_tpu/training/mbd_trainer.py (audiocraft's DiffusionSolver
recipe, audiocraft/solvers/diffusion.py):

  * each of the ``n_processes`` band models trains on its own frequency band
    of the target waveform (the julius mel band split);
  * targets are processor-projected (MultiBandProcessor.project_sample), the
    processor's running statistics fitted from clean waveforms first
    (``fit_processor``);
  * the objective is DDPM epsilon-prediction MSE at a uniformly drawn step:
    x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps, L = mean (eps_hat - eps)^2;
  * the conditioning is the EnCodec latent of the same audio.

The optimizer is optax's ``chain(clip_by_global_norm, adam)``: the port's
``training/finetune.AdamW`` with no weight decay. A step updates the params
and the moments in place. The step's draws (t, eps) come from a
``torch.Generator`` or are injected.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from metavoice_tpu_torch.models import mbd
from metavoice_tpu_torch.training.finetune import AdamW, apply_updates, mean_grads, tree_leaves

Params = dict[str, Any]


@dataclass(frozen=True)
class MBDTrainConfig:
    learning_rate: float = 2e-4
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip: float = 1.0
    batch_size: int = 4
    max_iters: int = 100_000
    # number of samples used to fit the band processors before training
    processor_fit_samples: int = 10_000


def processor_update(proc: Params, band: torch.Tensor) -> Params:
    """Online update of the processor's running sums from a (B, n_bands, T)
    band stack (diffusion_schedule.py project_sample's accumulation)."""
    bsz = band.shape[0]
    return {
        "counts": proc["counts"] + bsz,
        "sum_x": proc["sum_x"] + band.mean(dim=(0, 2)) * bsz,
        "sum_x2": proc["sum_x2"] + (band**2).mean(dim=(0, 2)) * bsz,
        "sum_target_x2": proc["sum_target_x2"],
    }


def fit_processor(cfg: mbd.MBDConfig, wavs: torch.Tensor, *, generator: torch.Generator | None = None,
                  noise: torch.Tensor | None = None) -> Params:
    """One MultiBandProcessor's statistics from clean waveforms (N, T).
    target_x2 comes from white noise (``noise``, or drawn from ``generator``)
    through the same band split: what the processor rescales each band
    toward."""
    n = cfg.processor_bands
    zeros = torch.zeros((n,), device=wavs.device)
    proc = {"counts": torch.zeros((1,), device=wavs.device), "sum_x": zeros, "sum_x2": zeros,
            "sum_target_x2": zeros}
    if noise is None:
        noise = torch.randn(wavs.shape, device=wavs.device, generator=generator)
    proc = processor_update(proc, torch.stack(mbd.split_bands(wavs, cfg.sample_rate, n), dim=1))
    noise_bands = torch.stack(mbd.split_bands(noise, cfg.sample_rate, n), dim=1)
    proc["sum_target_x2"] = (noise_bands**2).mean(dim=(0, 2)) * wavs.shape[0]
    return proc


def diffusion_loss(unet_params: Params, cfg: mbd.MBDConfig, x0: torch.Tensor, condition: torch.Tensor, *,
                   generator: torch.Generator | None = None, t: torch.Tensor | None = None,
                   eps: torch.Tensor | None = None) -> torch.Tensor:
    """DDPM epsilon-MSE at a uniform step (audiocraft DiffusionSolver.run_step).

    ``x0`` (B, T) the projected band target, ``condition`` (B, Tc, D); the
    steps ``t`` (B,) and the noise ``eps`` (B, T) are injected or drawn from
    ``generator``. Each example takes its own step's embedding."""
    bsz, dev = x0.shape[0], x0.device
    betas = torch.as_tensor(mbd.schedule_betas(cfg.schedule), dtype=torch.float32, device=dev)
    alpha_bars = torch.cumprod(1.0 - betas, dim=0)
    if t is None:
        t = torch.randint(0, cfg.schedule.num_steps, (bsz,), device=dev, generator=generator)
    if eps is None:
        eps = torch.randn(x0.shape, device=dev, generator=generator)
    t = torch.as_tensor(t, device=dev).long()
    ab = alpha_bars[t][:, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    est = mbd.unet_forward(unet_params, cfg.unet, x_t[..., None], t, condition)[..., 0]
    return torch.mean((est - eps) ** 2)


def make_mbd_train_step(cfg: mbd.MBDConfig, tcfg: MBDTrainConfig):
    """-> (opt, step): ``step(opt_state, unet_params, batch, generator=None,
    t=None, eps=None) -> (opt_state, unet_params, loss)``, ``batch`` =
    {"band": (B, T) projected band target, "emb": (B, Tc, D) EnCodec
    latent}; the params and moments are updated in place."""
    opt = AdamW(tcfg.learning_rate, b1=tcfg.beta1, b2=tcfg.beta2, eps=1e-8, weight_decay=0.0,
                grad_clip=tcfg.grad_clip)

    def step(opt_state, unet_params, batch, generator=None, t=None, eps=None):
        trained = [True] * len(tree_leaves(unet_params))
        loss, grads = mean_grads(
            unet_params, trained,
            lambda b, _gen: diffusion_loss(unet_params, cfg, b["band"], b["emb"], generator=generator, t=t, eps=eps),
            [batch], [0])
        updates, opt_state = opt.update(grads, opt_state, unet_params)
        apply_updates(unet_params, updates)
        return opt_state, unet_params, loss

    return opt, step


def train_band(cfg: mbd.MBDConfig, tcfg: MBDTrainConfig, band_index: int, unet_params: Params, proc: Params,
               batches, generator: torch.Generator | None = None, log_every: int = 50) -> tuple[Params, Params]:
    """Train ONE band model (audiocraft trains the n_processes models as
    independent runs) on ``batches`` of {"wav": (B, T), "emb": (B, Tc, D)},
    up to ``tcfg.max_iters`` steps, printing the loss every ``log_every``.
    -> (unet_params, processor); the params are trained in place."""
    opt, step = make_mbd_train_step(cfg, tcfg)
    opt_state = opt.init(unet_params)
    dev = tree_leaves(unet_params)[0].device
    for it, batch in enumerate(batches):
        if it >= tcfg.max_iters:
            break
        wav = torch.as_tensor(batch["wav"], dtype=torch.float32, device=dev)
        band = mbd.split_bands(wav, cfg.sample_rate, cfg.n_processes)[band_index]
        target = mbd.processor_project_sample(proc, band, cfg.sample_rate, cfg.processor_bands,
                                              cfg.processor_power_std)
        emb = torch.as_tensor(batch["emb"], dtype=torch.float32, device=dev)
        opt_state, unet_params, loss = step(opt_state, unet_params, {"band": target, "emb": emb}, generator)
        if it % log_every == 0:
            print(f"band {band_index} iter {it}: loss {float(loss):.4f}", flush=True)
    return unet_params, proc
