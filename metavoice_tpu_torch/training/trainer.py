"""The finetuning loop behind ``cli finetune``, with eval and checkpoints.

Port of metavoice_tpu/training/trainer.py: training/finetune.py's step over
training/data.py batches, with the reference loop's behaviour
(fam/llm/finetune.py:264-376): periodic eval (``estimate_loss``), the
``ckpt`` / ``best`` / ``final`` checkpoint policy, per-iteration logs, and
the start and end telemetry events.

Weights go to ``.npz`` files in the JAX package's format with the reference's
meta schema {model_args, iter_num, best_val_loss, config, meta}: either
package's ``load_npz`` reads them, and the port's ``load_first_stage_npz`` and
``TTS.from_checkpoints`` load them. The whole train state (params, Adam
moments, step) goes through ``torch.save`` in a ``state_{step}`` directory
(the JAX package uses orbax there), so a killed run restarts exactly.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Iterator

import numpy as np
import torch

from metavoice_tpu_torch import telemetry as tele
from metavoice_tpu_torch.core.config import TransformerConfig, first_stage_config
from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.training import finetune as ft
from metavoice_tpu_torch.utils import checkpoint as ck


def estimate_loss(eval_step, params, batches: list[dict]) -> float:
    """Mean eval loss over fixed batches (reference finetune.py:157-167)."""
    losses = [float(eval_step(params, b)) for b in batches]
    return float(np.mean(losses)) if losses else float("nan")


def save_checkpoint(
    out_dir: str,
    name: str,
    state: ft.TrainState,
    model_cfg: TransformerConfig,
    ft_cfg: ft.FinetuneConfig,
    best_val_loss: float,
    tokenizer_info: dict | None = None,
) -> str:
    """``{out_dir}/{name}.npz`` of ``state.params`` (the whole stacked tree)
    with the reference-schema meta (finetune.py:300-313)."""
    path = os.path.join(out_dir, f"{name}.npz")
    meta = {
        "model_args": {
            "n_layer": model_cfg.n_layer,
            "n_head": model_cfg.n_head,
            "n_local_heads": model_cfg.n_local_heads,
            "n_embd": model_cfg.dim,
            "block_size": model_cfg.block_size,
            "vocab_sizes": list(model_cfg.vocab_sizes),
            "causal": model_cfg.causal,
            "norm_type": model_cfg.norm_type,
            "nonlinearity_type": model_cfg.nonlinearity_type,
            "bias": model_cfg.bias,
            "spkemb_dropout": model_cfg.spkemb_dropout,
            "spk_emb_on_text": model_cfg.spk_emb_on_text,
        },
        "iter_num": int(state.step),
        "best_val_loss": float(best_val_loss),
        "config": dataclasses.asdict(ft_cfg),
        "meta": {
            "speaker_cond": True,
            "speaker_emb_size": model_cfg.speaker_emb_dim,
            "tokenizer": tokenizer_info or {},
        },
    }
    ck.save_npz(path, state.params, meta=meta)
    return path


def load_checkpoint(path: str) -> tuple[dict, dict]:
    return ck.load_npz(path)


def train(
    params: tfm.Params,
    model_cfg: TransformerConfig,
    ft_cfg: ft.FinetuneConfig,
    train_batches: Iterator[dict],
    val_batches: list[dict] | None = None,
    *,
    out_dir: str = "finetune_out",
    tokenizer_info: dict | None = None,
    log_every: int = 10,
    on_metrics=None,
) -> ft.TrainState:
    """Run the finetuning loop on the params' device; returns the final
    train state (its params the whole tree). With 0 < last_n_blocks_to_finetune
    < n_layer it trains the split tail (grads and moments for the last N
    blocks and ``ln_f*`` only); otherwise every leaf."""
    os.makedirs(out_dir, exist_ok=True)
    # start-of-finetuning event (reference fam/llm/finetune.py:246-262)
    job_props = {
        **dataclasses.asdict(ft_cfg),
        "n_layer": model_cfg.n_layer,
        "n_head": model_cfg.n_head,
        "n_embd": model_cfg.dim,
        "block_size": model_cfg.block_size,
        "out_dir": out_dir,
    }
    finetune_jobid = tele.hash_dictionary(job_props)
    tele.default_client.capture(tele.TelemetryEvent(
        name="user_started_finetuning", properties={"finetune_jobid": finetune_jobid, **job_props}))
    n_tail = ft_cfg.last_n_blocks_to_finetune
    if 0 < n_tail < model_cfg.n_layer:
        frozen, train_params = ft.split_trainable(params, n_tail)
        state, opt = ft.init_train_state(train_params, ft_cfg)
        step_fn = ft.make_finetune_step(model_cfg, ft_cfg, opt, frozen)

        def full_params(st):
            return ft.merge_trainable(frozen, st.params)

        def eval_params(st):
            return ft.split_view(frozen, st.params)
    else:
        state, opt = ft.init_train_state(params, ft_cfg)
        step_fn = ft.make_train_step(model_cfg, ft_cfg, opt, grad_mask=None)
        full_params = eval_params = lambda st: st.params  # noqa: E731
    eval_fn = ft.make_eval_step(model_cfg)

    best_val = float("inf")
    last_loss = None
    t_last = time.time()
    for it, batch in enumerate(train_batches):
        if it >= ft_cfg.max_iters:
            break
        state, metrics = step_fn(state, batch)

        if it % log_every == 0:
            loss = last_loss = float(metrics["loss"])
            dt = (time.time() - t_last) / max(log_every, 1)
            t_last = time.time()
            print(f"iter {it}: loss {loss:.4f}, {dt * 1000:.0f} ms/iter", flush=True)
            if on_metrics:
                on_metrics({"iter": it, "loss": loss, "ms_per_iter": dt * 1000})

        if val_batches and it > 0 and it % ft_cfg.eval_interval == 0:
            val_loss = estimate_loss(eval_fn, eval_params(state), val_batches)
            print(f"iter {it}: val loss {val_loss:.4f}", flush=True)
            ckpt_state = ft.TrainState(full_params(state), state.opt_state, state.step)
            save_checkpoint(out_dir, "ckpt", ckpt_state, model_cfg, ft_cfg, best_val, tokenizer_info)
            if val_loss < best_val:
                best_val = val_loss
                save_checkpoint(out_dir, "best", ckpt_state, model_cfg, ft_cfg, best_val, tokenizer_info)

    final_state = ft.TrainState(full_params(state), state.opt_state, state.step)
    save_checkpoint(out_dir, "final", final_state, model_cfg, ft_cfg, best_val, tokenizer_info)
    # end-of-finetuning event (reference finetune.py:368-375)
    tele.default_client.capture(tele.TelemetryEvent(
        name="user_completed_finetuning", properties={"finetune_jobid": finetune_jobid, "loss": last_loss}))
    return final_state


def _load_first_stage(path: str, device) -> tuple[dict, TransformerConfig, dict]:
    """A first-stage ``.pt`` or dense ``.npz`` -> (params on ``device``, cfg,
    tokenizer info)."""
    if path.endswith(".pt"):
        return ck.load_first_stage_pt(path, device=device)
    params, cfg, tok_info, quant = ck.load_first_stage_npz(path)
    if quant:
        raise ValueError(f"{path} is quantized ({quant}); finetuning needs a dense checkpoint")
    return ck.params_from_numpy(params, device=device), cfg, tok_info


def main(argv: list[str] | None = None) -> int:
    """CLI: finetune the first stage on a '|'-separated CSV dataset, as
    ``poetry run finetune --train X --val Y`` (pyproject.toml:38-39,
    fam/llm/finetune.py:116-122), on ``--device`` (default cuda)."""
    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.models import speaker_encoder as se
    from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
    from metavoice_tpu_torch.training.data import DynamicComputeDataset, training_batches

    ap = argparse.ArgumentParser(prog="metavoice_tpu_torch finetune", description="finetune the first-stage LLM")
    ap.add_argument("--train", required=True, help="train CSV ('|' separated)")
    ap.add_argument("--val", required=True, help="val CSV")
    ap.add_argument("--ckpt", help="first-stage checkpoint (.pt or a dense .npz)")
    ap.add_argument("--spk_emb_ckpt", help="speaker encoder checkpoint (.pt)")
    ap.add_argument("--out_dir", default="finetune_out")
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--max_iters", type=int, default=5000)
    ap.add_argument("--learning_rate", type=float, default=3e-5)
    ap.add_argument("--last_n_blocks", type=int, default=1)
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--small", action="store_true", help="small dev model (no ckpt)")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="residual/embedding dropout during finetuning (reference finetune_params.py:43 default "
                         "0.1; no attention-probability dropout: see transformer.apply_blocks)")
    ap.add_argument("--spkemb_dropout", type=float, default=None,
                    help="drop whole rows' speaker conditioning with this probability (trains the CFG uncond "
                         "branch; reference fam/llm/model.py:269-274). Default: keep the checkpoint's value.")
    ap.add_argument("--no_spk_emb_on_text", action="store_true",
                    help="mask speaker conditioning on text positions (reference _mask_spk_emb_on_text, "
                         "fam/llm/model.py:178-193)")
    ap.add_argument("--param_dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="bf16 params halve the training footprint (the reference finetunes in fp16 with a "
                         "GradScaler; bf16 needs no scaler)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    tokenizer_info: dict = {}
    if args.ckpt:
        params, model_cfg, tokenizer_info = _load_first_stage(args.ckpt, dev)
    else:
        print("no checkpoint given; random init (dev mode)")
        model_cfg = (first_stage_config(n_layer=2, n_head=4, dim=128, block_size=256) if args.small
                     else first_stage_config())
        params = tfm.init_params(model_cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(args.seed))

    cfg_overrides = {"dropout": args.dropout}
    if args.spkemb_dropout is not None:
        cfg_overrides["spkemb_dropout"] = args.spkemb_dropout
    if args.no_spk_emb_on_text:
        cfg_overrides["spk_emb_on_text"] = False
    model_cfg = dataclasses.replace(model_cfg, **cfg_overrides)

    dtype = torch.bfloat16 if args.param_dtype == "bfloat16" else torch.float32
    params = ft.tree_map(lambda a: a.to(dtype), params)
    tokenizer = TrainedBPETokeniser(**tokenizer_info) if tokenizer_info else TrainedBPETokeniser()
    spk_params = (ck.load_speaker_encoder_pt(args.spk_emb_ckpt, device=dev) if args.spk_emb_ckpt
                  else se.init_params(device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    ecfg = ec.EncodecConfig()
    eparams = ec.init_params(ecfg, device=dev, generator=torch.Generator(device=dev).manual_seed(1))

    ft_cfg = ft.FinetuneConfig(
        batch_size=args.batch_size,
        max_iters=args.max_iters,
        learning_rate=args.learning_rate,
        last_n_blocks_to_finetune=args.last_n_blocks,
        seed=args.seed,
    )
    datasets = [DynamicComputeDataset.from_csv(path, eparams, ecfg, tokenizer, spk_params,
                                               num_max_audio_tokens_timesteps=model_cfg.block_size // 2)
                for path in (args.train, args.val)]
    val_batches = list(training_batches(datasets[1], ft_cfg.batch_size, shuffle=False, epochs=1))[: ft_cfg.eval_iters]
    train(params, model_cfg, ft_cfg, training_batches(datasets[0], ft_cfg.batch_size, seed=args.seed), val_batches,
          out_dir=args.out_dir, tokenizer_info=tokenizer_info)
    return 0


# --------------------------------------------------------------------------------------
# Whole train-state checkpoints (resume with the optimizer state)
# --------------------------------------------------------------------------------------
#
# The reference resumes from torch pickles of model + optimizer + iter_num
# (fam/llm/finetune.py:91-113,133-144,298-315). The .npz files above are the
# portable weights; the whole train state goes through torch.save so that a
# killed run restarts exactly.


def save_train_state(ckpt_dir: str, state: ft.TrainState, step: int | None = None) -> str:
    """``{ckpt_dir}/state_{step}/state.pt``: params, optimizer state and step
    -> the directory."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"state_{step if step is not None else int(state.step)}"))
    os.makedirs(path, exist_ok=True)
    detached = ft.tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, state._asdict())
    torch.save(detached, os.path.join(path, "state.pt"))
    return path


def restore_train_state(path: str, device=None) -> ft.TrainState:
    """A ``save_train_state`` directory -> the TrainState, its tensors on
    ``device`` (default: where they were saved)."""
    d = torch.load(os.path.join(path, "state.pt"), map_location=device, weights_only=True)
    return ft.TrainState(d["params"], d["opt_state"], int(d["step"]))


if __name__ == "__main__":
    raise SystemExit(main())
