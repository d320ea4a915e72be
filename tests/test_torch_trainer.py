"""The port's finetuning loop (metavoice_tpu_torch/training/trainer.py) and
``cli finetune``: its checkpoints against the JAX package's reader and
writer, resume bit for bit, the eval / ckpt / best / final policy, the
telemetry events, and the CLI on the CPU.

Checkpoints are held bit for bit: JAX's ``load_npz`` reads the port's
``.npz`` with every leaf's dtype and bits and the same meta as JAX's own
``save_checkpoint`` writes for the same params.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.tree_util as jtu  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.training import finetune as jft  # noqa: E402
from metavoice_tpu.training import trainer as jtrainer  # noqa: E402
from metavoice_tpu.utils import checkpoint as jck  # noqa: E402
from metavoice_tpu_torch import cli  # noqa: E402
from metavoice_tpu_torch import telemetry as tele  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.training import finetune as ft  # noqa: E402
from metavoice_tpu_torch.training import trainer  # noqa: E402
from metavoice_tpu_torch.utils import audio_io as aio  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

TINY = dict(n_layer=3, n_head=4, n_local_heads=2, dim=32, block_size=32, vocab_sizes=(60,))
CFG = dataclasses.replace(first_stage_config(**TINY), dropout=0.2, spkemb_dropout=0.3)
FT = ft.FinetuneConfig(learning_rate=1e-3, min_lr=1e-4, warmup_iters=1, lr_decay_iters=10, max_iters=5,
                       eval_interval=2, eval_iters=2, last_n_blocks_to_finetune=1, batch_size=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(dtype=torch.float32):
    return tfm.init_params(CFG, device="cpu", generator=torch.Generator().manual_seed(0), dtype=dtype)


def _batch(seed, lead=None):
    rng = np.random.default_rng(seed)
    shape = (2, 16) if lead is None else (lead, 2, 16)
    return {"x": rng.integers(0, 60, shape).astype(np.int32), "y": rng.integers(0, 60, shape).astype(np.int32),
            "spk_emb": rng.normal(size=shape[:-1] + (256,)).astype(np.float32)}


def _bits(tree):
    """path -> (dtype name, shape, bytes), bf16 as its bits."""
    out = {}
    for k, v in jtu.tree_flatten_with_path(tree)[0]:
        a = v.detach().cpu().view(torch.int16).numpy() if torch.is_tensor(v) and v.dtype == torch.bfloat16 else (
            v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
        if a.dtype.name == "bfloat16":
            a = a.view(np.int16)
        out[jtu.keystr(k)] = (a.dtype.name, a.shape, a.tobytes())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoints_read_by_jax_and_the_port(tmp_path, dtype):
    """train() writes ckpt/best at each eval and final at the end; JAX's
    load_npz reads final.npz leaf for leaf and meta for meta as JAX's own
    save_checkpoint wrote it; the port's load_first_stage_npz gets the config."""
    seen = []
    state = trainer.train(_params(dtype), CFG, FT, (_batch(i) for i in range(100)), [_batch(50), _batch(51)],
                          out_dir=str(tmp_path / "port"), tokenizer_info={"k": 1}, log_every=2,
                          on_metrics=seen.append)
    assert state.step == FT.max_iters and [m["iter"] for m in seen] == [0, 2, 4]
    assert sorted(os.listdir(tmp_path / "port")) == ["best.npz", "ckpt.npz", "final.npz"]
    got_params, got_meta = jck.load_npz(str(tmp_path / "port" / "final.npz"))
    ckpt_meta, best_meta = (jck.load_npz(str(tmp_path / "port" / f"{n}.npz"))[1] for n in ("ckpt", "best"))
    assert ckpt_meta["iter_num"] == 5 and got_meta["iter_num"] == 5  # the last eval at it 4: step 5
    # ckpt carries the best before its eval, best and final the best after it
    assert np.isfinite(got_meta["best_val_loss"]) and got_meta["best_val_loss"] == best_meta["best_val_loss"]
    assert ckpt_meta["best_val_loss"] >= got_meta["best_val_loss"]

    jcfg = dataclasses.replace(jfirst_stage_config(**TINY), dropout=0.2, spkemb_dropout=0.3)
    jstate = jft.TrainState(jax.tree.map(np.asarray, got_params), None, state.step)
    jtrainer.save_checkpoint(str(tmp_path / "jax"), "final", jstate, jcfg,
                             jft.FinetuneConfig(**dataclasses.asdict(FT)), got_meta["best_val_loss"], {"k": 1})
    want_params, want_meta = jck.load_npz(str(tmp_path / "jax" / "final.npz"))
    assert got_meta == want_meta
    assert _bits(got_params) == _bits(want_params) == _bits(state.params)

    params, cfg, tok, quant = ck.load_first_stage_npz(str(tmp_path / "port" / "final.npz"))
    assert quant is None and tok == {"k": 1}
    assert (cfg.n_layer, cfg.n_local_heads, cfg.dim, cfg.vocab_sizes) == (3, 2, 32, (60,))
    assert _bits(params) == _bits(state.params)


def test_restore_then_two_steps_equals_four_straight(tmp_path):
    """Full tree, accumulation 2, dropout and speaker-embedding dropout: the
    draws come from (seed, step, micro-batch), so a restored run is the
    straight run bit for bit."""
    cfg = dataclasses.replace(FT, gradient_accumulation_steps=2)
    batches = [_batch(i, lead=2) for i in range(4)]

    def run(state, steps):
        step = ft.make_train_step(CFG, cfg, ft.make_optimizer(cfg), compute_dtype=torch.float32)
        for i in steps:
            state, _ = step(state, batches[i])
        return state

    straight = run(ft.init_train_state(_params(), cfg)[0], range(4))
    half = run(ft.init_train_state(_params(), cfg)[0], range(2))
    path = trainer.save_train_state(str(tmp_path), half)
    assert os.path.basename(path) == "state_2"
    resumed = run(trainer.restore_train_state(path), range(2, 4))
    assert resumed.step == straight.step == 4 and resumed.opt_state["count"] == 4
    assert _bits(resumed.params) == _bits(straight.params)
    assert _bits(resumed.opt_state) == _bits(straight.opt_state)
    assert _bits(straight.params) != _bits(_params())


def test_telemetry_events(tmp_path, monkeypatch):
    client = tele.TelemetryClient(spool_dir=str(tmp_path / "spool"), enabled=True)
    monkeypatch.setattr(tele, "default_client", client)
    trainer.train(_params(), CFG, dataclasses.replace(FT, max_iters=1), iter([_batch(0)]),
                  out_dir=str(tmp_path / "out"))
    with open(tmp_path / "spool" / "telemetry.jsonl") as f:
        events = [json.loads(line) for line in f]
    assert [e["event"] for e in events] == ["user_started_finetuning", "user_completed_finetuning"]
    started, done = (e["properties"] for e in events)
    assert started["finetune_jobid"] == done["finetune_jobid"] and started["n_layer"] == CFG.n_layer
    assert np.isfinite(done["loss"])


def test_cli_finetune_runs_on_the_cpu(tmp_path, capsys):
    """``cli finetune --small --device cpu``: a CSV of generated wavs, the
    random full-size EnCodec and speaker encoder, 2 iterations of the split
    path, final.npz that the port's loader reads."""
    rows = ["audio|caption"]
    for i, sr in enumerate((24000, 16000)):
        t = np.arange(int(0.25 * sr)) / sr
        aio.write_wav(str(tmp_path / f"u{i}.wav"), 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t), sr)
        rows.append(f"u{i}.wav|utterance number {i}.")
    (tmp_path / "ds.csv").write_text("\n".join(rows))
    out = tmp_path / "ft"
    assert cli.main(["finetune", "--train", str(tmp_path / "ds.csv"), "--val", str(tmp_path / "ds.csv"), "--small",
                     "--device", "cpu", "--max_iters", "2", "--out_dir", str(out)]) == 0
    assert "iter 0: loss" in capsys.readouterr().out
    params, cfg, _, _ = ck.load_first_stage_npz(str(out / "final.npz"))
    assert (cfg.n_layer, cfg.dim, cfg.block_size) == (2, 128, 256)
    assert params["layers"]["wqkv"].dtype == torch.bfloat16  # --param_dtype's default
