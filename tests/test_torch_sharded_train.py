"""Sharded training in the port (``parallel/sharding.py``'s cut and its
inverse, Megatron's reduce pair in ``models/transformer.py``,
``training/finetune.py`` under ``mesh=``, ``parallel/aot.
abstract_train_state``, ``parallel/dryrun.py``) on real ranks: one world of
4 CPU processes over gloo (``parallel/mesh.spawn``), started once for the
module, which runs every case at the meshes (data 2, tensor 2), (data 1,
tensor 4) and (data 4, tensor 1); the tests assert on what its ranks
return. The JAX references are computed here while the ranks run.

Held, on a 2-layer, 4-head, 64-wide first stage (vocab 64) in f32:

* ``shard_params`` then ``gather_params`` gives back the dense tree bit for
  bit (SwiGLU, and GELU with biases); ``prepare_tp_params(..., None)``
  keeps ``shard_params``'s layer shards bit for bit;
* two steps of the sharded ``make_train_step`` (the last-block mask;
  accumulation 2 without a mask) and of ``make_finetune_step`` (the split
  tail) against JAX's ``make_train_step`` / ``make_finetune_step`` on the
  same numpy weights and global batches, whose rows hold 0 to 16 ignored
  targets of 16 (a data rank of the 4 may hold none valid): losses and grad
  norms rtol 1e-5 (the reductions add the shards' f32 partial sums in
  another order than one product: measured under 1e-6), the gathered params
  by tests/test_torch_finetune.py's rule (every element within 2 x the
  rates summed, all but 1e-3 of them within 1e-3 lr: Adam's first steps
  move an element by about +-lr, so a grad near zero whose sign the two
  sums disagree on moves it the other way);
* every leaf bit-identical across a data group, the replicated leaves
  across a tensor group;
* with dropout (0.3, speaker-embedding dropout 0.5) a sharded step equals
  the port's one-process step under the same seed (the masks are drawn for
  the global batch and cut to each rank's rows), at the same tolerances;
  the sharded eval step gives the global mean;
* the reductions: under grad a layer reduces twice forward, and in the
  backward once in its recompute and twice for Megatron's f; under
  ``inference_mode`` twice, in place, as before;
* ``dryrun``'s rank body runs in the same world; ``abstract_train_state``
  at full scale for tp 1, 2 and 4 gives each rank's shapes and bytes with
  no world.

JAX is imported inside the fixtures only: the spawned ranks import this
module, and must not import the JAX package.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.parallel import aot, dryrun
from metavoice_tpu_torch.parallel import mesh as pmesh
from metavoice_tpu_torch.parallel import sharding as psh
from metavoice_tpu_torch.parallel import tp_decode as tpd
from metavoice_tpu_torch.training import finetune as ft

TINY = dict(n_layer=2, n_head=4, dim=64, block_size=32, vocab_sizes=(64,))  # FFN 256: 64 a rank at tp 4
GELU = dict(n_layer=2, n_head=4, dim=64, block_size=32)  # the second stage's recipe: GELU, biases
MESHES = (2, 4, 1)  # tp; the data axis takes the rest of the 4 ranks
ROWS, T = 4, 16
LR = 1e-3
FT = dict(learning_rate=LR, min_lr=1e-4, warmup_iters=0, lr_decay_iters=20, weight_decay=0.1)
STEPS = 2
MODES = ("mask", "accum2", "split")
DROP = dict(dropout=0.3, spkemb_dropout=0.5)
METRIC_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models() -> dict:
    """name -> (cfg, dense f32 tree): weights N(0, 0.02) from the port's
    init, norm weights 1 + N(0, 0.1), biases N(0, 0.1) (the init's zero
    norms and biases would hide a misplaced one)."""
    out = {}
    for name, cfg, seed in (("swiglu", first_stage_config(**TINY), 0), ("gelu", second_stage_config(**GELU), 1)):
        g = torch.Generator().manual_seed(seed)
        p = tfm.init_params(cfg, device="cpu", generator=g, dtype=torch.float32)
        for k, w in p["layers"].items():
            if k.endswith("_b"):
                w.copy_(0.1 * torch.randn(w.shape, generator=g))
        for k, w in list(p["layers"].items()) + [("ln_f_w", p["ln_f_w"])]:
            if k.endswith("norm_w") or k == "ln_f_w":
                w.add_(0.1 * torch.randn(w.shape, generator=g))
        out[name] = (cfg, p)
    return out


def _batch(seed: int, accum: int = 1) -> dict:
    """A global batch (numpy), (accum,) ROWS x T when accumulating; row r
    of each holds (0, 5, 16, 11)[r] ignored targets: a data rank of four
    may hold no valid one, and the ranks of two hold unequal counts."""
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum > 1 else ()
    b = {"x": rng.integers(0, 64, (*lead, ROWS, T)).astype(np.int32),
         "y": rng.integers(0, 64, (*lead, ROWS, T)).astype(np.int32),
         "spk_emb": rng.normal(size=(*lead, ROWS, 256)).astype(np.float32)}
    for r, n in enumerate((0, 5, 16, 11)):
        b["y"][..., r, :n] = -1
    return b


def _batches(mode: str) -> list:
    return [_batch(10 + i, 2 if mode == "accum2" else 1) for i in range(STEPS)]


def _ft_cfg(mode: str) -> ft.FinetuneConfig:
    return ft.FinetuneConfig(**FT, gradient_accumulation_steps=2 if mode == "accum2" else 1)


def _port_run(params, cfg, mode: str, mesh=None, batches=None):
    """STEPS steps of ``mode`` on this rank's copy of ``params`` (its
    shards under ``mesh``) -> (the stacked tree after, [(loss, grad_norm)])."""
    p = ft.tree_map(lambda t: t.detach().clone(), params)
    if mesh is not None:
        p = psh.shard_params(p, cfg, mesh)
    ftc = _ft_cfg(mode)
    if mode == "split":
        frozen, train = ft.split_trainable(p, 1)
        state, opt = ft.init_train_state(train, ftc)
        step = ft.make_finetune_step(cfg, ftc, opt, frozen, compute_dtype=torch.float32, mesh=mesh)
    else:
        state, opt = ft.init_train_state(p, ftc)
        mask = ft.trainable_mask(p, cfg, 1) if mode == "mask" else None
        step = ft.make_train_step(cfg, ftc, opt, grad_mask=mask, compute_dtype=torch.float32, mesh=mesh)
    metrics = []
    for b in batches or _batches(mode):
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return (ft.merge_trainable(frozen, state.params) if mode == "split" else state.params), metrics


def _numpy(tree):
    return ft.tree_map(lambda t: t.detach().numpy().copy(), tree)


def _counted_reductions(real, counts: dict):
    """``dist.all_reduce``, counting its calls (the block stack looks it up on the module)."""

    def counted(*a, **kw):
        counts["n"] += 1
        return real(*a, **kw)

    return counted


def _world(rank: int, models: dict) -> dict:
    """One rank of the module's world -> {case: what it returns}."""
    torch.set_num_threads(1)
    out = {}
    cfg, params = models["swiglu"]
    for tp in MESHES:
        mesh = pmesh.make_mesh(tp, device="cpu")
        for name in ("swiglu", "gelu"):
            c, p = models[name]
            out[f"roundtrip-{name}-tp{tp}"] = _numpy(psh.gather_params(psh.shard_params(p, c, mesh), c, mesh))
        for mode in MODES:
            done, metrics = _port_run(params, cfg, mode, mesh)
            out[f"{mode}-tp{tp}"] = (_numpy(done), _numpy(psh.gather_params(done, cfg, mesh)), metrics)
        dcfg = dataclasses.replace(cfg, **DROP)
        done, metrics = _port_run(params, dcfg, "mask", mesh, [_batch(20)])
        out[f"dropout-tp{tp}"] = (_numpy(psh.gather_params(done, dcfg, mesh)), metrics)
        shards = psh.shard_params(params, cfg, mesh)
        out[f"eval-tp{tp}"] = float(ft.make_eval_step(cfg, torch.float32, mesh)(shards, _batch(21)))
    # the reductions a layer makes: in a training forward and backward on a tp 4 grid, and in an inference step
    mesh = pmesh.make_mesh(4, device="cpu")
    shards = psh.shard_params(params, cfg, mesh)
    for leaf in ft.tree_leaves(shards):
        leaf.requires_grad_(True)
    counts, real = {"n": 0}, dist.all_reduce
    dist.all_reduce = _counted_reductions(real, counts)
    b = ft.to_device(_batch(22), torch.device("cpu"))
    loss = ft.loss_fn(shards, cfg, b, torch.float32, None, mesh)
    out["reductions-forward"] = counts["n"]
    loss.backward()
    out["reductions-train"] = counts["n"]
    counts["n"] = 0
    kv = tpd.make_tp_cache(cfg, mesh, 2, dtype=torch.float32)
    tpd.tp_forward(tpd.prepare_tp_params(params, cfg, mesh), cfg, mesh, b["x"][:2, :4], b["spk_emb"][:2], None, kv, 0,
                   compute_dtype=torch.float32)
    out["reductions-inference"] = counts["n"]
    dist.all_reduce = real
    out["dryrun"] = dryrun.dryrun_rank(rank, 2, ["cpu"] * 4)
    return out


@pytest.fixture(scope="module")
def world():
    """The world's results by rank, the models, and the JAX references."""
    models = _models()
    box = {}
    runner = threading.Thread(target=lambda: box.update(ranks=pmesh.spawn(_world, 4, args=(models,),
                                                                          devices=["cpu"] * 4, timeout=120)))
    runner.start()
    try:
        refs = _jax_references(models)
    finally:
        runner.join()
    assert "ranks" in box, "the world failed (its error is above)"
    return box["ranks"], models, refs


def _jax_references(models) -> dict:
    """JAX's two steps of each mode on the same numpy weights and batches
    -> mode -> (params after, [(loss, grad_norm)])."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from metavoice_tpu.core.config import first_stage_config as jfirst
    from metavoice_tpu.training import finetune as jft

    jcfg = jfirst(**TINY)
    dense = _numpy(models["swiglu"][1])
    out = {}
    for mode in MODES:
        cfg = jft.FinetuneConfig(**FT, gradient_accumulation_steps=2 if mode == "accum2" else 1)
        params = jax.tree.map(jnp.asarray, dense)
        if mode == "split":
            frozen, train = jft.split_trainable(params, 1)
            state, opt = jft.init_train_state(train, cfg)
            step = jft.make_finetune_step(jcfg, cfg, opt, frozen, compute_dtype=jnp.float32)
        else:
            state, opt = jft.init_train_state(params, cfg)
            mask = jft.trainable_mask(params, jcfg, 1) if mode == "mask" else None
            step = jft.make_train_step(jcfg, cfg, opt, grad_mask=mask, compute_dtype=jnp.float32)
        metrics = []
        for b in _batches(mode):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        done = jft.merge_trainable(frozen, state.params) if mode == "split" else state.params
        out[mode] = (jax.tree.map(np.asarray, done), metrics)
    return out


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _lr_sum() -> float:
    sched = ft.lr_schedule(ft.FinetuneConfig(**FT))
    return sum(sched(i) for i in range(STEPS))


def assert_params_close(got, want, lr_sum: float):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        d = np.abs(g[k].astype(np.float32) - w[k].astype(np.float32))
        assert d.max() <= 2 * lr_sum, (k, d.max())
        assert np.mean(d > 1e-3 * LR) <= 1e-3, (k, np.mean(d > 1e-3 * LR))


def _same_bits(a: dict, b: dict, keys, what: str):
    for k in keys:
        np.testing.assert_array_equal(a[k].view(np.int32), b[k].view(np.int32), err_msg=f"{what}: {k}")


@pytest.mark.parametrize("tp", MESHES)
@pytest.mark.parametrize("name", ["swiglu", "gelu"])
def test_shard_gather_round_trip(world, name, tp):
    ranks, models, _ = world
    want = _flat(_numpy(models[name][1]))
    for r in range(4):
        got = _flat(ranks[r][f"roundtrip-{name}-tp{tp}"])
        assert got.keys() == want.keys()
        _same_bits(got, want, want, f"rank {r}")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["swiglu", "gelu"])
def test_serving_keeps_the_training_cut(name, tp):
    """``prepare_tp_params(..., None)``'s layers are ``shard_params``'s, bit
    for bit (tests/test_torch_tp_layout.py holds both to JAX's layout), of
    the shapes ``param_specs`` gives."""
    cfg, params = _models()[name]
    for r in range(tp):
        mesh = pmesh.Mesh(tp, 1, r, 0, tuple(range(tp)), None, None, torch.device("cpu"))
        got, served = psh.shard_params(params, cfg, mesh), tpd.prepare_tp_params(params, cfg, mesh, None)
        assert served["layers"].keys() == got["layers"].keys()
        assert all(torch.equal(served["layers"][k], w) for k, w in got["layers"].items())
        specs = psh.param_specs(cfg)  # the table of split dims: a split leaf is 1/tp of the whole on its dim
        assert specs.keys() == params.keys() and specs["layers"].keys() == params["layers"].keys()
        for k, dim in specs["layers"].items():
            want = list(params["layers"][k].shape)
            if dim is not None:
                want[dim] //= tp
            assert list(got["layers"][k].shape) == want, k


@pytest.mark.parametrize("tp", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_steps_match_jax(world, mode, tp):
    ranks, _, refs = world
    want_params, want_metrics = refs[mode]
    for r in range(4):
        _, gathered, metrics = ranks[r][f"{mode}-tp{tp}"]
        np.testing.assert_allclose(metrics, want_metrics, rtol=METRIC_RTOL)
        assert_params_close(gathered, want_params, _lr_sum())


@pytest.mark.parametrize("tp", MESHES)
@pytest.mark.parametrize("mode", MODES)
def test_ranks_hold_the_same_bits(world, mode, tp):
    """Every leaf bit-identical across a data group; the replicated leaves
    across a tensor group."""
    ranks, _, _ = world
    split = _flat(psh.split_leaves(ranks[0][f"{mode}-tp{tp}"][0]))
    for r in range(4):
        mine = _flat(ranks[r][f"{mode}-tp{tp}"][0])
        _same_bits(mine, _flat(ranks[r % tp][f"{mode}-tp{tp}"][0]), mine, f"rank {r} against its data group's first")
        lead = _flat(ranks[r - r % tp][f"{mode}-tp{tp}"][0])
        _same_bits(mine, lead, [k for k in mine if not split[k]], f"rank {r} against its tensor group's leader")


@pytest.mark.parametrize("tp", MESHES)
def test_dropout_matches_the_one_process_step(world, tp):
    ranks, models, _ = world
    cfg, params = models["swiglu"]
    dcfg = dataclasses.replace(cfg, **DROP)
    want, want_metrics = _port_run(params, dcfg, "mask", batches=[_batch(20)])
    undropped = _port_run(params, cfg, "mask", batches=[_batch(20)])[1]
    assert abs(want_metrics[0][0] - undropped[0][0]) > 1e-3  # the dropout draws matter
    for r in range(4):
        gathered, metrics = ranks[r][f"dropout-tp{tp}"]
        np.testing.assert_allclose(metrics, want_metrics, rtol=METRIC_RTOL)
        assert_params_close(gathered, _numpy(want), ft.lr_schedule(ft.FinetuneConfig(**FT))(0))


@pytest.mark.parametrize("tp", MESHES)
def test_eval_step_gives_the_global_mean(world, tp):
    ranks, models, _ = world
    cfg, params = models["swiglu"]
    want = float(ft.make_eval_step(cfg, torch.float32)(params, _batch(21)))
    for r in range(4):
        np.testing.assert_allclose(ranks[r][f"eval-tp{tp}"], want, rtol=METRIC_RTOL)


def test_reductions_a_layer(world):
    ranks, models, _ = world
    n_layer = models["swiglu"][0].n_layer
    for r in range(4):
        assert ranks[r]["reductions-forward"] == 2 * n_layer
        # backward: Megatron's f's two a layer, and the recompute's first (the recompute stops at the last
        # tensor the backward saved, w2's input, short of the FFN's reduction)
        assert ranks[r]["reductions-train"] - ranks[r]["reductions-forward"] == 3 * n_layer
        assert ranks[r]["reductions-inference"] == 2 * n_layer


def test_dryrun_rank_body(world):
    ranks, _, _ = world
    got = [ranks[r]["dryrun"] for r in range(4)]
    assert all(g["mesh"] == (2, 2) for g in got)
    assert all(np.isfinite(g["loss"]) and g["loss"] == got[0]["loss"] for g in got)
    for r in range(4):  # each data rank's rows, the same on both ranks of its tensor group
        assert got[r]["logits"].shape == (2, 1, 96) and np.isfinite(got[r]["logits"]).all()
        np.testing.assert_array_equal(got[r]["logits"], got[r - r % 2]["logits"])


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_abstract_train_state_full_scale(tp):
    cfg = first_stage_config()
    states = aot.abstract_train_state(tp=tp)
    assert len(states) == tp
    d, i, h = cfg.dim, cfg.intermediate_size, cfg.n_head * cfg.head_dim
    layer = d * 3 * h + h * d + 3 * d * i + 2 * d  # qkv, wo, w1/w3/w2, the two norms
    whole = cfg.vocab_size * d + cfg.block_size * d + cfg.speaker_emb_dim * d + d  # wtes, wpe, speaker_cond, ln_f
    per_rank = cfg.n_layer * ((layer - 2 * d) // tp + 2 * d) + whole
    for st in states:
        p = st["params"]
        assert p["layers"]["wqkv"].shape == (cfg.n_layer, d, 3 * h // tp)
        assert p["layers"]["w2"].shape == (cfg.n_layer, i // tp, d) and p["wtes"][0].shape == (cfg.vocab_size, d)
        for tree in ("params", "mu", "nu"):
            leaves = ft.tree_leaves(st[tree])
            assert all(t.device.type == "meta" and t.dtype == torch.bfloat16 for t in leaves)
            assert [t.shape for t in leaves] == [t.shape for t in ft.tree_leaves(p)]
            assert st["bytes"][tree] == 2 * per_rank
    if tp == 2:  # about 627 M parameters a rank, 5.0 GB with grads and moments in bf16
        assert 6.2e8 < per_rank < 6.3e8


def _never(rank):
    raise AssertionError("no rank should start")


def test_no_cpu_unless_asked(monkeypatch):
    """With no card, nothing in ``parallel/`` picks the CPU unless asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (pmesh.rank_device, lambda: pmesh.make_mesh(1), lambda: pmesh.local_mesh(),
                 lambda: pmesh.spawn(_never, 2), lambda: dryrun.dryrun(2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert pmesh.make_mesh(1, device="cpu").device == torch.device("cpu")


def _falls_out_of_step(rank: int):
    """Rank 1 skips a reduction of the tensor group and goes on to a
    broadcast, where rank 0 waits in the reduction."""
    mesh = pmesh.make_mesh(2, device="cpu")
    x = torch.ones(4)
    if rank == 0:
        dist.all_reduce(x, group=mesh.tensor_group)
    dist.broadcast(x, src=0, group=mesh.tensor_group)
    return "unreachable"


def test_a_world_out_of_step_ends_in_an_error():
    """The groups ``make_mesh`` makes time out as the world does (torch's
    ``new_group`` would give them 30 minutes), and ``spawn``'s default
    deadline is finite."""
    timeout = 10
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="Timed out"):
        pmesh.spawn(_falls_out_of_step, 2, devices=["cpu"] * 2, timeout=timeout)
    assert time.monotonic() - t0 < pmesh.DEADLINE_TIMEOUTS * timeout


@pytest.mark.parametrize("peer_first", [True, False])
def test_a_peer_lost_connection_stamped_first_is_not_the_failure(peer_first):
    """The rank whose connection the failing rank closed can stamp its error
    first: ``spawn`` raises the failing rank's own error all the same, and
    a lost connection only when no rank raised one of its own."""
    timed_out = RuntimeError("[../third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81] Timed out waiting 10000ms")
    lost = RuntimeError("[../third_party/gloo/gloo/transport/tcp/pair.cc:534] Connection closed by peer [::1]:43127")
    stamps = (1.0, 2.0) if peer_first else (2.0, 1.0)
    errors = [(stamps[0], lost), (stamps[1], timed_out)]
    assert pmesh.first_failure(errors) is timed_out
    assert pmesh.first_failure(errors[:1]) is lost
    later = ValueError("a later failure of its own")
    assert pmesh.first_failure(errors + [(3.0, later)]) is timed_out
