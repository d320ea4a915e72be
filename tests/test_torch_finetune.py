"""The port's first-stage finetuning (metavoice_tpu_torch/training/finetune.py
and the training forward of models/transformer.py) against the JAX package's
(metavoice_tpu/training/finetune.py) on the same numpy weights and batches.

Tolerances:
  * cross-entropy: rtol 1e-6; the EOT mask exactly;
  * ``lr_schedule``: rtol 1e-6 of optax's at every step (both f32; numpy's
    cos against XLA's);
  * loss and grads at f32 compute (GQA: 2 kv heads for 4 query heads): 1e-4
    of max |ref| per leaf (measured 5e-7), the loss rtol 1e-5; at bf16
    compute the loss rtol 1e-2 (bf16 sums in other orders);
  * params after train steps: Adam moves an element by about lr times
    mu_hat / sqrt(nu_hat), a ratio near +-1. Where a grad lies near zero the
    two packages' grads, a few f32 ulps apart, can differ in sign there, and
    that element moves by up to +-lr in opposite directions: so every
    element within 2 x (the rates summed), and all but 1e-3 of the elements
    within 1e-3 x lr (measured at lr 1e-3: no element past 1.5e-7).

Dropout streams never match JAX's (torch generators against PRNG keys), so
dropout is held to its properties, and to JAX only where the draw cannot
matter (speaker-embedding dropout at rate 1).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as jfirst_stage_config  # noqa: E402
from metavoice_tpu.training import finetune as jft  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.training import finetune as ft  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

TINY = dict(n_layer=3, n_head=4, n_local_heads=2, dim=32, block_size=32, vocab_sizes=(60,))
JCFG, CFG = jfirst_stage_config(**TINY), first_stage_config(**TINY)
LR = 1e-3
STEPS = 3
FT = dict(learning_rate=LR, min_lr=1e-4, warmup_iters=2, lr_decay_iters=20, weight_decay=0.1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    """The JAX package's tree layout (the port's init_params keys), numpy
    draws: weights N(0, 0.02), norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(0)

    def draw(t, path):
        w = rng.normal(size=tuple(t.shape)).astype(np.float32)
        return (1 + 0.1 * w) if jtu.keystr(path).endswith(("norm_w']", "ln_f_w']")) else 0.02 * w

    return jtu.tree_map_with_path(lambda path, t: draw(t, path), tfm.init_params(CFG, device="cpu"))  # shapes


def _batch(seed, lead=None):
    rng = np.random.default_rng(seed)
    shape = (2, 16) if lead is None else (lead, 2, 16)
    b = {"x": rng.integers(0, 60, shape).astype(np.int32), "y": rng.integers(0, 60, shape).astype(np.int32),
         "spk_emb": rng.normal(size=shape[:-1] + (256,)).astype(np.float32)}
    b["y"][..., 0, :3] = -1  # ignored targets
    return b


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree):
    """path -> numpy array, for a JAX tree or the port's (same key paths)."""
    return {jtu.keystr(k): (v.detach().float().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
            for k, v in jtu.tree_flatten_with_path(tree)[0]}


def assert_params_close(got, want, lr_sum):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= 2 * lr_sum, (k, d.max())
        assert np.mean(d > 1e-3 * LR) <= 1e-3, (k, np.mean(d > 1e-3 * LR))


# ----------------------------------------------------------------------------- scalars


@pytest.mark.parametrize("hier", [1, 2])
def test_cross_entropy_matches_jax(hier):
    rng = np.random.default_rng(hier)
    logits = [rng.normal(size=(2, 7, 11)).astype(np.float32) * 3 for _ in range(hier)]
    tgt = rng.integers(0, 11, (2, hier, 7))
    tgt[0, :, :4] = -1
    tgt = tgt if hier > 1 else tgt[:, 0]
    want = float(jft.hierarchy_cross_entropy([jnp.asarray(x) for x in logits], jnp.asarray(tgt)))
    got = float(ft.hierarchy_cross_entropy([torch.from_numpy(x) for x in logits], torch.from_numpy(tgt)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    none = -np.ones_like(tgt)
    assert np.isfinite(float(ft.hierarchy_cross_entropy([torch.from_numpy(x) for x in logits],
                                                        torch.from_numpy(none))))


def test_mask_spk_emb_on_text_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 5, (3, 2, 9))
    idx[0, 0, 4] = idx[1, 0, 0] = idx[1, 0, 6] = 99  # EOT mid-row, first, repeated; row 2 has none
    for x in (idx, idx[:, 0]):
        want = np.asarray(jft.mask_spk_emb_on_text(jnp.asarray(x), end_of_text_token=99))
        got = ft.mask_spk_emb_on_text(torch.from_numpy(x), end_of_text_token=99).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(warmup_iters=10, lr_decay_iters=100), dict(warmup_iters=0, lr_decay_iters=30), FT])
def test_lr_schedule_matches_optax(kw):
    jcfg = jft.FinetuneConfig(**kw)
    counts = np.arange(jcfg.lr_decay_iters + 11)
    want = np.asarray(jft.lr_schedule(jcfg)(jnp.asarray(counts)))
    sched = ft.lr_schedule(ft.FinetuneConfig(**kw))
    got = np.asarray([sched(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == (0.0 if jcfg.warmup_iters else jcfg.learning_rate)


def test_masks_match_jax(jparams):
    p = ck.params_from_numpy(jparams, device="cpu")
    jp = jax.tree.map(jnp.asarray, jparams)
    got = {k: bool(v) for k, v in _flat(ft.weight_decay_mask(p)).items()}
    assert got == {k: bool(v) for k, v in _flat(jft.weight_decay_mask(jp)).items()}
    assert got["['layers']['attn_norm_w']"] and not got["['ln_f_w']"]  # (L, D) stacked norms decay
    for n in (-1, 0, 1, 2):
        got, want = _flat(ft.trainable_mask(p, CFG, n)), _flat(jft.trainable_mask(jp, JCFG, n))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.broadcast_to(got[k], want[k].shape), want[k])


# ----------------------------------------------------------------------------- loss and grads

_jax_grad = jax.jit(jax.value_and_grad(jft.loss_fn), static_argnames=("model_cfg", "compute_dtype"))
_jax_loss = jax.jit(jft.loss_fn, static_argnames=("model_cfg", "compute_dtype"))


def _port_grads(p, cfg, batch, dtype, generator=None):
    for leaf in ft.tree_leaves(p):
        leaf.requires_grad_(True)
    loss = ft.loss_fn(p, cfg, _tb(batch), dtype, generator)
    loss.backward()
    return float(loss.detach()), ft.tree_map(lambda t: t.grad, p)


@pytest.mark.parametrize("on_text", [True, False])
def test_loss_and_grads_match_jax_f32(jparams, on_text):
    # not on text: the tiny vocab holds no end-of-text id, so every position loses the conditioning
    jcfg, cfg = (c if on_text else dataclasses.replace(c, spk_emb_on_text=False) for c in (JCFG, CFG))
    batch = _batch(1)
    want_loss, want = _jax_grad(jax.tree.map(jnp.asarray, jparams), jcfg, _jb(batch), jnp.float32)
    got_loss, got = _port_grads(ck.params_from_numpy(jparams, device="cpu"), cfg, batch, torch.float32)
    np.testing.assert_allclose(got_loss, float(want_loss), rtol=1e-5)
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert np.abs(g[k] - w[k]).max() <= 1e-4 * np.abs(w[k]).max(), k


def test_loss_matches_jax_bf16(jparams):
    batch = _batch(2)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jparams)
    want = float(_jax_loss(jp, JCFG, _jb(batch), jnp.bfloat16))
    p = ck.params_from_numpy(jparams, device="cpu", dtype=torch.bfloat16)
    got = float(ft.loss_fn(p, CFG, _tb(batch), torch.bfloat16))
    np.testing.assert_allclose(got, want, rtol=1e-2)


# ----------------------------------------------------------------------------- train steps

MODES = ("mask", "split", "accum2")
JAX_EXTRA = 3  # the mask path runs on to step 6 in JAX: the carried state is taken at step 5


@pytest.fixture(scope="module")
def jax_runs(jparams):
    """mode -> (params after STEPS steps, metrics a step) of JAX's steps;
    the mask path also keeps its TrainState at step 5 and params at step 6."""
    out = {}
    for mode in MODES:
        cfg = jft.FinetuneConfig(**FT, gradient_accumulation_steps=2 if mode == "accum2" else 1)
        params = jax.tree.map(jnp.asarray, jparams)
        if mode == "split":
            frozen, train = jft.split_trainable(params, 1)
            state, opt = jft.init_train_state(train, cfg)
            step = jft.make_finetune_step(JCFG, cfg, opt, frozen, compute_dtype=jnp.float32)
        else:
            state, opt = jft.init_train_state(params, cfg)
            mask = jft.trainable_mask(params, JCFG, 1) if mode == "mask" else None
            step = jft.make_train_step(JCFG, cfg, opt, grad_mask=mask, compute_dtype=jnp.float32)
        metrics, extra = [], {}
        for i in range(STEPS + (JAX_EXTRA if mode == "mask" else 0)):
            if i == 5:
                extra["state5"] = jax.tree.map(np.asarray, state)
            state, m = step(state, _jb(_batch(10 + i, lead=2 if mode == "accum2" else None)))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == STEPS - 1:
                done = jft.merge_trainable(frozen, state.params) if mode == "split" else state.params
                extra["params"] = jax.tree.map(np.asarray, done)
        extra["params6"] = jax.tree.map(np.asarray, state.params)
        out[mode] = (extra, metrics)
    return out


def _port_run(jparams, mode, steps=STEPS):
    cfg = ft.FinetuneConfig(**FT, gradient_accumulation_steps=2 if mode == "accum2" else 1)
    params = ck.params_from_numpy(jparams, device="cpu")
    if mode == "split":
        frozen, train = ft.split_trainable(params, 1)
        state, opt = ft.init_train_state(train, cfg)
        step = ft.make_finetune_step(CFG, cfg, opt, frozen, compute_dtype=torch.float32)
    else:
        state, opt = ft.init_train_state(params, cfg)
        mask = ft.trainable_mask(params, CFG, 1) if mode == "mask" else None
        step = ft.make_train_step(CFG, cfg, opt, grad_mask=mask, compute_dtype=torch.float32)
    metrics = []
    for i in range(steps):
        state, m = step(state, _batch(10 + i, lead=2 if mode == "accum2" else None))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    done = ft.merge_trainable(frozen, state.params) if mode == "split" else state.params
    return done, metrics, state


def _lr_sum(steps):
    sched = ft.lr_schedule(ft.FinetuneConfig(**FT))
    return sum(sched(i) for i in range(steps))


@pytest.mark.parametrize("mode", MODES)
def test_three_steps_match_jax(jparams, jax_runs, mode):
    extra, want_metrics = jax_runs[mode]
    got, metrics, _ = _port_run(jparams, mode)
    np.testing.assert_allclose(metrics, want_metrics[:STEPS], rtol=1e-5)
    assert_params_close(got, extra["params"], _lr_sum(STEPS))
    if mode != "accum2":  # last-N freezing: the head, embeddings and speaker projection bit for bit
        init, done = _flat(jparams), _flat(got)
        for k in init:
            if "layers" in k:
                np.testing.assert_array_equal(done[k][:-1], init[k][:-1])
                assert not np.array_equal(done[k][-1], init[k][-1]), k
            elif "ln_f" not in k:
                np.testing.assert_array_equal(done[k], init[k])


def test_split_path_gives_the_mask_paths_tail(jparams):
    mask_params, mask_metrics, _ = _port_run(jparams, "mask")
    split_params, split_metrics, _ = _port_run(jparams, "split")
    np.testing.assert_allclose(split_metrics, mask_metrics, rtol=1e-6)
    assert_params_close(split_params, mask_params, _lr_sum(STEPS))


def test_step_from_a_carried_jax_train_state(jparams, jax_runs):
    """JAX's state at step 5 (params, optax moments and counts) carried into
    the port: its sixth step lands on JAX's."""
    extra, want_metrics = jax_runs["mask"]
    state = ck.train_state_from_numpy(extra["state5"], device="cpu")
    assert state.step == 5 and state.opt_state["count"] == 5
    cfg = ft.FinetuneConfig(**FT)
    opt = ft.make_optimizer(cfg)
    step = ft.make_train_step(CFG, cfg, opt, grad_mask=ft.trainable_mask(state.params, CFG, 1),
                              compute_dtype=torch.float32)
    state, m = step(state, _batch(15))
    np.testing.assert_allclose((float(m["loss"]), float(m["grad_norm"])), want_metrics[5], rtol=1e-5)
    assert state.step == 6
    assert_params_close(state.params, extra["params6"], ft.lr_schedule(cfg)(5))


# ----------------------------------------------------------------------------- dropout

DROP = dataclasses.replace(CFG, dropout=0.3)


def _loss(p, cfg, batch, seed=None):
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return float(ft.loss_fn(p, cfg, _tb(batch), torch.float32, gen))


def test_dropout_train_eval_and_seeds(jparams):
    p = ck.params_from_numpy(jparams, device="cpu")
    batch = _batch(3)
    eval_loss = _loss(p, DROP, batch)
    assert eval_loss == _loss(p, CFG, batch)  # no generator: no dropout
    assert _loss(p, DROP, batch, 7) != eval_loss  # train and eval differ
    assert _loss(p, DROP, batch, 7) == _loss(p, DROP, batch, 7)  # one seed, one loss
    assert _loss(p, DROP, batch, 7) != _loss(p, DROP, batch, 8)
    assert _loss(p, CFG, batch, 7) == eval_loss  # rate 0 draws nothing
    # inference stays as it was: no generator, no grad -> the same bits as eval
    with torch.no_grad():
        a, _ = tfm.forward(p, DROP, torch.from_numpy(batch["x"]), compute_dtype=torch.float32)
        b, _ = tfm.forward(p, CFG, torch.from_numpy(batch["x"]), compute_dtype=torch.float32)
    assert torch.equal(a[0], b[0])


def test_dropout_grads_under_recompute_equal_grads_without(jparams, monkeypatch):
    """The recompute restores the global RNG, not an explicit generator's: the
    masks are drawn outside it, so recomputed grads are the grads."""
    batch = _batch(4)
    _, with_remat = _port_grads(ck.params_from_numpy(jparams, device="cpu"), DROP, batch, torch.float32,
                                torch.Generator().manual_seed(5))
    calls = []

    def no_remat(fn, *args, use_reentrant=None, preserve_rng_state=None):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(tfm, "checkpoint", no_remat)
    _, without = _port_grads(ck.params_from_numpy(jparams, device="cpu"), DROP, batch, torch.float32,
                             torch.Generator().manual_seed(5))
    assert len(calls) == CFG.n_layer
    g, w = _flat(with_remat), _flat(without)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])


def test_full_spkemb_dropout_is_zero_conditioning(jparams):
    """spkemb_dropout = 1 drops every row, whatever the draw: the loss is
    JAX's loss with a zero speaker embedding."""
    batch = _batch(5)
    zero = dict(batch, spk_emb=np.zeros_like(batch["spk_emb"]))
    want = float(_jax_grad(jax.tree.map(jnp.asarray, jparams), JCFG, _jb(zero), jnp.float32)[0])  # shares a compile
    p = ck.params_from_numpy(jparams, device="cpu")
    got = _loss(p, dataclasses.replace(CFG, spkemb_dropout=1.0), batch, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(ft.spkemb_dropout_mask(gen, 4, 0.0), torch.ones(4, 1, 1))
    assert torch.equal(ft.spkemb_dropout_mask(gen, 4, 1.0), torch.zeros(4, 1, 1))


def test_split_trainable_round_trip(jparams):
    p = ck.params_from_numpy(jparams, device="cpu")
    frozen, train = ft.split_trainable(p, 1)
    assert train["layers_tail"]["wqkv"].shape[0] == 1 and frozen["layers_head"]["wqkv"].shape[0] == 2
    g, w = _flat(ft.merge_trainable(frozen, train)), _flat(p)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k])
    view = ft.split_view(frozen, train)
    batch = _tb(_batch(6))
    with torch.no_grad():
        a, _ = tfm.forward(view, CFG, batch["x"], spk_emb=batch["spk_emb"], compute_dtype=torch.float32)
        b, _ = tfm.forward(p, CFG, batch["x"], spk_emb=batch["spk_emb"], compute_dtype=torch.float32)
    assert torch.equal(a[0], b[0])
