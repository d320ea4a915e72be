"""The port's MBD and DF trainers (metavoice_tpu_torch/training/mbd_trainer.py,
df_trainer.py) against the JAX package's (metavoice_tpu/training/
mbd_trainer.py, df_trainer.py), and the trees they make carried across.

The weights are drawn with the port's init and handed to JAX as numpy; JAX's
draws are replayed into the port (its key splits: ``fit_processor``'s noise,
``diffusion_loss``'s t and eps). Tolerances: the processor's sums 1e-5 of
max |ref|; the losses 1e-4 relative and each grad leaf 1e-4 of its max |g|,
against ``jax.value_and_grad``; the synthetic pairs bit for bit; a few
training steps make the loss fall.
"""

import re
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from metavoice_tpu.models import enhancer as jenh  # noqa: E402
from metavoice_tpu.models import mbd as jmbd  # noqa: E402
from metavoice_tpu.training import df_trainer as jdft  # noqa: E402
from metavoice_tpu.training import mbd_trainer as jmt  # noqa: E402
from metavoice_tpu.utils import checkpoint as jck  # noqa: E402
from metavoice_tpu_torch.models import enhancer as enh  # noqa: E402
from metavoice_tpu_torch.models import mbd  # noqa: E402
from metavoice_tpu_torch.training import df_trainer as dft  # noqa: E402
from metavoice_tpu_torch.training import mbd_trainer as mt  # noqa: E402
from metavoice_tpu_torch.training.finetune import tree_leaves  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

UNET = dict(hidden=4, depth=2, num_steps=16, codec_dim=8)
MBD = dict(n_processes=2, step_list=(15, 7, 0), processor_bands=4, eq_bands=8, sample_rate=24000)
JMCFG = jmbd.MBDConfig(unet=jmbd.UNetConfig(**UNET), schedule=jmbd.ScheduleConfig(num_steps=16, beta_exp=1.0), **MBD)
MCFG = mbd.MBDConfig(unet=mbd.UNetConfig(**UNET), schedule=mbd.ScheduleConfig(num_steps=16, beta_exp=1.0), **MBD)
DF = dict(sr=8000, n_fft=256, hop=128, n_erb=12, df_bins=16, df_order=2, conv_ch=16, gru_dim=24)
JDCFG, DCFG = jenh.DFConfig(**DF), enh.DFConfig(**DF)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    """A tree of tensors -> numpy copies (None kept), for JAX: the port's
    steps update their params in place, and JAX's CPU arrays may share a
    numpy buffer while JAX still reads it."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return None if tree is None else np.array(tree.detach().cpu().numpy())


def _leaves(tree, prefix=""):
    """path -> leaf, None leaves left out."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {} if tree is None else {prefix[:-1]: tree}


def _close(got, want, tol: float, what: str = ""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{what}: max |err| {err:.3e} > {tol} x {scale:.3e}"


def _grads_close(got: dict, want: dict):
    """Each grad leaf within 1e-4 of its max |g|; a leaf whose gradient is 0
    but for rounding (a conv bias that a GroupNorm of one channel a group
    takes out again) within 1e-6 of the largest grad in both."""
    assert got.keys() == want.keys()
    floor = 1e-6 * max(np.abs(w).max() for w in want.values())
    for k, g in got.items():
        if np.abs(want[k]).max() < floor:
            assert np.abs(g).max() < floor, k
        else:
            _close(g, want[k], 1e-4, k)


def _losses(out: str, label: str) -> list[float]:
    return [float(x) for x in re.findall(rf"{label} iter \d+: loss ([-\d.e+naif]+)", out)]


@pytest.fixture(scope="module")
def band_batch():
    rng = np.random.default_rng(1)
    wav = rng.normal(size=(2, 512)).astype(np.float32)
    emb = rng.normal(size=(2, 4, 8)).astype(np.float32)
    return wav, emb


def test_fit_processor_matches_jax(band_batch):
    wav, _ = band_batch
    key = jax.random.PRNGKey(1)
    want = jax.jit(lambda w, k: jmt.fit_processor(JMCFG, w, k))(wav, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, wav.shape)))  # JAX's draw
    got = mt.fit_processor(MCFG, torch.from_numpy(wav), noise=noise)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k], 1e-5, k)
    drawn = mt.fit_processor(MCFG, torch.from_numpy(wav), generator=torch.Generator().manual_seed(0))
    assert (mbd.processor_stats(drawn)[2] > 0).all()


def test_diffusion_loss_and_grads_match_jax(band_batch):
    """Each example takes its own step's embedding (JAX vmaps the UNet over
    the batch); t and eps from JAX's key split."""
    wav, emb = band_batch
    gen = torch.Generator().manual_seed(2)
    unet = mbd.init_unet_params(MCFG.unet, device="cpu", generator=gen)
    x0 = torch.from_numpy(wav) * 0.5
    key = jax.random.PRNGKey(3)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jmt.diffusion_loss(p, JMCFG, jnp.asarray(x0.numpy()), jnp.asarray(emb), key)))(_np(unet))
    k_t, k_eps = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 16)))
    eps = torch.from_numpy(np.array(jax.random.normal(k_eps, wav.shape)))
    assert t[0] != t[1]  # two steps: a batch-wide embedding would show
    leaves = _leaves(unet)
    for p in leaves.values():
        p.requires_grad_(True)
    loss = mt.diffusion_loss(unet, MCFG, x0, torch.from_numpy(emb), t=t, eps=eps)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    _close(loss.item(), float(loss_j), 1e-4, "loss")
    _grads_close({k: g.numpy() for k, g in grads.items()}, _leaves(jax.tree.map(np.asarray, grads_j)))


def _assert_one_adam_step_close(got: dict, want: dict, lr: float, rounding: frozenset = frozenset()):
    """After one Adam step each element moves by about lr x sign(g), so a
    near-zero grad whose sign the two packages' f32 sums disagree on moves
    its element up to 2 lr apart: every element within 2 lr, all but 1e-3 of
    a leaf within 1e-3 lr, but for the ``rounding`` leaves, whose grad is 0
    but for rounding (their step is lr x the sign of that rounding)."""
    assert got.keys() == want.keys()
    for k, w in want.items():
        d = np.abs(got[k] - w)
        assert d.max() <= 2 * lr, (k, d.max())
        if k not in rounding:
            assert np.mean(d > 1e-3 * lr) <= 1e-3, (k, np.mean(d > 1e-3 * lr))


def test_mbd_train_step_matches_optax(band_batch):
    """One step: clip by global norm (a norm above 1 here, so the clip
    acts), then Adam, against JAX's ``make_mbd_train_step`` on the same
    draws."""
    wav, emb = band_batch
    unet = mbd.init_unet_params(MCFG.unet, device="cpu", generator=torch.Generator().manual_seed(6))
    x0 = torch.from_numpy(wav) * 3.0
    tcfg = mt.MBDTrainConfig(learning_rate=1e-3)
    key = jax.random.PRNGKey(7)
    jopt, jstep = jmt.make_mbd_train_step(JMCFG, jmt.MBDTrainConfig(learning_rate=1e-3))
    junet = _np(unet)
    jbatch = {"band": jnp.asarray(x0.numpy()), "emb": jnp.asarray(emb)}
    _, jnew, jloss = jstep(jopt.init(junet), junet, jbatch, key)
    jgrads = _leaves(jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: jmt.diffusion_loss(p, JMCFG, jbatch["band"], jbatch["emb"], key)))(junet)))
    floor = 1e-6 * max(np.abs(g).max() for g in jgrads.values())
    rounding = frozenset(k for k, g in jgrads.items() if np.abs(g).max() < floor)
    assert rounding  # the level-0 conv1_b: a GroupNorm of one channel a group takes their grad out
    k_t, k_eps = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 16)))
    eps = torch.from_numpy(np.array(jax.random.normal(k_eps, wav.shape)))
    opt, step = mt.make_mbd_train_step(MCFG, tcfg)
    _, new, loss = step(opt.init(unet), unet, {"band": x0, "emb": torch.from_numpy(emb)}, t=t, eps=eps)
    _close(loss.item(), float(jloss), 1e-4, "loss")
    _assert_one_adam_step_close({k: v.detach().numpy() for k, v in _leaves(new).items()},
                                _leaves(jax.tree.map(np.asarray, jnew)), tcfg.learning_rate, rounding)


def test_mbd_train_step_descends_and_train_band_moves_the_params(band_batch, capsys):
    wav, emb = band_batch
    gen = torch.Generator().manual_seed(4)
    unet = mbd.init_unet_params(MCFG.unet, device="cpu", generator=gen)
    w = torch.from_numpy(wav)
    proc = mt.fit_processor(MCFG, w, generator=gen)
    target = mbd.processor_project_sample(proc, mbd.split_bands(w, 24000, 2)[0], 24000, 4)
    opt, step = mt.make_mbd_train_step(MCFG, mt.MBDTrainConfig(learning_rate=1e-3))
    state = opt.init(unet)
    t, eps = torch.tensor([3, 11]), torch.randn(wav.shape, generator=gen)  # the same draw: a deterministic descent
    losses = []
    for _ in range(8):
        state, unet, loss = step(state, unet, {"band": target, "emb": torch.from_numpy(emb)}, t=t, eps=eps)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

    before = [p.detach().clone() for p in tree_leaves(unet)]

    def batches():
        rng = np.random.default_rng(5)
        while True:
            yield {"wav": rng.normal(size=(2, 512)).astype(np.float32),
                   "emb": rng.normal(size=(2, 4, 8)).astype(np.float32)}

    out, proc2 = mt.train_band(MCFG, mt.MBDTrainConfig(max_iters=3), 1, unet, proc, batches(), gen, log_every=1)
    assert proc2 is proc and len(_losses(capsys.readouterr().out, "band 1")) == 3
    assert max((a - b).abs().max().item() for a, b in zip(tree_leaves(out), before)) > 0


def test_synth_pairs_are_jax_bit_for_bit():
    got = dft.synth_clean_noisy(np.random.default_rng(7), 3, 800, 8000, 0.0, 12.0)
    want = jdft.synth_clean_noisy(np.random.default_rng(7), 3, 800, 8000, 0.0, 12.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_df_loss_and_grads_match_jax():
    gen = torch.Generator().manual_seed(8)
    params = enh.init_df_params(DCFG, device="cpu", generator=gen)
    params["gru_b"] = 0.3 * torch.randn(params["gru_b"].shape, generator=gen)
    clean, noisy = dft.synth_clean_noisy(np.random.default_rng(9), 2, 2400, 8000, 0.0, 6.0)
    noisy_spec, clean_spec = (dft._specs(x, DCFG, torch.device("cpu")) for x in (noisy, clean))
    tcfg, jtcfg = dft.DFTrainConfig(df_weight=0.5), jdft.DFTrainConfig(df_weight=0.5)
    loss_j, grads_j = jax.jit(jax.value_and_grad(lambda p: jdft.df_loss(
        p, JDCFG, jnp.asarray(noisy_spec.numpy()), jnp.asarray(clean_spec.numpy()), jtcfg)))(_np(params))
    for p in params.values():
        p.requires_grad_(True)
    loss = dft.df_loss(params, DCFG, noisy_spec, clean_spec, tcfg)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _close(loss.item(), float(loss_j), 1e-4, "loss")
    _grads_close({k: g.numpy() for k, g in grads.items()}, {k: np.asarray(v) for k, v in grads_j.items()})


def test_df_step_matches_optax():
    """One plain-Adam step of the DF network against JAX's ``_df_step``."""
    gen = torch.Generator().manual_seed(10)
    params = enh.init_df_params(DCFG, device="cpu", generator=gen)
    clean, noisy = dft.synth_clean_noisy(np.random.default_rng(11), 2, 2400, 8000, 0.0, 6.0)
    noisy_spec, clean_spec = (dft._specs(x, DCFG, torch.device("cpu")) for x in (noisy, clean))
    tcfg, jtcfg = dft.DFTrainConfig(learning_rate=1e-3), jdft.DFTrainConfig(learning_rate=1e-3)
    jp = _np(params)
    jnew, _, jloss = jdft._df_step(jp, optax.adam(1e-3).init(jp), JDCFG, jtcfg, jnp.asarray(noisy_spec.numpy()),
                                   jnp.asarray(clean_spec.numpy()))
    opt, step = dft.make_df_step(DCFG, tcfg)
    new, _, loss = step(params, opt.init(params), noisy_spec, clean_spec)
    _close(loss.item(), float(jloss), 1e-4, "loss")
    _assert_one_adam_step_close({k: v.detach().numpy() for k, v in new.items()},
                                {k: np.asarray(v) for k, v in jnew.items()}, tcfg.learning_rate)


def test_train_df_descends_and_stamps_a_tree_both_packages_carry(capsys, tmp_path):
    tcfg = dft.DFTrainConfig(max_iters=6, batch_size=2, clip_s=0.3, learning_rate=3e-3, seed=0)
    params = dft.train_df(None, DCFG, tcfg, device="cpu", log_every=1)
    losses = _losses(capsys.readouterr().out, "df")
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert int(params["trained_iters"]) == 6 and params["trained_iters"].dtype == torch.int32
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        enh.get_enhancer("df", params=params, cfg=DCFG, device="cpu")  # stamped: no warning

    # the JAX writer's .npz of a stamped JAX tree -> the port's reader and params_from_numpy
    jtree = dict(_np({k: v for k, v in params.items() if k != "trained_iters"}),
                 trained_iters=jnp.asarray(6, jnp.int32))
    path = str(tmp_path / "df.npz")
    jck.save_npz(path, jtree)
    tree, _ = ck.load_npz(path)
    for carried in (ck.params_from_numpy(tree, device="cpu"), ck.params_from_numpy(jtree, device="cpu")):
        assert carried.keys() == params.keys()
        for k, v in carried.items():
            assert v.dtype == params[k].dtype and torch.equal(v, params[k]), k
