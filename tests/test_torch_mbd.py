"""The port's multi-band diffusion vocoder (metavoice_tpu_torch/models/mbd.py)
and its audiocraft converter (utils/convert_external.py) against the JAX
package's (metavoice_tpu/models/mbd.py, utils/convert_external.py), on small
configs (JAX's TINY_MBD); the TTS's MBD route is in test_torch_mbd_tts.py.

The weights are drawn with the port's init and handed to JAX as numpy; JAX's
draws are replayed into the port: the test splits JAX's keys as
``mbd.generate`` / ``_generate_jit`` / ``generate_band`` do and injects each
process's initial noise and each step's noise.

Tolerances (of max |ref|): ``split_bands``, ``re_eq``, the processor and
``unet_forward`` 1e-5; ``generate`` and ``tokens_to_wav`` over the small
step list 1e-4; converter trees bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu.models import mbd as jmbd  # noqa: E402
from metavoice_tpu.utils import convert_external as jcx  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.models import mbd  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402
from metavoice_tpu_torch.utils import convert_external as cx  # noqa: E402
from test_mbd_torch_parity import CFG as ORACLE_CFG  # noqa: E402
from test_mbd_torch_parity import TorchDiffusionUnet, _state_dict_audiocraft_names  # noqa: E402

SR = 24_000
TINY_UNET = dict(hidden=4, depth=2, num_steps=16, codec_dim=16)
TINY = dict(n_processes=2, step_list=(15, 7, 0), processor_bands=4, eq_bands=8)
ECFG = dict(n_filters=4, dimension=16, codebook_size=32, n_q=2, ratios=(4, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(unet: dict | None = None, **kw):
    """The same MBDConfig in both packages: (JAX's, the port's)."""
    u, m = TINY_UNET | (unet or {}), TINY | kw
    return (jmbd.MBDConfig(unet=jmbd.UNetConfig(**u), **m), mbd.MBDConfig(unet=mbd.UNetConfig(**u), **m))


def _np(tree):
    """A tree of tensors -> numpy (None kept), for JAX."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return None if tree is None else tree.detach().cpu().numpy()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in _leaves(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _close(got, want, tol: float):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"max |err| {err:.3e} > {tol} x {scale:.3e}"


def _seeded(seed: int):
    return torch.Generator().manual_seed(seed)


def _perturb(tree, gen):
    """Norms and biases off their init, so a misplaced one shows."""
    for k, v in _leaves(tree).items():
        if torch.is_tensor(v) and k.rsplit("/", 1)[-1].endswith(("_w", "_b")) and v.dim() == 1:
            v.add_(0.1 * torch.randn(v.shape, generator=gen))
    return tree


def _jax_draws(key, cfg, bsz: int, size: int):
    """The draws of JAX's ``generate(..., key)``, as its keys split:
    (initial (P, B, size, chin), steps (P, n_iter, B, size, chin))."""
    shape = (bsz, size, cfg.unet.chin)
    key, kn = jax.random.split(key)
    inits, steps = [], []
    for i in range(cfg.n_processes):
        key, k1, k2 = jax.random.split(key, 3)
        inits.append(np.asarray(jax.random.normal(k1 if i else kn, shape)))
        per = []
        for _ in range(len(cfg.step_list) - 1):
            k2, sub = jax.random.split(k2)
            per.append(np.asarray(jax.random.normal(sub, shape)))
        steps.append(np.stack(per))
    return torch.from_numpy(np.stack(inits)), torch.from_numpy(np.stack(steps))


@pytest.mark.parametrize("n_bands", [4, 8, 32])
def test_split_bands_matches_jax(n_bands):
    x = np.random.default_rng(n_bands).normal(size=(2, 1500)).astype(np.float32)
    want = jax.jit(functools.partial(jmbd.split_bands, sr=SR, n_bands=n_bands))(x)
    got = mbd.split_bands(torch.from_numpy(x), SR, n_bands)
    assert len(got) == n_bands
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)
    np.testing.assert_allclose(sum(g.numpy() for g in got), x, atol=1e-5)


def test_re_eq_and_processor_match_jax():
    rng = np.random.default_rng(6)
    wav = rng.normal(size=(2, 2400)).astype(np.float32) * 5.0
    ref = rng.normal(size=(2, 2400)).astype(np.float32)
    want = jax.jit(lambda w, r: jmbd.re_eq(w, r, SR, 8))(wav, ref)
    _close(mbd.re_eq(torch.from_numpy(wav), torch.from_numpy(ref), SR, 8).numpy(), want, 1e-5)

    proc = {"counts": np.array([7.0], np.float32), "sum_x": rng.normal(size=4).astype(np.float32),
            "sum_x2": (40 + rng.random(4) * 5).astype(np.float32),
            "sum_target_x2": (3 + rng.random(4)).astype(np.float32)}
    tproc = {k: torch.from_numpy(v) for k, v in proc.items()}
    for jfn, fn in ((jmbd.processor_return_sample, mbd.processor_return_sample),
                    (jmbd.processor_project_sample, mbd.processor_project_sample)):
        want = jax.jit(lambda p, x, jfn=jfn: jfn(p, x, SR, 4))(proc, ref)
        _close(fn(tproc, torch.from_numpy(ref), SR, 4).numpy(), want, 1e-5)
    for got, want in zip(mbd.processor_stats(tproc), jmbd.processor_stats(proc)):
        _close(got.numpy(), want, 1e-6)  # target_std is sum_target_x2 / counts: no square root


def _bilstm_tree(gen, ch: int, hid: int, width: int):
    """A 2-layer BLSTM tree: wi (in, 4 hid), wh (width, 4 hid), where the
    state is ``width`` wide (``hid`` for a real LSTM)."""
    def w(*shape):
        return 0.3 * torch.randn(shape, generator=gen)

    layers = []
    for c_in in (ch, 2 * width):
        layers.append({f"{n}_{d}": t for d in ("f", "b") for n, t in (
            ("wi", w(c_in, 4 * hid)), ("wh", w(width, 4 * hid)), ("bi", w(4 * hid)), ("bh", w(4 * hid)))})
    return {"layers": layers, "linear_w": w(2 * width, ch), "linear_b": w(ch)}


@pytest.mark.parametrize("case", ["zeroed", "passthrough", "unconditioned", "one_embedding", "bilstm"])
def test_unet_forward_matches_jax(case):
    unet = {"unconditioned": {"codec_dim": None}, "one_embedding": {"emb_all_layers": False},
            "passthrough": {"bottleneck": "passthrough"}}.get(case, {})
    jcfg, cfg = _cfgs(unet)
    gen = _seeded(11)
    params = _perturb(mbd.init_unet_params(cfg.unet, device="cpu", generator=gen), gen)
    if case == "bilstm":
        # JAX's _bilstm takes the state width from wh.shape[1] (the gates'),
        # so it runs only where wh is square: one hidden unit, its 4-wide
        # state broadcast against the 1-wide gates. The port takes the width
        # from wh.shape[0], which is the same there; a real LSTM's tree is
        # held to torch.nn.LSTM below.
        params["bilstm"] = _bilstm_tree(gen, cfg.unet.channels()[-1], hid=1, width=4)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 101, 1)).astype(np.float32)  # not a multiple of the stride: the padding shows
    cond = None if case == "unconditioned" else rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = jax.jit(lambda p, x, c: jmbd.unet_forward(p, jcfg.unet, x, jnp.asarray(9), c))(_np(params), x, cond)
    got = mbd.unet_forward(params, cfg.unet, torch.from_numpy(x), 9, None if cond is None else torch.from_numpy(cond))
    _close(got.detach().numpy(), want, 1e-5)


def test_bilstm_matches_torch_lstm():
    """The port's bottleneck BLSTM on a real (h, 4h) tree is torch's
    bidirectional 2-layer nn.LSTM and a linear layer."""
    gen = _seeded(13)
    tree = _bilstm_tree(gen, 16, hid=8, width=8)
    lstm = torch.nn.LSTM(16, 8, num_layers=2, bidirectional=True, batch_first=True)
    with torch.no_grad():
        for i, layer in enumerate(tree["layers"]):
            for d, sfx in (("f", ""), ("b", "_reverse")):
                getattr(lstm, f"weight_ih_l{i}{sfx}").copy_(layer[f"wi_{d}"].T)
                getattr(lstm, f"weight_hh_l{i}{sfx}").copy_(layer[f"wh_{d}"].T)
                getattr(lstm, f"bias_ih_l{i}{sfx}").copy_(layer[f"bi_{d}"])
                getattr(lstm, f"bias_hh_l{i}{sfx}").copy_(layer[f"bh_{d}"])
        x = torch.randn(2, 9, 16, generator=gen)
        want = lstm(x)[0] @ tree["linear_w"] + tree["linear_b"]
        _close(mbd._bilstm(x, tree).numpy(), want.numpy(), 1e-5)


def test_schedule_constants_match_jax_and_refuse_an_out_of_range_list():
    for sched in ({}, dict(num_steps=100, beta_t0=1e-4, beta_t1=0.02, beta_exp=1.0)):
        steps = (99, 66, 33, 0) if sched else jmbd.MBDConfig().step_list
        want = jmbd._subsampled_constants(jmbd.ScheduleConfig(**sched), steps)
        got = mbd._subsampled_constants(mbd.ScheduleConfig(**sched), steps)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="out of range"):
        mbd._subsampled_constants(mbd.ScheduleConfig(num_steps=16), (99, 0))


def test_generate_matches_jax_under_jax_draws():
    jcfg, cfg = _cfgs()
    gen = _seeded(21)
    params = mbd.init_params(cfg, device="cpu", generator=gen)
    for p in params["processes"]:
        _perturb(p["unet"], gen)
        p["processor"] = {"counts": torch.tensor([9.0]), "sum_x": 0.1 * torch.randn(4, generator=gen),
                          "sum_x2": 9.0 + torch.rand(4, generator=gen), "sum_target_x2": 2.0 + torch.rand(4, generator=gen)}
    emb = np.random.default_rng(22).normal(size=(2, 6, 16)).astype(np.float32)
    key = jax.random.PRNGKey(23)
    want = jmbd.generate(_np(params), jcfg, jnp.asarray(emb), 640, key)
    init, steps = _jax_draws(key, cfg, 2, 640)
    got = mbd.generate(params, cfg, torch.from_numpy(emb), 640, initial_noise=init, step_noise=steps)
    _close(got.numpy(), want, 1e-4)
    drawn = mbd.generate(params, cfg, torch.from_numpy(emb), 640, generator=_seeded(0))
    assert drawn.shape == (2, 640) and torch.isfinite(drawn).all()


def test_tokens_to_wav_matches_jax_under_jax_draws():
    jcfg, cfg = _cfgs()
    gen = _seeded(31)
    eparams = ec.init_params(ec.EncodecConfig(**ECFG), device="cpu", generator=gen)
    params = mbd.init_params(cfg, device="cpu", generator=gen)
    codes = np.random.default_rng(32).integers(0, 32, size=(2, 24))
    key = jax.random.PRNGKey(33)
    jecfg = jec.EncodecConfig(**ECFG)
    want = jax.jit(lambda p, e, c, k: jmbd.tokens_to_wav(p, jcfg, e, c, k, encodec_cfg=jecfg))(
        _np(params), _np(eparams), jnp.asarray(codes), key)
    init, steps = _jax_draws(key, cfg, 1, 24 * 8)
    got = mbd.tokens_to_wav(params, cfg, eparams, codes, ec.EncodecConfig(**ECFG), initial_noise=init,
                            step_noise=steps)
    assert got.shape == (1, 24 * 8)
    _close(got.numpy(), want, 1e-4)


def _init_jax_tree(cfg, seed: int):
    """A tree of JAX's ``mbd.init_params`` (its structure, None leaves and
    dtypes from ``jax.eval_shape``), seeded numpy values in its arrays."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jmbd.init_params(k, cfg), jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.mark.parametrize("emb_all_layers", [True, False])
def test_init_params_has_jax_tree(emb_all_layers):
    """The port's ``init_params`` makes JAX's tree: the same keys, shapes,
    dtypes and None leaves; the processor the identity."""
    jcfg, cfg = _cfgs({"emb_all_layers": emb_all_layers})
    want = _leaves(jax.eval_shape(lambda k: jmbd.init_params(k, jcfg), jax.random.PRNGKey(0)))
    got = _leaves(mbd.init_params(cfg, device="cpu", generator=_seeded(0)))
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert (w is None and got[k] is None) or (tuple(got[k].shape) == w.shape and str(w.dtype) == "float32"
                                                   and got[k].dtype == torch.float32), k
    mean, std, target_std = mbd.processor_stats(mbd.init_processor(4, device="cpu"))
    assert not mean.any() and torch.equal(std, target_std)


@pytest.mark.parametrize("emb_all_layers", [True, False])
def test_params_from_numpy_carries_jax_mbd_trees(emb_all_layers):
    """A JAX MBD tree has None leaves ("bilstm", and "embeddings" without
    emb_all_layers): they come across as None, every array bit for bit, and
    the carried tree runs."""
    jcfg, cfg = _cfgs({"emb_all_layers": emb_all_layers}, n_processes=1)
    tree = _init_jax_tree(jcfg, 41)
    got = ck.params_from_numpy(tree, device="cpu")
    for p in got["processes"]:
        assert p["unet"]["bilstm"] is None
        assert (p["unet"]["embeddings"] is None) != emb_all_layers
    want, have = _leaves(tree), _leaves(got)
    assert want.keys() == have.keys()
    for k, v in want.items():
        if v is None:
            assert have[k] is None
        else:
            assert have[k].dtype == torch.float32 and np.array_equal(have[k].numpy(), v), k
    wav = mbd.generate(got, cfg, torch.zeros(1, 3, 16), 160, generator=_seeded(0))
    assert torch.isfinite(wav).all()


@pytest.fixture(scope="module")
def audiocraft_pkg():
    """audiocraft's package layout {sample_rate, n_bands, i: {model_state,
    processor_state, cfg}} of a torch DiffusionUnet with audiocraft's names
    (tests/test_mbd_torch_parity.py's oracle)."""
    torch.manual_seed(0)
    sd = _state_dict_audiocraft_names(TorchDiffusionUnet(ORACLE_CFG))
    proc = {"counts": torch.tensor([100.0]), "sum_x": torch.zeros(4), "sum_x2": torch.full((4,), 100.0),
            "sum_target_x2": torch.full((4,), 90.0)}
    return {"sample_rate": 24_000, "n_bands": 2,
            0: {"model_state": sd, "processor_state": proc,
                "cfg": {"schedule": {"num_steps": 32, "beta_t0": 1e-4, "beta_t1": 0.02, "beta_exp": 1.0}}},
            1: {"model_state": sd, "processor_state": proc, "cfg": {}}}


@pytest.mark.parametrize("bottleneck", ["auto", "passthrough"])
def test_mbd_converter_matches_jax_bit_for_bit(audiocraft_pkg, bottleneck, tmp_path):
    want, jcfg = jcx.convert_mbd_checkpoint(audiocraft_pkg, bottleneck=bottleneck)
    got, cfg = cx.convert_mbd_checkpoint(audiocraft_pkg, bottleneck=bottleneck, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.schedule.num_steps == 32 and max(cfg.step_list) < 32  # the step list rescaled to the schedule
    w, g = _leaves(want), _leaves(got)
    assert w.keys() == g.keys()
    for k, v in w.items():
        assert (v is None and g[k] is None) or np.array_equal(g[k].numpy(), v), k
    path = tmp_path / "mbd.pt"
    torch.save(audiocraft_pkg, path)
    loaded, lcfg = cx.load_mbd_pt(str(path), bottleneck=bottleneck, device="cpu")
    assert lcfg == cfg and all(torch.equal(a, b) for a, b in zip(_leaves(loaded).values(), g.values())
                               if a is not None)


def test_mbd_converter_refuses_what_jax_refuses(audiocraft_pkg):
    with pytest.raises(ValueError, match="bottleneck"):
        cx.convert_mbd_checkpoint(audiocraft_pkg, bottleneck="lstm", device="cpu")
    pkg = {**audiocraft_pkg, "n_bands": 1}
    pkg[0] = {**pkg[0], "model_state": {**pkg[0]["model_state"], "lstm.lstm.weight_ih_l0": torch.zeros(4, 4)}}
    for convert in (jcx.convert_mbd_checkpoint, functools.partial(cx.convert_mbd_checkpoint, device="cpu")):
        with pytest.raises(NotImplementedError, match="bottleneck"):
            convert(pkg)
