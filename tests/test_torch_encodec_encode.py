"""The port's EnCodec encoder (``encode_latent``, ``rvq_encode``,
``encode_codes``) against the JAX package's on the same weights and wav,
and its place in ``init_params`` and the JAX-parameter carry-over."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import encodec as jec  # noqa: E402
from metavoice_tpu_torch.models import encodec as ec  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ck  # noqa: E402

SMALL = dict(n_filters=8, dimension=32)
# f32 convolutions and the LSTM summed in other orders on the two sides
LATENT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codec():
    jcfg = jec.EncodecConfig(**SMALL)
    # jitted: one compile, where the eager init compiles op by op (about 3x longer)
    jparams = jax.jit(jec.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = ck.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ec.EncodecConfig(**SMALL), params


def _wav(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24000)) / 24000
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 2 * t))
    return (wav + 0.05 * rng.normal(size=len(t))).astype(np.float32)[None]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_carry_over_takes_jax_encoder_leaves(codec):
    """params_from_numpy keeps every encoder leaf of a JAX tree, bit for bit."""
    _, jparams, _, params = codec
    want = dict(_leaves(jax.tree.map(np.asarray, jparams["encoder"])))
    got = dict(_leaves(params["encoder"]))
    assert want.keys() == got.keys() and len(want) == 31
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_init_params_encoder_tree_matches_jax_layout(codec):
    jcfg, jparams, cfg, _ = codec
    ours = ec.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    want = {k: np.shape(v) for k, v in _leaves(jax.tree.map(np.asarray, jparams))}
    assert {k: tuple(v.shape) for k, v in _leaves(ours)} == want


def test_init_params_keeps_seeded_decoder():
    """The encoder is drawn after the decoder and the codebooks: a seed gives
    the decoder and codebooks it gave before the encoder was ported (the sums
    of those 32 leaves at seed 5, from the decoder-only init_params), and
    the encoder follows them in the generator's stream."""
    cfg = ec.EncodecConfig(**SMALL)
    gen = torch.Generator().manual_seed(5)
    p = ec.init_params(cfg, device="cpu", generator=gen)
    old = [v.double() for _, v in _leaves({"decoder": p["decoder"], "codebooks": p["codebooks"]})]
    assert len(old) == 32
    assert sum(float(v.sum()) for v in old) == pytest.approx(165.31234318666367, rel=1e-12)
    assert sum(float(v.abs().sum()) for v in old) == pytest.approx(233526.03027656698, rel=1e-12)
    after_decoder = torch.Generator().manual_seed(5)
    ec.init_params(cfg, device="cpu", generator=after_decoder)
    assert torch.equal(gen.get_state(), after_decoder.get_state())


@pytest.mark.parametrize("seconds,seed", [(0.4, 0), (1.0, 1)])
def test_encode_latent_matches_jax(codec, seconds, seed):
    jcfg, jparams, cfg, params = codec
    wav = _wav(seconds, seed)
    ref = np.asarray(jec.encode_latent(jparams, jcfg, jnp.asarray(wav)))
    ours = ec.encode_latent(params, cfg, torch.from_numpy(wav)).numpy()
    assert ours.shape == ref.shape == (1, wav.shape[1] // cfg.hop_length, cfg.dimension)
    np.testing.assert_allclose(ours, ref, atol=LATENT_TOL * np.abs(ref).max())


def test_rvq_encode_matches_jax_on_one_latent(codec):
    """The nearest-codeword search alone, on the same latent: the same codes."""
    jcfg, jparams, cfg, params = codec
    latent = np.random.default_rng(3).normal(size=(2, 30, cfg.dimension)).astype(np.float32)
    ref = np.asarray(jec.rvq_encode(jparams["codebooks"], jnp.asarray(latent), jcfg.n_q))
    ours = ec.rvq_encode(params["codebooks"], torch.from_numpy(latent), cfg.n_q)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("seconds,seed", [(0.4, 0), (1.0, 1)])
def test_encode_codes_matches_jax(codec, seconds, seed):
    jcfg, jparams, cfg, params = codec
    wav = _wav(seconds, seed)
    ref = np.asarray(jec.encode_codes(jparams, jcfg, jnp.asarray(wav)))
    ours = ec.encode_codes(params, cfg, wav).numpy()
    assert ours.shape == ref.shape == (1, cfg.n_q, wav.shape[1] // cfg.hop_length)
    assert ours.min() >= 0 and ours.max() < cfg.codebook_size
    np.testing.assert_array_equal(ours, ref)


def test_codes_decode_back_to_a_wav(codec):
    _, _, cfg, params = codec
    codes = ec.encode_codes(params, cfg, _wav(0.4, 2))
    wav = ec.decode_codes(params, cfg, codes)
    assert wav.shape == (1, codes.shape[-1] * cfg.hop_length) and torch.isfinite(wav).all()
