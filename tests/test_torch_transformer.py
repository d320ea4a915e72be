"""Transformer core: the port against metavoice_tpu/models/transformer.py in
f32 on the same weights (made by the JAX ``init_params``, perturbed so norm
weights and biases are not trivially 1 and 0, carried over by the converter).

The port's T=1 cached step runs ops/attention.py:decode_attention, whose CPU
path is the kernel's plain version; the JAX side runs its XLA cached path.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import config as jconfig  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core import config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

ATOL = RTOL = 1e-4

CONFIGS = {
    "first": dict(n_layer=2, dim=128, n_head=4, block_size=256),
    "second": dict(n_layer=2, dim=96, n_head=6, block_size=64),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    make = (jconfig.first_stage_config, config.first_stage_config) if name == "first" else (
        jconfig.second_stage_config, config.second_stage_config)
    return make[0](**CONFIGS[name]), make[1](**CONFIGS[name])


def _weights(jcfg, seed=0):
    params = _jax_init(jax.random.PRNGKey(seed), cfg=jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), params
    )
    return jax.tree.map(jnp.asarray, np_params), params_from_numpy(np_params, device="cpu")


def _tokens(cfg, shape, rng):
    if cfg.num_hierarchies == 1:
        return rng.integers(0, cfg.vocab_sizes[0], size=shape)
    return np.stack([rng.integers(0, v, size=shape) for v in cfg.vocab_sizes], axis=1)


def _close(ours, ref):
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["first", "second"])
def test_uncached_forward_matches_jax(name):
    jcfg, cfg = _configs(name)
    jp, p = _weights(jcfg)
    rng = np.random.default_rng(1)
    idx = _tokens(cfg, (2, 40), rng)
    spk = rng.normal(size=(2, cfg.speaker_emb_dim)).astype(np.float32)
    ref, _ = jtfm.forward(jp, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk), compute_dtype=jnp.float32)
    ours, _ = tfm.forward(
        p, cfg, torch.from_numpy(idx), spk_emb=torch.from_numpy(spk), compute_dtype=torch.float32
    )
    assert len(ours) == len(cfg.output_vocab_sizes)
    _close(ours, ref)


def test_prefill_and_cached_decode_steps_match_jax():
    jcfg, cfg = _configs("first")
    jp, p = _weights(jcfg, seed=2)
    rng = np.random.default_rng(3)
    t_pad, t_true = 32, 21
    prompt = _tokens(cfg, (1, t_pad), rng)
    spk = np.repeat(rng.normal(size=(1, cfg.speaker_emb_dim)).astype(np.float32), 2, axis=0)
    idx = np.repeat(prompt, 2, axis=0)  # the CFG pair
    jmask = jfs.make_spk_cond_mask(1)
    mask = fs.make_spk_cond_mask(1, device="cpu")
    jkv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.float32)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.float32, device="cpu")
    ref, jkv = jtfm.forward(jp, jcfg, jnp.asarray(idx), spk_emb=jnp.asarray(spk), spk_cond_mask=jmask,
                            kv_cache=jkv, cache_pos=0, compute_dtype=jnp.float32)
    ours, kv = tfm.forward(p, cfg, torch.from_numpy(idx), spk_emb=torch.from_numpy(spk),
                           spk_cond_mask=mask, kv_cache=kv, cache_pos=0, compute_dtype=torch.float32)
    _close(ours, ref)
    # three teacher-forced T=1 steps from the true prompt end
    for step in range(3):
        pos = t_true + step
        tok = np.repeat(_tokens(cfg, (1, 1), rng), 2, axis=0)
        ref, jkv = jtfm.forward(jp, jcfg, jnp.asarray(tok), spk_emb=jnp.asarray(spk), spk_cond_mask=jmask,
                                kv_cache=jkv, cache_pos=pos, compute_dtype=jnp.float32)
        ours, kv = tfm.forward(p, cfg, torch.from_numpy(tok), spk_emb=torch.from_numpy(spk),
                               spk_cond_mask=mask, kv_cache=kv, cache_pos=pos,
                               compute_dtype=torch.float32)
        _close(ours, ref)
    np.testing.assert_allclose(kv.k[:, : t_true + 3].numpy(), np.asarray(jkv.k[:, : t_true + 3]),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_mirror_jax_rounding_and_eps(dtype):
    """f32 statistics, LayerNorm's eps fixed at 1e-5 whatever ``eps`` says,
    and the rounding to x's dtype BEFORE the weight multiply: bf16 results
    are bit-identical to the JAX package's."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 3, 64)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    for norm_type, bias in (("rmsnorm", None), ("layernorm", b)):
        for eps in (1e-5, 1e-1):
            ref = jtfm._norm(jx, jnp.asarray(w), None if bias is None else jnp.asarray(bias),
                             norm_type, eps)
            ours = tfm._norm(tx, torch.from_numpy(w),
                             None if bias is None else torch.from_numpy(bias), norm_type, eps)
            assert ours.dtype == tx.dtype
            if dtype == "bfloat16":
                np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref, np.float32))
            else:
                np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
