"""K4 multi-query decode attention: the port's CPU path (its plain version)
against the JAX package's Pallas kernel in interpret mode, in f32; the T = 1
GQA reroute of ``decode_attention``; and a GQA first stage's cached decode
against the JAX package's ``apply_blocks``.

The CUDA kernel itself is held to the plain version on the card in
tests/test_torch_decode_attention_multi_cuda.py and in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import config as jconfig  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu_torch.core import config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

# f32 on both sides: only the summation order differs (online softmax over
# chunks in the Pallas kernel, one softmax here)
Y_TOL = 1e-5  # of max |ref|


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(t, h=8, h_kv=8, l=2, s=512, b=2, dh=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, t, dh)).astype(np.float32)
    k_new, v_new = (rng.normal(size=(b, h_kv, t, dh)).astype(np.float32) for _ in range(2))
    k_cache, v_cache = (rng.normal(size=(l, s, b, h_kv, dh)).astype(np.float32) for _ in range(2))
    return q, k_new, v_new, k_cache, v_cache


def _port(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None):
    t = [torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_cache, v_cache)]
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    before = A.decode_attention_multi.launches
    y, kc, vc = A.decode_attention_multi(*t, layer, pos, st)
    assert A.decode_attention_multi.launches == before  # the CPU path launches nothing
    assert kc is t[3] and vc is t[4]  # the caches are updated in place
    return y.numpy(), kc.numpy(), vc.numpy()


def _assert_rows_written(kc, k_cache, k_new, layer, pos):
    """Rows [pos, pos+T) of ``layer`` hold k_new bit for bit; every other
    slot is as it was."""
    t = k_new.shape[2]
    np.testing.assert_array_equal(kc[layer, pos : pos + t], k_new.transpose(2, 0, 1, 3))
    untouched = np.ones(kc.shape[:2], bool)
    untouched[layer, pos : pos + t] = False
    np.testing.assert_array_equal(kc[untouched], k_cache[untouched])


@pytest.mark.parametrize(
    "t,h,h_kv,pos,starts",
    [
        (1, 8, 1, 300, None), (1, 8, 2, 255, (3, 60)), (1, 8, 4, 256, None),
        (4, 8, 8, 0, None), (4, 8, 8, 253, None), (4, 8, 2, 400, (256, 300)),
        (4, 8, 1, 63, None), (4, 8, 4, 400, (270, 390)),
        (16, 8, 8, 250, None), (16, 8, 4, 400, (400, 392)),
    ],
)
def test_matches_jax_kernel_interpret(t, h, h_kv, pos, starts):
    arrays = _setup(t, h, h_kv)
    layer = 1
    st = None if starts is None else jnp.asarray(starts, jnp.int32)
    y_ker, kc_ker, vc_ker = JA.decode_attention_multi(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(layer, jnp.int32), jnp.asarray(pos, jnp.int32),
        starts=st, interpret=True,
    )
    y, kc, vc = _port(*arrays, layer, pos, starts)
    y_ker = np.asarray(y_ker)
    assert np.abs(y - y_ker).max() <= Y_TOL * np.abs(y_ker).max()
    np.testing.assert_array_equal(kc, np.asarray(kc_ker))
    np.testing.assert_array_equal(vc, np.asarray(vc_ker))
    _assert_rows_written(kc, arrays[3], arrays[1], layer, pos)
    _assert_rows_written(vc, arrays[4], arrays[2], layer, pos)


@pytest.mark.parametrize("t,h_kv", [(3, 8), (8, 2)])
@pytest.mark.parametrize("pos", [7, 300, 496])
def test_matches_jax_reference(t, h_kv, pos):
    arrays = _setup(t, 8, h_kv, seed=pos)
    y_ref, kc_ref, _ = JA.decode_attention_multi_reference(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(0), jnp.asarray(pos)
    )
    y, kc, _ = _port(*arrays, 0, pos)
    y_ref = np.asarray(y_ref)
    assert np.abs(y - y_ref).max() <= Y_TOL * np.abs(y_ref).max()
    np.testing.assert_array_equal(kc, np.asarray(kc_ref))


def test_nan_past_the_window_stays_out():
    q, k_new, v_new, k_cache, v_cache = _setup(4, 8, 2)
    pos = 100
    y_clean, _, _ = _port(q, k_new, v_new, k_cache, v_cache, 0, pos)
    nan_k, nan_v = k_cache.copy(), v_cache.copy()
    nan_k[:, pos + 4 :], nan_v[:, pos + 4 :] = np.nan, np.nan
    y_nan, _, _ = _port(q, k_new, v_new, nan_k, nan_v, 0, pos)
    np.testing.assert_array_equal(y_nan, y_clean)


def test_start_past_pos_is_taken_as_pos():
    """A row whose start lies past pos attends [pos, pos + t], as a start at
    pos does (the JAX reference, given the start at pos)."""
    arrays = _setup(4, 8, 2)
    pos = 200
    y, _, _ = _port(*arrays, 0, pos, (50, 350))
    y_ref, _, _ = JA.decode_attention_multi_reference(
        *(jnp.asarray(a) for a in arrays), jnp.asarray(0), jnp.asarray(pos),
        starts=jnp.asarray([50, pos], jnp.int32),
    )
    y_ref = np.asarray(y_ref)
    assert np.abs(y - y_ref).max() <= Y_TOL * np.abs(y_ref).max()


def test_decode_attention_reroutes_gqa_to_k4():
    """decode_attention with H_kv < H is K4 at T = 1, as JAX's reroute is,
    and no longer raises."""
    q, k_new, v_new, k_cache, v_cache = _setup(1, 8, 2)
    starts = torch.tensor([3, 60], dtype=torch.int32)
    t = [torch.from_numpy(a.copy()) for a in (q[:, :, 0], k_new[:, :, 0], v_new[:, :, 0], k_cache, v_cache)]
    y1, kc1, _ = A.decode_attention(*t, 1, 100, starts)
    y4, kc4, _ = A.decode_attention_multi(
        *(torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_cache, v_cache)), 1, 100, starts
    )
    assert torch.equal(y1, y4[:, :, 0]) and torch.equal(kc1, kc4)
    with pytest.raises(ValueError, match="GQA"):
        A.decode_attention(t[0], t[1][:, :1].repeat(1, 3, 1), t[2][:, :1].repeat(1, 3, 1), t[3], t[4], 1, 100)
    with pytest.raises(ValueError, match="query tokens"):
        A.decode_attention_multi(*(torch.zeros(2, 8, 17, 16), torch.zeros(2, 2, 17, 16),
                                   torch.zeros(2, 2, 17, 16), torch.zeros(1, 64, 2, 2, 16),
                                   torch.zeros(1, 64, 2, 2, 16)), 0, 0)


def test_gqa_first_stage_decode_matches_jax():
    """A 2-layer f32 first stage with 2 kv heads of 4: prefill, then 8
    teacher-forced T = 1 steps (K4's plain version) against JAX's
    ``apply_blocks`` on the CPU: logits within 1e-4 of max |ref|."""
    kw = dict(n_layer=2, dim=128, n_head=4, n_local_heads=2, block_size=256)
    jcfg, cfg = jconfig.first_stage_config(**kw), config.first_stage_config(**kw)
    params = _jax_init(jax.random.PRNGKey(4), cfg=jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(scale=0.05, size=a.shape)).astype(np.float32), params
    )
    jp, p = jax.tree.map(jnp.asarray, np_params), params_from_numpy(np_params, device="cpu")
    t_pad, t_true = 32, 21
    idx = np.repeat(rng.integers(0, cfg.vocab_size, size=(1, t_pad)), 2, axis=0)
    spk = np.repeat(rng.normal(size=(1, cfg.speaker_emb_dim)).astype(np.float32), 2, axis=0)
    jkv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=jnp.float32)
    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.float32, device="cpu")
    jmask, mask = jfs.make_spk_cond_mask(1), fs.make_spk_cond_mask(1, device="cpu")
    outs = []
    for step in range(-1, 8):
        tok, pos = (idx, 0) if step < 0 else (np.repeat(rng.integers(0, 1024, size=(1, 1)), 2, axis=0), t_true + step)
        ref, jkv = jtfm.forward(jp, jcfg, jnp.asarray(tok), spk_emb=jnp.asarray(spk), spk_cond_mask=jmask,
                                kv_cache=jkv, cache_pos=pos, compute_dtype=jnp.float32)
        ours, kv = tfm.forward(p, cfg, torch.from_numpy(tok), spk_emb=torch.from_numpy(spk),
                               spk_cond_mask=mask, kv_cache=kv, cache_pos=pos, compute_dtype=torch.float32)
        outs.append((ours[0].numpy(), np.asarray(ref[0])))
    for o, r in outs:
        assert np.abs(o - r).max() <= 1e-4 * np.abs(r).max()
