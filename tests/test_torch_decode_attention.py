"""K1 decode attention: the port's CPU path (its plain version) against the
JAX package's Pallas kernel (interpret mode) and its jnp reference, in f32.

The CUDA kernel itself is held to the plain version on the card in
tests/test_torch_decode_attention_cuda.py and in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402

# f32 on both sides: only the summation order differs (online softmax in the
# Pallas kernel vs one softmax here)
ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(dh, l=2, s=512, b=2, h=4, seed=0):
    rng = np.random.default_rng(seed)
    q, k_new, v_new = (rng.normal(size=(b, h, dh)).astype(np.float32) for _ in range(3))
    k_cache, v_cache = (rng.normal(size=(l, s, b, h, dh)).astype(np.float32) for _ in range(2))
    return q, k_new, v_new, k_cache, v_cache


def _port(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None):
    t = [torch.from_numpy(a.copy()) for a in (q, k_new, v_new, k_cache, v_cache)]
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    y, kc, vc = A.decode_attention(*t, layer, pos, st)
    assert kc is t[3] and vc is t[4]  # the caches are updated in place
    return y.numpy(), kc.numpy(), vc.numpy()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize(
    "pos,starts",
    [(0, None), (5, None), (255, None), (256, None), (400, None),
     (400, (256, 300)), (400, (270, 390)), (400, (400, 400)), (300, (0, 290))],
)
def test_matches_jax_kernel_and_reference(dh, pos, starts):
    arrays = _setup(dh)
    layer = 1
    st = None if starts is None else jnp.asarray(starts, jnp.int32)
    j = [jnp.asarray(a) for a in arrays]
    y_ref, kc_ref, vc_ref = JA.decode_attention_reference(
        *j, jnp.asarray(layer), jnp.asarray(pos), starts=st
    )
    y_ker, _, _ = JA.decode_attention(
        *j, jnp.asarray(layer, jnp.int32), jnp.asarray(pos, jnp.int32), starts=st, interpret=True
    )
    y, kc, vc = _port(*arrays, layer, pos, starts)
    np.testing.assert_allclose(y, np.asarray(y_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y, np.asarray(y_ker), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(kc, np.asarray(kc_ref))
    np.testing.assert_array_equal(vc, np.asarray(vc_ref))


@pytest.mark.parametrize("dh", [64, 128])
def test_garbage_beyond_pos_is_ignored(dh):
    q, k_new, v_new, k_cache, v_cache = _setup(dh)
    pos = 100
    y_clean, _, _ = _port(q, k_new, v_new, k_cache, v_cache, 0, pos)
    big_k, big_v = k_cache.copy(), v_cache.copy()
    big_k[:, pos + 1 :], big_v[:, pos + 1 :] = 1e6, -1e6
    y_ref, _, _ = JA.decode_attention_reference(
        *(jnp.asarray(a) for a in (q, k_new, v_new, big_k, big_v)), jnp.asarray(0), jnp.asarray(pos)
    )
    y_big, _, _ = _port(q, k_new, v_new, big_k, big_v, 0, pos)
    np.testing.assert_allclose(y_big, np.asarray(y_ref), atol=ATOL, rtol=RTOL)
    nan_k, nan_v = k_cache.copy(), v_cache.copy()
    nan_k[:, pos + 1 :], nan_v[:, pos + 1 :] = np.nan, np.nan
    y_nan, _, _ = _port(q, k_new, v_new, nan_k, nan_v, 0, pos)
    np.testing.assert_array_equal(y_nan, y_clean)


def test_cpu_path_counts_no_launch_and_rejects_gqa():
    q, k_new, v_new, k_cache, v_cache = _setup(64, s=32)
    before = A.decode_attention.launches
    _port(q, k_new, v_new, k_cache, v_cache, 0, 3)
    assert A.decode_attention.launches == before  # only kernel launches count
    t = [torch.from_numpy(a) for a in (q, k_new[:, :2], v_new[:, :2])]
    with pytest.raises(ValueError, match="GQA"):
        A.decode_attention(*t, torch.from_numpy(k_cache), torch.from_numpy(v_cache), 0, 3)
