"""The groupwise int4 formats and the plain versions of their kernels (K12
``matmul_int4``, K13 ``matmul_int4_packed``) against the JAX package, on the
CPU:

* ``quantize_int4_grouped``, ``dequantize_int4_grouped``, ``pack_int4`` /
  ``unpack_int4`` and ``quantize_params_int4`` / ``_packed`` are
  bit-identical to JAX's, for groupsizes 64 and 128.
* K12's and K13's plain versions at M = 1, 2, 8, 40 with bf16 and f32 x
  against JAX ``matmul_int4`` / ``matmul_int4_packed`` in interpret mode:
  each element within 1e-3 of max |ref| plus one bf16 ulp of the element
  (the same bf16 weights and products, f32 sums in another order, then the
  cast to x's dtype); and against JAX's f32 ``matmul_int4_reference``
  within 1e-2 of max |ref| (that route keeps x and the weights in f32).
* ``_linear`` on both leaf kinds: at M <= 256 through K12/K13 (their plain
  versions here) against JAX's CPU ``_linear`` (the f32 reference) within
  1e-2 of max |ref|; at M = 300 through the dense f32 route, as JAX takes
  it on every backend, within 1e-5 of max |ref|.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

KERNEL_TOL = 1e-3
F32_REF_TOL = 1e-2
LINEAR_TOL = 1e-2
DENSE_TOL = 1e-5
K, N = 256, 512


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These checks are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _bf16_ulp(ref):
    """One bf16 ulp of each element (2^(e - 8) for |v| = m 2^e, m in [0.5, 1))."""
    _, e = np.frexp(ref)
    return np.ldexp(1.0, e - 8)


def _weights(gs, seed=0):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    q, s, z = jqz.quantize_int4_grouped(w, gs)
    return rng, w, q, s, z


@pytest.mark.parametrize("gs", [64, 128])
def test_format_bit_identical_to_jax(gs):
    _, w, q, s, z = _weights(gs)
    tq, ts, tz = Q.quantize_int4_grouped(torch.from_numpy(np.array(w)), gs)
    for got, ref in ((tq, q), (ts, s), (tz, z)):
        assert got.dtype == torch.from_numpy(np.asarray(ref)).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(Q.dequantize_int4_grouped(tq, ts, tz, gs).numpy(),
                                  np.asarray(jqz.dequantize_int4_grouped(q, s, z, gs)))
    p = Q.pack_int4(tq)
    assert p.dtype == torch.uint8 and p.shape == (K // 2, N)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jqz.pack_int4(q)))
    np.testing.assert_array_equal(Q.unpack_int4(p).numpy(), np.asarray(jqz.unpack_int4(jqz.pack_int4(q))))

    jcfg = j_first_stage_config(n_layer=2, n_head=2, dim=256, intermediate_size=256, block_size=64,
                                vocab_sizes=(97,))
    jp = _jax_init(jax.random.PRNGKey(gs), cfg=jcfg, dtype=jnp.bfloat16)
    tp = _torch(jp)
    for jquant, quant in ((jqz.quantize_params_int4, Q.quantize_params_int4),
                          (jqz.quantize_params_int4_packed, Q.quantize_params_int4_packed)):
        ref, got = jax.tree.map(np.asarray, jquant(jp, groupsize=gs)), quant(tp, groupsize=gs)
        for key in ("wqkv", "wo", "w1", "w3", "w2"):
            leaf = got["layers"][key]
            assert Q.is_int4_grouped(leaf) and set(leaf) == set(ref["layers"][key])
            for field, arr in leaf.items():
                want = ref["layers"][key][field]
                assert arr.dtype == torch.from_numpy(want).dtype, (key, field)
                np.testing.assert_array_equal(arr.numpy(), want)
        assert got["wtes"][0].dtype == torch.bfloat16 and got["layers"]["attn_norm_w"] is tp["layers"]["attn_norm_w"]


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("gs", [64, 128])
def test_plain_versions_match_jax_interpret(gs, packed):
    rng, _, q, s, z = _weights(gs, seed=gs + packed)
    p = jqz.pack_int4(q)
    t = _torch({"w": p if packed else q, "s": s, "z": z})
    matmul = Q.matmul_int4_packed if packed else Q.matmul_int4
    for m in (1, 2, 8, 40):
        x32 = rng.normal(size=(m, K)).astype(np.float32)
        for dtype in (jnp.bfloat16, jnp.float32):
            x = jnp.asarray(x32, dtype)
            if packed:
                ref = jqz.matmul_int4_packed(x, p, s, z, groupsize=gs, tile_n=256, interpret=True)
            else:
                ref = jqz.matmul_int4(x, q, s, z, groupsize=gs, tile_n=256, interpret=True)
            ref = np.asarray(ref, np.float32)
            got = matmul(_torch({"x": x})["x"], t["w"], t["s"], t["z"], gs)
            assert got.shape == (m, N) and got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
            gap = np.abs(got.float().numpy() - ref)
            ulp = _bf16_ulp(ref) if dtype == jnp.bfloat16 else 0.0
            assert (gap <= KERNEL_TOL * np.abs(ref).max() + ulp).all(), (m, dtype, gap.max())
            f32 = np.asarray(jqz.matmul_int4_reference(x.astype(jnp.float32), q, s, z, gs))
            np.testing.assert_allclose(got.float().numpy(), f32, atol=F32_REF_TOL * np.abs(f32).max(), rtol=0)


@pytest.mark.parametrize("m", [3, 300])
@pytest.mark.parametrize("packed", [False, True], ids=["q", "p"])
def test_linear_routes_like_jax(packed, m, monkeypatch):
    rng, _, q, s, z = _weights(64, seed=m)
    jleaf = {"p": jqz.pack_int4(q), "scales": s, "zeros": z} if packed else {"q": q, "scales": s, "zeros": z}
    leaf = _torch(jleaf)
    kernel = "matmul_int4_packed" if packed else "matmul_int4"
    calls = []
    monkeypatch.setattr(tfm, kernel, lambda *a: calls.append(a) or getattr(Q, kernel)(*a))
    dtype = jnp.bfloat16 if m <= Q.INT4_KERNEL_MAX_ROWS else jnp.float32
    x = jnp.asarray(rng.normal(size=(1, m, K)).astype(np.float32), dtype)
    b = jnp.asarray(rng.normal(size=(N,)).astype(np.float32) * 0.1)
    ref = np.asarray(jtfm._linear(x, jleaf, b), np.float32)
    got = tfm._linear(_torch({"x": x})["x"], leaf, torch.from_numpy(np.asarray(b)))
    assert got.shape == (1, m, N) and got.dtype == (torch.bfloat16 if m <= 256 else torch.float32)
    tol = LINEAR_TOL if m <= Q.INT4_KERNEL_MAX_ROWS else DENSE_TOL
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * np.abs(ref).max(), rtol=0)
    assert len(calls) == (1 if m <= Q.INT4_KERNEL_MAX_ROWS else 0)
    if calls:
        assert calls[0][-1] == 64  # the groupsize, from the shapes
