"""The per-layer int4 kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, on the CPU (the ``tests/test_kv8_packed.py`` and
``tests/test_gqa_kernels.py`` setups at 2 layers, D = 1024, 8 heads of 128,
FFN 2048, S = 256, the CFG pair):

* K5 ``decode_attention_block_int4`` for a bf16, an int8 and a packed cache,
  MHA and GQA (2 kv heads), at pos 0, 77 and 255, with and without starts.
  y within 2e-2 of max |y|: the port's plain version takes the products in
  f32 where JAX rounds each bf16 product, and its softmax uses the window's
  maximum where JAX's runs online over chunks, so bf16 roundings of the
  value weights land apart. Every cache byte and scale other than the new
  row's is identical; the new row's int8 values are within one step and its
  scales within 1e-6 relative (bf16 cache: within one bf16 ulp, or 1e-4 of
  the row's max where a value near 0 cancels), since its f32 qkv sums run
  in another order.
* K6 ``decode_ffn_int4`` within 1e-2 of max |y| (the same arithmetic; f32
  sums in another order and the SwiGLU rounding to bf16 between them).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

B, H, DH, S, L, IP = 2, 8, 128, 256, 2, 2048
D = H * DH
LAYER = 1
Y_TOL = 2e-2
FFN_TOL = 1e-2
STARTS = {0: (0, 0), 77: (10, 40), 255: (100, 200)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These steps are many small CPU ops: beside other test processes, a
    pool of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _packed(rng, shapes):
    """Seeded (L, K, N) weights packed by the port's int4 quantizer (bit-
    identical to the JAX package's, tests/test_torch_quantized.py) -> (the
    port's layers, the same arrays for JAX)."""
    dense = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.03) for k, shape in shapes.items()}
    lay = Q.quantize_params_int4_i32({"layers": dense})["layers"]
    to_jax = {torch.int32: lambda t: jnp.asarray(t.numpy()),
              torch.bfloat16: lambda t: jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))}
    return lay, {k: {f: to_jax[t.dtype](t) for f, t in w.items()} for k, w in lay.items()}


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _cache(rng, fmt, h_kv):
    """A filled cache in the JAX layout: (k, v, k_scale, v_scale) numpy."""
    shape = (L, S, B, h_kv, DH)
    if fmt == "bf16":
        return [np.asarray(jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16))
                for _ in range(2)] + [None, None]
    width = 128
    vals = [rng.integers(-127, 128, size=shape, dtype=np.int8) for _ in range(2)]
    scales = [np.zeros((L, S, 1, width), np.float32) for _ in range(2)]
    for sc in scales:
        sc[..., : B * h_kv] = rng.uniform(0.005, 0.03, size=(L, S, 1, B * h_kv))
    if fmt == "int8":
        return vals + scales
    words = [np.asarray(jax.vmap(jtfm.pack_kv_s)(jnp.asarray(v))) for v in vals]
    tables = [np.ascontiguousarray(sc.reshape(L, S // 4, 4, 1, width).transpose(0, 2, 1, 3, 4)) for sc in scales]
    return words + tables


def _unpack(words):
    """(L, S/4, ...) int32 words -> (L, S, ...) int32 values."""
    w = np.asarray(words)
    vals = np.stack([(w << (24 - 8 * j)) >> 24 for j in range(4)], axis=2)
    return vals.reshape(w.shape[0], -1, *w.shape[2:])


def _positions(fmt, table):
    """A scale table as (L, S, W), position-major."""
    t = np.asarray(table)
    return t[:, :, 0] if fmt == "int8" else t[:, :, :, 0].transpose(0, 2, 1, 3).reshape(L, S, -1)


@pytest.fixture(scope="module", params=[(f, h) for f in ("bf16", "int8", "packed") for h in (8, 2)],
                ids=lambda p: f"{p[0]}-kv{p[1]}")
def block_case(request):
    """Weights, a filled cache and JAX's jitted interpret-mode kernel."""
    fmt, h_kv = request.param
    rng = np.random.default_rng(5 + h_kv + len(fmt))
    w, qp = _packed(rng, {"wqkv": (L, D, D + 2 * h_kv * DH), "wo": (L, D, D)})
    cache = _cache(rng, fmt, h_kv)

    @jax.jit
    def run(xa, k, v, ks, vs, pos, starts):
        return JA.decode_attention_block_int4(
            xa, qp["wqkv"]["pw"], qp["wqkv"]["sc"], qp["wo"]["pw"], qp["wo"]["sc"], k, v,
            jnp.asarray(LAYER, jnp.int32), pos, H, starts=starts, interpret=True, k_scale=ks, v_scale=vs,
            n_kv_head=h_kv)

    return fmt, h_kv, w, cache, run, rng


@pytest.mark.parametrize("with_starts", [False, True], ids=["no-starts", "starts"])
@pytest.mark.parametrize("pos", [0, 77, 255])
def test_block_plain_version_matches_jax_interpret(block_case, pos, with_starts):
    fmt, h_kv, w, cache, run, rng = block_case
    bkv = B * h_kv
    xa = rng.normal(size=(B, D)).astype(np.float32)
    starts = np.asarray(STARTS[pos] if with_starts else (0, 0), np.int32)
    xa_b = jnp.asarray(xa, jnp.bfloat16)
    jy, jk, jv, jks, jvs = run(xa_b, *[None if c is None else jnp.asarray(c) for c in cache],
                               jnp.asarray(pos, jnp.int32), jnp.asarray(starts))
    t = _torch({"x": np.asarray(xa_b), "c": [c for c in cache if c is not None]})
    kc, vc, *sc = t["c"]
    ks, vs = sc if sc else (None, None)
    y, kc, vc, ks, vs = A.decode_attention_block_int4(
        t["x"], w["wqkv"]["pw"], w["wqkv"]["sc"], w["wo"]["pw"], w["wo"]["sc"], kc, vc, LAYER, pos, H,
        n_kv_head=h_kv, starts=torch.from_numpy(starts) if with_starts else None, k_scale=ks, v_scale=vs)
    assert y.dtype == torch.bfloat16 and y.shape == (B, D)
    _close(y.float().numpy(), np.asarray(jy, np.float32), Y_TOL)

    others = np.ones(S, bool)
    others[pos] = False
    if fmt == "bf16":
        for got, ref in ((kc, jk), (vc, jv)):
            got, ref = got.float().numpy(), np.asarray(ref, np.float32)
            np.testing.assert_array_equal(got[:, others], ref[:, others])
            np.testing.assert_array_equal(got[np.arange(L) != LAYER], ref[np.arange(L) != LAYER])
            row, ref_row = got[LAYER, pos], ref[LAYER, pos]
            # one bf16 ulp, and 1e-4 of the row's max for values near 0 that cancel in f32
            assert (np.abs(row - ref_row) <= np.abs(ref_row) * 2.0**-7 + 1e-4 * np.abs(ref_row).max()).all()
        return
    for got, ref, gs, rs in ((kc, jk, ks, jks), (vc, jv, vs, jvs)):
        got = _unpack(got.numpy()) if fmt == "packed" else got.numpy().astype(np.int32)
        ref = _unpack(ref) if fmt == "packed" else np.asarray(ref).astype(np.int32)
        np.testing.assert_array_equal(got[:, others], ref[:, others])
        np.testing.assert_array_equal(got[np.arange(L) != LAYER], ref[np.arange(L) != LAYER])
        assert np.abs(got[LAYER, pos] - ref[LAYER, pos]).max() <= 1
        gs, rs = _positions(fmt, gs.numpy()), _positions(fmt, rs)
        np.testing.assert_array_equal(gs[:, others], rs[:, others])
        np.testing.assert_array_equal(gs[LAYER, pos, bkv:], rs[LAYER, pos, bkv:])  # the padding stays 0
        np.testing.assert_allclose(gs[LAYER, pos, :bkv], rs[LAYER, pos, :bkv], rtol=1e-6, atol=0)
        assert (gs[LAYER, pos, :bkv] > 0).all()


def test_ffn_plain_version_matches_jax_interpret():
    rng = np.random.default_rng(9)
    w, qp = _packed(rng, {"w1": (L, D, IP), "w3": (L, D, IP), "w2": (L, IP, D)})
    mats = [qp[k][f] for k in ("w1", "w3", "w2") for f in ("pw", "sc")]
    run = jax.jit(lambda x, li: jqz.decode_ffn_int4(x, *mats, li, interpret=True))
    tmats = [w[k][f] for k in ("w1", "w3", "w2") for f in ("pw", "sc")]
    for layer in range(L):
        x = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32), jnp.bfloat16)
        ref = np.asarray(run(x, jnp.asarray(layer, jnp.int32)))
        got = Q.decode_ffn_int4(_torch({"x": np.asarray(x)})["x"], *tmats, layer)
        assert got.dtype == torch.float32 and got.shape == (B, D)
        _close(got.numpy(), ref, FFN_TOL)
