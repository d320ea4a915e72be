"""The port's int4-in-int32 serving format and K2 (on the CPU its plain
version) against the JAX package's ``ops/quantized.py``, on the same
numpy-seeded inputs.

Packing and quantization are held BIT-IDENTICAL to the JAX package's: a
``cli quantize`` ``.npz`` must load in both packages. The matmul is held to
JAX's kernel in interpret mode (atol 1e-2 * max |ref|, rtol 1e-2: the same
arithmetic, f32 sums in another order) and to JAX's dense-dequant reference
(atol and rtol 5e-2 * max |ref|, as ``tests/test_int4_i32.py`` allows it:
that reference neither rounds x to bf16 nor the group sums).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu.utils import checkpoint as jckpt  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ckpt  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    """JAX array -> numpy; bf16 -> its bits as int16, so equality is bitwise."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16_t(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def test_pack_unpack_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, size=(1024, 16), dtype=np.int8)
    pw = Q.pack_int4_i32(torch.from_numpy(q))
    assert pw.shape == (128, 16) and pw.dtype == torch.int32
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jqz.pack_int4_i32(jnp.asarray(q))))
    np.testing.assert_array_equal(Q.unpack_int4_i32(pw).numpy(), q)


@pytest.mark.parametrize("shape", [(1024, 512), (704, 16), (2048, 300)])
def test_quantize_int4_i32_bit_identical(shape):
    """(704, 16): an unaligned K, zero-padded to 1024 with zeroed pad groups."""
    w = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32) * 0.05
    jpw, jsc = jqz.quantize_int4_i32(jnp.asarray(w))
    pw, sc = Q.quantize_int4_i32(torch.from_numpy(w))
    assert sc.dtype == torch.bfloat16 and pw.shape[0] * 8 % 1024 == 0
    np.testing.assert_array_equal(pw.numpy(), _np(jpw))
    np.testing.assert_array_equal(_tnp(sc), _np(jsc))


def _params(rng, d=1024, n_layer=2, inter=2816, vocab=200):
    """A first-stage-like tree: the FFN width pads to 3072, the tied head to 1024."""

    def w(*shape):
        return (rng.normal(size=shape) * 0.02).astype(np.float32)

    return {
        "wtes": [w(vocab, d)],
        "wpe": w(64, d),
        "layers": {
            "attn_norm_w": np.ones((n_layer, d), np.float32),
            "wqkv": w(n_layer, d, 3 * d), "wo": w(n_layer, d, d),
            "ffn_norm_w": np.ones((n_layer, d), np.float32),
            "w1": w(n_layer, d, inter), "w3": w(n_layer, d, inter), "w2": w(n_layer, inter, d),
        },
        "ln_f_w": np.ones((d,), np.float32),
    }


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def quantized_pair():
    p = _params(np.random.default_rng(4))
    jq = jqz.quantize_params_int4_i32(jax.tree.map(jnp.asarray, p))
    tq = Q.quantize_params_int4_i32(
        {k: ([torch.from_numpy(v) for v in x] if isinstance(x, list) else
             {kk: torch.from_numpy(vv) for kk, vv in x.items()} if isinstance(x, dict) else torch.from_numpy(x))
         for k, x in p.items()}
    )
    return jq, tq


def test_quantize_params_int4_i32_bit_identical(quantized_pair):
    jq, tq = quantized_pair
    jf, tf = _flat(jq), _flat(tq)
    assert set(jf) == set(tf)
    assert tq["layers"]["w1"]["pw"].shape == (2, 128, 3072)  # FFN 2816 padded
    assert tq["layers"]["w2"]["pw"].shape == (2, 3072 // 8, 1024)
    assert tq["lm_head_q"]["pw"].shape == (128, 1024)  # vocab 200 padded
    for k in jf:
        np.testing.assert_array_equal(_tnp(tf[k]), _np(jf[k]), err_msg=k)
    # pad columns dequantize to exactly 0
    assert not tq["layers"]["w1"]["sc"][..., 2816:].any()
    assert not tq["lm_head_q"]["sc"][:, 200:].any()


def test_jax_npz_loads_identically(quantized_pair, tmp_path):
    jq, tq = quantized_pair
    path = str(tmp_path / "q.npz")
    jckpt.save_npz(path, jax.tree.map(np.asarray, jq), meta={"quantisation_mode": "int4"})
    tree, meta = ckpt.load_npz(path)
    assert meta == {"quantisation_mode": "int4"}
    lf, tf = _flat(tree), _flat(tq)
    assert set(lf) == set(tf)
    for k in lf:
        assert lf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(_tnp(lf[k]), _tnp(tf[k]), err_msg=k)


def test_params_from_numpy_keeps_packed_leaves(quantized_pair):
    """dtype= casts the float leaves, but not the packed int4 ones."""
    jq, _ = quantized_pair
    tree = ckpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu", dtype=torch.float32)
    assert tree["layers"]["wqkv"]["sc"].dtype == torch.bfloat16
    assert tree["layers"]["wqkv"]["pw"].dtype == torch.int32
    assert tree["lm_head_q"]["sc"].dtype == torch.bfloat16
    assert tree["wtes"][0].dtype == torch.float32 and tree["ln_f_w"].dtype == torch.float32


@pytest.mark.parametrize("m", [1, 8, 200, 300])
def test_matmul_matches_jax_kernel(m):
    rng = np.random.default_rng(m)
    k, n = 1024, 512
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    jpw, jsc = jqz.quantize_int4_i32(jnp.asarray(w))
    kernel = np.asarray(jqz.matmul_int4_i32(jnp.asarray(x), jpw, jsc, interpret=True))
    dense = np.asarray(jqz.matmul_int4_i32_reference(jnp.asarray(x), jpw, jsc))
    before = Q.matmul_int4_i32.launches
    ours = Q.matmul_int4_i32(torch.from_numpy(x), torch.from_numpy(_np(jpw).copy()), _bf16_t(jsc))
    assert Q.matmul_int4_i32.launches == before  # CPU tensors take the plain version
    assert ours.dtype == torch.float32 and ours.shape == (m, n)
    ours = ours.numpy()
    np.testing.assert_allclose(ours, kernel, atol=1e-2 * np.abs(kernel).max(), rtol=1e-2)
    np.testing.assert_allclose(ours, dense, atol=5e-2 * np.abs(dense).max(), rtol=5e-2)


def test_matmul_refuses_bad_shapes():
    pw = torch.zeros((128, 64), dtype=torch.int32)
    sc = torch.zeros((16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        Q.matmul_int4_i32(torch.zeros((2, 512)), pw, sc)  # K is not 8 * pw rows
    with pytest.raises(ValueError):
        Q.matmul_int4_i32(torch.zeros((2, 1024)), pw, sc[:, :32])
