"""The port's int8-in-int32 serving format, K8 and K7 (on the CPU their plain
versions) against the JAX package's ``ops/quantized.py`` and
``ops/decode_stack.py``, on the same numpy-seeded inputs.

* Packing and quantization are held BIT-IDENTICAL to the JAX package's: a
  ``cli quantize --mode int8`` ``.npz`` must load in both packages.
* The matmul is held to JAX's kernel in interpret mode within 1e-3 * max
  |ref| in every row, apart from one stated flip: the c term takes back
  about 128 * s * sum(x), and both sides round sum(x) to bf16 after summing
  it in f32 in their own order, so a row whose sum lies on a bf16 rounding
  boundary may round one ulp apart, which moves that row by |c| * ulp. Such
  a row passes if moving its bf16(sum x) one ulp either way brings it
  within the tolerance.
* The decode stack (L=2, H=8, Dh=128, B=2, S=256, D=1024, Ip=2048) is held
  to JAX's kernel in interpret mode, first one layer at a time: JAX's stack
  runs as a chain of L=1 calls (bit-identical to its L=2 call), and the
  port's plain version runs each layer alone, fed JAX's residual stream and
  that layer's cache. Each row of such a layer's x within 1e-2 * max |ref|,
  or so once moved by a power of two times the c row of wo or of w2, that
  move itself within 2e-2 * max |ref|: the two products that feed the
  residual stream directly, where a bf16(sum) one ulp apart moves a whole
  row by |c| * ulp (measured: 1.25% of max |ref| in one of ten layers, 0.64%
  once moved back); its written cache rows within one bf16 ulp plus 1e-3 of
  the row's largest value (their entries come from cancelling sums). Then
  the whole stack:
  both round at the same points, but their f32 sums run in other orders, so
  a bf16 rounding of a residual or hidden state can land one ulp apart; the
  next layer's input then differs by such flips, which can move one of its
  bf16(sum x) by an ulp and so a whole output row by |c| * ulp. Hence:
  x_out within 5e-2 * max |ref| (the whole-stack tolerance of the int4
  stack on the card; measured here up to 2.5%, in the case where layer 1's
  k/v rows moved so); every layer's rows within rtol 1e-2 and atol
  2e-2 * max |ref| (measured up to 2.0% of the row's largest value); every
  other slot bit-identical.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from chip_smoke import k8_row_gap  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu.ops.decode_stack import decode_stack_int4 as jax_decode_stack  # noqa: E402
from metavoice_tpu.utils import checkpoint as jckpt  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import decode_stack as DS  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

# the JAX kernel in interpret mode, compiled once a shape (pos is traced) and shared by the cases
_jax_stack = jax.jit(jax_decode_stack, static_argnames=("n_head", "n_kv_head", "norm_eps", "wfmt", "interpret"))
_jax_q8 = jax.jit(jax.vmap(jqz.quantize_int8_i32))  # the JAX quantizer of the stack's inputs, compiled once a shape

K8_TOL = 1e-3
K7_LAYER_TOL = 1e-2
K7_TOL = 5e-2


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


def _t(a):
    """numpy (ml_dtypes bf16 included) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def test_pack_unpack_roundtrip_matches_jax():
    q = np.random.default_rng(0).integers(-128, 128, size=(1024, 16), dtype=np.int8)
    p8 = Q.pack_int8_i32(torch.from_numpy(q))
    assert p8.shape == (256, 16) and p8.dtype == torch.int32
    np.testing.assert_array_equal(p8.numpy(), np.asarray(jqz.pack_int8_i32(jnp.asarray(q))))
    np.testing.assert_array_equal(Q.unpack_int8_i32(p8).numpy(), q)


@pytest.mark.parametrize("shape", [(1024, 512), (1282, 384), (2048, 300)])
def test_quantize_int8_i32_bit_identical(shape):
    """(1282, 384): an off-grid K, zero-padded to 1284; bf16 weights as the
    serving trees hold them."""
    w = (np.random.default_rng(shape[0]).normal(size=shape) * 0.05).astype(np.float32)
    jp8, jsc8 = jqz.quantize_int8_i32(jnp.asarray(w, jnp.bfloat16))
    p8, sc8 = Q.quantize_int8_i32(torch.from_numpy(w).to(torch.bfloat16))
    assert p8.shape == (-(-shape[0] // 4), shape[1]) and sc8.shape == (16, shape[1])
    np.testing.assert_array_equal(p8.numpy(), _np(jp8))
    np.testing.assert_array_equal(_tnp(sc8), _np(jsc8))


def _params(rng, d=1024, n_layer=2, inter=2816, vocab=200):
    """A first-stage-like tree: the FFN width pads to 3072."""

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


@pytest.fixture(scope="module")
def quantized_pair():
    p = _params(np.random.default_rng(4))
    jq = jqz.quantize_params_int8_i32(jax.tree.map(jnp.asarray, p))
    tq = Q.quantize_params_int8_i32(ckpt.params_from_numpy(p, device="cpu"))
    return jq, tq


def test_quantize_params_int8_i32_bit_identical(quantized_pair):
    jq, tq = quantized_pair
    jf, tf = _flat(jq), _flat(tq)
    assert set(jf) == set(tf) and "lm_head_q" not in tq
    assert tq["layers"]["w1"]["p8"].shape == (2, 256, 3072)  # FFN 2816 padded on out
    assert tq["layers"]["w2"]["p8"].shape == (2, 3072 // 4, 1024)  # and on K
    for k in jf:
        np.testing.assert_array_equal(_tnp(tf[k]), _np(jf[k]), err_msg=k)
    # pad columns dequantize to exactly 0
    assert not tq["layers"]["w1"]["sc8"][..., 2816:].any()
    assert not tq["layers"]["w3"]["sc8"][..., 2816:].any()
    assert Q.is_int8_i32(tq["layers"]["wqkv"]) and not Q.is_int4(tq["layers"]["wqkv"])


def test_jax_npz_loads_identically(quantized_pair, tmp_path):
    jq, tq = quantized_pair
    path = str(tmp_path / "q8.npz")
    jckpt.save_npz(path, jax.tree.map(np.asarray, jq), meta={"quantisation_mode": "int8"})
    tree, meta = ckpt.load_npz(path)
    assert meta == {"quantisation_mode": "int8"}
    lf, tf = _flat(tree), _flat(tq)
    assert set(lf) == set(tf)
    for k in lf:
        assert lf[k].dtype == tf[k].dtype, k
        np.testing.assert_array_equal(_tnp(lf[k]), _tnp(tf[k]), err_msg=k)


def test_params_from_numpy_keeps_packed_int8_leaves(quantized_pair):
    """dtype= casts the float leaves, but not the packed int8 ones."""
    jq, _ = quantized_pair
    tree = ckpt.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu", dtype=torch.float32)
    assert tree["layers"]["wqkv"]["sc8"].dtype == torch.bfloat16
    assert tree["layers"]["wqkv"]["p8"].dtype == torch.int32
    assert tree["wtes"][0].dtype == torch.float32 and tree["ln_f_w"].dtype == torch.float32


def assert_k8_close(got, ref, x, sc8, tol=K8_TOL):
    """Every row within tol * max |ref|, or so once its bf16(sum x) moves one
    ulp either way (the sum-order flip the module docstring states)."""
    gap = k8_row_gap(torch, got.float(), ref.float(), x, sc8)
    assert gap <= tol, gap


@pytest.mark.parametrize("m", [1, 5, 300])
@pytest.mark.parametrize("n", [256, 384])
def test_matmul_matches_jax_kernel(m, n):
    rng = np.random.default_rng(m * n)
    k = 1024
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    x = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    jp8, jsc8 = jqz.quantize_int8_i32(jnp.asarray(w))
    kernel = np.asarray(jqz.matmul_int8_i32(jnp.asarray(x), jp8, jsc8, interpret=True))
    before = Q.matmul_int8_i32.launches
    ours = Q.matmul_int8_i32(torch.from_numpy(x), _t(jp8), _t(jsc8))
    assert Q.matmul_int8_i32.launches == before  # CPU tensors take the plain version
    assert ours.dtype == torch.float32 and ours.shape == (m, n)
    assert_k8_close(ours, torch.from_numpy(kernel.copy()), torch.from_numpy(x), _t(jsc8))


def test_linear_zero_pads_an_off_grid_k():
    """K = 1282 packs to 1284 word rows x 4; _linear pads the activations
    with zeros, which add nothing to the byte product or to sum(x). JAX's
    CPU _linear takes its unrounded-sum reference: held within 2e-2."""
    rng = np.random.default_rng(9)
    w = (rng.normal(size=(1282, 256)) * 0.05).astype(np.float32)
    x = (rng.normal(size=(2, 3, 1282)) * 0.5).astype(np.float32)
    p8, sc8 = Q.quantize_int8_i32(torch.from_numpy(w))
    leaf = {"p8": p8, "sc8": sc8}
    got = tfm._linear(torch.from_numpy(x), leaf)
    assert got.shape == (2, 3, 256) and got.dtype == torch.float32
    padded = torch.nn.functional.pad(torch.from_numpy(x).reshape(6, 1282), (0, 2))
    want = Q.matmul_int8_i32_reference(padded, p8, sc8).reshape(2, 3, 256)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    jaxed = np.asarray(jtfm._linear(jnp.asarray(x), {"p8": jnp.asarray(p8.numpy()),
                                                      "sc8": jnp.asarray(_tnp(sc8).view(jnp.bfloat16))}))
    np.testing.assert_allclose(got.numpy(), jaxed, atol=2e-2 * np.abs(jaxed).max(), rtol=0)


def test_matmul_refuses_bad_shapes():
    p8 = torch.zeros((256, 64), dtype=torch.int32)
    sc8 = torch.zeros((16, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        Q.matmul_int8_i32(torch.zeros((2, 512)), p8, sc8)  # K is not 4 * p8 rows
    with pytest.raises(ValueError):
        Q.matmul_int8_i32(torch.zeros((2, 1024)), p8, sc8[:, :32])


# ------------------------------------------------------------------ K7, the int8 decode stack

L, H, DH, B, S = 2, 8, 128, 2, 256
D = H * DH  # 1024
IP = 2048
EPS = 1e-5


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@functools.lru_cache(maxsize=None)  # the JAX quantizer runs once a seed
def _stack_inputs(seed, h_kv=H):
    """numpy inputs in the JAX package's layout, packed by the JAX quantizer."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.02):
        return rng.normal(size=shape).astype(np.float32) * s

    def q8(arr):
        p8, sc8 = _jax_q8(jnp.asarray(arr))
        return np.asarray(p8), _bf16(sc8)

    qout = D + 2 * h_kv * DH
    return {
        "wqkv": q8(w(L, D, qout)), "wo": q8(w(L, D, D)), "w1": q8(w(L, D, IP)),
        "w3": q8(w(L, D, IP)), "w2": q8(w(L, IP, D)),
        "n1": _bf16(1.0 + w(L, D, s=0.1)), "n2": _bf16(1.0 + w(L, D, s=0.1)),
        "x": _bf16(w(B, D, s=0.3)),
        "k": _bf16(w(L, S, B, h_kv, DH, s=1.0)), "v": _bf16(w(L, S, B, h_kv, DH, s=1.0)),
    }


def _mats(inp):
    return [t for k in ("wqkv", "wo", "w1", "w3", "w2") for t in inp[k]]


def _check_rows(ref, ours, pos, layer=0):
    """The cache rows written at pos in one layer: within one bf16 ulp plus
    1e-3 of the row's largest value."""
    for i, name in ((1, "k"), (2, "v")):
        row, ref_row = ours[i][layer, pos], ref[i][layer, pos]
        excess = np.abs(row - ref_row) - np.abs(ref_row) * 2.0**-7  # beyond one bf16 ulp
        assert excess.max() <= 1e-3 * np.abs(ref_row).max(), (name, layer, excess.max())


def _assert_layer_close(got, ref, mats):
    """One layer's x, row by row, within K7_LAYER_TOL * max |ref|, or so once
    moved by one of the flips the module docstring states."""
    atol = K7_LAYER_TOL * np.abs(ref).max()
    shifts = [np.zeros(ref.shape[-1], np.float32)]
    for sc8 in (mats[3], mats[9]):  # wo, w2
        c = np.asarray(sc8, np.float32)[0, sc8.shape[1] // 2]
        shifts += [sign * 2.0**e * c for sign in (1, -1) for e in range(-20, 8)
                   if 2.0**e * np.abs(c).max() <= 2 * atol]
    d = got - ref
    row_gap = np.min([np.abs(d - sh).max(-1) for sh in shifts], axis=0)
    assert row_gap.max() <= atol, (row_gap, atol)


def _run_both(inp, pos, h_kv=H, starts=None):
    """JAX's stack one layer at a time, each of the port's layers alone held
    to it; -> JAX's whole step and the port's, as f32 numpy."""
    jkw = dict(n_kv_head=h_kv, norm_eps=EPS, wfmt="i8", interpret=True)
    tkw = dict(n_kv_head=h_kv, norm_eps=EPS, wfmt="i8")
    if starts is not None:
        jkw["starts"] = jnp.asarray(starts, jnp.int32)
        tkw["starts"] = torch.tensor(starts, dtype=torch.int32)
    before = (DS.decode_stack_int4.launches, DS.decode_stack_int4.launches_i8)
    x, ks, vs = inp["x"], [], []
    for li in range(L):
        one = {k: inp[k][li : li + 1] for k in ("n1", "n2", "k", "v")}
        mats = [m[li : li + 1] for m in _mats(inp)]
        ref = _jax_stack(
            jnp.asarray(x), jnp.asarray(one["n1"]), jnp.asarray(one["n2"]),
            *[jnp.asarray(m) for m in mats], jnp.asarray(one["k"]), jnp.asarray(one["v"]),
            jnp.asarray(pos, jnp.int32), H, **jkw,
        )
        ref = [np.asarray(r) for r in ref]
        ours = DS.decode_stack_int4(
            _t(x), _t(one["n1"]), _t(one["n2"]), *[_t(m) for m in mats],
            _t(one["k"]), _t(one["v"]), pos, H, **tkw,
        )
        ref32, ours32 = [r.astype(np.float32) for r in ref], [o.float().numpy() for o in ours]
        _assert_layer_close(ours32[0], ref32[0], mats)
        _check_rows(ref32, ours32, pos)
        x = ref[0]
        ks.append(ref[1])
        vs.append(ref[2])
    ours = DS.decode_stack_int4(
        _t(inp["x"]), _t(inp["n1"]), _t(inp["n2"]), *[_t(m) for m in _mats(inp)],
        _t(inp["k"]), _t(inp["v"]), pos, H, **tkw,
    )
    # CPU tensors take the plain version
    assert (DS.decode_stack_int4.launches, DS.decode_stack_int4.launches_i8) == before
    assert len(ours) == 3
    ref = (x, np.concatenate(ks), np.concatenate(vs))
    return [np.asarray(r, np.float32) for r in ref], [o.float().numpy() for o in ours]


def _check_step(ref, ours, inp, pos):
    np.testing.assert_allclose(ours[0], ref[0], atol=K7_TOL * np.abs(ref[0]).max(), rtol=0)
    _check_rows(ref, ours, pos)
    for i, name in ((1, "k"), (2, "v")):
        np.testing.assert_allclose(ours[i][:, pos], ref[i][:, pos], rtol=1e-2,
                                   atol=2e-2 * np.abs(ref[i][:, pos]).max())
        others = np.arange(S) != pos
        orig = np.asarray(inp[name], np.float32)[:, others]
        np.testing.assert_array_equal(ours[i][:, others], orig)
        np.testing.assert_array_equal(ref[i][:, others], orig)


@pytest.mark.parametrize("pos", [0, 100, 255])
def test_int8_stack_matches_jax(pos):
    inp = _stack_inputs(pos)
    ref, ours = _run_both(inp, pos)
    _check_step(ref, ours, inp, pos)


def test_int8_stack_respects_starts():
    inp = _stack_inputs(3)
    ref, ours = _run_both(inp, 200, starts=(0, 150))
    _check_step(ref, ours, inp, 200)


def test_int8_stack_gqa_matches_jax():
    """GQA with 4 kv heads for 8 query heads (the JAX kernel needs B * H_kv
    to fill its 8 sublanes)."""
    inp = _stack_inputs(5, h_kv=4)
    ref, ours = _run_both(inp, 130, h_kv=4)
    _check_step(ref, ours, inp, 130)


def test_int8_stack_refuses_a_head_and_int4_words():
    inp = _stack_inputs(0)
    mats = [_t(m) for m in _mats(inp)]
    args = (_t(inp["x"]), _t(inp["n1"]), _t(inp["n2"]), *mats, _t(inp["k"]), _t(inp["v"]), 0, H)
    head = dict(ln_f_w=torch.ones(D), head_pw=torch.zeros((D // 8, 1024), dtype=torch.int32),
                head_sc=torch.zeros((16, 1024), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head"):
        DS.decode_stack_int4(*args, wfmt="i8", **head)
    with pytest.raises(ValueError):  # int8 words read as int4 ones: K/8 rows expected
        DS.decode_stack_int4(*args, wfmt="i4")
    with pytest.raises(ValueError, match="wfmt"):
        DS.decode_stack_int4(*args, wfmt="i2")
