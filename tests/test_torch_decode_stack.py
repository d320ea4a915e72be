"""The port's int4 decode stack (K3; on the CPU its plain version) against
the JAX package's ``decode_stack_int4`` run in interpret mode, on the same
numpy-seeded inputs: the ``tests/test_decode_stack.py`` setup (L=3, H=8,
Dh=128, B=2, S=512, D=1024, Ip=2048).

Tolerances: x_out and the written cache rows within rtol 1e-2 and atol
2e-2 * max |ref|; fused-head logits within rtol 2e-2 and atol 2e-2 * max
|ref|; every other cache slot bit-identical; vocab pad logits exactly 0.
Both sides round at the same points, but the port's f32 sums run in another
order, so a bf16 rounding of a layer's residual or hidden state can land one
ulp apart, and later layers carry that as an absolute error of an ulp of
the intermediate's size: hence atol scaled by max |ref| (measured: at most
about 1% of max |ref| here). Weights are normal(0.02), the reference init.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu.ops.decode_stack import decode_stack_int4 as jax_decode_stack  # noqa: E402
from metavoice_tpu_torch.ops import decode_stack as DS  # noqa: E402

# the JAX kernel in interpret mode, compiled once a shape (pos and starts are traced) and shared by the cases
_jax_stack = jax.jit(jax_decode_stack, static_argnames=("n_head", "n_kv_head", "norm_eps", "wfmt", "interpret"))
_jax_q4 = jax.jit(jax.vmap(jqz.quantize_int4_i32))  # the JAX quantizer, compiled once a shape

L, H, DH, B, S = 3, 8, 128, 2, 512
D = H * DH  # 1024
IP = 2048
EPS = 1e-5
VOCAB, VP = 200, 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


@functools.lru_cache(maxsize=None)  # the JAX quantizer runs once a seed
def _setup(seed, h_kv=H, head=False):
    """numpy inputs in the JAX package's layout, packed by the JAX quantizer."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.02):
        return rng.normal(size=shape).astype(np.float32) * s

    def q4(arr):
        pw, sc = _jax_q4(jnp.asarray(arr))
        return np.asarray(pw), _bf16(sc)

    qout = D + 2 * h_kv * DH
    inp = {
        "wqkv": q4(w(L, D, qout)), "wo": q4(w(L, D, D)), "w1": q4(w(L, D, IP)),
        "w3": q4(w(L, D, IP)), "w2": q4(w(L, IP, D)),
        "n1": _bf16(1.0 + w(L, D, s=0.1)), "n2": _bf16(1.0 + w(L, D, s=0.1)),
        "x": _bf16(w(B, D, s=0.3)),
        "k": _bf16(w(L, S, B, h_kv, DH, s=1.0)), "v": _bf16(w(L, S, B, h_kv, DH, s=1.0)),
    }
    if head:
        wte = w(VOCAB, D)
        wt = np.concatenate([wte.T, np.zeros((D, VP - VOCAB), np.float32)], axis=1)
        hpw, hsc = jqz.quantize_int4_i32(jnp.asarray(wt))
        hsc = jnp.where((jnp.arange(VP) < VOCAB)[None, :], hsc, 0.0)
        inp["head"] = (_bf16(1.0 + w(D, s=0.1)), np.asarray(hpw), _bf16(hsc))
    return inp


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _run_both(inp, pos, h_kv=H, starts=None):
    mats = [t for k in ("wqkv", "wo", "w1", "w3", "w2") for t in inp[k]]
    # JAX's kernel takes no starts as zeros: given them, the cases with and without starts share its compile
    jkw = dict(n_kv_head=h_kv, norm_eps=EPS, interpret=True, starts=jnp.asarray(starts or (0,) * B, jnp.int32))
    tkw = dict(n_kv_head=h_kv, norm_eps=EPS)
    if starts is not None:
        tkw["starts"] = torch.tensor(starts, dtype=torch.int32)
    if "head" in inp:
        lnf, hpw, hsc = inp["head"]
        jkw.update(ln_f_w=jnp.asarray(lnf), head_pw=jnp.asarray(hpw), head_sc=jnp.asarray(hsc))
        tkw.update(ln_f_w=_t(lnf), head_pw=_t(hpw), head_sc=_t(hsc))
    ref = _jax_stack(
        jnp.asarray(inp["x"]), jnp.asarray(inp["n1"]), jnp.asarray(inp["n2"]),
        *[jnp.asarray(m) for m in mats], jnp.asarray(inp["k"]), jnp.asarray(inp["v"]),
        jnp.asarray(pos, jnp.int32), H, **jkw,
    )
    kc, vc = _t(inp["k"]), _t(inp["v"])
    before = DS.decode_stack_int4.launches
    ours = DS.decode_stack_int4(
        _t(inp["x"]), _t(inp["n1"]), _t(inp["n2"]), *[_t(m) for m in mats], kc, vc, pos, H, **tkw
    )
    assert DS.decode_stack_int4.launches == before  # CPU tensors take the plain version
    return [np.asarray(r, np.float32) for r in ref], [o.float().numpy() for o in ours]


def _close(got, ref, rtol, atol_of_max=2e-2):
    np.testing.assert_allclose(got, ref, atol=atol_of_max * np.abs(ref).max(), rtol=rtol)


def _check_step(ref, ours, inp, pos):
    _close(ours[0], ref[0], 1e-2)
    for i, name in ((1, "k"), (2, "v")):
        _close(ours[i][:, pos], ref[i][:, pos], 1e-2)
        others = np.arange(S) != pos
        orig = np.asarray(inp[name], np.float32)[:, others]
        np.testing.assert_array_equal(ours[i][:, others], orig)
        np.testing.assert_array_equal(ref[i][:, others], orig)


@pytest.mark.parametrize("pos", [0, 100, 300])
def test_stack_matches_jax(pos):
    inp = _setup(0)
    ref, ours = _run_both(inp, pos)
    _check_step(ref, ours, inp, pos)


def test_stack_respects_starts():
    inp = _setup(3)
    ref, ours = _run_both(inp, 200, starts=(0, 150))
    _check_step(ref, ours, inp, 200)


def test_stack_fused_head_matches_jax():
    inp = _setup(7, head=True)
    ref, ours = _run_both(inp, 64)
    _check_step(ref, ours, inp, 64)
    assert ours[3].shape == (B, VP)
    _close(ours[3][:, :VOCAB], ref[3][:, :VOCAB], 2e-2)
    np.testing.assert_array_equal(ours[3][:, VOCAB:], 0.0)


def test_stack_gqa_matches_jax():
    """GQA with 4 kv heads for 8 query heads: the JAX kernel needs B * H_kv
    to fill its 8 sublanes, so 2 kv heads at B=2 are out of its reach (the
    card test runs n_kv_head=2 at full width against the plain version)."""
    inp = _setup(5, h_kv=4)
    ref, ours = _run_both(inp, 130, h_kv=4)
    _check_step(ref, ours, inp, 130)


def test_stack_refuses_int8_words():
    """int4 words announced as int8 ones (wfmt="i8", K7) are refused: int8
    words hold K/4 rows, these K/8 (tests/test_torch_int8.py runs K7)."""
    inp = _setup(0)
    mats = [_t(t) for k in ("wqkv", "wo", "w1", "w3", "w2") for t in inp[k]]
    with pytest.raises(ValueError, match="wqkv"):
        DS.decode_stack_int4(_t(inp["x"]), _t(inp["n1"]), _t(inp["n2"]), *mats,
                             _t(inp["k"]), _t(inp["v"]), 0, H, wfmt="i8")
