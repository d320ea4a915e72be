"""The plain-int8 kernels' plain versions against the JAX package's Pallas
kernels in interpret mode, on the CPU, and the groupwise int4 trees beside
them:

* ``quantize_params_int8`` is bit-identical to JAX's (values and f32 scales).
* K11 ``matmul_int8`` at M = 1, 8, 200 against JAX ``matmul_int8(...,
  interpret=True)``: within 1e-3 of max |ref| (the same bf16 products, f32
  sums in another order).
* K10 ``ffn_int8`` against JAX ``ffn_int8(..., tile_i=256, interpret=True)``:
  within 1e-2 of max |ref| (the f32 sums in another order and the SwiGLU
  rounding to bf16 between them; JAX adds its two hidden tiles' products
  one at a time).
* ``models/transformer._mlp`` at T = 1 takes K10 only where its kernel
  takes the shape (D and I multiples of 64, ``ffn_int8_kernel_ok``), else
  ``_linear`` per product, as JAX's ``_mlp`` off the TPU: within 3e-2 of
  max |ref| of JAX's ``_mlp`` (the tolerance of
  ``test_torch_int8_plain_slice.py``).
* K9 ``decode_attention_block_int8`` on JAX's own test shape (b 2, h 4,
  dh 128, s 512, l 2; ``tests/test_decode_block_kernel.py``) at pos 0, 100
  and 300, with and without starts: y within 2e-2 of max |y| (the port's
  softmax uses the window's maximum where JAX's runs online over chunks,
  and y and the o-proj round to bf16); the new cache row within one bf16
  ulp (its f32 qkv sums run in another order); every other slot identical.
* JAX ``quantize_params_int4`` and ``quantize_params_int4_packed`` trees
  (K12, K13) run in ``TTS`` and ``_linear``; ``params_from_numpy
  (dtype=bf16)`` keeps the f32 scales of all three JAX leaf kinds.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import attention as JA  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.core.config import TransformerConfig  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.runtime.tts import TTS  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init as one program, compiled once a config (eagerly, op by op, it takes seconds)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))

K11_TOL = 1e-3
K10_TOL = 1e-2
Y_TOL = 2e-2
B, H, DH, S, L = 2, 4, 128, 512, 2
D = H * DH
LAYER = 1
STARTS = {0: (0, 0), 100: (10, 60), 300: (0, 150)}


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


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, atol=tol * np.abs(ref).max(), rtol=0)


def _jax_params(seed=0, **overrides):
    jcfg = j_first_stage_config(n_layer=2, n_head=4, dim=256, intermediate_size=512, block_size=256, **overrides)
    return jcfg, _jax_init(jax.random.PRNGKey(seed), cfg=jcfg, dtype=jnp.bfloat16)


def test_quantize_params_int8_bit_identical_to_jax():
    _, jp = _jax_params()
    jq = jax.tree.map(np.asarray, jqz.quantize_params_int8(jp))
    tq = Q.quantize_params_int8(_torch(jp))
    for key in ("wqkv", "wo", "w1", "w3", "w2"):
        leaf, ref = tq["layers"][key], jq["layers"][key]
        assert Q.is_int8_plain(leaf) and set(leaf) == {"q", "scales"}
        assert leaf["q"].dtype == torch.int8 and leaf["scales"].dtype == torch.float32
        np.testing.assert_array_equal(leaf["q"].numpy(), ref["q"])
        np.testing.assert_array_equal(leaf["scales"].numpy(), ref["scales"])
    assert tq["wtes"][0].dtype == torch.bfloat16 and tq["layers"]["attn_norm_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("m", [1, 8, 200])
def test_matmul_int8_plain_version_matches_jax_interpret(m):
    rng = np.random.default_rng(m)
    k, n = 384, 512
    x = rng.normal(size=(m, k)).astype(np.float32)
    q, s = jqz.quantize_int8(jnp.asarray(rng.normal(size=(k, n)).astype(np.float32) * 0.05))
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jqz.matmul_int8(xb, q, s, tile_n=256, interpret=True), np.float32)
    t = _torch({"x": np.asarray(xb), "q": q, "s": s})
    got = Q.matmul_int8(t["x"], t["q"], t["s"])
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got.float().numpy(), ref, K11_TOL)
    # f32 x: the kernel rounds it to bf16 and returns f32, which JAX's own
    # reference (full f32 x) does not do; both round at the kernel's points
    ref32 = np.asarray(jqz.matmul_int8(jnp.asarray(x), q, s, tile_n=256, interpret=True))
    got32 = Q.matmul_int8(torch.from_numpy(x), t["q"], t["s"])
    assert got32.dtype == torch.float32
    _close(got32.numpy(), ref32, K11_TOL)


def test_ffn_int8_plain_version_matches_jax_interpret():
    rng = np.random.default_rng(7)
    d, i_sz = 256, 512
    mats = []
    for shape in ((d, i_sz), (d, i_sz), (i_sz, d)):
        mats += list(jqz.quantize_int8(jnp.asarray(rng.normal(size=shape).astype(np.float32) * 0.05)))
    tmats = _torch({"m": mats})["m"]
    for m in (1, 2, 3):
        x = jnp.asarray(rng.normal(size=(m, d)).astype(np.float32), jnp.bfloat16)
        ref = np.asarray(jqz.ffn_int8(x, *mats, tile_i=256, interpret=True))
        got = Q.ffn_int8(_torch({"x": np.asarray(x)})["x"], *tmats)
        assert got.dtype == torch.float32 and got.shape == (m, d)
        _close(got.numpy(), ref, K10_TOL)


@pytest.mark.parametrize("i_sz,takes_k10", [(528, False), (512, True)])
def test_mlp_routes_t1_by_the_k10_predicate(i_sz, takes_k10, monkeypatch):
    """FFN width 528 (a multiple of 16, not of 64) misses K10 on every device
    and runs _linear (K11's plain version) three times; 512 takes K10. Both
    match JAX's _mlp on the CPU (its _linear route)."""
    rng = np.random.default_rng(i_sz)
    d = 256
    ws = {k: rng.normal(size=(1, *shape)).astype(np.float32) * 0.05
          for k, shape in (("w1", (d, i_sz)), ("w3", (d, i_sz)), ("w2", (i_sz, d)))}
    jlp = jax.tree.map(lambda a: a[0], jqz.quantize_params_int8({"layers": ws})["layers"])
    tlp = _torch(jlp)
    x = jnp.asarray(rng.normal(size=(2, 1, d)).astype(np.float32), jnp.bfloat16)
    ref = np.asarray(jtfm._mlp(x, jlp, j_first_stage_config(dim=d, intermediate_size=i_sz)), np.float32)
    calls = []
    monkeypatch.setattr(tfm, "ffn_int8", lambda *a: calls.append(1) or Q.ffn_int8(*a))
    got = tfm._mlp(_torch({"x": np.asarray(x)})["x"], tlp, TransformerConfig(dim=d, intermediate_size=i_sz))
    assert len(calls) == int(takes_k10) and Q.ffn_int8_kernel_ok(2, d, i_sz) is takes_k10
    assert got.shape == (2, 1, d) and got.dtype == torch.bfloat16
    _close(got.float().numpy(), ref, 3e-2)


@pytest.fixture(scope="module")
def block_case():
    """JAX's own test setup (tests/test_decode_block_kernel.py) and its
    jitted interpret-mode kernel."""
    rng = np.random.default_rng(0)
    xa = jnp.asarray(rng.normal(size=(B, D)).astype(np.float32) * 0.1)
    wqkv = jqz.quantize_int8(jnp.asarray(rng.normal(size=(D, 3 * D)).astype(np.float32) * 0.05))
    wo = jqz.quantize_int8(jnp.asarray(rng.normal(size=(D, D)).astype(np.float32) * 0.05))
    caches = [jnp.asarray(rng.normal(size=(L, S, B, H, DH)).astype(np.float32), jnp.bfloat16) for _ in range(2)]

    @jax.jit
    def run(pos, starts):
        return JA.decode_attention_block_int8(xa, *wqkv, *wo, *caches, jnp.asarray(LAYER, jnp.int32), pos, H,
                                              starts=starts, interpret=True)

    return xa, wqkv, wo, caches, run


@pytest.mark.parametrize("with_starts", [False, True], ids=["no-starts", "starts"])
@pytest.mark.parametrize("pos", [0, 100, 300])
def test_block_plain_version_matches_jax_interpret(block_case, pos, with_starts):
    xa, wqkv, wo, caches, run = block_case
    starts = np.asarray(STARTS[pos] if with_starts else (0, 0), np.int32)
    jy, jk, jv = run(jnp.asarray(pos, jnp.int32), jnp.asarray(starts))
    t = _torch({"x": xa, "w": [*wqkv, *wo], "c": caches})
    kc, vc = t["c"]
    y, kc, vc = A.decode_attention_block_int8(t["x"], *t["w"], kc, vc, LAYER, pos, H,
                                              starts=torch.from_numpy(starts) if with_starts else None)
    assert y.dtype == torch.bfloat16 and y.shape == (B, D)
    _close(y.float().numpy(), np.asarray(jy, np.float32), Y_TOL)
    others = np.ones((L, S), bool)
    others[LAYER, pos] = False
    for got, ref in ((kc, jk), (vc, jv)):
        got, ref = got.float().numpy(), np.asarray(ref, np.float32)
        np.testing.assert_array_equal(got[others], ref[others])
        row, ref_row = got[LAYER, pos], ref[LAYER, pos]
        # one bf16 ulp, and 1e-4 of the row's max for values near 0 that cancel in f32
        assert (np.abs(row - ref_row) <= np.abs(ref_row) * 2.0**-7 + 1e-4 * np.abs(ref_row).max()).all()


@pytest.fixture(scope="module")
def legacy_trees():
    _, jp = _jax_params()
    return {kernel: jax.tree.map(np.asarray, jax.jit(quantize)(jp))  # data only: eagerly, seconds a tree
            for kernel, quantize in (("K12", jqz.quantize_params_int4), ("K13", jqz.quantize_params_int4_packed))}


@pytest.mark.parametrize("kernel", ["K12", "K13"])
def test_legacy_int4_trees_are_refused_by_name(legacy_trees, kernel, tmp_path):
    """The JAX package's groupwise int4 trees, once refused by name, now run
    (tests/test_torch_int4_grouped*.py): ``TTS`` takes them as they are,
    refuses a requested mode, and ``_linear`` matches the kernel's plain
    version."""
    jcfg, _ = _jax_params()
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(legacy_trees[kernel], device="cpu", dtype=torch.bfloat16)
    small = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    comps = dataclasses.replace(small.c, first_stage_params=params, first_stage_cfg=cfg)
    assert TTS(comps, device="cpu", output_dir=str(tmp_path)).quantisation_mode is None
    with pytest.raises(ValueError, match="groupwise int4"):
        TTS(comps, device="cpu", output_dir=str(tmp_path), quantisation_mode="int8_plain")
    x = torch.randn((2, 3, cfg.dim), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    leaf = tfm._layer(params["layers"], 0)["wqkv"]
    gs = cfg.dim // leaf["scales"].shape[0]
    ref = (Q.matmul_int4_packed_reference(x[0], leaf["p"], leaf["scales"], leaf["zeros"], gs) if kernel == "K13"
           else Q.matmul_int4_reference(x[0], leaf["q"], leaf["scales"], leaf["zeros"], gs))
    assert torch.equal(tfm._linear(x, leaf)[0], ref)


def test_params_from_numpy_keeps_quantized_scales_f32(legacy_trees):
    _, jp = _jax_params()
    trees = dict(legacy_trees, plain=jax.tree.map(np.asarray, jax.jit(jqz.quantize_params_int8)(jp)))
    for name, tree in trees.items():
        tree = dict(tree, ln_f_w=np.ones(tree["ln_f_w"].shape, np.float32))
        params = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
        for key in ("wqkv", "w2"):
            leaf, ref = params["layers"][key], tree["layers"][key]
            for field, arr in leaf.items():
                assert arr.dtype == torch.from_numpy(np.asarray(ref[field])).dtype, (name, key, field)
                np.testing.assert_array_equal(arr.numpy(), np.asarray(ref[field]))
            assert leaf["scales"].dtype == torch.float32
        assert params["ln_f_w"].dtype == torch.bfloat16  # the cast still reaches the other leaves
