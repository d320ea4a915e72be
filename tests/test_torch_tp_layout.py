"""The port's tensor-parallel layout (``metavoice_tpu_torch/parallel/``)
against the JAX package's ``parallel/`` on the same numpy-seeded weights, in
one process (no ranks spawned):

* ``permute_qkv_cols``, ``local_view`` and ``build_tp_layers`` /
  ``prepare_tp_params`` for tp 2 and 4, modes None, int4 and int8, SwiGLU
  and GELU with biases: rank r's tree equals shard r of JAX's global
  ``build_tp_layers`` output (its natural split by ``layer_specs``) BIT FOR
  BIT, ``pw``/``sc`` and ``p8``/``sc8`` included, and the int4 hidden
  padding of ``w_fc`` and ``w_fc_b`` where it fires;
* ``make_tp_cache``: each rank's cache (bf16, int8, packed; batch over the
  data group or not) equals the matching shard of JAX's ``make_tp_cache``
  on the virtual 8-device CPU mesh, scale tables included;
* ``shard_params`` against JAX's ``param_specs`` placement of its serving
  layout (qkv in head blocks), the embeddings whole;
* the mesh arithmetic (``process_batch_slice``, the multihost topology
  rule) against JAX's, as ``tests/test_sharding.py`` drives it;
* ``aot.abstract_params`` at full scale (24L/2048d) for tp 2, 4 and 8: each
  rank's shapes equal JAX's shard shapes (``jax.eval_shape``).

The JAX side is called eagerly where the test is about its bits (its
quantizers jitted are not bit-identical to eager ones).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.parallel import mesh as jmesh  # noqa: E402
from metavoice_tpu.parallel import sharding as jsh  # noqa: E402
from metavoice_tpu.parallel import tp_decode as jtpd  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.parallel import aot  # noqa: E402
from metavoice_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from metavoice_tpu_torch.parallel import sharding as psh  # noqa: E402
from metavoice_tpu_torch.parallel import tp_decode as tpd  # noqa: E402

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")

# The two recipes share their widths, so JAX's eager quantizers, which
# compile each op once a shape, compile once for both. Hidden 1024: 512 a
# rank at tp 2 and 256 at tp 4, so the int4 padding of the column shards
# (w1, w3, w_fc and w_fc_b, to 1024) fires in both.
SWIGLU = dict(n_layer=1, n_head=4, dim=256, block_size=32, vocab_sizes=(97,), intermediate_size=1024)
GELU = dict(SWIGLU, intermediate_size=None, nonlinearity_type="gelu", norm_type="layernorm", bias=True)
GQA = dict(SWIGLU, n_local_heads=2)
CONFIGS = {"swiglu": SWIGLU, "gelu": GELU, "gqa": GQA}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """name -> (port cfg, JAX cfg, port f32 params, the same as numpy)."""
    out = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        cfg = first_stage_config(**kw)
        g = torch.Generator().manual_seed(10 + i)
        p = tfm.init_params(cfg, device="cpu", generator=g, dtype=torch.float32)
        for k, w in p["layers"].items():  # the init's zero biases and unit norms would hide a misplaced slice
            if k.endswith("_b"):
                w.copy_(torch.randn(w.shape, generator=g) * 0.1)
            elif k.endswith("norm_w"):
                w.copy_(1.0 + torch.randn(w.shape, generator=g) * 0.1)
        out[name] = (cfg, j_first_stage_config(**kw), p, _to_numpy(p))
    return out


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


def _shard(x, spec, tp: int, rank: int) -> np.ndarray:
    """Rank ``rank``'s piece of a global array under a tensor-axis spec."""
    x = np.asarray(x)
    for axis, name in enumerate(spec):
        if name == jmesh.TENSOR_AXIS:
            return np.split(x, tp, axis=axis)[rank]
    return x


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _same_bits(got: torch.Tensor, want: np.ndarray, what: str):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, (what, tuple(got.shape), want.shape)
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16).numpy(), want.view(np.int16)
    else:
        got = got.numpy()
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def test_local_view_and_qkv_permutation(models):
    cfg, jcfg, p, pn = models["gqa"]
    for tp in (1, 2):
        lv, jlv = tpd.local_view(cfg, tp), jtpd.local_view(jcfg, tp)
        assert (lv.n_head, lv.n_local_heads, lv.head_dim, lv.dim) == (
            jlv.n_head, jlv.n_local_heads, jlv.head_dim, jlv.dim)
        got = tpd.permute_qkv_cols(p["layers"]["wqkv"], cfg, tp)
        _same_bits(got, jtpd.permute_qkv_cols(jnp.asarray(pn["layers"]["wqkv"]), jcfg, tp), f"qkv tp {tp}")
    for bad in (3, 4):  # 2 kv heads do not split 4 ways; 4 heads not 3 ways
        with pytest.raises(ValueError, match="not divisible"):
            tpd.local_view(cfg, bad)
        with pytest.raises(ValueError):
            jtpd.local_view(jcfg, bad)


@pytest.mark.parametrize("name", ["swiglu", "gelu"])
@pytest.mark.parametrize("mode", [None, "int4", "int8"])
@pytest.mark.parametrize("tp", [2, 4])
def test_build_tp_layers_bit_for_bit(models, name, mode, tp):
    cfg, jcfg, p, pn = models[name]
    want = jtpd.build_tp_layers(jax.tree.map(jnp.asarray, pn["layers"]), jcfg, tp, mode)
    specs = _leaves(jtpd.layer_specs(want))
    want = _leaves(want)
    for rank in range(tp):
        got = _leaves(tpd.build_tp_layers(p["layers"], cfg, tp, mode, rank))
        assert got.keys() == want.keys()
        for k in want:
            _same_bits(got[k].contiguous(), _shard(want[k], specs[k], tp, rank), f"{k} rank {rank}")
    if mode == "int4" and name == "gelu":  # the per-shard hidden padding fired
        assert got["w_fc.pw"].shape[-1] == got["w_fc_b"].shape[-1] == 1024 != 4 * cfg.dim // tp
        assert got["w_proj.pw"].shape[1] * 8 == 1024


@pytest.mark.parametrize("mode", [None, "int4", "int8"])
def test_prepare_tp_params_is_the_rank_shard(models, mode):
    cfg, jcfg, p, pn = models["gelu"]
    tp = 2
    for rank in range(tp):
        mesh = pmesh.Mesh(tp, 1, rank, 0, (0, 1), None, None, torch.device("cpu"))
        got = tpd.prepare_tp_params(p, cfg, mesh, mode)
        layers = tpd.build_tp_layers(p["layers"], cfg, tp, mode, rank)
        for k, v in _leaves(layers).items():
            assert torch.equal(_leaves(got["layers"])[k], v), k
        for k in ("wpe", "ln_f_w", "ln_f_b", "speaker_cond"):
            assert torch.equal(got[k], p[k]), k  # replicated whole
        assert torch.equal(got["wtes"][0], p["wtes"][0])
    if mode is not None:  # a quantized tree cannot be cut again: its words interleave input rows
        with pytest.raises(ValueError, match="quantized"):
            tpd.prepare_tp_params(got, cfg, mesh, None)


def _jax_shard_of(arr, mesh, d: int, t: int) -> np.ndarray:
    dev = mesh.devices[d, t]
    for s in arr.addressable_shards:
        if s.device == dev:
            return np.asarray(s.data)
    raise AssertionError("no shard on that device")


@pytest.mark.parametrize("fmt", ["bf16", "int8", "int8_packed"])
@pytest.mark.parametrize("tp,batch,data_sharded", [(2, 8, True), (4, 4, True), (2, 3, False), (4, 2, False)])
def test_make_tp_cache_matches_jax_shards(models, fmt, tp, batch, data_sharded):
    cfg, jcfg, _, _ = models["swiglu"]
    jm = jmesh.make_mesh(8, tensor_parallel=tp)
    jkv = jtpd.make_tp_cache(jcfg, jm, batch, data_sharded=data_sharded,
                             dtype=jnp.bfloat16 if fmt == "bf16" else fmt)
    dp = 8 // tp
    for d in range(dp):
        for t in range(tp):
            mesh = pmesh.Mesh(tp, dp, t, d, tuple(range(d * tp, d * tp + tp)), None, None, torch.device("cpu"))
            kv = tpd.make_tp_cache(cfg, mesh, batch, data_sharded=data_sharded,
                                   dtype=torch.bfloat16 if fmt == "bf16" else fmt)
            for field in ("k", "v", "k_scale", "v_scale"):
                got, want = getattr(kv, field), getattr(jkv, field)
                assert (got is None) == (want is None), field
                if got is not None:
                    _same_bits(got, _jax_shard_of(want, jm, d, t), f"{field} d{d} t{t}")
    local = tfm.KVCache.create(tpd.local_view(cfg, tp), batch // dp if data_sharded else batch,
                               dtype=torch.bfloat16 if fmt == "bf16" else fmt, device="cpu")
    assert kv.k.shape == local.k.shape and (kv.k_scale is None or kv.k_scale.shape == local.k_scale.shape)


@pytest.mark.parametrize("name", ["swiglu", "gelu", "gqa"])
def test_shard_params_follows_jax_param_specs(models, name):
    """``shard_params``'s layer shards are JAX's ``param_specs`` placement of
    its serving layout (qkv permuted into head blocks,
    ``permute_qkv_cols``): rank t's leaf is device t's shard, bit for bit.
    The embeddings, the speaker projection and the final norm stay whole on
    every rank, where JAX splits the first two over their feature dim."""
    cfg, jcfg, p, pn = models[name]
    tp = 2
    jm = jmesh.make_mesh(8, tensor_parallel=tp)
    layers = dict(pn["layers"])
    for k in ("wqkv", "wqkv_b"):
        if k in layers:
            layers[k] = jtpd.permute_qkv_cols(jnp.asarray(layers[k]), jcfg, tp)
    placed = jsh.shard_params(jax.tree.map(jnp.asarray, {**pn, "layers": layers}), jcfg, jm)
    want = _leaves(placed["layers"])
    for t in range(tp):
        mesh = pmesh.Mesh(tp, 4, t, 0, (0, 1), None, None, torch.device("cpu"))
        got = psh.shard_params(p, cfg, mesh)
        assert _leaves(got["layers"]).keys() == want.keys()
        for k, arr in want.items():
            _same_bits(got["layers"][k], _jax_shard_of(arr, jm, 0, t), f"{k} t{t}")
        for k, w in p.items():
            if k != "layers":
                for i, (a, b) in enumerate(zip(*((v if isinstance(v, list) else [v]) for v in (got[k], w)))):
                    _same_bits(a, b.numpy(), f"{k} {i} t{t}")


def test_mesh_arithmetic_matches_jax():
    for gb, pc in ((16, 4), (16, 1), (12, 3)):
        for pi in range(pc):
            assert pmesh.process_batch_slice(gb, process_index=pi, process_count=pc) == \
                jmesh.process_batch_slice(gb, process_index=pi, process_count=pc)
    assert pmesh.process_batch_slice(8) == (0, 8)  # one process: the whole batch
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.process_batch_slice(10, process_index=0, process_count=4)
    devs = jax.devices()[:8]
    # (tp, world, local): tp 4 packs into 4 local ranks; 8 and 3 do not; 4 does not divide 6
    for tp, world, local, devices in ((4, 8, 4, devs), (8, 8, 4, devs), (3, 8, 4, devs), (4, 12, 6, devs[:4] * 3),
                                      (2, 8, 8, devs)):
        try:
            jmesh.make_multihost_mesh(tp, devices=devices, process_count=world // local, local_device_count=local)
            jax_ok = True
        except ValueError:
            jax_ok = False
        if jax_ok:
            pmesh.check_topology(tp, world, local)
        else:
            with pytest.raises(ValueError, match="straddle hosts"):
                pmesh.check_topology(tp, world, local)
    with pytest.raises(RuntimeError, match="spawn"):  # no process group: only tp 1
        pmesh.make_mesh(2)
    one = pmesh.make_mesh(1, device="cpu")
    assert one.shape == {"data": 1, "tensor": 1} and one.tensor_group is None and one.leader


@pytest.mark.parametrize("tp,mode", [(2, None), (4, None), (8, None), (2, "int4"), (2, "int8")])
def test_abstract_params_full_scale(tp, mode):
    """Each rank's full-scale (24L/16H/2048d) shard tree on the meta device
    has JAX's shard shapes and dtypes."""
    jcfg = j_first_stage_config()
    shapes = jax.eval_shape(lambda k: jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                                   jtfm_init(k, jcfg)), jax.random.PRNGKey(0))
    layers = jax.eval_shape(lambda l: jtpd.build_tp_layers(l, jcfg, tp, mode), shapes["layers"])
    specs = _leaves(jtpd.layer_specs(layers))
    want = _leaves(layers)
    trees = aot.abstract_params(tp=tp, quantisation_mode=mode)
    assert len(trees) == tp
    for rank, tree in enumerate(trees):
        got = _leaves(tree["layers"])
        assert got.keys() == want.keys()
        for k, sd in want.items():
            shape = list(sd.shape)
            for axis, name in enumerate(specs[k]):
                if name == jmesh.TENSOR_AXIS:
                    shape[axis] //= tp
            assert got[k].device.type == "meta" and tuple(got[k].shape) == tuple(shape), (k, got[k].shape, shape)
            assert str(got[k].dtype).split(".")[-1] == str(sd.dtype), (k, got[k].dtype, sd.dtype)
    assert tuple(trees[0]["wtes"][0].shape) == shapes["wtes"][0].shape


def jtfm_init(key, jcfg):
    from metavoice_tpu.models import transformer as jtfm

    return jtfm.init_params(key, jcfg, dtype=jnp.float32)


def test_named_sharding_of_the_jax_cache_is_per_shard_padded(models):
    """The JAX quantized cache's scale table is the per-shard-padded stack,
    so its natural shard is the port's local table (pad128 of the local
    batch x heads), not a slice of pad128 of the global one."""
    cfg, jcfg, _, _ = models["swiglu"]
    jm = jmesh.make_mesh(8, tensor_parallel=4)
    jkv = jtpd.make_tp_cache(jcfg, jm, 2, data_sharded=False, dtype="int8")
    assert isinstance(jkv.k_scale.sharding, NamedSharding)
    local = tfm.kv_scale_width(2 * tpd.local_view(cfg, 4).n_local_heads)
    assert jkv.k_scale.shape[-1] == 4 * local != tfm.kv_scale_width(2 * cfg.n_local_heads)
