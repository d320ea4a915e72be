"""Tensor-parallel decode in the port (``parallel/tp_decode.py``,
``models/transformer.apply_blocks(tp=...)``) on real ranks: one world of 4
CPU processes over gloo (``parallel/mesh.spawn``), started once for the
module; the tests assert on what its ranks return.

Inside the world, a tp 4 grid (data 1) and a tp 2 grid (data 2, the batch
split over the data groups) each run a prefill of 4 tokens and 2 decode
steps on a 2-layer, 4-head, 512-wide first stage (head_dim 128), for
weights None, int4 and int8, on bf16, int8 and packed caches, and with GQA
(2 kv heads); the GELU/bias second-stage recipe runs the uncached forward;
``tp_generate`` runs near-greedy. Held:

* every rank of a tensor group returns the same logits (and tokens);
* in f32, the dense logits within 1e-5 of max |ref| of the port's tp = 1
  forward (only the order of the f32 sums differs: the reduction adds the
  shards' partial products) and within 1e-4 of the JAX package's
  single-device ``tfm.forward`` on the same weights. The quantized ones
  within 1e-2 of tp = 1's: their kernels round the activations to bf16, so
  a value whose f32 sum lands one ulp apart may round one bf16 ulp apart
  and move the products it feeds (int4: the shard boundaries fall on
  128-row groups, so the per-shard quantization is the whole one's;
  measured up to 0.10%); int8 also quantizes each shard with its own
  column scales and rounds its own sum(x) to bf16 for the c term (c = -128
  s takes back about 128 s sum(x)), as the JAX package's TP does (measured
  0.38%). JAX's CPU route for int4 multiplies f32 activations where its
  kernel, and the port on every device, round them to bf16, so the
  quantized modes meet JAX in bf16 (below), and the port's int4 products
  are held to JAX's kernel in tests/test_torch_int4_unfused.py;
* in bf16, within the JAX package's own TP tolerance (atol 0.15, rtol 0.1,
  ``tests/test_tp_decode.py``) of its ``make_tp_forward_fn`` on the same
  shards, and the quantized caches' scale tables within rtol 5e-2 of its
  cache's matching shard;
* ``tp_generate``'s near-greedy tokens (``top_p=1e-4``) equal tp = 1's;
* the fused routes stay off under TP: the int4 and int8 decode stacks (K3,
  K7), the int4 attention-block and FFN kernels (K5, K6) and the plain-int8
  attention block (K9) are never called on a 1024-wide model where tp = 1
  takes them, while ``_linear``'s K2 / K8 and the decode attention K1 are.
  On the CPU the wrappers run their plain versions and count no launches,
  so the world counts the calls.

A rank failure fails the world within its deadline: ``spawn`` stops the
other ranks and raises the rank's exception.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import quantized as Q
from metavoice_tpu_torch.parallel import mesh as pmesh
from metavoice_tpu_torch.parallel import tp_decode as tpd

# dh 128; every tp in {2, 4} cuts wo (512) and w2 (1024) on 128-row groups
CFG_KW = dict(n_layer=2, n_head=4, dim=512, block_size=64, vocab_sizes=(97,), intermediate_size=1024)
GQA_KW = dict(CFG_KW, n_local_heads=2)
STAGE2_KW = dict(n_layer=2, block_size=64)
WIDE_KW = dict(n_layer=1, n_head=8, dim=1024, block_size=64, vocab_sizes=(97,), intermediate_size=2048)
B = {4: 2, 2: 4}  # rows a tp takes: one a JAX data device (8 // tp of them), as JAX's own test
STEPS = 6  # tokens: a prefill of 4, then 2 decode steps
GEN = dict(top_p=1e-4, max_new_tokens=8, prompt_pad_multiple=16)
QUANT_F32_TOL = 1e-2
# every case the world runs: (name, tp, model, mode, compute dtype, cache format)
CASES = [(f"tp{tp}-{mode}-{dt}-{fmt}", tp, "main", mode, dt, fmt)
         for tp in (4, 2) for mode in (None, "int4", "int8") for dt in ("f32", "bf16")
         for fmt in (("bf16", "int8", "int8_packed") if (dt, mode) == ("bf16", None) and tp == 2 else ("bf16",))]
CASES += [(f"tp2-gqa-{dt}", 2, "gqa", None, dt, "bf16") for dt in ("f32", "bf16")]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
FUSED = ("decode_stack_int4", "decode_attention_block_int4", "decode_ffn_int4", "decode_attention_block_int8")
UNFUSED = ("matmul_int4_i32", "matmul_int8_i32", "matmul_int8", "decode_attention")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models() -> dict:
    def init(kw, seed, make=first_stage_config):
        cfg = make(**kw)
        return cfg, tfm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(seed),
                                    dtype=torch.float32)

    out = {"main": init(CFG_KW, 0), "gqa": init(GQA_KW, 1), "stage2": init(STAGE2_KW, 2, second_stage_config),
           "wide": init(WIDE_KW, 3)}
    cfg2, p2 = out["stage2"]
    g = torch.Generator().manual_seed(4)
    for k, w in p2["layers"].items():  # the init's zero biases would hide a bias added before the reduction
        if k.endswith("_b"):
            w.copy_(torch.randn(w.shape, generator=g) * 0.1)
    return out


def _inputs(rows: int, seed: int = 1):
    """The first ``rows`` of one seeded draw of 4 rows: tokens and speaker embeddings."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 97, size=(4, STEPS))
    spk = rng.normal(size=(4, 256)).astype(np.float32)
    return torch.from_numpy(idx[:rows]).long(), torch.from_numpy(spk[:rows])


def _sequence(step, idx) -> np.ndarray:
    """Prefill idx[:, :4], then decode the rest a token at a time ->
    (STEPS - 3, rows, V) f32, each forward's last position;
    ``step(tokens, pos)`` -> the first head's (rows, T, V) logits."""
    outs = [np.asarray(step(idx[:, :4], 0), np.float32)[:, -1]]
    for pos in range(4, idx.shape[1]):
        outs.append(np.asarray(step(idx[:, pos : pos + 1], pos), np.float32)[:, 0])
    return np.stack(outs)


def _cache_format(dt: str, fmt: str):
    """A case's cache: the compute dtype's, or a quantized format."""
    return DTYPES[dt] if fmt == "bf16" else fmt


def _scales_by_row(table, rows: int, heads: int):
    """A quantized cache's scale table -> (..., rows, heads), its real columns."""
    return table[..., : rows * heads].reshape(*table.shape[:-1], rows, heads)


def _spied(counts: dict):
    """Count the calls of the route-deciding wrappers the block stack looks up."""
    for name in FUSED + UNFUSED:
        fn = getattr(tfm, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        setattr(tfm, name, spy)


def _route_calls(mesh, cfg, params, counts, mode) -> dict:
    """One prefill and one decode step of the 1024-wide model -> the calls
    of each wrapper (tp = 1 on this rank alone when ``mesh`` is None)."""
    for k in counts:
        counts[k] = 0
    idx, spk = _inputs(2, seed=5)
    if mesh is None:
        quant = {"int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32,
                 "int8_plain": Q.quantize_params_int8}[mode]
        p, lcfg, tp, kv = quant(params), cfg, None, tfm.KVCache.create(cfg, 2, device="cpu")
    else:
        p = tpd.prepare_tp_params(params, cfg, mesh, None if mode == "int8_plain" else mode)
        if mode == "int8_plain":  # the rank's shards in plain int8: K9's weights (TTS refuses this mode under TP)
            p = Q.quantize_params_int8(p)
        lcfg, tp, kv = tpd.local_view(cfg, mesh.tensor_parallel), mesh.tensor_group, tpd.make_tp_cache(
            cfg, mesh, 2, data_sharded=False)
    with torch.inference_mode():
        for i, pos in ((idx[:, :4], 0), (idx[:, 4:5], 4)):  # a prefill and one decode step
            tfm.forward(p, lcfg, i, spk_emb=spk, kv_cache=kv, cache_pos=pos, tp=tp)
    return dict(counts)


def _world(rank: int, models: dict) -> dict:
    """One rank of the module's world -> {case: its logits or tokens or counts}."""
    torch.set_num_threads(1)
    meshes = {4: pmesh.make_mesh(4, device="cpu"), 2: pmesh.make_mesh(2, device="cpu")}
    out = {}
    for name, tp, model, mode, dt, fmt in CASES:
        cfg, params = models[model]
        mesh = meshes[tp]
        p = tpd.prepare_tp_params(params, cfg, mesh, mode)
        lo, hi = pmesh.process_batch_slice(B[tp], process_index=mesh.data_rank, process_count=mesh.data_parallel)
        idx, spk = _inputs(B[tp])
        kv = tpd.make_tp_cache(cfg, mesh, B[tp], dtype=_cache_format(dt, fmt))
        out[name] = _sequence(lambda i, pos: tpd.tp_forward(p, cfg, mesh, i, spk[lo:hi], None, kv, pos,
                                                            compute_dtype=DTYPES[dt])[0][0].float(), idx[lo:hi])
        if kv.k_scale is not None:
            table = kv.k_scale if not kv.packed else kv.k_scale.transpose(1, 2).flatten(1, 2)  # position-major
            out[name + "-scales"] = _scales_by_row(table.numpy(), hi - lo, cfg.n_local_heads // tp)
    cfg2, p2 = models["stage2"]
    mesh = meshes[2]
    rng = np.random.default_rng(13)
    idx2 = torch.from_numpy(rng.integers(0, 1000, size=(4, 2, 12))).long()
    lo, hi = pmesh.process_batch_slice(4, process_index=mesh.data_rank, process_count=mesh.data_parallel)
    for dt in ("f32", "bf16"):
        logits = tpd.tp_forward_nocache(tpd.prepare_tp_params(p2, cfg2, mesh), cfg2, mesh, idx2[lo:hi],
                                        torch.ones((2, 256)), compute_dtype=DTYPES[dt])
        out[f"stage2-{dt}"] = np.stack([lg.float().numpy() for lg in logits])
    cfg, params = models["main"]
    prompt = (np.arange(10) * 7) % 90 + 3
    for tp, fmt in ((4, None), (2, None), (2, "int8"), (2, "int8_packed")):
        toks = tpd.tp_generate(tpd.prepare_tp_params(params, cfg, meshes[tp]), cfg, meshes[tp], prompt,
                               np.ones(256, np.float32), generator=torch.Generator().manual_seed(9),
                               cache_dtype=fmt, **GEN)
        out[f"gen-tp{tp}-{fmt}"] = toks
    counts = {k: 0 for k in FUSED + UNFUSED}
    _spied(counts)
    cfgw, pw = models["wide"]
    for mode in ("int4", "int8", "int8_plain"):
        out[f"routes-tp2-{mode}"] = _route_calls(meshes[2], cfgw, pw, counts, mode)
        out[f"routes-tp1-{mode}"] = _route_calls(None, cfgw, pw, counts, mode)
    return out


@pytest.fixture(scope="module")
def world():
    """The world's results by rank, and the models; the JAX references are
    computed here while the ranks run."""
    models = _models()
    box = {}
    runner = threading.Thread(target=lambda: box.update(ranks=pmesh.spawn(_world, 4, args=(models,), timeout=120,
                                                                          devices=["cpu"] * 4, deadline=400)))
    runner.start()
    try:
        refs = _jax_references(models)
    finally:
        runner.join()
    assert "ranks" in box, "the world failed (its error is above)"
    return box["ranks"], models, refs


def _jax_references(models) -> dict:
    """The JAX package's single-device f32 forward (dense, and GQA) and
    its bf16 TP forward on the virtual 8-device mesh, on the port's weights
    and shards."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from metavoice_tpu.core.config import first_stage_config as jfirst
    from metavoice_tpu.core.config import second_stage_config as jsecond
    from metavoice_tpu.models import transformer as jtfm
    from metavoice_tpu.parallel import mesh as jmesh
    from metavoice_tpu.parallel import tp_decode as jtpd

    def to_jax(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else \
            jnp.asarray(t.numpy())

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [tree(v) for v in t]
        return to_jax(t)

    def run(fwd, kv, idx, spk):
        state = {"kv": kv}

        def step(i, pos):
            logits, state["kv"] = fwd(jnp.asarray(i.numpy()), jnp.asarray(spk.numpy()), state["kv"], pos)
            return logits[0]

        return _sequence(step, idx), state["kv"]

    refs = {}
    jcfgs = {"main": jfirst(**CFG_KW), "gqa": jfirst(**GQA_KW), "stage2": jsecond(**STAGE2_KW)}
    for model, mode in (("main", None), ("gqa", None)):
        cfg, params = models[model]
        jp = tree(params)
        jcfg = jcfgs[model]
        fwd = jax.jit(lambda i, s, kv, pos, jp=jp, jcfg=jcfg: jtfm.forward(
            jp, jcfg, i, spk_emb=s, kv_cache=kv, cache_pos=pos, compute_dtype=jnp.float32))
        idx, spk = _inputs(4)
        refs[f"jax-single-{model}-{mode}"] = run(fwd, jtfm.KVCache.create(jcfg, 4, dtype=jnp.float32), idx, spk)[0]

    def tp_params(model, tp, mode):
        """JAX's global TP layout, assembled from the port's rank shards, on the mesh."""
        cfg, params = models[model]
        jm = jmesh.make_mesh(8, tensor_parallel=tp)
        ranks = [tpd.build_tp_layers(params["layers"], cfg, tp, mode, r) for r in range(tp)]

        def cat(key, leaves):
            axis = 1 if key in ("wo", "w2", "w_proj") else -1 if key in (
                "wqkv", "w1", "w3", "w_fc", "wqkv_b", "w_fc_b") else None
            return to_jax(leaves[0] if axis is None else torch.cat(leaves, dim=axis))

        layers = {k: ({kk: cat(k, [r[k][kk] for r in ranks]) for kk in v} if isinstance(v, dict)
                      else cat(k, [r[k] for r in ranks])) for k, v in ranks[0].items()}
        placed = jax.tree.map(lambda x, sp: jax.device_put(x, NamedSharding(jm, sp)), layers,
                              jtpd.layer_specs(layers), is_leaf=lambda x: not isinstance(x, (dict, list)))
        p = tree({k: v for k, v in params.items() if k != "layers"})
        p["layers"] = placed
        return jm, p

    for name, tp, model, mode, dt, fmt in CASES:
        if dt != "bf16":
            continue
        jm, p = tp_params(model, tp, mode)
        tp_fwd = jtpd.make_tp_forward_fn(jcfgs[model], jm)
        kv = jtpd.make_tp_cache(jcfgs[model], jm, B[tp], dtype=jnp.bfloat16 if fmt == "bf16" else fmt)
        idx, spk = _inputs(B[tp])
        refs[f"jax-tp-{name}"], kv = run(lambda i, s, kv, pos, p=p, f=tp_fwd: f(p, i, s, None, kv, pos), kv, idx, spk)
        if fmt != "bf16":  # one row a data device: each shard holds its row's columns
            table = np.asarray(kv.k_scale)
            if fmt == "int8_packed":  # (L, 4, Sw, 1, W) -> position-major (L, S, 1, W)
                table = table.transpose(0, 2, 1, 3, 4).reshape(table.shape[0], -1, 1, table.shape[-1])
            heads = jcfgs[model].n_local_heads // tp
            refs[f"jax-tp-{name}-scales"] = np.stack(
                [_scales_by_row(sh, 1, heads)[..., 0, :] for sh in np.split(table, jm.devices.size, axis=-1)])
    jm, p = tp_params("stage2", 2, None)
    rng = np.random.default_rng(13)
    idx2 = rng.integers(0, 1000, size=(4, 2, 12))
    logits = jtpd.make_tp_forward_nocache_fn(jcfgs["stage2"], jm)(p, jnp.asarray(idx2), jnp.ones((4, 256)))
    refs["jax-tp-stage2"] = np.stack([np.asarray(lg, np.float32) for lg in logits])
    return refs


def _tp1(models, model, mode, dt, fmt, rows):
    """The port's tp = 1 forward of a case (whole-model quantization)."""
    cfg, params = models[model]
    quant = {None: lambda p: p, "int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32}[mode]
    p = quant(params)
    idx, spk = _inputs(rows)
    kv = tfm.KVCache.create(cfg, rows, dtype=_cache_format(dt, fmt), device="cpu")
    with torch.inference_mode():
        return _sequence(lambda i, pos: tfm.forward(p, cfg, i, spk_emb=spk, kv_cache=kv, cache_pos=pos,
                                                    compute_dtype=DTYPES[dt])[0][0].float(), idx)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tp_forward_parity(world, case):
    ranks, models, refs = world
    name, tp, model, mode, dt, fmt = case
    for r in range(4):  # the ranks of a tensor group hold the same logits
        np.testing.assert_array_equal(ranks[r][name], ranks[r - r % tp][name])
    got = np.concatenate([ranks[d * tp][name] for d in range(4 // tp)], axis=1)  # every data group's rows
    if dt == "f32":
        ref = _tp1(models, model, mode, dt, fmt, B[tp])
        gap = np.abs(got - ref).max() / np.abs(ref).max()
        assert gap <= (1e-5 if mode is None else QUANT_F32_TOL), gap
        if mode is None:
            jref = refs[f"jax-single-{model}-{mode}"][:, : B[tp]]
            gap = np.abs(got - jref).max() / np.abs(jref).max()
            assert gap <= 1e-4, gap
        return
    np.testing.assert_allclose(got, refs[f"jax-tp-{name}"], atol=0.15, rtol=0.1)
    if fmt != "bf16":  # the scales of every (position, row, local head) against JAX's cache shard that holds it
        want = refs[f"jax-tp-{name}-scales"]  # (device, ..., heads), one row a data device
        for r in range(4):
            d, t = r // tp, r % tp
            rows = ranks[r][name + "-scales"]
            for b in range(rows.shape[-2]):
                jdev = (d * rows.shape[-2] + b) * tp + t
                np.testing.assert_allclose(rows[..., b, :], want[jdev], rtol=5e-2, atol=1e-6)


def test_tp_second_stage_forward(world):
    ranks, models, refs = world
    cfg2, p2 = models["stage2"]
    rng = np.random.default_rng(13)
    idx2 = torch.from_numpy(rng.integers(0, 1000, size=(4, 2, 12))).long()
    with torch.inference_mode():
        ref, _ = tfm.forward(p2, cfg2, idx2, spk_emb=torch.ones((4, 256)), compute_dtype=torch.float32)
    ref = np.stack([lg.numpy() for lg in ref])
    for dt in ("f32", "bf16"):
        got = np.concatenate([ranks[0][f"stage2-{dt}"], ranks[2][f"stage2-{dt}"]], axis=1)
        assert got.shape[0] == len(cfg2.target_vocab_sizes)
        np.testing.assert_array_equal(ranks[1][f"stage2-{dt}"], ranks[0][f"stage2-{dt}"])
        if dt == "f32":
            assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(got, refs["jax-tp-stage2"], atol=0.25, rtol=0.1)


def test_tp_generate_matches_single(world):
    ranks, models, _ = world
    cfg, params = models["main"]
    prompt = (np.arange(10) * 7) % 90 + 3
    for fmt in (None, "int8", "int8_packed"):
        ref = fs.generate(params, cfg, prompt, np.ones(256, np.float32), generator=torch.Generator().manual_seed(9),
                          cache_dtype=fmt, **GEN)
        tps = (4, 2) if fmt is None else (2,)
        for tp in tps:
            for r in range(4):
                np.testing.assert_array_equal(ranks[r][f"gen-tp{tp}-{fmt}"], ref)
        assert len(ref) > len(prompt) + 1


@pytest.mark.parametrize("mode", ["int4", "int8", "int8_plain"])
def test_fused_routes_stay_off_under_tp(world, mode):
    ranks, _, _ = world
    for r in range(4):
        alone, tp = ranks[r][f"routes-tp1-{mode}"], ranks[r][f"routes-tp2-{mode}"]
        fused = {"int4": ("decode_stack_int4",), "int8": ("decode_stack_int4",),
                 "int8_plain": ("decode_attention_block_int8",)}[mode]
        assert all(alone[k] > 0 for k in fused), alone  # the 1024-wide model takes them at tp 1 ...
        assert all(tp[k] == 0 for k in FUSED), tp  # ... and none under TP
        # each projection at the prefill and the step (plain int8's step FFN is K10's), K1 at T = 1
        matmul, calls = {"int4": ("matmul_int4_i32", 10), "int8": ("matmul_int8_i32", 10),
                         "int8_plain": ("matmul_int8", 7)}[mode]
        assert tp[matmul] == calls and tp["decode_attention"] == 1, tp


def test_nccl_refuses_two_ranks_on_one_card():
    with pytest.raises(ValueError, match="backend='gloo'"):
        pmesh.spawn(_never, 2, backend="nccl", devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="a card each"):
        pmesh.spawn(_never, 2, backend="nccl", devices=["cpu", "cpu"])


def _never(rank):
    raise AssertionError("no rank should start")


def _one_rank_fails(rank):
    if rank == 1:
        raise ValueError("rank 1 failed before its first reduction")
    dist.all_reduce(torch.ones(4))  # rank 0 waits here for a peer that never comes
    return "unreachable"


def test_a_failed_rank_ends_the_run_quickly():
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="before its first reduction"):
        pmesh.spawn(_one_rank_fails, 2, devices=["cpu"] * 2, timeout=60, deadline=120)
    assert time.monotonic() - t0 < 30
