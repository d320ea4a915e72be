"""The first stage's CUDA-graph decode step on the card, against the eager
loop of the same steps on every single-card route, and K1, K4, K5 and K9
with their position read on the device.

Needs a CUDA card; skips elsewhere. Imports no JAX, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest tests/test_torch_graph_decode_cuda.py -q
"""

import pytest
import torch

from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q
from metavoice_tpu_torch.ops.counters import KERNEL_COUNTERS

EOA = 2048


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    fs.release_graphs()


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 255, 383, 384, 511, 512, 1000, 1023, 1024, 2047])
@pytest.mark.parametrize("starts", [None, (3, 1500)])
def test_k1_device_pos_gives_the_host_int_bits(cuda, pos, starts):
    gen = torch.Generator(device=cuda).manual_seed(pos)
    b, h, dh, s = 2, 16, 128, 2048

    def t(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    q, k_new, v_new = t(b, h, dh), t(b, h, dh), t(b, h, dh)
    kc, vc = t(2, s, b, h, dh), t(2, s, b, h, dh)
    kc[:, pos + 1 :] = float("nan")  # never read
    kd, vd = kc.clone(), vc.clone()
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=cuda)
    y, _, _ = A.decode_attention(q, k_new, v_new, kc, vc, 1, pos, st)
    window = A.attention_window(pos + 1, s)
    yd, _, _ = A.decode_attention(q, k_new, v_new, kd, vd, 1, torch.tensor(pos, dtype=torch.int32, device=cuda), st,
                                  window=window)
    assert _same_bits(y, yd) and _same_bits(kc, kd) and _same_bits(vc, vd)
    ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc.clone(), vc.clone(), 1, pos, st)
    torch.testing.assert_close(yd.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pos,start", [(0, 3), (255, 3), (383, 3), (384, 3), (512, 300), (1000, 3), (2047, 3)])
@pytest.mark.parametrize("kernel", ["K4-bf16", "K4-f32", "K5-bf16", "K5-int8", "K5-packed", "K9"])
def test_block_and_gqa_device_pos_gives_the_host_int_bits(cuda, kernel, pos, start):
    """K4 at T = 1 (GQA), K5 on its three caches and K9 with pos on the
    device and planned at the window bucket: the host-int call's bits, and
    the plain version within rounding, NaN past pos never read. At pos 512
    a split of the bucket's plan ends at pos and the row's tiles from start
    300 have one over pos (which takes no new row: its slot stays zeroed)."""
    gen = torch.Generator(device=cuda).manual_seed(pos)
    s, b = 2048, 2
    window = A.attention_window(pos + 1, s)
    st = torch.tensor([start, 2047], dtype=torch.int32, device=cuda)
    dpos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    if kernel.startswith("K4"):
        dt = torch.bfloat16 if kernel == "K4-bf16" else torch.float32
        q = torch.randn(b, 16, 1, 128, generator=gen, device=cuda).to(dt)
        kn, vn = (torch.randn(b, 2, 1, 128, generator=gen, device=cuda).to(dt) for _ in range(2))
        kc, vc = (torch.randn(2, s, b, 2, 128, generator=gen, device=cuda).to(dt) for _ in range(2))
        kc[:, pos + 1 :] = float("nan")
        caches = [(kc, vc), (kc.clone(), vc.clone()), (kc.clone(), vc.clone())]
        y, *_ = A.decode_attention_multi(q, kn, vn, *caches[0], 1, pos, st)
        yd, *_ = A.decode_attention_multi(q, kn, vn, *caches[1], 1, dpos, st, window=window)
        ref, *_ = A.decode_attention_multi_reference(q, kn, vn, *caches[2], 1, pos, st)
    else:
        cfg = first_stage_config(n_layer=2, n_head=16, dim=2048, n_local_heads=2 if kernel != "K9" else 16)
        dense = tfm.init_params(cfg, device=cuda, generator=gen, dtype=torch.bfloat16)
        fmt = {"K5-bf16": torch.bfloat16, "K5-int8": "int8", "K5-packed": "int8_packed", "K9": torch.bfloat16}[kernel]
        base = _filled(cfg, b, gen, cuda, fmt)
        _garbage_past(base, pos)
        caches = [_clone(base) for _ in range(3)]
        xa = torch.randn(b, 2048, generator=gen, device=cuda).to(torch.bfloat16)
        if kernel == "K9":
            lp = Q.quantize_params_int8(dense)["layers"]
            w = (lp["wqkv"]["q"][1], lp["wqkv"]["scales"][1], lp["wo"]["q"][1], lp["wo"]["scales"][1])

            def call(kv, p, fn=A.decode_attention_block_int8, **kw):
                return fn(xa, *w, kv.k, kv.v, 1, p, 16, starts=st, **kw)[0]
            ref = call(caches[2], pos, fn=A.decode_attention_block_int8_reference)
        else:
            lp = Q.quantize_params_int4_i32(dense)["layers"]
            w = (lp["wqkv"]["pw"], lp["wqkv"]["sc"], lp["wo"]["pw"], lp["wo"]["sc"])

            def call(kv, p, fn=A.decode_attention_block_int4, **kw):
                return fn(xa, *w, kv.k, kv.v, 1, p, 16, n_kv_head=2, starts=st, k_scale=kv.k_scale,
                          v_scale=kv.v_scale, **kw)[0]
            ref = call(caches[2], pos, fn=A.decode_attention_block_int4_reference)
        y = call(caches[0], pos)
        yd = call(caches[1], dpos, window=window)
        caches = [_cache_bits(kv) for kv in caches]
    assert _same_bits(y, yd) and all(_same_bits(a, c) for a, c in zip(caches[0], caches[1]))
    assert torch.isfinite(yd.float()).all()
    torch.testing.assert_close(yd.float(), ref.float(), atol=3e-2, rtol=3e-2)


def _model(cuda, mode, **over):
    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024, **over)
    gen = torch.Generator(device=cuda).manual_seed(7)
    params = tfm.init_params(cfg, device=cuda, generator=gen, dtype=torch.bfloat16)
    quantize = {None: lambda p: p, "int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32,
                "int8_plain": Q.quantize_params_int8, "int4g": Q.quantize_params_int4,
                "int4g_packed": Q.quantize_params_int4_packed}[mode]
    return cfg, quantize(params), gen


def _filled(cfg, rows, gen, dev, fmt=torch.bfloat16):
    """A cache of ``fmt`` whose every slot holds values, as after a prefill."""
    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=fmt, device=dev)
    for t in (kv.k, kv.v):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        else:
            info = torch.iinfo(t.dtype)
            t.copy_(torch.randint(info.min + 1, info.max, t.shape, generator=gen, device=dev, dtype=t.dtype))
    for t in (kv.k_scale, kv.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 1e-3)
    return kv


def _garbage_past(kv, pos):
    """NaN past pos: in the values of a float cache, in the scales of a quantized one."""
    if kv.k_scale is None:
        kv.k[:, pos + 1 :] = float("nan")
        kv.v[:, pos + 1 :] = float("nan")
    elif kv.packed:
        p = torch.arange(pos + 1, kv.max_seq_len, device=kv.k.device)
        for t in (kv.k_scale, kv.v_scale):
            t[:, p % 4, p // 4] = float("nan")
    else:
        kv.k_scale[:, pos + 1 :] = float("nan")
        kv.v_scale[:, pos + 1 :] = float("nan")


def _clone(kv):
    return tfm.KVCache(*(None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)))


def _cache_bits(kv):
    return [t for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]


# (weights, cache format, config overrides, route, batches): each route of the graph loop on the card; the
# 16-row routes take a ragged batch of 8 (at 8 rows or fewer they would be K3 / K7)
ROUTES = [
    (None, torch.bfloat16, {}, "K1", (1, 3)), ("int4", torch.bfloat16, {}, "K3", (1, 3)),
    ("int8", torch.bfloat16, {}, "K7", (1, 3)), ("int4", "int8", {}, "K5/K6", (1, 3)),
    ("int4", "int8_packed", {}, "K5/K6", (1, 3)), ("int8_plain", torch.bfloat16, {}, "K9/K10", (1, 3)),
    (None, torch.bfloat16, {"n_local_heads": 2}, "GQA", (1, 3)),
    ("int8_plain", torch.bfloat16, {"n_local_heads": 2}, "K9/K10", (1, 3)),
    ("int4g", torch.bfloat16, {}, "K12/K13+K1", (1, 3)), ("int4g_packed", torch.bfloat16, {}, "K12/K13+K1", (1, 3)),
    ("int8", torch.bfloat16, {}, "K8+K1", (8,)), ("int4", torch.bfloat16, {}, "int4-unfused", (8,)),
    (None, "int8", {}, "dequant-cache", (1, 3)),
]
ROUTE_CASES = [(m, c, o, r, b) for m, c, o, r, bs in ROUTES for b in bs]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cache,over,route,b", ROUTE_CASES,
                         ids=[f"{r}-{c}-{len(o)}-b{b}" for _, c, o, r, b in ROUTE_CASES])
def test_graph_loop_gives_the_eager_loop_bits(cuda, mode, cache, over, route, b):
    pads = None if b == 1 else (0, 17, 300, 5, 60, 1, 90, 33)[:b]
    cfg, params, gen = _model(cuda, mode, **over)
    base = _filled(cfg, 2 * b, gen, cuda, cache)
    assert fs.step_route(params, cfg, 2 * b, base) == route
    kv = _clone(base)
    eager = _clone(base)
    cur = torch.randint(0, EOA, (b,), generator=gen, device=cuda)
    spk = torch.randn((b, 256), generator=gen, device=cuda)
    pos, n = 370, 160  # crosses K1's window buckets at 384 and 512
    noise = torch.randn((n, b, cfg.vocab_sizes[0]), generator=gen, device=cuda)
    kw = dict(temperature=torch.linspace(0.5, 1.5, b, device=cuda)[:, None], top_p=0.9, guidance_scale=3.0,
              pad_lens=None if pads is None else torch.tensor(pads, dtype=torch.int32, device=cuda), noise=noise)
    before = {k: getattr(f, a) for k, (f, a) in KERNEL_COUNTERS.items()}
    stats_e = {}
    want = fs.decode_eager(params, cfg, cur, pos, eager, spk, n, stats=stats_e, **kw)
    mid = {k: getattr(f, a) for k, (f, a) in KERNEL_COUNTERS.items()}
    stats = {}
    got = fs.decode(params, cfg, cur, pos, kv, spk, n, stats=stats, **kw)
    after = {k: getattr(f, a) for k, (f, a) in KERNEL_COUNTERS.items()}
    assert stats["decode_route"] == "graph" and stats_e["decode_route"] == "eager"
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert all(_same_bits(a, c) for a, c in zip(_cache_bits(kv), _cache_bits(eager)))
    assert {k: after[k] - mid[k] for k in KERNEL_COUNTERS} == {k: mid[k] - before[k] for k in KERNEL_COUNTERS}
    assert stats["decode_steps"] == stats_e["decode_steps"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cache,over,route,b", [r[:4] + (r[4][0],) for r in ROUTES],
                         ids=[f"{r}-{c}-{len(o)}" for _, c, o, r, _ in ROUTES])
def test_capture_before_any_eager_call_raises(cuda, monkeypatch, mode, cache, over, route, b):
    cfg, params, gen = _model(cuda, mode, **over)
    kv = _filled(cfg, 2 * b, gen, cuda, cache)
    spec = fs.StepSpec(2, EOA, 0, torch.bfloat16)
    cur = torch.zeros((b,), dtype=torch.int64, device=cuda)
    state = fs.init_state(cur, 100, torch.zeros((b, 256), device=cuda), 4, spec)
    graphs = fs.StepGraphs(spec, state, cfg.block_size, [], None)
    tables = [(DS, "_stack_tickets"), (A, "_tickets"), (Q, "_int4g_tickets"), (Q, "_prefill_tickets")]
    for mod, name in tables:
        monkeypatch.setattr(mod, name, {})
    if route == "dequant-cache":  # plain PyTorch: nothing to make
        graphs.capture(params, cfg, kv, fs.step_window(route, 100, cfg.block_size))
        return
    with pytest.raises(RuntimeError, match="eager call"):
        graphs.capture(params, cfg, kv, fs.step_window(route, 100, cfg.block_size))
    assert not any(getattr(mod, name) for mod, name in tables)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,cache", [("int4", "int8"), ("int4", "int8_packed"), ("int8_plain", torch.bfloat16)],
                         ids=["K5-int8", "K5-packed", "K9"])
def test_block_attention_eager_loop_repeats_its_bits(cuda, mode, cache):
    """The eager loop of the K5 and K9 routes, run 12 times on the same
    inputs from pos 400 with a row starting at 300, across pos 512 (where a
    split of the bucket's plan ends at pos): every run the first's tokens
    and caches. Only the split that holds pos makes the new row; a split
    ending at pos that made one from its unfilled shared memory gave NaN in
    some runs and not in others."""
    cfg, params, gen = _model(cuda, mode)
    b = 3
    base = _filled(cfg, 2 * b, gen, cuda, cache)
    cur = torch.randint(0, EOA, (b,), generator=gen, device=cuda)
    spk = torch.randn((b, 256), generator=gen, device=cuda)
    noise = torch.randn((113, b, cfg.vocab_sizes[0]), generator=gen, device=cuda)
    kw = dict(temperature=torch.linspace(0.5, 1.5, b, device=cuda)[:, None], top_p=0.9, guidance_scale=3.0,
              pad_lens=torch.tensor((0, 17, 300), dtype=torch.int32, device=cuda), noise=noise)
    runs = []
    for _ in range(12):
        kv = _clone(base)
        tokens, lengths = fs.decode_eager(params, cfg, cur, 400, kv, spk, 113, **kw)
        runs.append([tokens, lengths, *_cache_bits(kv)])
    assert all(torch.isfinite(t.float()).all() for t in _cache_bits(kv) if t.dtype.is_floating_point)
    parted = [i for i, r in enumerate(runs) if not all(_same_bits(a, c) for a, c in zip(runs[0], r))]
    assert not parted, f"runs {parted} of 12 part from the first"
