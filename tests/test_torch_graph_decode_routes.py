"""The decode step of every single-card route as a CUDA-graph step, on the
CPU at a small size: K5/K6 (int4 on the int8 and packed caches), K9/K10
(plain int8, and its GQA form K11 + K4 + K10), dense GQA (K4 at T = 1),
groupwise int4 (K12/K13 + K1), int8 words (K8 + K1), the unfused int4
route (K2 + K1) and the dequantizing quantized-cache path.

* ``decode_step`` reads nothing back to the host on each route;
* the step loop with ``pos`` on the device gives the host-int loop's bits;
* the graph host loop (a stub capture whose replay runs the step eagerly)
  gives ``decode_eager``'s tokens, lengths and caches, one capture a window
  bucket, each replay credited with the route's launches;
* K4's, K5's and K9's plain versions with a tensor ``pos`` give their
  int-``pos`` bits near the window buckets' edges, with starts and NaN past
  ``pos``;
* a route family's ``generate`` through the graph loop gives the JAX
  package's decode-loop tokens under injected noise (int8 cache, plain
  int8, GQA, groupwise int4);
* ``TTS.warmup`` on an int8 cache and an int4 engine's ``warmup`` at 16
  slots capture every window bucket of their route.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu.ops import quantized as jqz  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402
from test_torch_graph_decode import _StubGraph, _same_bits, no_host_reads  # noqa: E402

_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))
_jax_forward = jax.jit(jtfm.forward, static_argnames=("cfg", "compute_dtype"))

EOA = 96  # an in-vocabulary end-of-audio token
SMALL = dict(n_layer=2, n_head=4, dim=64, block_size=512, vocab_sizes=(128,))
WIDE4 = dict(n_layer=1, n_head=8, dim=1024, block_size=512, vocab_sizes=(128,))  # K5/K6's widths
WIDE8 = dict(n_layer=1, n_head=4, dim=512, intermediate_size=1536, block_size=512, vocab_sizes=(128,))  # K9's


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(dims, seed=0, dtype=torch.float32):
    cfg = first_stage_config(**dims)
    return cfg, tfm.init_params(cfg, device="cpu", generator=torch.Generator().manual_seed(seed), dtype=dtype)


# route case -> (dims, overrides, quantizer, cache format, compute dtype, the route, the kernels a step
# launches on the card: {wrapper: launches a layer})
CASES = {
    "K5/K6-int8": (WIDE4, {}, Q.quantize_params_int4_i32, "int8", torch.bfloat16, "K5/K6",
                   {A.decode_attention_block_int4: 1, Q.decode_ffn_int4: 1}),
    "K5/K6-packed": (WIDE4, {}, Q.quantize_params_int4_i32, "int8_packed", torch.bfloat16, "K5/K6",
                     {A.decode_attention_block_int4: 1, Q.decode_ffn_int4: 1}),
    "K9/K10": (WIDE8, {}, Q.quantize_params_int8, torch.bfloat16, torch.bfloat16, "K9/K10",
               {A.decode_attention_block_int8: 1, Q.ffn_int8: 1}),
    "K9/K10-gqa": (WIDE8, {"n_local_heads": 2}, Q.quantize_params_int8, torch.bfloat16, torch.bfloat16, "K9/K10",
                   {Q.matmul_int8: 2, A.decode_attention_multi: 1, Q.ffn_int8: 1}),
    "GQA": (SMALL, {"n_local_heads": 2}, None, torch.float32, torch.float32, "GQA", {A.decode_attention_multi: 1}),
    "K12+K1": (SMALL, {}, lambda p: Q.quantize_params_int4(p, groupsize=32), torch.float32, torch.float32,
               "K12/K13+K1", {Q.matmul_int4: 5, A.decode_attention: 1}),
    "K13+K1": (SMALL, {}, lambda p: Q.quantize_params_int4_packed(p, groupsize=32), torch.float32, torch.float32,
               "K12/K13+K1", {Q.matmul_int4_packed: 5, A.decode_attention: 1}),
    "K8+K1": (SMALL, {}, Q.quantize_params_int8_i32, torch.float32, torch.float32, "K8+K1",
              {Q.matmul_int8_i32: 5, A.decode_attention: 1}),
    "int4-unfused": (SMALL, {}, Q.quantize_params_int4_i32, torch.float32, torch.float32, "int4-unfused",
                     {Q.matmul_int4_i32: 5, A.decode_attention: 1}),
    "dequant-int8": (SMALL, {}, None, "int8", torch.float32, "dequant-cache", {}),
    "dequant-packed": (SMALL, {}, None, "int8_packed", torch.float32, "dequant-cache", {}),
}
_built: dict = {}


def _case(name):
    """(cfg, params, cache format, compute dtype, route, launches a step), built once a case."""
    if name not in _built:
        dims, over, quantize, fmt, compute, route, kernels = CASES[name]
        cfg, dense = _dense(dims | over, dtype=torch.bfloat16 if compute == torch.bfloat16 else torch.float32)
        params = dense if quantize is None else quantize(dense)
        _built[name] = (cfg, params, fmt, compute, route, {f: n * cfg.n_layer for f, n in kernels.items()})
    return _built[name]


def _filled(cfg, rows, fmt, seed=3):
    """A cache of ``fmt`` whose every slot holds values, as after a prefill."""
    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=fmt, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for t in (kv.k, kv.v):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, dtype=torch.int8))
        else:
            t.copy_(torch.randint(-2**31, 2**31 - 1, t.shape, generator=gen, dtype=torch.int32))
    for t in (kv.k_scale, kv.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen) * 0.02 + 1e-3)
    return kv


def _clone(kv):
    return tfm.KVCache(*(None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)))


def _cache_bits(kv):
    return [t for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]


def _noise(n, b, vocab, seed=2):
    return torch.from_numpy(np.random.default_rng(seed).gumbel(size=(n, b, vocab)).astype(np.float32) * 0.1)


def _setup(name, b=2, pos=A.ATTN_ONE_SPLIT - 2, n=8, pads=(0, 37)):
    cfg, params, fmt, compute, route, _ = _case(name)
    rng = np.random.default_rng(1)
    cur = torch.as_tensor(rng.integers(0, EOA, size=b), dtype=torch.int64)
    spk = torch.as_tensor(rng.normal(size=(b, 256)).astype(np.float32))
    kv = _filled(cfg, 2 * b, fmt)
    assert fs.step_route(params, cfg, 2 * b, kv) == route
    knobs = dict(temperature=torch.tensor([[0.5], [1.2]][:b]), top_p=0.9, guidance_scale=3.0,
                 pad_lens=None if pads is None else torch.tensor(pads[:b], dtype=torch.int32),
                 noise=_noise(n, b, cfg.vocab_sizes[0]))
    return cfg, params, compute, route, cur, spk, kv, knobs


def _state(cur, pos, spk, n, spec, knobs):
    return fs.init_state(cur, pos, spk, n, spec, temperature=knobs["temperature"], top_p=knobs["top_p"],
                         guidance_scale=knobs["guidance_scale"], pad_lens=knobs["pad_lens"], noise=knobs["noise"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_step_reads_nothing_back(name):
    cfg, params, compute, route, cur, spk, kv, knobs = _setup(name, n=4)
    spec = fs.StepSpec(2, EOA, 0, compute)
    pos = A.ATTN_ONE_SPLIT - 2
    state = _state(cur, pos, spk, 4, spec, knobs)
    with torch.inference_mode(), no_host_reads():
        for i in range(4):  # crosses the first window bucket
            fs.decode_step(params, cfg, kv, state, spec, window=fs.step_window(route, pos + i, cfg.block_size))
    assert state.step.view(1).tolist() == [4] and state.pos.view(1).tolist() == [pos + 4]


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_pos_steps_give_the_host_int_bits(name):
    n = 6
    cfg, params, compute, route, cur, spk, kv, knobs = _setup(name, n=n)
    spec = fs.StepSpec(2, EOA, 0, compute)
    pos = A.ATTN_ONE_SPLIT - 3
    kv_host = _clone(kv)
    dev, host = _state(cur, pos, spk, n, spec, knobs), _state(cur, pos, spk, n, spec, knobs)
    with torch.inference_mode():
        for i in range(n):
            fs.decode_step(params, cfg, kv, dev, spec, window=fs.step_window(route, pos + i, cfg.block_size))
            fs.decode_step(params, cfg, kv_host, host, spec, cache_pos=pos + i)
    assert torch.equal(dev.tokens, host.tokens) and torch.equal(dev.lengths, host.lengths)
    assert all(_same_bits(a, c) for a, c in zip(_cache_bits(kv), _cache_bits(kv_host)))


@pytest.fixture
def stub_capture(monkeypatch):
    """``StepGraphs.capture`` on the CPU: a replay runs the step eagerly on
    the call's weights and cache, credited with ``credit`` (the route's
    launches a step, set by the test); records the windows captured."""
    captured = []
    call = {}
    credit: dict = {}
    step = fs.StepGraphs.step

    def step_in_call(self, params, cfg, kv_cache, window):
        call.update(params=params, cfg=cfg, kv_cache=kv_cache)
        try:
            step(self, params, cfg, kv_cache, window)
        finally:
            call.clear()

    def capture(self, params, cfg, kv_cache, window):
        captured.append(window)
        credits = []
        with fs.uncounted(credits):
            for fn, n in credit.items():
                attr = "launches"
                setattr(fn, attr, getattr(fn, attr) + n)
        graph = _StubGraph(lambda: fs.decode_step(call["params"], call["cfg"], call["kv_cache"], self.state,
                                                  self.spec, window=window, generator=self.generator))
        return graph, credits

    monkeypatch.setattr(fs.StepGraphs, "step", step_in_call)
    monkeypatch.setattr(fs.StepGraphs, "capture", capture)
    fs.release_graphs()
    yield captured, credit
    fs.release_graphs()


@pytest.mark.parametrize("name", sorted(CASES))
def test_graph_loop_equals_the_eager_loop(name, stub_capture):
    captured, credit = stub_capture
    pos, n = A.ATTN_ONE_SPLIT - 4, 10  # crosses the bucket at 384
    cfg, params, compute, route, cur, spk, kv, knobs = _setup(name, pos=pos, n=n)
    credit.update(_case(name)[5])
    kw = dict(end_of_audio_token=EOA, compute_dtype=compute, **knobs)
    kv0 = _clone(kv)
    want = fs.decode_eager(params, cfg, cur, pos, kv0, spk, n, **kw)
    before = {f: f.launches for f in credit}
    stats = {}
    got = fs._decode(params, cfg, cur, pos, kv, spk, n, True, stats=stats, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(_same_bits(a, c) for a, c in zip(_cache_bits(kv), _cache_bits(kv0)))
    assert stats == {"decode_steps": n, "decode_route": "graph"}
    buckets = [w for w in fs.window_buckets(route, cfg.block_size) if w > pos][:2]
    assert captured == (buckets if route != "dequant-cache" else [cfg.block_size])
    # every step but the warm ones (one a bucket, uncounted on the CPU) is a replay credited with the route's launches
    assert {f: f.launches - before[f] for f in credit} == {f: k * (n - len(captured)) for f, k in credit.items()}


def test_window_buckets_of_every_route():
    s = 2048
    for route, how in fs.DECODE_ROUTES.items():
        if how != "graph":
            continue
        want = [s] if route in fs.WHOLE_CACHE_ROUTES else [384, 512, 1024, 2048]
        assert fs.window_buckets(route, s) == want, route
        for p in (0, 383, 384, 1000, 2047):
            assert p < fs.step_window(route, p, s) == (s if route in fs.WHOLE_CACHE_ROUTES
                                                       else A.attention_window(p + 1, s)), (route, p)


# ---------------------------------------------------------------- the plain versions with pos on the device

POSITIONS = [0, 255, 383, 384, 511, 512, 1000, 2047]


def _k4_args(pos, starts, nan, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, h, h_kv, dh, s = 2, 8, 2, 64, 2048
    q = torch.randn(b, h, 1, dh, generator=gen)
    kn, vn = (torch.randn(b, h_kv, 1, dh, generator=gen) for _ in range(2))
    kc, vc = (torch.randn(2, s, b, h_kv, dh, generator=gen) for _ in range(2))
    if nan:
        kc[:, pos + 1 :] = float("nan")
        vc[:, pos + 1 :] = float("nan")
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    return [q, kn, vn, kc, vc, 1], st


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("starts,nan", [(None, False), ((3, 2047), True)])
def test_k4_plain_version_device_pos_gives_the_int_bits(pos, starts, nan):
    host, st = _k4_args(pos, starts, nan)
    dev, _ = _k4_args(pos, starts, nan)
    y_h, kh, vh = A.decode_attention_multi(*host, pos, st)
    y_d, kd, vd = A.decode_attention_multi(*dev, torch.tensor(pos, dtype=torch.int32), st,
                                           window=A.attention_window(pos + 1, 2048))
    assert _same_bits(y_h, y_d) and _same_bits(kh, kd) and _same_bits(vh, vd) and torch.isfinite(y_d).all()
    # the same attention as the spec verify's plan over [0, pos + 1), within rounding
    ref, _, _ = A.decode_attention_multi_reference(*_k4_args(pos, starts, nan)[0][:5], 1, pos, st, window=pos + 1)
    torch.testing.assert_close(y_d, ref, rtol=1e-5, atol=1e-6)


def _block_cache(fmt, pos, nan, b, h_kv, seed=4):
    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024, block_size=2048, n_local_heads=h_kv)
    kv = _filled(cfg, b, {"bf16": torch.bfloat16, "int8": "int8", "packed": "int8_packed"}[fmt], seed)
    if nan:  # garbage past pos: NaN values (float) and NaN scales (quantized)
        if fmt == "bf16":
            kv.k[:, pos + 1 :] = float("nan")
            kv.v[:, pos + 1 :] = float("nan")
        elif fmt == "int8":
            kv.k_scale[:, pos + 1 :] = float("nan")
            kv.v_scale[:, pos + 1 :] = float("nan")
        else:
            p = torch.arange(pos + 1, 2048)
            for t in (kv.k_scale, kv.v_scale):
                t[:, p % 4, p // 4] = float("nan")
    return cfg, kv


_W4: dict = {}


def _w4():
    if not _W4:
        cfg, dense = _dense(dict(n_layer=2, n_head=8, dim=1024, n_local_heads=2, block_size=2048, vocab_sizes=(128,)),
                            dtype=torch.bfloat16)
        q = Q.quantize_params_int4_i32(dense)["layers"]
        _W4.update(wqkv=(q["wqkv"]["pw"], q["wqkv"]["sc"]), wo=(q["wo"]["pw"], q["wo"]["sc"]))
    return _W4


@pytest.mark.parametrize("pos", [0, 383, 384, 1000, 2047])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "packed"])
def test_k5_plain_version_device_pos_gives_the_int_bits(fmt, pos):
    w = _w4()
    b, h_kv = 2, 2
    gen = torch.Generator().manual_seed(pos)
    xa = torch.randn(b, 1024, generator=gen).to(torch.bfloat16)
    st = torch.tensor([5, 2047], dtype=torch.int32)
    outs = []
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        _, kv = _block_cache(fmt, pos, True, b, h_kv)
        win = A.attention_window(pos + 1, 2048) if isinstance(p, torch.Tensor) else None
        y, *_ = A.decode_attention_block_int4(xa, *w["wqkv"], *w["wo"], kv.k, kv.v, 1, p, 8, n_kv_head=h_kv,
                                              starts=st, k_scale=kv.k_scale, v_scale=kv.v_scale, window=win)
        outs.append((y, _cache_bits(kv)))
    (y_h, c_h), (y_d, c_d) = outs
    assert _same_bits(y_h, y_d) and all(_same_bits(a, c) for a, c in zip(c_h, c_d)) and torch.isfinite(y_d).all()


_W8: dict = {}


@pytest.mark.parametrize("pos", [0, 383, 384, 1000, 2047])
@pytest.mark.parametrize("starts", [None, (5, 2047)])
def test_k9_plain_version_device_pos_gives_the_int_bits(pos, starts):
    if not _W8:
        cfg, dense = _dense(dict(n_layer=1, n_head=4, dim=512, block_size=2048, vocab_sizes=(128,)),
                            dtype=torch.bfloat16)
        q = Q.quantize_params_int8(dense)["layers"]
        _W8.update(w=(q["wqkv"]["q"][0], q["wqkv"]["scales"][0], q["wo"]["q"][0], q["wo"]["scales"][0]))
    b = 2
    gen = torch.Generator().manual_seed(pos)
    xa = torch.randn(b, 512, generator=gen).to(torch.bfloat16)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    outs = []
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        kc, vc = (torch.randn(2, 2048, b, 4, 128, generator=torch.Generator().manual_seed(9)).to(torch.bfloat16)
                  for _ in range(2))
        kc[:, pos + 1 :] = float("nan")
        vc[:, pos + 1 :] = float("nan")
        win = A.attention_window(pos + 1, 2048) if isinstance(p, torch.Tensor) else None
        y, kc, vc = A.decode_attention_block_int8(xa, *_W8["w"], kc, vc, 1, p, 4, starts=st, window=win)
        outs.append((y, kc, vc))
    assert all(_same_bits(a, c) for a, c in zip(*outs)) and torch.isfinite(outs[1][0]).all()


def test_device_pos_is_checked():
    host, st = _k4_args(10, None, False)
    with pytest.raises(ValueError, match="device pos is one int32"):
        A.decode_attention_multi(*host, torch.tensor(10), st)
    with pytest.raises(ValueError, match=r"window 384 must hold rows \[383, 385\)"):  # T = 2 past the bucket
        q, kn, vn, kc, vc, layer = host
        A.decode_attention_multi(q.repeat(1, 1, 2, 1), kn.repeat(1, 1, 2, 1), vn.repeat(1, 1, 2, 1), kc, vc, layer,
                                 383, window=384)
    w = _w4()
    _, kv = _block_cache("int8", 10, False, 2, 2)
    xa = torch.zeros(2, 1024, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="pos 500 / window 384"):
        A.decode_attention_block_int4(xa, *w["wqkv"], *w["wo"], kv.k, kv.v, 1, 500, 8, n_kv_head=2,
                                      k_scale=kv.k_scale, v_scale=kv.v_scale, window=384)


def test_quantized_cache_row_writes_take_a_device_pos():
    """The dequantizing path's writes with pos on the device: the same bits
    as an int's slices, at every residue of the packed word."""
    cfg = first_stage_config(**SMALL)
    for fmt in ("int8", "int8_packed"):
        for pos in (0, 1, 2, 3, 382, 511):
            a, b = _filled(cfg, 4, fmt), _filled(cfg, 4, fmt)
            gen = torch.Generator().manual_seed(pos)
            k_new, v_new = (torch.randn(4, 4, 1, 16, generator=gen) for _ in range(2))
            ka, va = tfm._quantized_window(a, 1, pos, k_new, v_new, torch.float32)
            kb, vb = tfm._quantized_window(b, 1, torch.tensor(pos, dtype=torch.int32), k_new, v_new, torch.float32)
            assert all(_same_bits(x, y) for x, y in zip(_cache_bits(a) + [ka, va], _cache_bits(b) + [kb, vb]))
            starts = torch.tensor([0, 7, 300, 0], dtype=torch.int32)
            assert torch.equal(tfm._window_mask(pos, 1, 512, starts, "cpu"),
                               tfm._window_mask(torch.tensor(pos, dtype=torch.int32), 1, 512, starts, "cpu"))


# ---------------------------------------------------------------- the JAX package's decode loop, through the graph loop

def _jax_tokens(jcfg, jparams, prompt, spk, noise, n_tokens, cache_dtype, temperature, top_p, guidance=3.0):
    """Prefill + T = 1 cached steps of the JAX package's forward (jitted
    once a shape) and sampling, the noise added where
    ``jax.random.categorical`` would draw it."""
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=jcfg.block_size)
    kv = jtfm.KVCache.create(jcfg, 2, jcfg.block_size, dtype=cache_dtype)
    spk2 = jnp.repeat(jnp.asarray(spk).reshape(1, -1), 2, axis=0)
    mask = jfs.make_spk_cond_mask(1)

    def sample(logits, i):
        merged = JS.top_p_mask(JS.apply_temperature(JS.cfg_merge(logits, guidance), temperature), top_p)
        return int(jnp.argmax(merged + jnp.asarray(noise[i]), axis=-1)[0])

    tokens = np.stack([padded, padded])
    logits, kv = _jax_forward(jparams, jcfg, jnp.asarray(tokens), spk_emb=spk2, spk_cond_mask=mask, kv_cache=kv,
                              cache_pos=0, compute_dtype=jnp.float32)
    out = [sample(logits[0][:, t_true - 1], 0)]
    for i in range(1, n_tokens):
        if out[-1] == EOA:
            break
        step = np.array([[out[-1]], [out[-1]]], np.int32)
        logits, kv = _jax_forward(jparams, jcfg, jnp.asarray(step), spk_emb=spk2, spk_cond_mask=mask, kv_cache=kv,
                                  cache_pos=t_true + i - 1, compute_dtype=jnp.float32)
        out.append(sample(logits[0][:, 0], i))
    return np.asarray(out, np.int32)


# family -> (config keywords, JAX quantizer, the JAX cache dtype, the port's cache format)
FAMILIES = {
    "int8-cache": (SMALL, None, jnp.int8, "int8"),
    "int8_plain": (dict(WIDE8, n_layer=2), jqz.quantize_params_int8, jnp.bfloat16, torch.bfloat16),  # K9 takes bf16
    "GQA": (dict(SMALL, n_local_heads=2), None, jnp.float32, None),
    "groupwise": (SMALL, lambda p: jqz.quantize_params_int4(p, groupsize=32), jnp.float32, None),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_graph_loop_tokens_equal_the_jax_loop(family, stub_capture, monkeypatch):
    dims, jquantize, jcache, cache_fmt = FAMILIES[family]
    jcfg = j_first_stage_config(**dims)
    jparams = _jax_init(jax.random.PRNGKey(3), cfg=jcfg, dtype=jnp.float32)
    if jquantize is not None:
        jparams = jax.jit(jquantize)(jparams)
    cfg = first_stage_config(**dims)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    n_tokens = 20
    rng = np.random.default_rng(5)
    prompt = rng.integers(EOA + 1, dims["vocab_sizes"][0], size=21).tolist()
    spk = rng.normal(size=(256,)).astype(np.float32)
    noise = torch.from_numpy(rng.gumbel(size=(n_tokens, 1, dims["vocab_sizes"][0])).astype(np.float32))
    temperature, top_p = 1.0, 0.95
    want = _jax_tokens(jcfg, jparams, prompt, spk, noise.numpy(), n_tokens, jcache, temperature, top_p)
    monkeypatch.setattr(fs, "graphs_on", lambda device: True)  # decode's graph loop, on the stub capture
    stats = {}
    got = fs.generate(params, cfg, prompt, spk, temperature=temperature, top_p=top_p, guidance_scale=3.0,
                      max_new_tokens=n_tokens, end_of_audio_token=EOA, compute_dtype=torch.float32,
                      cache_dtype=cache_fmt, noise=noise, stats=stats)[len(prompt):]
    np.testing.assert_array_equal(got, want)
    windows = [512] if family == "int8-cache" else [A.attention_window(len(prompt) + 1, 512)]
    assert stats["decode_route"] == "graph" and stub_capture[0] == windows


# ---------------------------------------------------------------- warm start

def test_int8_cache_tts_warmup_captures_every_bucket(stub_capture, monkeypatch):
    from metavoice_tpu_torch.runtime.tts import TTS

    monkeypatch.setattr(fs, "graphs_on", lambda device: True)
    tts = TTS.from_random(small=True, device="cpu", kv_cache_dtype="int8")
    tts.warmup(prompt_buckets=(128,), vocoder_frame_buckets=(25,), guidance_variants=(3.0,))
    cfg = tts.c.first_stage_cfg
    kv = tts._persistent_kv_cache(3.0)
    assert fs.step_route(tts.c.first_stage_params, cfg, 2, kv) == "dequant-cache"
    assert stub_capture[0] == fs.window_buckets("dequant-cache", kv.max_seq_len)


def test_int4_engine_at_16_slots_warmup_captures_every_bucket(stub_capture, monkeypatch):
    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
    from metavoice_tpu_torch.runtime.tts import TTS

    monkeypatch.setattr(fs, "graphs_on", lambda device: True)
    tts = TTS.from_random(small=True, device="cpu", quantisation_mode="int4")
    eng = ContinuousBatchingEngine(tts, slots=16, segment_tokens=16)
    try:
        eng.warmup(prompt_buckets=(128,), warm_tts=False)
        route = fs.step_route(tts.c.first_stage_params, tts.c.first_stage_cfg, 32, eng._kv)
        assert route == "int4-unfused"
        assert stub_capture[0] == fs.window_buckets(route, eng._kv.max_seq_len)
    finally:
        eng.shutdown()


def test_uncounted_credits_the_sub_counters():
    """A replay credits K11's GEMV-route counter too (no TTS.stats key)."""
    credits = []
    before = (Q.matmul_int8.launches, Q.matmul_int8.gemv_launches)
    with fs.uncounted(credits):
        Q.matmul_int8.launches += 3
        Q.matmul_int8.gemv_launches += 3
    assert (Q.matmul_int8.launches, Q.matmul_int8.gemv_launches) == before
    assert {(Q.matmul_int8, "launches", 3), (Q.matmul_int8, "gemv_launches", 3)} <= set(credits)
