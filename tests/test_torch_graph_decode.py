"""The first stage's decode loop as a step on device tensors (``DecodeState``,
``decode_step``), its CUDA-graph runner's bookkeeping, and K1 with its
position on the device, on the CPU at a small size.

* the ``decode_step`` loop against the eager loop the port had before it
  (kept here as ``_loop_before``), bit for bit under injected noise;
* the same tokens as the JAX package's step loop (f32, the same noise);
* ``decode_step`` reads nothing back to the host;
* K1's plain version with a tensor ``pos`` in a window bucket against the
  host-int call;
* the window buckets, the graph sets' keys and the launch crediting, with a
  stub capture whose replay runs the step eagerly (the host loop of
  ``decode`` as it runs on the card), and knobs that change between calls.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from metavoice_tpu.core import sampling as JS  # noqa: E402
from metavoice_tpu.core.config import first_stage_config as j_first_stage_config  # noqa: E402
from metavoice_tpu.models import first_stage as jfs  # noqa: E402
from metavoice_tpu.models import transformer as jtfm  # noqa: E402
from metavoice_tpu_torch.core.config import first_stage_config  # noqa: E402
from metavoice_tpu_torch.models import first_stage as fs  # noqa: E402
from metavoice_tpu_torch.models import transformer as tfm  # noqa: E402
from metavoice_tpu_torch.ops import attention as A  # noqa: E402
from metavoice_tpu_torch.ops import quantized as Q  # noqa: E402
from metavoice_tpu_torch.utils.checkpoint import params_from_numpy  # noqa: E402

# the JAX init and forward compiled once a config / shape (cache_pos is traced)
_jax_init = jax.jit(jtfm.init_params, static_argnames=("cfg", "dtype"))
_jax_forward = jax.jit(jtfm.forward, static_argnames=("cfg", "compute_dtype"))

DIMS = dict(n_layer=2, n_head=4, dim=64, block_size=512, vocab_sizes=(128,))
EOA = 96  # an in-vocabulary end-of-audio token, so the noise can force it
EOT = 100  # the third guidance group's end-of-text (ids above EOA are text)
NOISE_SCALE = 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = j_first_stage_config(**DIMS)
    jparams = _jax_init(jax.random.PRNGKey(0), cfg=jcfg, dtype=jnp.float32)
    return jcfg, jparams, first_stage_config(**DIMS), params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                                        device="cpu")


def _noise(n, b, seed=2, eoa_at=()):
    noise = (np.random.default_rng(seed).gumbel(size=(n, b, DIMS["vocab_sizes"][0])) * NOISE_SCALE)
    noise = noise.astype(np.float32)
    for step, row in eoa_at:
        noise[step, row, EOA] = 1e4
    return torch.from_numpy(noise)


def _filled_cache(cfg, rows, seed=3, dtype=torch.float32):
    """A cache whose every slot holds values, as after a prefill."""
    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=dtype, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for t in (kv.k, kv.v):
        t.copy_(torch.randn(t.shape, generator=gen))
    return kv


def _clone(kv):
    return tfm.KVCache(kv.k.clone(), kv.v.clone())


@torch.inference_mode()
def _loop_before(params, cfg, cur_token, pos, kv_cache, spk_emb, max_steps, *, temperature, top_p, guidance_scale,
                 cfg_rows=2, prompt_guidance_scale=1.0, pad_lens=None, end_of_text_token=0, noise=None):
    """The port's decode loop before the step became a function of device
    tensors: the host's int position into every layer, knobs as given."""
    b = cur_token.shape[0]
    spk_rows = fs._cfg_rows(spk_emb, cfg_rows)
    mask = fs.make_spk_cond_mask(b, cfg_rows, device="cpu")
    starts = None if pad_lens is None else fs._cfg_rows(pad_lens.to(dtype=torch.int32), cfg_rows)
    slots = torch.arange(kv_cache.max_seq_len)
    eoa = torch.full_like(cur_token, EOA)
    tokens = torch.full((b, max_steps), EOA, dtype=torch.int64)
    lengths = torch.zeros_like(cur_token)
    done = cur_token == EOA
    cur = cur_token
    for step in range(max(0, min(max_steps, kv_cache.max_seq_len - pos))):
        if step % fs.DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
        p = pos + step
        positions = slots[p : p + 1] if starts is None else (p - starts).long()[:, None]
        x = tfm.embed_inputs(params, cfg, fs.guidance_rows(cur[:, None], cfg_rows, end_of_text_token),
                             positions, spk_rows, mask, torch.float32)
        out, _, head_done = tfm.apply_blocks(params, cfg, x, None, kv_cache, p, attn_starts=starts, fused_head=True)
        logits = out if head_done else tfm.output_logits(params, cfg, out)[0][:, 0, :]
        sampled = fs.sample_guided(logits, guidance_scale, prompt_guidance_scale, cfg_rows, temperature, top_p,
                                   noise=None if noise is None else noise[step])
        nxt = torch.where(done, eoa, sampled)
        tokens[:, step] = nxt
        lengths += (~done).to(lengths.dtype)
        done = done | (nxt == EOA)
        cur = nxt
    return tokens, lengths


def _case(cfg, b, cfg_rows, pos, seed=0):
    rng = np.random.default_rng(seed)
    cur = torch.as_tensor(rng.integers(0, EOA, size=b), dtype=torch.int64)
    spk = torch.as_tensor(rng.normal(size=(b, 256)).astype(np.float32))
    return cur, spk, _filled_cache(cfg, cfg_rows * b, seed=seed + 1)


LOOP_CASES = {
    # name: (rows b, guidance, start pos, max_steps, noise's forced EOA cells, knobs per row, pad_lens)
    "two-rows": (1, 3.0, 100, 24, (), False, None),
    "three-rows": (1, (2.0, 1.5), 100, 24, (), False, None),
    "eoa-at-5": (1, 3.0, 100, 30, ((5, 0),), False, None),
    "eoa-at-latch": (1, 3.0, 100, 40, ((fs.DONE_CHECK_EVERY - 1, 0),), False, None),
    "budget-inside-latch-window": (1, 3.0, 100, fs.DONE_CHECK_EVERY + 5, (), False, None),
    "pos-reaches-block-size": (1, 3.0, DIMS["block_size"] - 10, 24, (), False, None),
    "crosses-window-bucket": (1, 3.0, A.ATTN_ONE_SPLIT - 8, 20, (), False, None),
    "ragged-per-row-knobs": (3, 3.0, 200, 26, ((7, 1),), True, (0, 37, 150)),
    "ragged-three-rows": (2, (2.5, 1.5), 64, 20, ((3, 0),), True, (5, 60)),
}


@pytest.mark.parametrize("name", sorted(LOOP_CASES))
def test_step_loop_equals_the_loop_before(model, name):
    _, _, cfg, params = model
    b, guidance, pos, max_steps, eoa_at, per_row, pads = LOOP_CASES[name]
    spk_g, prompt_g, rows = fs._normalize_guidance(guidance)
    cur, spk, kv = _case(cfg, b, rows, pos)
    noise = _noise(max_steps, b, eoa_at=eoa_at)
    # a forced EOA needs it inside the nucleus: top-p 1 on the rows it is forced on
    knobs = dict(temperature=1.0 if eoa_at else 0.1, top_p=1.0 if eoa_at else 0.95, guidance_scale=spk_g)
    if per_row:
        knobs = dict(temperature=torch.tensor([[1.0], [0.7], [1.3]][:b]), top_p=torch.tensor([[1.0], [1.0], [0.8]][:b]),
                     guidance_scale=torch.tensor([[spk_g], [1.5], [2.0]][:b]))
    pad_lens = None if pads is None else torch.tensor(pads, dtype=torch.int32)
    common = dict(cfg_rows=rows, prompt_guidance_scale=prompt_g, pad_lens=pad_lens, end_of_text_token=EOT, noise=noise,
                  **knobs)
    kv0 = _clone(kv)
    want_tokens, want_lengths = _loop_before(params, cfg, cur, pos, kv0, spk, max_steps, **common)
    stats = {}
    got_tokens, got_lengths = fs.decode(params, cfg, cur, pos, kv, spk, max_steps, end_of_audio_token=EOA,
                                        compute_dtype=torch.float32, stats=stats, **common)
    assert torch.equal(got_tokens, want_tokens)
    assert torch.equal(got_lengths, want_lengths)
    assert torch.equal(kv.k, kv0.k) and torch.equal(kv.v, kv0.v)
    assert stats["decode_route"] == "eager"  # the CPU has no graphs
    assert cur.tolist() == _case(cfg, b, rows, pos)[0].tolist()  # the caller's tokens are not written
    if eoa_at:
        assert (got_lengths < max_steps).any()


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def _jax_loop(jcfg, jparams, prompt, spk, noise, guidance, n_tokens, temperature, top_p):
    """Prefill + T=1 cached steps of the JAX package's forward and sampling
    (the ``tests/test_torch_tts.py`` oracle), the noise added where
    ``jax.random.categorical`` would draw it."""
    padded, t_true = jfs.pad_to_bucket(prompt, 128, max_len=jcfg.block_size)
    spk_g, prompt_g, rows = jfs._normalize_guidance(guidance)
    kv = jtfm.KVCache.create(jcfg, rows, jcfg.block_size, dtype=jnp.float32)
    spk2 = jnp.repeat(jnp.asarray(spk).reshape(1, -1), rows, axis=0)
    mask = jfs.make_spk_cond_mask(1, rows)

    def batch(tokens):
        tokens = jnp.asarray(tokens)[None]
        return jnp.concatenate([tokens, tokens, jfs._uncond_prompt_rows(tokens, EOT)][:rows], axis=0)

    def sample(logits, i):
        merged = JS.cfg_merge3(logits, spk_g, prompt_g) if rows == 3 else JS.cfg_merge(logits, spk_g)
        merged = JS.top_p_mask(JS.apply_temperature(merged, temperature), top_p)
        return int(jnp.argmax(merged + jnp.asarray(noise[i]), axis=-1)[0])

    logits, kv = _jax_forward(jparams, jcfg, batch(padded), spk_emb=spk2, spk_cond_mask=mask, kv_cache=kv,
                              cache_pos=0, compute_dtype=jnp.float32)
    out = [sample(logits[0][:, t_true - 1], 0)]
    for i in range(1, n_tokens):
        if out[-1] == EOA:
            break
        logits, kv = _jax_forward(jparams, jcfg, batch(np.array([out[-1]], np.int32)), spk_emb=spk2,
                                  spk_cond_mask=mask, kv_cache=kv, cache_pos=t_true + i - 1,
                                  compute_dtype=jnp.float32)
        out.append(sample(logits[0][:, 0], i))
    return np.asarray(out, np.int32)


@pytest.mark.parametrize("guidance,eoa_at", [(3.0, None), ((2.0, 1.5), None), (3.0, 11)])
def test_step_loop_tokens_equal_the_jax_loop(model, guidance, eoa_at):
    jcfg, jparams, cfg, params = model
    n_tokens = 24
    rng = np.random.default_rng(5)
    prompt = rng.integers(EOA + 1, DIMS["vocab_sizes"][0], size=21).tolist()
    spk = rng.normal(size=(256,)).astype(np.float32)
    noise = _noise(n_tokens, 1, seed=6, eoa_at=() if eoa_at is None else ((eoa_at, 0),))
    temperature, top_p = (0.1, 0.95) if eoa_at is None else (1.0, 1.0)  # a forced EOA inside the nucleus
    want = _jax_loop(jcfg, jparams, prompt, spk, noise.numpy(), guidance, n_tokens, temperature, top_p)
    stats = {}
    got = fs.generate(params, cfg, prompt, spk, temperature=temperature, top_p=top_p, guidance_scale=guidance,
                      max_new_tokens=n_tokens, end_of_audio_token=EOA, end_of_text_token=EOT,
                      compute_dtype=torch.float32, noise=noise, stats=stats)[len(prompt):]
    np.testing.assert_array_equal(got, want)
    assert stats["decode_steps"] >= len(want) - 1 and stats["decode_route"] == "eager"
    if eoa_at is not None:
        assert got[-1] == EOA and len(got) == eoa_at + 1


@contextlib.contextmanager
def no_host_reads():
    """Inside, any read of a tensor's value back to the host raises."""

    def refuse(name):
        def method(*args, **kwargs):
            raise AssertionError(f"Tensor.{name} read a value back to the host")
        return method

    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__", "numpy"):
            mp.setattr(torch.Tensor, name, refuse(name))
        yield


def _int4_model(n_layer=1):
    """A 1024-wide first stage on the int4 or int8 decode-stack routes."""
    cfg = first_stage_config(n_layer=n_layer, n_head=8, dim=1024, block_size=512, vocab_sizes=(256,))
    gen = torch.Generator().manual_seed(7)
    return cfg, tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16)


@pytest.mark.parametrize("route", ["K1", "K3", "K7"])
def test_decode_step_reads_nothing_back(model, route):
    if route == "K1":
        _, _, cfg, params = model
        dtype, compute, vocab = torch.float32, torch.float32, DIMS["vocab_sizes"][0]
    else:
        cfg, dense = _int4_model()
        params = (Q.quantize_params_int4_i32 if route == "K3" else Q.quantize_params_int8_i32)(dense)
        dtype, compute, vocab = torch.bfloat16, torch.bfloat16, 256
    b = 2
    spec = fs.StepSpec(2, EOA, 0, compute)
    rng = np.random.default_rng(8)
    kv = _filled_cache(cfg, 2 * b, dtype=dtype)
    assert fs.step_route(params, cfg, 2 * b, kv) == route
    cur = torch.as_tensor(rng.integers(0, EOA, size=b), dtype=torch.int64)
    state = fs.init_state(cur, A.ATTN_ONE_SPLIT - 2, torch.randn(b, 256), 8, spec, temperature=0.5,
                          pad_lens=torch.tensor([0, 3], dtype=torch.int32),
                          noise=torch.randn(8, b, vocab))
    with torch.inference_mode(), no_host_reads():
        for i in range(4):  # crosses K1's first bucket
            window = fs.step_window(route, A.ATTN_ONE_SPLIT - 2 + i, cfg.block_size)
            fs.decode_step(params, cfg, kv, state, spec, window=window)
    with pytest.raises(AssertionError, match="read a value back"), no_host_reads():
        bool(state.done.all())  # the guard is armed
    assert state.step.view(1).tolist() == [4] and state.pos.view(1).tolist() == [A.ATTN_ONE_SPLIT + 2]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))  # NaN past pos compares too


def _k1_inputs(pos, garbage=None, seed=0, s=2048):
    gen = torch.Generator().manual_seed(seed)
    b, h, dh = 2, 4, 64
    q, k_new, v_new = (torch.randn(b, h, dh, generator=gen) for _ in range(3))
    k_cache, v_cache = (torch.randn(2, s, b, h, dh, generator=gen) for _ in range(2))
    if garbage is not None:
        k_cache[:, pos + 1 :] = garbage
        v_cache[:, pos + 1 :] = garbage
    return q, k_new, v_new, k_cache, v_cache


@pytest.mark.parametrize("pos,starts,garbage", [
    (0, None, None), (255, None, None), (383, None, None), (384, None, None), (511, (3, 500), None),
    (512, None, float("nan")), (1000, (0, 999), None), (1023, None, None), (2047, (1500, 2047), None),
])
def test_k1_plain_version_with_a_device_pos_equals_the_host_int_call(pos, starts, garbage):
    s = 2048
    window = A.attention_window(pos + 1, s)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32)
    host = _k1_inputs(pos, garbage)
    dev = _k1_inputs(pos, garbage)
    y_host, kh, vh = A.decode_attention(*host, 1, pos, st)
    y_dev, kd, vd = A.decode_attention(*dev, 1, torch.tensor(pos, dtype=torch.int32), st, window=window)
    assert all(_same_bits(a, c) for a, c in ((y_host, y_dev), (kh, kd), (vh, vd)))
    assert torch.isfinite(y_dev).all()
    # the bucket's plan: as many splits as its upper end takes, the window wholly inside
    split_len, n_splits = A.attention_plan(window, 8, 1)
    assert split_len * n_splits >= window > pos
    # the whole cache as the window: the same result within rounding
    y_all, _, _ = A.decode_attention(*_k1_inputs(pos, garbage), 1, torch.tensor(pos, dtype=torch.int32), st)
    torch.testing.assert_close(y_all, y_host, rtol=1e-5, atol=1e-6)


def test_window_buckets():
    assert [A.attention_window(n, 2048) for n in (1, 384, 385, 512, 513, 1024, 1025, 2048)] == [
        384, 384, 512, 512, 1024, 1024, 2048, 2048]
    assert A.attention_window(100, 256) == 256 and A.attention_window(300, 320) == 320
    assert fs.window_buckets("K1", 2048) == [384, 512, 1024, 2048]
    assert fs.window_buckets("K3", 2048) == fs.window_buckets("K7", 2048) == [2048]
    assert fs.window_buckets("K1", 512) == [384, 512]
    assert [fs.step_window("K1", p, 2048) for p in (0, 383, 384, 511, 512, 1023, 1024, 2047)] == [
        384, 384, 512, 512, 1024, 1024, 2048, 2048]
    assert fs.step_window("K3", 5, 2048) == 2048
    for n in range(1, 2049, 7):  # each bucket holds its window and is a plan of whole splits
        w = A.attention_window(n, 2048)
        split_len, n_splits = A.attention_plan(w, 32, 1)
        assert n <= w and split_len * n_splits >= w and (n_splits - 1) * split_len < w


def test_route_table_names_every_route(model):
    _, _, cfg, params = model
    kv = _filled_cache(cfg, 2)
    assert fs.step_route(params, cfg, 2, kv) == "K1"
    assert fs.step_route(params, cfg, 2, kv, tp=object()) == "TP"
    q8 = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype="int8", device="cpu")
    assert fs.step_route(params, cfg, 2, q8) == "dequant-cache"
    gqa_cfg = first_stage_config(**(DIMS | {"n_local_heads": 2}))
    gqa = tfm.init_params(gqa_cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert fs.step_route(gqa, gqa_cfg, 2, tfm.KVCache.create(gqa_cfg, 2, device="cpu")) == "GQA"
    assert fs.step_route(Q.quantize_params_int8(params), cfg, 2, kv) == "K9/K10"
    assert fs.step_route(Q.quantize_params_int4(params, groupsize=32), cfg, 2, kv) == "K12/K13+K1"
    assert fs.step_route(Q.quantize_params_int4_i32(params), cfg, 2, kv) == "int4-unfused"
    assert fs.step_route(Q.quantize_params_int8_i32(params), cfg, 2, kv) == "K8+K1"
    wide_cfg, wide = _int4_model()
    wkv = tfm.KVCache.create(wide_cfg, 2, device="cpu")
    assert fs.step_route(Q.quantize_params_int4_i32(wide), wide_cfg, 2, wkv) == "K3"
    assert fs.step_route(Q.quantize_params_int8_i32(wide), wide_cfg, 2, wkv) == "K7"
    wq8 = tfm.KVCache.create(wide_cfg, 2, dtype="int8", device="cpu")
    assert fs.step_route(Q.quantize_params_int4_i32(wide), wide_cfg, 2, wq8) == "K5/K6"
    assert {r for r, how in fs.DECODE_ROUTES.items() if how == "eager"} == {"TP"}


class _StubGraph:
    """A captured step that replays by running the step eagerly."""

    def __init__(self, run):
        self.run = run
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.run()


@pytest.fixture
def stub_capture(monkeypatch):
    """``StepGraphs.capture`` on the CPU: no graph, a replay that runs the
    step eagerly on the call's weights and cache (held only during the
    call, as a graph holds none), n_layer K1 launches a replay credited;
    records the windows captured."""
    captured = []
    call = {}
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
            A.decode_attention.launches += cfg.n_layer  # what a capture of the K1 step counts
        graph = _StubGraph(lambda: fs.decode_step(call["params"], call["cfg"], call["kv_cache"], self.state,
                                                  self.spec, window=window, generator=self.generator))
        return graph, credits

    monkeypatch.setattr(fs.StepGraphs, "step", step_in_call)
    monkeypatch.setattr(fs.StepGraphs, "capture", capture)
    fs.release_graphs()
    yield captured
    fs.release_graphs()


def _graph_decode(params, cfg, cur, pos, kv, spk, n, **kw):
    """``decode`` as it runs on the card: the step from the graph sets."""
    return fs._decode(params, cfg, cur, pos, kv, spk, n, True, **kw)


def test_graph_loop_equals_the_eager_loop_and_credits_launches(model, stub_capture):
    _, _, cfg, params = model
    pos, n = A.ATTN_ONE_SPLIT - 20, 45
    cur, spk, kv = _case(cfg, 2, 2, pos)
    knobs = dict(temperature=0.2, top_p=0.9, guidance_scale=3.0, end_of_audio_token=EOA, compute_dtype=torch.float32,
                 pad_lens=torch.tensor([0, 30], dtype=torch.int32), noise=_noise(n, 2, eoa_at=((30, 1),)))
    base, kv0 = _clone(kv), _clone(kv)
    want = fs.decode_eager(params, cfg, cur, pos, kv0, spk, n, **knobs)
    before = A.decode_attention.launches
    stats = {}
    got = _graph_decode(params, cfg, cur, pos, kv, spk, n, stats=stats, **knobs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(kv.k, kv0.k) and torch.equal(kv.v, kv0.v)
    assert stats == {"decode_steps": n, "decode_route": "graph"}
    assert stub_capture == [384, 512]  # one capture a bucket, each after an eager warm step
    # every step but the two warm ones (CPU: uncounted) is a replay credited with n_layer launches
    assert A.decode_attention.launches - before == cfg.n_layer * (n - 2)
    # a second call on the same cache and weights replays what is there
    kv.k.copy_(base.k), kv.v.copy_(base.v)
    got2 = _graph_decode(params, cfg, cur, pos, kv, spk, n, **knobs)
    assert stub_capture == [384, 512] and torch.equal(got2[0], got[0])


def test_graph_sets_keyed_by_cache_and_weights(model, stub_capture):
    _, _, cfg, params = model
    cur, spk, kv = _case(cfg, 1, 2, 10)
    kw = dict(end_of_audio_token=EOA, compute_dtype=torch.float32, noise=_noise(3, 1))
    _graph_decode(params, cfg, cur, 10, kv, spk, 3, **kw)
    _graph_decode(params, cfg, cur, 10, kv, spk, 3, temperature=0.3, top_p=0.5, **kw)  # knobs: the same set
    assert len(fs._graph_sets) == 1
    other = _filled_cache(cfg, 2)
    _graph_decode(params, cfg, cur, 10, other, spk, 3, **kw)  # a new cache: a new set
    assert len(fs._graph_sets) == 2
    _graph_decode(params, cfg, cur, 10, kv, spk, 3, end_of_audio_token=EOA, compute_dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))  # draws from a generator: a set of their own
    assert len(fs._graph_sets) == 3
    new_weights = {**params, "wpe": params["wpe"].clone()}  # a new tree: a new set
    _graph_decode(new_weights, cfg, cur, 10, kv, spk, 3, **kw)
    assert len(fs._graph_sets) == 4
    del other, new_weights
    gc.collect()
    _graph_decode(params, cfg, cur, 10, kv, spk, 3, **kw)  # the sets of a freed cache or tree are dropped
    assert len(fs._graph_sets) == 2
    assert stub_capture == [384] * 4


def test_generator_draws_continue_across_graph_calls(model, stub_capture):
    _, _, cfg, params = model
    cur, spk, kv = _case(cfg, 1, 2, 10)
    kw = dict(end_of_audio_token=EOA, compute_dtype=torch.float32, temperature=1.0)
    g_eager, g_graph = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    kv0 = _clone(kv)
    for pos in (10, 22):
        want = fs.decode_eager(params, cfg, cur, pos, kv0, spk, 12, generator=g_eager, **kw)
        got = _graph_decode(params, cfg, cur, pos, kv, spk, 12, generator=g_graph, **kw)
        assert torch.equal(got[0], want[0])
    assert torch.equal(g_eager.get_state(), g_graph.get_state())


def test_knobs_changed_between_calls_take_effect(model, stub_capture):
    _, _, cfg, params = model
    cur, spk, kv = _case(cfg, 1, 2, 40)
    base = _clone(kv)
    noise = _noise(20, 1, seed=9)
    outs = []
    for temperature, top_p in ((0.05, 0.95), (3.0, 0.3)):
        kw = dict(temperature=temperature, top_p=top_p, end_of_audio_token=EOA, compute_dtype=torch.float32,
                  noise=noise)
        want = fs.decode_eager(params, cfg, cur, 40, _clone(base), spk, 20, **kw)
        kv.k.copy_(base.k), kv.v.copy_(base.v)
        got = _graph_decode(params, cfg, cur, 40, kv, spk, 20, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        outs.append(got[0])
    assert len(fs._graph_sets) == 1 and stub_capture == [384]
    assert not torch.equal(outs[0], outs[1])


def test_noise_shorter_than_the_loop_raises(model):
    _, _, cfg, params = model
    cur, spk, kv = _case(cfg, 1, 2, 10)
    with pytest.raises(ValueError, match="noise holds 3 draws"):
        fs.decode(params, cfg, cur, 10, kv, spk, 5, noise=_noise(3, 1), compute_dtype=torch.float32)


def test_capture_needs_no_host_knob():
    """A Python knob is refused where a capture is under way (the sampling
    functions' guard), and taken as a tensor elsewhere."""
    logits = torch.randn(2, 97)
    t = torch.full((2, 1), 0.5)
    assert torch.equal(fs.S.apply_temperature(logits, t), fs.S.apply_temperature(logits, 0.5))
    assert fs.S.knob(t, logits) is t
