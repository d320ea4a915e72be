"""The first stage's CUDA-graph decode step on the card, against the eager
loop of the same steps, and K1 with its position read on the device.

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


def _model(cuda, mode):
    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024)
    gen = torch.Generator(device=cuda).manual_seed(7)
    params = tfm.init_params(cfg, device=cuda, generator=gen, dtype=torch.bfloat16)
    quantize = {None: lambda p: p, "int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32}[mode]
    return cfg, quantize(params), gen


def _filled(cfg, rows, gen, dev):
    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=torch.bfloat16, device=dev)
    for t in (kv.k, kv.v):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    return kv


@pytest.mark.cuda
@pytest.mark.parametrize("mode,route", [(None, "K1"), ("int4", "K3"), ("int8", "K7")])
@pytest.mark.parametrize("b,pads", [(1, None), (3, (0, 17, 300))])
def test_graph_loop_gives_the_eager_loop_bits(cuda, mode, route, b, pads):
    cfg, params, gen = _model(cuda, mode)
    base = _filled(cfg, 2 * b, gen, cuda)
    assert fs.step_route(params, cfg, 2 * b, base) == route
    kv = tfm.KVCache(base.k.clone(), base.v.clone())
    eager = tfm.KVCache(base.k.clone(), base.v.clone())
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
    assert _same_bits(kv.k, eager.k) and _same_bits(kv.v, eager.v)
    assert {k: after[k] - mid[k] for k in KERNEL_COUNTERS} == {k: mid[k] - before[k] for k in KERNEL_COUNTERS}
    assert stats["decode_steps"] == stats_e["decode_steps"]


@pytest.mark.cuda
def test_capture_before_any_eager_call_raises(cuda, monkeypatch):
    cfg, params, gen = _model(cuda, "int4")
    kv = _filled(cfg, 2, gen, cuda)
    spec = fs.StepSpec(2, EOA, 0, torch.bfloat16)
    cur = torch.zeros((1,), dtype=torch.int64, device=cuda)
    state = fs.init_state(cur, 100, torch.zeros((1, 256), device=cuda), 4, spec)
    graphs = fs.StepGraphs(spec, state, cfg.block_size, [], None)
    monkeypatch.setattr(DS, "_stack_tickets", {})
    monkeypatch.setattr(A, "_tickets", {})
    with pytest.raises(RuntimeError, match="eager call"):
        graphs.capture(params, cfg, kv, cfg.block_size)
    assert not DS._stack_tickets and not A._tickets
