"""The int8 kernels on the card against their plain PyTorch versions, at the
main-path shapes: K8 (ops/quantized.matmul_int8_i32) and K7
(ops/decode_stack.decode_stack_int4 with wfmt="i8"). Needs a CUDA card and
nvcc; skips elsewhere. Imports no JAX, so it runs with ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_int8_cuda.py -q

Tolerances: K8 every row within 1e-3 * max |ref|, or so once its bf16(sum x)
moves one ulp either way: the c term takes back about 128 * s * sum(x), and
the kernel sums x in f32 in another order than the plain version before
rounding to bf16, so a row whose sum lies on a rounding boundary may move by
|c| * ulp; at every row count of the plan's CPU tests; K8 also gives the
same bits twice and from 3 replays of a captured call, a capture before any
eager call raises, and every byte converts exactly. K7 as K3
(tests/test_torch_int4_cuda.py): each layer alone, fed the plain version's
residual stream, within 1e-2 * max |ref|; all 24
layers' x_out within 5e-2 * max |ref|; layer 0's new cache row within one
bf16 ulp plus 1e-4 of its largest value; every other cache slot
bit-identical. The flip allowance, the one-layer-at-a-time check and the
random full-width model are chip_smoke.py's own, so the two hold the
kernels alike. The redesigned step (csrc/decode_stack_gemv.cuh) is also
held to: every byte converted exactly, 1..8 rows at those tolerances, the
same bits twice, and a captured step replayed 3 times giving the eager bits
with the merge tickets back at 0.
"""

import pytest
import torch

from chip_smoke import STACK_KERNELS_A_LAYER, _k7_args, _random_int8_model, k8_row_gap, stack_graph_check, \
    stack_worst_layer
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

K8_TOL = 1e-3
K7_TOL = 5e-2
K7_LAYER_TOL = 1e-2
# (M, K, N): the prefill projections at M = 256 (CFG pair x 128-token
# bucket), the per-layer decode route's M = 2, ragged M, a narrow model's
# K = 512, and K = 160, whose 40 word rows leave most of a 128-row block empty
K8_CASES = [(256, 2048, 6144), (256, 2048, 2048), (256, 6144, 2048), (1, 2048, 2048),
            (2, 2048, 6144), (200, 2048, 6144), (300, 6144, 2048), (2, 512, 1536), (5, 160, 72)]
# then every row count of the plan's tests (tests/test_torch_prefill_plan.py) at the main path's shapes
K8_CASES += [(m, k, n) for m in (1, 2, 8, 9, 16, 32, 64, 65, 200, 256, 300, 512)
             for k, n in ((2048, 6144), (2048, 2048), (6144, 2048)) if (m, k, n) not in K8_CASES]
# (pos, starts, garbage past pos, n_kv_head)
K7_CASES = [(0, None, None, 16), (255, None, None, 16), (1000, None, None, 16),
            (2047, None, None, 16), (1000, (300, 700), None, 16),
            (1000, None, float("nan"), 16), (1000, None, None, 2)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", K8_CASES)
def test_k8_matches_plain(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    p8, sc8 = Q.quantize_int8_i32(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = Q.matmul_int8_i32.launches
    y = Q.matmul_int8_i32(x, p8, sc8)
    torch.cuda.synchronize()
    assert Q.matmul_int8_i32.launches == before + 1
    ref = Q.matmul_int8_i32_reference(x, p8, sc8)
    assert y.shape == (m, n) and y.dtype == torch.float32 and torch.isfinite(y).all()
    assert k8_row_gap(torch, y, ref, x, sc8) <= K8_TOL


# (M, K, N) with more than one split (the merge behind the counters) and with one
K8_BITS_CASES = [(256, 2048, 6144), (16, 6144, 2048), (512, 2048, 6144)]


@pytest.mark.parametrize("m,k,n", K8_BITS_CASES)
def test_k8_gives_the_same_bits_twice_and_from_a_graph(dev, m, k, n):
    """Two calls give the same bits, and so do 3 replays of a captured call
    (after an eager one: the merge counters are made), with the counters
    back at 0."""
    gen = torch.Generator(device=dev).manual_seed(7 * m + k)
    p8, sc8 = Q.quantize_int8_i32(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y1 = Q.matmul_int8_i32(x, p8, sc8)
    y2 = Q.matmul_int8_i32(x, p8, sc8)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q.matmul_int8_i32(x, p8, sc8)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = Q.matmul_int8_i32(x, p8, sc8)
    for _ in range(3):
        yg.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yg, y1)
    tickets = Q._prefill_tickets.get(dev.index if dev.index is not None else torch.cuda.current_device())
    assert tickets is None or not tickets.any()


def test_k8_capture_before_any_eager_call_raises(dev):
    """The merge counters are made by the first eager call that splits K: a
    CUDA-graph capture before it raises and makes none."""
    gen = torch.Generator(device=dev).manual_seed(3)
    p8, sc8 = Q.quantize_int8_i32(torch.randn((2048, 6144), generator=gen, device=dev) * 0.02)
    x = torch.randn((256, 2048), generator=gen, device=dev).to(torch.bfloat16)
    assert Q.prefill_plan(256, 2048, 6144, "i8")[3] > 1
    saved = Q._prefill_tickets.copy()
    Q._prefill_tickets.clear()
    try:
        with pytest.raises(RuntimeError, match="eager call"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                Q.matmul_int8_i32(x, p8, sc8)
        assert not Q._prefill_tickets
    finally:
        torch.cuda.synchronize()
        Q._prefill_tickets.clear()
        Q._prefill_tickets.update(saved)


def test_k8_converts_every_byte_exactly(dev):
    """Words holding every byte 0..255 in every slab, s = 1, c = 0, and x the
    identity (K split across blocks and merged): each output is one byte
    times one, the byte bit for bit."""
    k, n = 1024, 64
    gen = torch.Generator(device=dev).manual_seed(256)
    q = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    q[:256, 0] = torch.arange(-128, 128, device=dev, dtype=torch.int32).to(torch.int8)
    p8 = Q.pack_int8_i32(q)
    sc8 = torch.zeros((2 * Q.I8_GP, n), device=dev, dtype=torch.bfloat16)
    sc8[0] = 1.0
    assert Q.prefill_plan(k, k, n, "i8")[3] > 1
    y = Q.matmul_int8_i32(torch.eye(k, device=dev, dtype=torch.bfloat16), p8, sc8)
    torch.cuda.synchronize()
    byte = (q.to(torch.int32) + 128).float()
    assert set(byte.unique().tolist()) == set(range(256))
    assert torch.equal(y, byte)


@pytest.fixture(scope="module")
def stacks(dev):
    """Full-width first-stage int8 weights (24L/16H/2048d, Ip 6144 packed),
    MHA and GQA (n_kv_head 2), from a seed."""
    out = {}
    for h_kv in (16, 2):
        cfg = first_stage_config(n_local_heads=h_kv)
        out[h_kv] = (cfg, _random_int8_model(torch, cfg, h_kv, dev))
    return out


@pytest.mark.parametrize("pos,starts,garbage,h_kv", K7_CASES)
def test_k7_matches_plain(dev, stacks, pos, starts, garbage, h_kv):
    cfg, qp = stacks[h_kv]
    gen = torch.Generator(device=dev).manual_seed(pos + h_kv)
    b = 2
    shape = (cfg.n_layer, cfg.block_size, b, h_kv, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    if garbage is not None:
        kc[:, pos + 1 :] = garbage
        vc[:, pos + 1 :] = garbage
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    kc0, vc0 = kc.clone(), vc.clone()
    kr, vr = kc.clone(), vc.clone()
    args = _k7_args(qp)
    kw = dict(n_kv_head=h_kv, starts=st, norm_eps=cfg.norm_eps, wfmt="i8")
    # one layer at a time, fed the plain version's stream
    assert stack_worst_layer(torch, x, args, kc, vc, pos, cfg.n_head, **kw) <= K7_LAYER_TOL
    before = (DS.decode_stack_int4.launches, DS.decode_stack_int4.launches_i8)
    xo, _, _ = DS.decode_stack_int4(x, *args, kc, vc, pos, cfg.n_head, **kw)
    torch.cuda.synchronize()
    assert (DS.decode_stack_int4.launches, DS.decode_stack_int4.launches_i8) == (before[0], before[1] + 1)
    xr, _, _ = DS.decode_stack_int4_reference(x, *args, kr, vr, pos, cfg.n_head, **kw)
    assert torch.isfinite(xo).all()
    err = (xo.float() - xr.float()).abs().max().item()
    assert err <= K7_TOL * xr.float().abs().max().item(), err
    for got, ref, orig in ((kc, kr, kc0), (vc, vr, vc0)):
        row, ref_row = got[0, pos].float(), ref[0, pos].float()
        excess = (row - ref_row).abs() - ref_row.abs() * 2.0**-7  # beyond one bf16 ulp
        assert excess.max().item() <= 1e-4 * ref_row.abs().max().item(), excess.max().item()
        others = torch.ones(cfg.block_size, dtype=torch.bool, device=dev)
        others[pos] = False
        assert torch.equal(got[:, others].view(torch.int16), orig[:, others].view(torch.int16))


def test_k7_takes_pos_on_the_device(dev, stacks):
    """pos as a 0-d int32 tensor on the card gives the same step as an int."""
    cfg, qp = stacks[16]
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (cfg.n_layer, cfg.block_size, 2, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    k2, v2 = kc.clone(), vc.clone()
    a = DS.decode_stack_int4(x, *_k7_args(qp), kc, vc, 77, cfg.n_head, wfmt="i8")[0]
    pos = torch.tensor(77, dtype=torch.int32, device=dev)
    b = DS.decode_stack_int4(x, *_k7_args(qp), k2, v2, pos, cfg.n_head, wfmt="i8")[0]
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(kc.view(torch.int16), k2.view(torch.int16))


def test_k7_converts_every_byte_exactly(dev):
    """Byte j of w0 is (t + j) mod 256 and of w1 (7 t + 3 j) mod 256 in thread
    t: each byte lane's bf16 pair holds both values exactly."""
    from test_torch_int4_cuda import _stack_values

    _, byte = _stack_values(dev)
    t = torch.arange(256)[:, None]
    j = torch.arange(4)[None, :]
    assert torch.equal(byte[:, :, 0], ((t + j) % 256).float())
    assert torch.equal(byte[:, :, 1], ((7 * t + 3 * j) % 256).float())
    assert set(byte.flatten().tolist()) == set(range(256))


@pytest.fixture(scope="module")
def stack8(dev):
    cfg = first_stage_config()
    return cfg, _random_int8_model(torch, cfg, 88, dev)


@pytest.mark.parametrize("b", range(1, DS.MAX_BATCH + 1))
def test_k7_rows_match_plain(dev, stack8, b):
    """1..8 rows: each layer alone within K7_LAYER_TOL, all 24 layers within
    K7_TOL, and the same bits twice."""
    cfg, qp = stack8
    gen = torch.Generator(device=dev).manual_seed(200 + b)
    shape = (cfg.n_layer, cfg.block_size, b, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    args = _k7_args(qp)
    assert stack_worst_layer(torch, x, args, kc, vc, 300, cfg.n_head, wfmt="i8") <= K7_LAYER_TOL
    kr, vr = kc.clone(), vc.clone()
    xo = DS.decode_stack_int4(x, *args, kc.clone(), vc.clone(), 300, cfg.n_head, wfmt="i8")[0]
    xo2 = DS.decode_stack_int4(x, *args, kc, vc, 300, cfg.n_head, wfmt="i8")[0]
    torch.cuda.synchronize()
    assert torch.equal(xo, xo2)
    xr = DS.decode_stack_int4_reference(x, *args, kr, vr, 300, cfg.n_head, wfmt="i8")[0]
    assert (xo.float() - xr.float()).abs().max().item() <= K7_TOL * xr.float().abs().max().item()


def test_k7_graph_replays_give_the_eager_bits(dev, stack8):
    """One whole step captured in a CUDA graph: 6 kernels a layer, 3 replays
    the eager step's bits, the merge tickets back at 0."""
    cfg, qp = stack8
    gen = torch.Generator(device=dev).manual_seed(19)
    shape = (cfg.n_layer, cfg.block_size, 2, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(700, dtype=torch.int32, device=dev)
    names = stack_graph_check(torch, lambda: DS.decode_stack_int4(x, *_k7_args(qp), kc, vc, pos, cfg.n_head,
                                                                  wfmt="i8"), "K7")
    assert len(names) == STACK_KERNELS_A_LAYER * cfg.n_layer
    assert sum("stack_gemv" in n for n in names) == 4 * cfg.n_layer
