"""The groupwise int4 kernels on the card against their plain PyTorch
versions, at the main-path shapes: K12 (ops/quantized.matmul_int4) and K13
(ops/quantized.matmul_int4_packed) at M = 2 (decode, the split-K GEMV) and
M = 256 (prefill, the ring of tensor-core tiles) for one layer's
projections, at M = 1, 8, 9, 16, 32, 64, 65, 200, with f32 x and with
groupsizes 8, 24 and 64; ``_linear`` on both leaf kinds at M = 300 (the
dense f32 route, no launch); the one-launch GEMV of up to 8 rows at every
row count, at N off its column tile, under other plans (odd split counts,
other warps), two calls giving the same bits and a CUDA-graph replay giving
the eager call's bits, also where the graph is captured first; at up to 8
rows with a groupsize that is no multiple of 16 (the ring); and the ring's
own checks: every weight dequantized bit for bit (one-hot rows of x, f32
out, every int8 value of q and every nibble), two calls the same bits at
M 16 and 256, graph replays the eager bits, a capture before any eager
call raising. Needs a CUDA card and nvcc; skips elsewhere. Imports no JAX,
so it runs with ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_int4_grouped_cuda.py -q

Tolerance, chip_smoke.py's own (its k12_case holds each case): every
element within 1e-3 of max |ref| plus one bf16 ulp of the element (the same
bf16 weights and products summed in another order, then rounded to x's
dtype).
"""

import pytest
import torch

from chip_smoke import k12_case
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

D, I_SZ = 2048, 5632
SHAPES = [(D, 3 * D), (D, D), (D, I_SZ), (I_SZ, D)]
CASES = [(m, k, n, torch.bfloat16, 128) for m in (2, 256) for k, n in SHAPES]
CASES += [(1, D, 3 * D, torch.bfloat16, 128), (8, D, I_SZ, torch.bfloat16, 128), (200, D, 3 * D, torch.bfloat16, 128),
          (2, D, 3 * D, torch.float32, 128), (256, I_SZ, D, torch.float32, 128), (2, I_SZ, D, torch.bfloat16, 64),
          (256, D, I_SZ, torch.bfloat16, 64)]
# the ring's row tiles (16, 32, 64, 128 and 256 rows, splits of K) at the main shapes, f32 x, groupsizes 8,
# 24 and 64 (a step of 64 k spans 8 groups at 8, straddles groups at 24)
CASES += [(m, k, n, torch.bfloat16, 128) for m in (9, 16, 32, 64, 65) for k, n in SHAPES]
CASES += [(16, I_SZ, D, torch.float32, 128), (32, D, 3 * D, torch.float32, 128), (65, D, I_SZ, torch.float32, 128),
          (16, D, D, torch.bfloat16, 8), (256, D, 3 * D, torch.bfloat16, 8), (32, 1152, I_SZ, torch.bfloat16, 24),
          (256, 1152, 3 * D, torch.bfloat16, 24), (200, 1152, D, torch.bfloat16, 24), (64, D, D, torch.bfloat16, 64),
          (1, D, 3 * D, torch.bfloat16, 8), (8, 1152, I_SZ, torch.bfloat16, 24), (16, 1152, D, torch.bfloat16, 12),
          (2, 1152, 2064, torch.bfloat16, 12)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m,k,n,dtype,gs", CASES)
def test_kernel_matches_plain(dev, m, k, n, dtype, gs, packed):
    fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    gen = torch.Generator(device="cuda").manual_seed(m + k + n + gs)
    before = fn.launches
    k12_case(torch, m, k, n, gen, packed=packed, dtype=dtype, groupsize=gs)
    assert fn.launches == before + 1


@pytest.mark.parametrize("packed", [False, True], ids=["q", "p"])
def test_linear_over_256_rows_takes_the_dense_route(dev, packed):
    gen = torch.Generator(device="cuda").manual_seed(300)
    q, s, z = Q.quantize_int4_grouped(torch.randn((D, D), generator=gen, device=dev) * 0.02)
    leaf = {"p": Q.pack_int4(q), "scales": s, "zeros": z} if packed else {"q": q, "scales": s, "zeros": z}
    x = torch.randn((1, 300, D), generator=gen, device=dev)
    before = (Q.matmul_int4.launches, Q.matmul_int4_packed.launches)
    y = tfm._linear(x, leaf)
    ref = x @ Q.dequantize_int4_grouped(q, s, z, 128)
    assert (Q.matmul_int4.launches, Q.matmul_int4_packed.launches) == before
    torch.testing.assert_close(y, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m", range(1, Q.DECODE_MAX_ROWS + 1))
def test_gemv_at_every_row_count(dev, m, packed):
    fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    gen = torch.Generator(device="cuda").manual_seed(40 + m)
    before = fn.launches
    k12_case(torch, m, D, D, gen, packed=packed)
    assert fn.launches == before + 1


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m,n,gs", [(2, 16, 128), (2, 2064, 128), (2, 2064, 64), (7, 2064, 64), (2, 3 * D, 64)])
def test_gemv_off_the_column_tile_and_at_groupsize_64(dev, m, n, gs, packed):
    gen = torch.Generator(device="cuda").manual_seed(n + gs + m)
    k12_case(torch, m, D, n, gen, packed=packed, groupsize=gs)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("max_splits,warps", [(3, 1), (5, 3), (7, 4), (1, 2), (2, 8)])
def test_kernel_matches_plain_version_under_other_plans(dev, monkeypatch, packed, m, max_splits, warps):
    """Any plan the kernel takes merges right: odd split counts, warps that
    leave a run empty."""
    monkeypatch.setattr(Q, "INT4G_BLOCKS_PER_SM", 1000)  # as many splits as the caps allow
    monkeypatch.setattr(Q, "INT4G_MAX_SPLITS", max_splits)
    monkeypatch.setattr(Q, "INT4G_WARPS", warps)
    assert Q.int4g_plan(m, D, 3 * D, packed)[1] == max_splits
    gen = torch.Generator(device="cuda").manual_seed(max_splits * 10 + warps + m)
    k12_case(torch, m, D, 3 * D, gen, packed=packed)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m,k,gs", [(2, D, 8), (2, 1152, 24), (8, 1152, 24)])
def test_few_rows_at_a_groupsize_off_the_k_step(dev, m, k, gs, packed):
    """Up to 8 rows with a groupsize that is no multiple of 16 take the
    tiles, one launch, and agree."""
    fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    gen = torch.Generator(device="cuda").manual_seed(k + gs + m)
    before = fn.launches
    k12_case(torch, m, k, D, gen, packed=packed, groupsize=gs)
    assert fn.launches == before + 1


def _gemv_call(dev, packed, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, s, z = Q.quantize_int4_grouped(torch.randn((D, 3 * D), generator=gen, device=dev) * 0.02)
    w = Q.pack_int4(q) if packed else q
    x = torch.randn((2, D), generator=gen, device=dev).to(torch.bfloat16)
    fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    assert Q.int4g_plan(2, D, 3 * D, packed)[1] > 1  # the merge is on the path
    return lambda: fn(x, w, s, z)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_two_calls_give_the_same_bits(dev, packed):
    call = _gemv_call(dev, packed, 50)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_graph_replays_give_the_eager_bits(dev, packed):
    """The merge tickets are left at 0, so each replay merges as the first launch did."""
    call = _gemv_call(dev, packed, 60)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_graph_captured_before_any_eager_call(dev, monkeypatch, packed):
    """A capture that would have to make the device's merge counters raises
    (their zero fill would only be recorded); after one eager call the same
    capture replays to the eager bits."""
    monkeypatch.setattr(Q, "_int4g_tickets", {})
    call = _gemv_call(dev, packed, 70)
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            call()
    assert not Q._int4g_tickets
    eager = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


# ---- the ring of tensor-core tiles (more than 8 rows, or a groupsize off the GEMV's k-step)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("k,gs", [(D, 128), (1152, 24), (1152, 12)])
def test_ring_dequantizes_every_weight_exactly(dev, packed, k, gs):
    """One-hot rows of x (the identity, M = K) and f32 out: y is each row's
    bf16 weight, bit for bit, across every int8 value of q (K12: the ring
    takes any int8, as the TPU kernel does) and every nibble (K13); a
    groupsize that is no multiple of 8 (12) reads each row's scale and zero
    from global memory."""
    n = 256
    gen = torch.Generator().manual_seed(7 + gs)
    kk, nn = torch.meshgrid(torch.arange(k), torch.arange(n), indexing="ij")
    if packed:
        q = ((kk * 5 + nn * 3) % 16 - 8).to(torch.int8)
    else:
        q = ((kk * 7 + nn * 11) % 256 - 128).to(torch.int8)
    s = torch.rand((k // gs, n), generator=gen) * 0.05 + 1e-3
    z = torch.randn((k // gs, n), generator=gen) * 0.05
    want = Q.dequantize_int4_grouped(q, s, z, gs).to(torch.bfloat16).float()  # the plain version's weights
    x = torch.eye(k, device=dev)
    qd, sd, zd = q.to(dev), s.to(dev), z.to(dev)
    y = Q.matmul_int4_packed(x, Q.pack_int4(qd), sd, zd, gs) if packed else Q.matmul_int4(x, qd, sd, zd, gs)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    assert torch.equal(y.cpu().view(torch.int32), want.view(torch.int32))


def _ring_call(dev, packed, m, seed):
    """A ring call of the wo shape, whose plan splits K at 16 and at 256 rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, s, z = Q.quantize_int4_grouped(torch.randn((D, D), generator=gen, device=dev) * 0.02)
    w = Q.pack_int4(q) if packed else q
    x = torch.randn((m, D), generator=gen, device=dev).to(torch.bfloat16)
    fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    assert Q.int4g_tile_plan(m, D, D, packed)[2] > 1  # the merge is on the path
    return lambda: fn(x, w, s, z)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m", [16, 256])
def test_ring_two_calls_give_the_same_bits(dev, packed, m):
    call = _ring_call(dev, packed, m, 80 + m)
    first, second = call(), call()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m", [16, 256])
def test_ring_graph_replays_give_the_eager_bits(dev, packed, m):
    call = _ring_call(dev, packed, m, 90 + m)
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_ring_graph_captured_before_any_eager_call(dev, monkeypatch, packed):
    """As for the GEMV: the ring's merge counters are the same per-device
    table, so a capture that would make them raises."""
    monkeypatch.setattr(Q, "_int4g_tickets", {})
    call = _ring_call(dev, packed, 256, 99)
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            call()
    assert not Q._int4g_tickets
    eager = call()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))
