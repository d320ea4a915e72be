"""The int4 kernels on the card against their plain PyTorch versions, at the
main-path shapes: K2 (ops/quantized.matmul_int4_i32) and K3
(ops/decode_stack.decode_stack_int4). Needs a CUDA card and nvcc; skips
elsewhere. Imports no JAX, so it runs with ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_int4_cuda.py -q

Tolerances: K2 max |dy| <= 1e-3 * max |ref| (the same bf16 products, summed
in another order), at every row count of the plan's CPU tests; K2 also gives
the same bits twice and from 3 replays of a captured call (the K split's
merge in a fixed order), a capture before any eager call raises (its merge
counters), and every nibble converts exactly. K3: the two versions round at the same points, but a
bf16 rounding of an f32 sum taken in another order can land one ulp apart,
and later layers spread such a flip into every value, so the gap grows with
depth (measured: 0.4% of max |ref| after one layer, 2.2% after 24). Each
layer alone, fed the plain version's residual stream, is held within
1e-2 * max |ref|; all 24 layers' x_out and logits within 5e-2 * max |ref|;
layer 0's new cache row
within one bf16 ulp of the plain version's plus 1e-4 of the row's largest
value (the bf16 rounding of an f32 sum taken in another order can land one
ulp apart, and entries near 0 come from cancelling sums whose f32 error
scales with the terms, not the result), every other cache slot
bit-identical. The redesigned step (csrc/decode_stack_gemv.cuh) is also
held to: every nibble converted exactly, 1..8 rows at those tolerances, the
same bits twice, and a captured step replayed 3 times giving the eager bits
with the merge tickets back at 0.
"""

import pytest
import torch

from chip_smoke import STACK_KERNELS_A_LAYER, stack_graph_check, stack_worst_layer
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

K2_TOL = 1e-3
K3_TOL = 5e-2
K3_LAYER_TOL = 1e-2
# (M, K, N): the prefill projections at M = 256 (CFG pair x 128-token bucket), then ragged M; then every
# row count of the plan's tests (tests/test_torch_prefill_plan.py) at the main path's shapes
K2_CASES = [(256, 2048, 6144), (256, 2048, 2048), (256, 6144, 2048), (1, 2048, 2048),
            (200, 2048, 6144), (300, 6144, 2048)]
K2_CASES += [(m, k, n) for m in (1, 2, 8, 9, 16, 32, 64, 65, 200, 256, 300, 512)
             for k, n in ((2048, 6144), (2048, 2048), (6144, 2048)) if (m, k, n) not in K2_CASES]
# (pos, starts, garbage past pos, n_kv_head)
K3_CASES = [(0, None, None, 16), (255, None, None, 16), (1000, None, None, 16),
            (2047, None, None, 16), (1000, (300, 700), None, 16),
            (1000, None, float("nan"), 16), (1000, None, None, 2)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(k, n, gen, dev):
    w = torch.randn((k, n), generator=gen, device=dev) * 0.02
    return Q.quantize_int4_i32(w)


@pytest.mark.parametrize("m,k,n", K2_CASES)
def test_k2_matches_plain(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    pw, sc = _packed(k, n, gen, dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    before = Q.matmul_int4_i32.launches
    y = Q.matmul_int4_i32(x, pw, sc)
    torch.cuda.synchronize()
    assert Q.matmul_int4_i32.launches == before + 1
    ref = Q.matmul_int4_i32_reference(x, pw, sc)
    assert y.shape == (m, n) and y.dtype == torch.float32 and torch.isfinite(y).all()
    err = (y - ref).abs().max().item()
    assert err <= K2_TOL * ref.abs().max().item(), err


# (M, K, N) with more than one split (the merge behind the counters) and with one
K2_BITS_CASES = [(256, 2048, 6144), (16, 6144, 2048), (512, 2048, 6144)]


@pytest.mark.parametrize("m,k,n", K2_BITS_CASES)
def test_k2_gives_the_same_bits_twice_and_from_a_graph(dev, m, k, n):
    """Two calls give the same bits, and so do 3 replays of a captured call
    (after an eager one: the merge counters are made), with the counters
    back at 0."""
    gen = torch.Generator(device=dev).manual_seed(7 * m + k)
    pw, sc = _packed(k, n, gen, dev)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    y1 = Q.matmul_int4_i32(x, pw, sc)
    y2 = Q.matmul_int4_i32(x, pw, sc)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        Q.matmul_int4_i32(x, pw, sc)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        yg = Q.matmul_int4_i32(x, pw, sc)
    for _ in range(3):
        yg.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yg, y1)
    tickets = Q._prefill_tickets.get(dev.index if dev.index is not None else torch.cuda.current_device())
    assert tickets is None or not tickets.any()


def test_k2_capture_before_any_eager_call_raises(dev):
    """The merge counters are made by the first eager call that splits K: a
    CUDA-graph capture before it raises and makes none."""
    gen = torch.Generator(device=dev).manual_seed(3)
    pw, sc = _packed(2048, 6144, gen, dev)
    x = torch.randn((256, 2048), generator=gen, device=dev).to(torch.bfloat16)
    assert Q.prefill_plan(256, 2048, 6144, "i4")[3] > 1
    saved = Q._prefill_tickets.copy()
    Q._prefill_tickets.clear()
    try:
        with pytest.raises(RuntimeError, match="eager call"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                Q.matmul_int4_i32(x, pw, sc)
        assert not Q._prefill_tickets
    finally:
        torch.cuda.synchronize()
        Q._prefill_tickets.clear()
        Q._prefill_tickets.update(saved)


def test_k2_converts_every_nibble_exactly(dev):
    """Words holding every nibble 0..15 in every slab, s = 1, c = 0, and x the
    identity: each output is one nibble times one, the nibble bit for bit."""
    k, n = 1024, 64
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
    q[:16, 0] = torch.arange(-8, 8, device=dev, dtype=torch.int8)  # each value at least once in slab 0
    pw = Q.pack_int4_i32(q)
    gp = k // Q.I32_GROUPSIZE
    sc = torch.cat([torch.ones((gp, n)), torch.zeros((gp, n))]).to(torch.bfloat16).to(dev)
    y = Q.matmul_int4_i32(torch.eye(k, device=dev, dtype=torch.bfloat16), pw, sc)
    torch.cuda.synchronize()
    nib = (q.to(torch.int32) + 8).float()
    assert set(nib.unique().tolist()) == set(range(16))
    assert torch.equal(y, nib)


@pytest.fixture(scope="module")
def stacks(dev):
    """Full-width first-stage int4 weights (24L/16H/2048d, Ip 6144 packed,
    head Vp 3072), MHA and GQA (n_kv_head 2), from a seed."""
    out = {}
    for h_kv in (16, 2):
        cfg = first_stage_config(n_local_heads=h_kv)
        gen = torch.Generator(device=dev).manual_seed(h_kv)
        params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
        params["layers"]["attn_norm_w"] = 1 + 0.1 * torch.randn(
            params["layers"]["attn_norm_w"].shape, generator=gen, device=dev
        ).to(torch.bfloat16)
        out[h_kv] = (cfg, Q.quantize_params_int4_i32(params))
    return out


def _k3_args(cfg, qp):
    lay = qp["layers"]
    return (lay["attn_norm_w"], lay["ffn_norm_w"],
            *[t for k in ("wqkv", "wo", "w1", "w3", "w2") for t in (lay[k]["pw"], lay[k]["sc"])])


@pytest.mark.parametrize("pos,starts,garbage,h_kv", K3_CASES)
def test_k3_matches_plain(dev, stacks, pos, starts, garbage, h_kv):
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
    head = dict(ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])
    kc0, vc0 = kc.clone(), vc.clone()
    kr, vr = kc.clone(), vc.clone()
    args = _k3_args(cfg, qp)
    kw = dict(n_kv_head=h_kv, starts=st, norm_eps=cfg.norm_eps, **head)
    xl = x
    for li in range(cfg.n_layer):  # one layer at a time, fed the plain version's stream
        one = [a[li : li + 1] for a in args]
        cl = [c[li : li + 1].clone() for c in (kc, vc, kc, vc)]
        got = DS.decode_stack_int4(xl, *one, cl[0], cl[1], pos, cfg.n_head, n_kv_head=h_kv, starts=st)[0]
        xl = DS.decode_stack_int4_reference(xl, *one, cl[2], cl[3], pos, cfg.n_head, n_kv_head=h_kv,
                                            starts=st)[0]
        gap = (got.float() - xl.float()).abs().max().item()
        assert gap <= K3_LAYER_TOL * xl.float().abs().max().item(), (li, gap)
    before = DS.decode_stack_int4.launches
    xo, _, _, lg = DS.decode_stack_int4(x, *args, kc, vc, pos, cfg.n_head, **kw)
    torch.cuda.synchronize()
    assert DS.decode_stack_int4.launches == before + 1
    xr, _, _, lr = DS.decode_stack_int4_reference(x, *args, kr, vr, pos, cfg.n_head, **kw)
    vocab = cfg.vocab_size
    assert torch.isfinite(xo).all() and torch.isfinite(lg).all()
    for got, ref in ((xo.float(), xr.float()), (lg[:, :vocab], lr[:, :vocab])):
        err = (got - ref).abs().max().item()
        assert err <= K3_TOL * ref.abs().max().item(), err
    assert torch.equal(lg[:, vocab:], torch.zeros_like(lg[:, vocab:]))
    for got, ref, orig in ((kc, kr, kc0), (vc, vr, vc0)):
        row, ref_row = got[0, pos].float(), ref[0, pos].float()
        excess = (row - ref_row).abs() - ref_row.abs() * 2.0**-7  # beyond one bf16 ulp
        assert excess.max().item() <= 1e-4 * ref_row.abs().max().item(), excess.max().item()
        others = torch.ones(cfg.block_size, dtype=torch.bool, device=dev)
        others[pos] = False
        assert torch.equal(got[:, others].view(torch.int16), orig[:, others].view(torch.int16))


def test_k3_takes_pos_on_the_device(dev, stacks):
    """pos as a 0-d int32 tensor on the card gives the same step as an int."""
    cfg, qp = stacks[16]
    gen = torch.Generator(device=dev).manual_seed(5)
    shape = (cfg.n_layer, cfg.block_size, 2, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    k2, v2 = kc.clone(), vc.clone()
    a = DS.decode_stack_int4(x, *_k3_args(cfg, qp), kc, vc, 77, cfg.n_head)[0]
    pos = torch.tensor(77, dtype=torch.int32, device=dev)
    b = DS.decode_stack_int4(x, *_k3_args(cfg, qp), k2, v2, pos, cfg.n_head)[0]
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(kc.view(torch.int16), k2.view(torch.int16))


def _stack_values(dev):
    """The products' conversions of every nibble and byte (mv_decode_stack_values):
    (nib (256, 4, 2, 2), byte (256, 4, 2)) as floats, the last axis (w0's, w1's)."""
    from metavoice_tpu_torch.ops import _build

    nib = torch.zeros((256, 4, 2), dtype=torch.int32, device=dev)
    byte = torch.zeros((256, 4), dtype=torch.int32, device=dev)
    err = _build.kernels().lib.mv_decode_stack_values(nib.data_ptr(), byte.data_ptr(),
                                                      torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    as_bf16 = lambda t: t.cpu().view(torch.int16).view(torch.bfloat16).float()  # noqa: E731
    return as_bf16(nib).reshape(256, 4, 2, 2), as_bf16(byte).reshape(256, 4, 2)


def test_k3_converts_every_nibble_exactly(dev):
    """Nibble j of w0 is (t + j) mod 16 and of w1 (t / 16 + 3 j) mod 16 in
    thread t: byte lane j's pairs give slabs 2 j and 2 j + 1, each value exact."""
    nib, _ = _stack_values(dev)
    t = torch.arange(256)[:, None]
    for h in range(2):
        slab = 2 * torch.arange(4)[None, :] + h
        assert torch.equal(nib[:, :, h, 0], ((t + slab) % 16).float())
        assert torch.equal(nib[:, :, h, 1], ((t // 16 + 3 * slab) % 16).float())
    assert set(nib.flatten().tolist()) == set(range(16))


@pytest.mark.parametrize("b", range(1, DS.MAX_BATCH + 1))
def test_k3_rows_match_plain(dev, stacks, b):
    """1..8 rows: each layer alone within K3_LAYER_TOL, all 24 layers and the
    logits within K3_TOL, and the same bits twice."""
    cfg, qp = stacks[16]
    gen = torch.Generator(device=dev).manual_seed(100 + b)
    shape = (cfg.n_layer, cfg.block_size, b, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    args = _k3_args(cfg, qp)
    kw = dict(ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])
    assert stack_worst_layer(torch, x, args, kc, vc, 300, cfg.n_head) <= K3_LAYER_TOL
    kr, vr = kc.clone(), vc.clone()
    xo, _, _, lg = DS.decode_stack_int4(x, *args, kc.clone(), vc.clone(), 300, cfg.n_head, **kw)
    xo2, _, _, lg2 = DS.decode_stack_int4(x, *args, kc, vc, 300, cfg.n_head, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xo, xo2) and torch.equal(lg, lg2)
    xr, _, _, lr = DS.decode_stack_int4_reference(x, *args, kr, vr, 300, cfg.n_head, **kw)
    for got, ref in ((xo.float(), xr.float()), (lg[:, : cfg.vocab_size], lr[:, : cfg.vocab_size])):
        assert (got - ref).abs().max().item() <= K3_TOL * ref.abs().max().item()


def test_k3_graph_replays_give_the_eager_bits(dev, stacks):
    """One whole step captured in a CUDA graph: 6 kernels a layer and the
    head's (the launches chained by programmatic dependent launch), 3
    replays the eager step's bits, the merge tickets back at 0."""
    cfg, qp = stacks[16]
    gen = torch.Generator(device=dev).manual_seed(9)
    shape = (cfg.n_layer, cfg.block_size, 2, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((2, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.tensor(700, dtype=torch.int32, device=dev)
    kw = dict(ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])
    names = stack_graph_check(torch, lambda: DS.decode_stack_int4(x, *_k3_args(cfg, qp), kc, vc, pos,
                                                                  cfg.n_head, **kw), "K3")
    assert len(names) == STACK_KERNELS_A_LAYER * cfg.n_layer + 1
    assert sum("stack_gemv" in n for n in names) == 4 * cfg.n_layer + 1
