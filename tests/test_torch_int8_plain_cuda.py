"""The plain-int8 kernels on the card against their plain PyTorch versions,
at the main-path shapes: K11 (ops/quantized.matmul_int8) at M = 2 (its
tensor-core GEMV) and 256 (its ring of tensor-core tiles) for one layer's
projections, at every M of 1-8, M 9, 16, 32, 64, 65, 200 and 600, N 16 and
2064, K 5632, with bf16 and f32 x, every int8 value bit for bit on both
routes, two calls the same bits and a graph of one call (one kernel)
replayed 3 times to the eager bits at M 2, 16 and 256, a capture before any
eager call raising, and an unaligned or strided weight refused; K9
(ops/attention.decode_attention_block_int8; 24 stacked layers, D 2048, 16
heads, B = 2, S 2048, bf16 cache) at pos 0, 77, 255 and 2047, with a start
past pos and with NaN past pos, and one call captured in a CUDA graph (3
kernels, 3 replays the eager bits, the merge counters at 0 after every
call; a capture before any eager call raises); K10 (ops/quantized.ffn_int8; D 2048, I
5632) at 1..8 rows on layers 0, 11 and 23, with w3 = w1 and s3 = 2 s1 (each
matrix its own scales), one call captured in a CUDA graph (2 kernels, 3
replays the eager bits, the merge counters at 0; a capture before any
eager call raises), and a D or I off the 64 grid refused. Needs a CUDA card
and nvcc; skips elsewhere.
Imports no JAX, so it runs with ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_int8_plain_cuda.py -q

Tolerances, chip_smoke.py's own (its k11_case, k9_case and k10_case hold
each case): K11 every element within 1e-3 of max |ref| plus one bf16 ulp of
the element (the same bf16 products summed in another order, then rounded
to x's dtype); K9's y within 2e-2 of max |y| (its softmax runs online per
split), the new row within one bf16 ulp, every other slot unchanged; K10
within 1e-2 of max |y|.
"""

import pytest
import torch

import chip_smoke
from chip_smoke import (FFN_KERNELS, FFN_LAYERS, K9_POS, _k9_args, _k10_args, _kv_cache, _random_int8_plain_model,
                        block_graph_check, capture_first_raises, k9_case, k10_case, k10_own_scales_case, k11_call,
                        k11_case, k11_exact_case, k11_graph_check)
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

D, I_SZ = 2048, 5632
K11_CASES = [(256, D, 3 * D), (256, D, D), (256, D, I_SZ), (256, I_SZ, D), (1, D, 3 * D), (2, D, D),
             (8, D, I_SZ), (200, D, 3 * D)]
# the GEMV's main shapes at M 2, and chip_smoke's cases of both routes (every GEMV row count, the ring's row
# tiles, 600 rows, N 16 and 2064, K 5632)
K11_CASES += [(2, D, 3 * D), (2, D, I_SZ), (2, I_SZ, D)]
K11_CASES += list(dict.fromkeys((m, k, n) for m, k, n, _ in chip_smoke.K11_CASES if (m, k, n) not in K11_CASES))
# (pos, starts, garbage past pos)
K9_CASES = [(p, None, None) for p in K9_POS] + [(255, (100, 300), None), (1000, None, float("nan"))]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(dev):
    cfg = first_stage_config()
    return cfg, _random_int8_plain_model(torch, cfg, 99, dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", K11_CASES)
def test_k11_matches_plain(dev, m, k, n, dtype):
    gen = torch.Generator(device="cuda").manual_seed(m + k + n)
    before = Q.matmul_int8.launches
    k11_case(torch, m, k, n, gen, dtype)
    assert Q.matmul_int8.launches == before + 1


@pytest.mark.parametrize("rows", [8, 256], ids=["gemv", "ring"])
def test_k11_gives_every_int8_value_exactly(dev, rows):
    """One-hot rows of x, scales 1, f32 out: y is rows of q bit for bit,
    across all 256 int8 values, on the route that ``rows`` takes."""
    k11_exact_case(torch, rows)


@pytest.mark.parametrize("m,k,n", [(2, D, 3 * D), (16, D, D), (256, D, D)])
def test_k11_call_is_one_kernel_replayed_bit_for_bit(dev, m, k, n):
    """Two calls give the same bits; one call captured in a CUDA graph is one
    kernel and replays 3 times to the eager bits, the merge counters back at
    0 (each shape's cut splits K, so the merge is on the path)."""
    route, cut = Q.int8_route(m, k, n)
    assert cut[1 if route == "gemv" else 2] > 1
    name = k11_graph_check(torch, k11_call(torch, m, k, n, 60 + m), f"K11 at M {m}")
    assert name == ("stack_gemv" if route == "gemv" else "int4g_ring_kernel")


@pytest.mark.parametrize("m", [2, 256], ids=["gemv", "ring"])
def test_k11_capture_before_any_eager_call_raises(dev, monkeypatch, m):
    """Each route takes its merge counters on every call: a capture that
    would have to make them raises; after an eager call the same call
    captures and replays."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    monkeypatch.setattr(Q, "_int4g_tickets", {})
    call = k11_call(torch, m, D, D, 70 + m)
    capture_first_raises(torch, call, f"K11 at M {m}", tables=((DS, "_stack_tickets"), (Q, "_int4g_tickets")))
    assert not DS._stack_tickets and not Q._int4g_tickets
    k11_graph_check(torch, call, f"K11 at M {m}, warmed after a refused capture")


def test_k11_counts_its_gemv_launches(dev):
    x2, x16 = (torch.zeros((m, D), dtype=torch.bfloat16, device=dev) for m in (2, 16))
    q, s = Q.quantize_int8(torch.randn((D, D), device=dev))
    launches, gemv = Q.matmul_int8.launches, Q.matmul_int8.gemv_launches
    Q.matmul_int8(x2, q, s)
    Q.matmul_int8(x16, q, s)
    assert (Q.matmul_int8.launches, Q.matmul_int8.gemv_launches) == (launches + 2, gemv + 1)


def test_k11_refuses_an_unaligned_or_strided_weight(dev):
    """The kernel reads q and the scales where they lie (tensor maps, 16-byte
    copies): a q one byte off a 16-byte boundary, or a strided one, raises;
    nothing is copied and nothing launches."""
    q, s = Q.quantize_int8(torch.randn((D, D), device=dev))
    x = torch.zeros((16, D), dtype=torch.bfloat16, device=dev)
    off = torch.empty(D * D + 1, dtype=torch.int8, device=dev)[1:].view(D, D)
    off.copy_(q)
    before = Q.matmul_int8.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        Q.matmul_int8(x, off, s)
    with pytest.raises(ValueError, match="contiguous"):
        Q.matmul_int8(x, torch.cat([q, q], dim=1)[:, :D], s)
    assert Q.matmul_int8.launches == before


@pytest.mark.parametrize("pos,starts,garbage", K9_CASES)
def test_k9_matches_plain(model, pos, starts, garbage):
    cfg, qp = model
    gen = torch.Generator(device="cuda").manual_seed(pos)
    before = A.decode_attention_block_int8.launches
    k9_case(torch, qp, cfg, pos, gen, starts=starts, garbage=garbage)
    assert A.decode_attention_block_int8.launches == before + 1


def _k9_call(model, seed: int, pos: int = 1000):
    cfg, qp = model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv = _kv_cache(torch, cfg, "bf16", gen, torch.device("cuda"), 2)
    x = torch.randn((2, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: A.decode_attention_block_int8(x, *_k9_args(qp, 5), kv.k, kv.v, 5, pos, cfg.n_head)


@pytest.mark.parametrize("pos", [255, 1000])
def test_k9_call_is_three_kernels_replayed_bit_for_bit(model, pos):
    """The qkv product, the one-pass attention (one split at pos 255, four
    at 1000) and the o-proj: a captured call replays to the eager bits, the
    merge counters left at 0."""
    block_graph_check(torch, _k9_call(model, 90, pos), f"K9 at pos {pos}")


def test_k9_capture_before_any_eager_call_raises(model, monkeypatch):
    """A capture that would have to make the device's merge counters raises;
    after an eager call the same call captures and replays."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    monkeypatch.setattr(A, "_tickets", {})
    call = _k9_call(model, 91)
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            call()
    assert not DS._stack_tickets and not A._tickets
    block_graph_check(torch, call, "K9, warmed after a refused capture")


@pytest.mark.parametrize("layer", FFN_LAYERS)
@pytest.mark.parametrize("rows", range(1, 9))
def test_k10_matches_plain(model, rows, layer):
    cfg, qp = model
    gen = torch.Generator(device="cuda").manual_seed(rows)
    before = Q.ffn_int8.launches
    x = torch.randn((rows, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16)
    k10_case(torch, x, _k10_args(qp, layer), f"layer {layer}")
    assert Q.ffn_int8.launches == before + 1


def test_k10_scales_w1_and_w3_each_by_its_own(model):
    """w3 = w1 with s3 = 2 s1: h3 = 2 h1, which a scale shared by both
    matrices would miss by half of y."""
    k10_own_scales_case(torch, model[1], torch.Generator(device="cuda").manual_seed(103))


def _k10_call(model, seed: int):
    cfg, qp = model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: (Q.ffn_int8(x, *_k10_args(qp, 5)),)


def test_k10_call_is_two_kernels_replayed_bit_for_bit(model):
    """w1/w3 and w2 on the tensor-core GEMV, chained: a captured call
    replays to the eager bits, the merge counters left at 0."""
    assert block_graph_check(torch, _k10_call(model, 104), "K10", FFN_KERNELS) == list(FFN_KERNELS)


def test_k10_capture_before_any_eager_call_raises(model, monkeypatch):
    """A capture that would have to make the device's merge counters raises;
    after an eager call the same call captures and replays."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    call = _k10_call(model, 105)
    capture_first_raises(torch, call, "K10")
    assert not DS._stack_tickets
    block_graph_check(torch, call, "K10, warmed after a refused capture", FFN_KERNELS)


def test_kernels_refuse_what_they_cannot_take(dev):
    """On the card a shape the kernel cannot take raises; nothing falls back."""
    x = torch.zeros((2, 40), dtype=torch.bfloat16, device=dev)
    q, s = Q.quantize_int8(torch.randn((40, 24), device=dev))
    with pytest.raises(ValueError, match="N of 16"):
        Q.matmul_int8(x, q, s)
    q, s = Q.quantize_int8(torch.randn((40, 32), device=dev))
    with pytest.raises(ValueError, match="1..8 rows"):
        Q.ffn_int8(torch.zeros((9, 40), dtype=torch.bfloat16, device=dev), q, s, q, s, *Q.quantize_int8(
            torch.randn((32, 40), device=dev)))


@pytest.mark.parametrize("d,i_sz", [(2048, 5648), (528, 1536), (2048, 5664)])
def test_k10_refuses_d_or_i_off_the_64_grid(dev, d, i_sz):
    """D and I must be multiples of 64 (32-column tiles, two a cluster): a
    shape off that grid raises with the shape; nothing falls back."""
    w1, s1 = Q.quantize_int8(torch.randn((d, i_sz), device=dev))
    w2, s2 = Q.quantize_int8(torch.randn((i_sz, d), device=dev))
    before = Q.ffn_int8.launches
    with pytest.raises(ValueError, match=f"multiples of 64; got 2 rows, D {d}, I {i_sz}"):
        Q.ffn_int8(torch.zeros((2, d), dtype=torch.bfloat16, device=dev), w1, s1, w1, s1, w2, s2)
    assert Q.ffn_int8.launches == before
