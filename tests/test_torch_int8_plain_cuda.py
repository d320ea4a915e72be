"""The plain-int8 kernels on the card against their plain PyTorch versions,
at the main-path shapes: K11 (ops/quantized.matmul_int8) at M = 256 for one
layer's projections and at M = 1, 2, 8, 200 and with f32 x; K9
(ops/attention.decode_attention_block_int8; 24 stacked layers, D 2048, 16
heads, B = 2, S 2048, bf16 cache) at pos 0, 77, 255 and 2047, with a start
past pos and with NaN past pos, and one call captured in a CUDA graph (3
kernels, 3 replays the eager bits, the merge counters at 0 after every
call; a capture before any eager call raises); K10 (ops/quantized.ffn_int8; D 2048, I
5632) at 1, 2 and 3 rows. Needs a CUDA card and nvcc; skips elsewhere.
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

from chip_smoke import (K9_POS, K10_CASES, _k9_args, _kv_cache, _random_int8_plain_model, block_graph_check, k9_case,
                        k10_case, k11_case)
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

D, I_SZ = 2048, 5632
K11_CASES = [(256, D, 3 * D), (256, D, D), (256, D, I_SZ), (256, I_SZ, D), (1, D, 3 * D), (2, D, D),
             (8, D, I_SZ), (200, D, 3 * D)]
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


@pytest.mark.parametrize("rows,layer", K10_CASES)
def test_k10_matches_plain(model, rows, layer):
    cfg, qp = model
    gen = torch.Generator(device="cuda").manual_seed(rows)
    before = Q.ffn_int8.launches
    k10_case(torch, qp, layer, torch.randn((rows, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16))
    assert Q.ffn_int8.launches == before + 1


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
