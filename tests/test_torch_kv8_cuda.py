"""The per-layer int4 kernels on the card against their plain PyTorch versions,
at the main-path shape (24 stacked layers, D 2048, 16 heads, B = 2, S 2048,
FFN packed to 6144): K5 (ops/attention.decode_attention_block_int4) for a
bf16, an int8 and a packed KV cache, MHA and GQA (2 kv heads), at pos 0, 77,
255 and 2047, with starts, with NaN past pos in the bf16 cache and NaN
scales before the starts in the int8 and packed caches, and one
call in each format captured in a CUDA graph (3 kernels, 3 replays the
eager bits, the merge counters at 0 after every call; a capture before any
eager call raises); K6 (ops/quantized.decode_ffn_int4) at 1..8 rows on
layers 0, 11 and 23, and one call captured in a CUDA graph (2 kernels, 3
replays the eager bits, the merge counters at 0; a capture before any
eager call raises). Needs a CUDA card and nvcc; skips elsewhere. Imports no JAX, so it runs with ``--noconftest``:

    python -m pytest --noconftest tests/test_torch_kv8_cuda.py -q

Tolerances, chip_smoke.py's own (its k5_case and k6_case hold each case):
K5's y within 2e-2 of max |y| (the plain version's softmax uses the
window's maximum where the kernel's runs online per split, so the bf16
roundings of the value weights land apart), every cache byte and scale but
the new row's unchanged, the new row within one int8 step with scales 1e-6
relative (bf16: one ulp plus 1e-4 of its largest value), the f32 qkv sums
running in another order; K6 within 1e-2 of max |y|.
"""

import pytest
import torch

from chip_smoke import (FFN_KERNELS, FFN_LAYERS, K5_POS, KV_FORMATS, _k5_args, _k6_args, _kv_cache, _random_int4_model,
                        block_graph_check, capture_first_raises, k5_case, k6_case)
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

# (format, n_kv_head, pos, starts, garbage: past pos in a bf16 cache, else in the scales before the starts)
K5_CASES = [(fmt, h, p, None, None) for fmt in KV_FORMATS for h in (16, 2) for p in K5_POS]
K5_CASES += [("int8", 16, 1000, (300, 700), None), ("int8_packed", 2, 1001, (999, 1001), None),
             ("bf16", 16, 1000, None, float("nan")), ("bf16", 2, 700, (100, 650), float("nan")),
             ("int8", 16, 1000, (301, 703), float("nan")), ("int8_packed", 16, 1000, (301, 703), float("nan")),
             ("int8_packed", 2, 1001, (999, 1001), float("nan"))]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models(dev):
    return {h: (cfg, _random_int4_model(torch, cfg, 50 + h, dev))
            for h, cfg in ((h, first_stage_config(n_local_heads=h)) for h in (16, 2))}


@pytest.mark.parametrize("fmt,h_kv,pos,starts,garbage", K5_CASES)
def test_k5_matches_plain(models, fmt, h_kv, pos, starts, garbage):
    cfg, qp = models[h_kv]
    gen = torch.Generator(device="cuda").manual_seed(pos + h_kv + len(fmt))
    before = A.decode_attention_block_int4.launches
    k5_case(torch, qp, cfg, fmt, pos, gen, starts=starts, garbage=garbage)
    assert A.decode_attention_block_int4.launches == before + 1


def _k5_call(models, fmt: str, seed: int, pos: int = 1000):
    cfg, qp = models[16]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kv = _kv_cache(torch, cfg, fmt, gen, torch.device("cuda"), 2)
    x = torch.randn((2, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: A.decode_attention_block_int4(x, *_k5_args(qp), kv.k, kv.v, 5, pos, cfg.n_head,
                                                 k_scale=kv.k_scale, v_scale=kv.v_scale)


@pytest.mark.parametrize("fmt", KV_FORMATS)
def test_k5_call_is_three_kernels_replayed_bit_for_bit(models, fmt):
    """The qkv product, the one-pass attention and the o-proj: a captured
    call replays to the eager bits, the merge counters left at 0."""
    block_graph_check(torch, _k5_call(models, fmt, 80), f"K5 {fmt} cache")


def test_k5_capture_before_any_eager_call_raises(models, monkeypatch):
    """A capture that would have to make the device's merge counters raises;
    after an eager call the same call captures and replays."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    monkeypatch.setattr(A, "_tickets", {})
    call = _k5_call(models, "int8", 81)
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            call()
    assert not DS._stack_tickets and not A._tickets
    block_graph_check(torch, call, "K5 int8 cache, warmed after a refused capture")


@pytest.mark.parametrize("layer", FFN_LAYERS)
@pytest.mark.parametrize("rows", range(1, 9))
def test_k6_matches_plain(models, rows, layer):
    cfg, qp = models[16]
    gen = torch.Generator(device="cuda").manual_seed(layer + 100 * rows)
    before = Q.decode_ffn_int4.launches
    k6_case(torch, qp, layer, torch.randn((rows, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16))
    assert Q.decode_ffn_int4.launches == before + 1


def _k6_call(models, seed: int):
    cfg, qp = models[16]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((2, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: (Q.decode_ffn_int4(x, *_k6_args(qp), 5),)


def test_k6_call_is_two_kernels_replayed_bit_for_bit(models):
    """w1/w3 and w2 on the tensor-core GEMV, chained: a captured call
    replays to the eager bits, the merge counters left at 0."""
    assert block_graph_check(torch, _k6_call(models, 82), "K6", FFN_KERNELS) == list(FFN_KERNELS)


def test_k6_capture_before_any_eager_call_raises(models, monkeypatch):
    """A capture that would have to make the device's merge counters raises;
    after an eager call the same call captures and replays."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    call = _k6_call(models, 83)
    capture_first_raises(torch, call, "K6")
    assert not DS._stack_tickets
    block_graph_check(torch, call, "K6, warmed after a refused capture", FFN_KERNELS)
