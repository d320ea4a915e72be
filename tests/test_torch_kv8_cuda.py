"""The per-layer int4 kernels on the card against their plain PyTorch versions,
at the main-path shape (24 stacked layers, D 2048, 16 heads, B = 2, S 2048,
FFN packed to 6144): K5 (ops/attention.decode_attention_block_int4) for a
bf16, an int8 and a packed KV cache, MHA and GQA (2 kv heads), at pos 0, 77,
255 and 2047, with starts and with NaN past pos in the bf16 cache; K6
(ops/quantized.decode_ffn_int4). Needs a CUDA card and nvcc; skips
elsewhere. Imports no JAX, so it runs with ``--noconftest``:

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

from chip_smoke import K5_POS, KV_FORMATS, _random_int4_model, k5_case, k6_case
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import quantized as Q

pytestmark = pytest.mark.cuda

# (format, n_kv_head, pos, starts, garbage past pos)
K5_CASES = [(fmt, h, p, None, None) for fmt in KV_FORMATS for h in (16, 2) for p in K5_POS]
K5_CASES += [("int8", 16, 1000, (300, 700), None), ("int8_packed", 2, 1001, (999, 1001), None),
             ("bf16", 16, 1000, None, float("nan")), ("bf16", 2, 700, (100, 650), float("nan"))]


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


@pytest.mark.parametrize("layer", [0, 11, 23])
def test_k6_matches_plain(models, layer):
    cfg, qp = models[16]
    gen = torch.Generator(device="cuda").manual_seed(layer)
    before = Q.decode_ffn_int4.launches
    k6_case(torch, qp, layer, torch.randn((2, cfg.dim), generator=gen, device="cuda").to(torch.bfloat16))
    assert Q.decode_ffn_int4.launches == before + 1
