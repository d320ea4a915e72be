"""The groupwise int4 kernels on the card against their plain PyTorch
versions, at the main-path shapes: K12 (ops/quantized.matmul_int4) and K13
(ops/quantized.matmul_int4_packed) at M = 2 (decode, the split-K GEMV) and
M = 256 (prefill, the tensor-core tiles) for one layer's projections, at
M = 1, 8, 200, with f32 x and with groupsize 64; and ``_linear`` on both
leaf kinds at M = 300 (the dense f32 route, no launch). Needs a CUDA card
and nvcc; skips elsewhere. Imports no JAX, so it runs with
``--noconftest``:

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
