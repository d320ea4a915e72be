"""K1 on the card: the CUDA decode-attention kernel against its plain version.

Needs a CUDA card; skips elsewhere. Imports no JAX, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest tests/test_torch_decode_attention_cuda.py -q
"""

import numpy as np
import pytest
import torch

from metavoice_tpu_torch.ops import attention as A


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, l, s, b, h, dh, seed=0, garbage=None, pos=None):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    q, k_new, v_new = t(b, h, dh), t(b, h, dh), t(b, h, dh)
    k_cache, v_cache = t(l, s, b, h, dh), t(l, s, b, h, dh)
    if garbage is not None:
        k_cache[:, pos + 1 :] = garbage
        v_cache[:, pos + 1 :] = garbage
    return q, k_new, v_new, k_cache, v_cache


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize(
    "pos,starts,garbage",
    [(0, None, None), (5, None, None), (255, None, None), (256, None, None),
     (400, None, None), (400, (270, 390), None), (300, (0, 301), None),
     (100, None, float("nan")),
     # the edges of attention_plan at 8 rows: one split (a window of 15), a
     # window ending on a split boundary (64 = 4 x 16), a full cluster of 16
     # splits ending on one (256) and past it, starts on and off the
     # boundaries, NaN past pos in a full cluster
     (14, None, None), (63, None, None), (511, (16, 47), None), (300, (0, 17), float("nan"))],
)
def test_kernel_matches_plain_version(cuda, dtype, dh, pos, starts, garbage):
    q, k_new, v_new, k_cache, v_cache = _inputs(
        cuda, dtype, 2, 512, 2, 4, dh, garbage=garbage, pos=pos
    )
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=cuda)
    kc_ref, vc_ref = k_cache.clone(), v_cache.clone()
    y_ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc_ref, vc_ref, 1, pos, st)
    before = A.decode_attention.launches
    y, kc, vc = A.decode_attention(q, k_new, v_new, k_cache, v_cache, 1, pos, st)
    torch.cuda.synchronize()
    assert A.decode_attention.launches == before + 1
    assert kc is k_cache and vc is v_cache  # updated in place
    assert _same_bits(kc, kc_ref) and _same_bits(vc, vc_ref)
    assert torch.isfinite(y).all()
    # f32: only the summation order differs; bf16: one rounding of y
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_kernel_rejects_gqa_and_wrong_dtype(cuda):
    """GQA whose kv heads do not divide the query heads, or whose caches do
    not match k_new, is refused (a well-formed GQA call goes to K4)."""
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, torch.bfloat16, 1, 64, 1, 4, 64)
    with pytest.raises(ValueError):
        A.decode_attention(q, k_new[:, :3], v_new[:, :3], k_cache[:, :, :, :3].contiguous(),
                           v_cache[:, :, :, :3].contiguous(), 0, 3)
    with pytest.raises(ValueError):
        A.decode_attention(q, k_new[:, :2], v_new[:, :2], k_cache, v_cache, 0, 3)
    with pytest.raises(ValueError):
        A.decode_attention(q.float(), k_new, v_new, k_cache, v_cache, 0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("min_split", [16, 40, 100])
@pytest.mark.parametrize("pos,starts", [(300, None), (511, (17, 200)), (200, None)])
def test_kernel_matches_plain_version_under_other_plans(cuda, monkeypatch, dtype, min_split, pos, starts):
    """Any split the plan may give merges right: odd split counts, splits of
    any length, starts inside a split (the plan's own cases are above)."""
    monkeypatch.setattr(A, "ATTN_ONE_SPLIT", 0)
    monkeypatch.setattr(A, "ATTN_MIN_SPLIT", min_split)
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, dtype, 2, 512, 2, 4, 128)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=cuda)
    kc_ref, vc_ref = k_cache.clone(), v_cache.clone()
    y_ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc_ref, vc_ref, 1, pos, st)
    y, kc, vc = A.decode_attention(q, k_new, v_new, k_cache, v_cache, 1, pos, st)
    torch.cuda.synchronize()
    assert A.attention_plan(pos + 1, 8, 1)[1] > 1
    assert _same_bits(kc, kc_ref) and _same_bits(vc, vc_ref)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_graph_captured_before_any_eager_call(cuda, monkeypatch):
    """A capture that would have to make the device's merge counters raises
    (their zero fill would only be recorded); after one eager call the same
    capture replays to the eager bits."""
    monkeypatch.setattr(A, "_tickets", {})
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, torch.bfloat16, 2, 2048, 2, 4, 128)
    pos = 1500
    assert A.attention_plan(pos + 1, 8, 1)[1] > 1
    with pytest.raises(RuntimeError, match="eager call"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            A.decode_attention(q, k_new, v_new, k_cache, v_cache, 1, pos)
    assert not A._tickets
    eager, _, _ = A.decode_attention(q, k_new, v_new, k_cache, v_cache, 1, pos)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _, _ = A.decode_attention(q, k_new, v_new, k_cache, v_cache, 1, pos)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, eager)
