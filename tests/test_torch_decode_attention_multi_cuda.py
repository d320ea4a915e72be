"""K4 on the card: the CUDA multi-query decode-attention kernel against its
plain version.

Needs a CUDA card; skips elsewhere. Imports no JAX, so on the machine with
the card it runs without the JAX package's conftest:

    python -m pytest --noconftest tests/test_torch_decode_attention_multi_cuda.py -q
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


def _inputs(dev, dtype, t, h, h_kv, dh, l=2, s=512, b=2, seed=0, garbage=None, pos=None):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)

    q, k_new, v_new = r(b, h, t, dh), r(b, h_kv, t, dh), r(b, h_kv, t, dh)
    k_cache, v_cache = r(l, s, b, h_kv, dh), r(l, s, b, h_kv, dh)
    if garbage is not None:
        k_cache[:, pos + t :] = garbage
        v_cache[:, pos + t :] = garbage
    return q, k_new, v_new, k_cache, v_cache


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("t,h,h_kv", [(1, 8, 2), (4, 8, 8), (16, 8, 8), (8, 8, 2), (16, 8, 1), (3, 6, 3)])
@pytest.mark.parametrize(
    "pos,starts,garbage",
    [(0, None, None), (61, None, None), (255, None, None), (400, (270, 390), None),
     (300, (0, 500), None), (100, None, float("nan")),
     # the edges of attention_plan: one split (a window of at most 28), a
     # window of 512 = 16 x 32 at T 16 (a full cluster ending on a split
     # boundary), starts inside a full cluster with NaN past pos + T - 1
     (12, None, None), (496, (40, 480), None), (200, (33, 150), float("nan"))],
)
def test_kernel_matches_plain_version(cuda, dtype, dh, t, h, h_kv, pos, starts, garbage):
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, dtype, t, h, h_kv, dh, garbage=garbage, pos=pos)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=cuda)
    kc_ref, vc_ref = k_cache.clone(), v_cache.clone()
    y_ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kc_ref, vc_ref, 1, pos, st)
    before = A.decode_attention_multi.launches
    y, kc, vc = A.decode_attention_multi(q, k_new, v_new, k_cache, v_cache, 1, pos, st)
    torch.cuda.synchronize()
    assert A.decode_attention_multi.launches == before + 1
    assert kc is k_cache and vc is v_cache  # updated in place
    assert _same_bits(kc, kc_ref) and _same_bits(vc, vc_ref)
    assert torch.isfinite(y).all()
    # f32: only the summation order differs; bf16: one rounding of y
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_gqa_decode_attention_launches_k4(cuda):
    """decode_attention with fewer kv heads than query heads is K4 at T = 1."""
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, torch.bfloat16, 1, 16, 2, 128)
    k1, k4 = A.decode_attention.launches, A.decode_attention_multi.launches
    y, _, _ = A.decode_attention(q[:, :, 0], k_new[:, :, 0], v_new[:, :, 0], k_cache, v_cache, 0, 50)
    torch.cuda.synchronize()
    assert (A.decode_attention.launches, A.decode_attention_multi.launches) == (k1, k4 + 1)
    assert y.shape == (2, 16, 128) and torch.isfinite(y).all()


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, torch.bfloat16, 4, 8, 2, 128, s=64)
    with pytest.raises(ValueError):
        A.decode_attention_multi(q.float(), k_new, v_new, k_cache, v_cache, 0, 3)  # mixed dtypes
    with pytest.raises(ValueError):
        A.decode_attention_multi(q.transpose(1, 2).contiguous().transpose(1, 2), k_new, v_new,
                                 k_cache, v_cache, 0, 3)  # not contiguous
    with pytest.raises(ValueError):
        A.decode_attention_multi(q, k_new, v_new, k_cache, v_cache, 0, 61)  # rows past the cache
    q96, kn96, vn96, kc96, vc96 = _inputs(cuda, torch.bfloat16, 4, 8, 2, 96, s=64)
    with pytest.raises(ValueError):
        A.decode_attention_multi(q96, kn96, vn96, kc96, vc96, 0, 3)  # head_dim 96


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("min_split", [16, 40, 100])
@pytest.mark.parametrize("t,h,h_kv", [(1, 8, 2), (8, 8, 8), (16, 8, 1)])
def test_kernel_matches_plain_version_under_other_plans(cuda, monkeypatch, dtype, min_split, t, h, h_kv):
    """Any split the plan may give merges right: odd split counts, splits of
    any length, starts inside a split, NaN past pos + T - 1."""
    monkeypatch.setattr(A, "ATTN_ONE_SPLIT", 0)
    monkeypatch.setattr(A, "ATTN_MIN_SPLIT", min_split)
    pos = 300
    q, k_new, v_new, k_cache, v_cache = _inputs(cuda, dtype, t, h, h_kv, 128, garbage=float("nan"), pos=pos)
    st = torch.tensor((17, 150), dtype=torch.int32, device=cuda)
    kc_ref, vc_ref = k_cache.clone(), v_cache.clone()
    y_ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kc_ref, vc_ref, 1, pos, st)
    y, kc, vc = A.decode_attention_multi(q, k_new, v_new, k_cache, v_cache, 1, pos, st)
    torch.cuda.synchronize()
    assert A.attention_plan(pos + t, 2 * h_kv, t * h // h_kv)[1] > 1
    assert _same_bits(kc, kc_ref) and _same_bits(vc, vc_ref)
    assert torch.isfinite(y).all()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=tol)
