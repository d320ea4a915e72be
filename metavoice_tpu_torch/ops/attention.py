"""T=1 decode attention (flash-decoding): the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces ``metavoice_tpu/ops/attention.py:decode_attention`` (the Pallas TPU
kernel ``_decode_attn_kernel``). The kernel is
``metavoice_tpu_torch/csrc/decode_attention.cu``; its header says what bounds
it on the card (the bytes of the cache window it reads,
``2 * (pos + 1 - min_start) * B * H * Dh`` elements per layer) and how its
design follows that bound.

Layout: the cache is sequence-major ``(L, S, B, H, Dh)`` as in
``models/transformer.py``. Both functions update the caches IN PLACE at
``(layer, pos)`` and return them, so callers written against the JAX
signature ``(y, k_cache, v_cache)`` keep working.
"""

from __future__ import annotations

import math

import torch

from metavoice_tpu_torch.ops import _build

SPLIT_POSITIONS = 64  # cache slots per block of the sequence split
MAX_SPLITS = 32

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None):
    """Plain PyTorch version of the kernel: the CPU path and the card's oracle.

    Semantics of ``metavoice_tpu/ops/attention.py:decode_attention_reference``:
    write the new row, f32 scores scaled by 1/sqrt(Dh), -1e30 outside
    ``[starts[b], pos]``, softmax, f32 weighted sum, output in q's dtype.
    Only slots ``[0, pos]`` enter the sums: the rest carry weight exactly 0
    in the reference, and leaving them out keeps garbage (even NaN) beyond
    ``pos`` out of the result. A start past ``pos`` is taken as ``pos``, as
    in the kernel.
    """
    dh = q.shape[-1]
    k_cache[layer, pos] = k_new.to(k_cache.dtype)
    v_cache[layer, pos] = v_new.to(v_cache.dtype)
    lk = k_cache[layer, : pos + 1].float()  # (pos+1, B, H, Dh)
    lv = v_cache[layer, : pos + 1].float()
    s = torch.einsum("bhd,sbhd->bhs", q.float(), lk) / math.sqrt(dh)
    if starts is not None:
        slot = torch.arange(pos + 1, device=q.device)
        valid = slot[None, None, :] >= starts.clamp(max=pos)[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhs,sbhd->bhd", p, lv)
    return y.to(q.dtype), k_cache, v_cache


def _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts):
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, Dh), got {tuple(q.shape)}")
    b, h, dh = q.shape
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(
            f"k_new/v_new must match q {tuple(q.shape)} (GQA, H_kv != H, is the "
            f"multi-query kernel's job), got {tuple(k_new.shape)}, {tuple(v_new.shape)}"
        )
    if k_cache.dim() != 5 or k_cache.shape[2:] != (b, h, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"caches must be (L, S, {b}, {h}, {dh}), got {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}"
        )
    if not (0 <= layer < k_cache.shape[0] and 0 <= pos < k_cache.shape[1]):
        raise ValueError(f"layer {layer} / pos {pos} outside cache {tuple(k_cache.shape)}")
    tensors = (q, k_new, v_new, k_cache, v_cache)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {[t.device for t in tensors]}")
    if starts is not None and (starts.shape != (b,) or starts.device != q.device):
        raise ValueError(f"starts must be ({b},) on {q.device}, got {tuple(starts.shape)}")


def decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int, pos: int, starts=None):
    """One decode-attention step for one layer: ``(y (B, H, Dh), k_cache, v_cache)``.

    q, k_new, v_new: (B, H, Dh); caches: (L, S, B, H, Dh), updated in place
    at (layer, pos); starts: optional (B,) int per-row first valid slot, on
    q's device (a start past ``pos`` is taken as ``pos``). ``layer`` and
    ``pos`` are ints.

    A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
    takes :func:`decode_attention_reference`. ``decode_attention.launches``
    counts kernel launches.
    """
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, h, dh = q.shape
    dtypes = {t.dtype for t in (q, k_new, v_new, k_cache, v_cache)}
    if len(dtypes) != 1 or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes one dtype of bf16/f32 for all inputs, got {dtypes}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {dh}")
    if not all(t.is_contiguous() for t in (q, k_new, v_new, k_cache, v_cache)):
        raise ValueError("decode_attention needs contiguous tensors")
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    n = pos + 1
    n_splits = min(-(-n // SPLIT_POSITIONS), MAX_SPLITS)
    split_len = -(-n // n_splits)
    part_ml = torch.empty((b * h * n_splits * 2,), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((b * h * n_splits * dh,), dtype=torch.float32, device=q.device)
    y = torch.empty_like(q)
    err = _build.kernels().lib.mv_decode_attention(
        _DTYPE_CODE[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if starts is None else starts.data_ptr(),
        b, h, dh, k_cache.shape[1], layer, pos, split_len, n_splits,
        part_ml.data_ptr(), part_acc.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    decode_attention.launches += 1
    return y, k_cache, v_cache


decode_attention.launches = 0
