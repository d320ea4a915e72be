"""Decode attention (flash-decoding): the CUDA kernels' wrappers and their
plain PyTorch versions.

* K1, ``decode_attention``: one query token per (batch, head) row. Replaces
  ``metavoice_tpu/ops/attention.py:decode_attention`` (the Pallas TPU kernel
  ``_decode_attn_kernel``); the kernel is
  ``metavoice_tpu_torch/csrc/decode_attention.cu``. A GQA call (fewer kv
  heads than query heads) goes to K4 at T = 1, as in the JAX package.
* K4, ``decode_attention_multi``: T <= 16 query tokens at ``[pos, pos+T)``
  in kv-head space (GQA), the speculative verify's attention. Replaces
  ``metavoice_tpu/ops/attention.py:decode_attention_multi`` (the Pallas TPU
  kernel ``_decode_attn_multi_kernel``); the kernel is
  ``metavoice_tpu_torch/csrc/decode_attention_multi.cu``.

Each kernel's source says what bounds it on the card (the bytes of the cache
window it reads, ``2 * (pos + T - min_start) * B * H_kv * Dh`` elements per
layer) and how its design follows that bound.

Layout: the cache is sequence-major ``(L, S, B, H_kv, Dh)`` as in
``models/transformer.py``. Every function updates the caches IN PLACE at
``(layer, [pos, pos+T))`` and returns them, so callers written against the
JAX signature ``(y, k_cache, v_cache)`` keep working. A start past ``pos``
is taken as ``pos``.
"""

from __future__ import annotations

import math

import torch

from metavoice_tpu_torch.ops import _build

SPLIT_POSITIONS = 64  # cache slots per block of the sequence split
MAX_SPLITS = 32
MULTI_MAX_T = 16  # K4's most query tokens a call

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
    """Shapes of one call, T = 1 (3-D q) or T (4-D q): raise on a mismatch."""
    b, h, *t, dh = q.shape
    h_kv = k_new.shape[1] if k_new.dim() == q.dim() else -1
    if k_new.shape != (b, h_kv, *t, dh) or v_new.shape != k_new.shape or h_kv < 1 or h % h_kv:
        raise ValueError(
            f"k_new/v_new must be (B, H_kv, ..., Dh) with H_kv dividing H (GQA) for q "
            f"{tuple(q.shape)}, got {tuple(k_new.shape)}, {tuple(v_new.shape)}"
        )
    if k_cache.dim() != 5 or k_cache.shape[2:] != (b, h_kv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"caches must be (L, S, {b}, {h_kv}, {dh}) for k_new's GQA kv heads, got "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    n_new = t[0] if t else 1
    if not (0 <= layer < k_cache.shape[0] and 0 <= pos and pos + n_new <= k_cache.shape[1]):
        raise ValueError(f"layer {layer} / rows [{pos}, {pos + n_new}) outside cache {tuple(k_cache.shape)}")
    tensors = (q, k_new, v_new, k_cache, v_cache)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {[t.device for t in tensors]}")
    if starts is not None and (starts.shape != (b,) or starts.device != q.device):
        raise ValueError(f"starts must be ({b},) on {q.device}, got {tuple(starts.shape)}")


def _check_kernel_inputs(name, tensors):
    """What both CUDA kernels take: one dtype of bf16/f32, head_dim 64 or
    128, contiguous tensors."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _DTYPE_CODE:
        raise ValueError(f"the kernel takes one dtype of bf16/f32 for all inputs, got {dtypes}")
    if tensors[0].shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {_HEAD_DIMS}, got {tensors[0].shape[-1]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _split_scratch(n: int, rows: int, dh: int, device):
    """The sequence split of a window of ``n`` slots, and the f32 scratch of
    its partials -> (split_len, n_splits, part_ml, part_acc)."""
    n_splits = min(-(-n // SPLIT_POSITIONS), MAX_SPLITS)
    part_ml = torch.empty((rows * n_splits * 2,), dtype=torch.float32, device=device)
    part_acc = torch.empty((rows * n_splits * dh,), dtype=torch.float32, device=device)
    return -(-n // n_splits), n_splits, part_ml, part_acc


def decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int, pos: int, starts=None):
    """One decode-attention step for one layer: ``(y (B, H, Dh), k_cache, v_cache)``.

    q, k_new, v_new: (B, H, Dh); caches: (L, S, B, H, Dh), updated in place
    at (layer, pos); starts: optional (B,) int per-row first valid slot, on
    q's device (a start past ``pos`` is taken as ``pos``). ``layer`` and
    ``pos`` are ints.

    A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
    takes :func:`decode_attention_reference`. ``decode_attention.launches``
    counts kernel launches. GQA (k_new with fewer heads than q) is
    :func:`decode_attention_multi` at T = 1, as in the JAX package: K4 on
    the card, counted in ``decode_attention_multi.launches``.
    """
    if q.dim() == 3 and k_new.dim() == 3 and k_new.shape[1] != q.shape[1]:
        y4, k_cache, v_cache = decode_attention_multi(
            q[:, :, None], k_new[:, :, None], v_new[:, :, None], k_cache, v_cache, layer, pos, starts
        )
        return y4[:, :, 0], k_cache, v_cache
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, Dh), got {tuple(q.shape)}")
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, h, dh = q.shape
    _check_kernel_inputs("decode_attention", (q, k_new, v_new, k_cache, v_cache))
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    split_len, n_splits, part_ml, part_acc = _split_scratch(pos + 1, b * h, dh, q.device)
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


def decode_attention_multi_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None):
    """Plain PyTorch version of K4: the CPU path and the card's oracle.

    Semantics of ``metavoice_tpu/ops/attention.py:decode_attention_multi_reference``:
    write the T new rows at ``[pos, pos+T)``, f32 scores scaled by
    1/sqrt(Dh), query t masked to ``[starts[b], pos + t]`` (-1e30 outside),
    softmax, f32 weighted sum, output in q's dtype; kv head h // g serves
    query head h (g = H / H_kv). Only slots ``[0, pos+T)`` enter the sums,
    which keeps garbage (even NaN) past the window out of the result; a
    start past ``pos`` is taken as ``pos``.
    """
    b, h, t, dh = q.shape
    h_kv = k_new.shape[1]
    n = pos + t
    k_cache[layer, pos:n] = k_new.permute(2, 0, 1, 3).to(k_cache.dtype)
    v_cache[layer, pos:n] = v_new.permute(2, 0, 1, 3).to(v_cache.dtype)
    lk = k_cache[layer, :n].float()  # (n, B, H_kv, Dh)
    lv = v_cache[layer, :n].float()
    if h_kv != h:
        lk = torch.repeat_interleave(lk, h // h_kv, dim=2)
        lv = torch.repeat_interleave(lv, h // h_kv, dim=2)
    s = torch.einsum("bhtd,sbhd->bhts", q.float(), lk) / math.sqrt(dh)
    slot = torch.arange(n, device=q.device)
    valid = slot[None, None, None, :] <= (pos + torch.arange(t, device=q.device))[None, None, :, None]
    if starts is not None:
        valid = valid & (slot[None, None, None, :] >= starts.clamp(max=pos)[:, None, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhts,sbhd->bhtd", p, lv)
    return y.to(q.dtype), k_cache, v_cache


def decode_attention_multi(q, k_new, v_new, k_cache, v_cache, layer: int, pos: int, starts=None):
    """T-query decode attention for one layer: ``(y (B, H, T, Dh), k_cache, v_cache)``.

    q: (B, H, T, Dh); k_new, v_new: (B, H_kv, T, Dh) with H_kv dividing H;
    caches: (L, S, B, H_kv, Dh), updated in place at rows ``[pos, pos+T)``
    of ``layer``; query t attends ``[starts[b], pos + t]``. T <= 16.

    A CUDA tensor launches the hand-written kernel (one dtype of bf16/f32,
    head_dim 64 or 128, contiguous tensors) or raises; a CPU tensor takes
    :func:`decode_attention_multi_reference`.
    ``decode_attention_multi.launches`` counts kernel launches.
    """
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, Dh), got {tuple(q.shape)}")
    b, h, t, dh = q.shape
    if not 1 <= t <= MULTI_MAX_T:
        raise ValueError(f"decode_attention_multi takes 1..{MULTI_MAX_T} query tokens, got {t}")
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type == "cpu":
        return decode_attention_multi_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_multi runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs("decode_attention_multi", (q, k_new, v_new, k_cache, v_cache))
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    split_len, n_splits, part_ml, part_acc = _split_scratch(pos + t, b * h * t, dh, q.device)
    y = torch.empty_like(q)
    err = _build.kernels().lib.mv_decode_attention_multi(
        _DTYPE_CODE[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if starts is None else starts.data_ptr(),
        b, h, k_new.shape[1], t, dh, k_cache.shape[1], layer, pos, split_len, n_splits,
        part_ml.data_ptr(), part_acc.data_ptr(), y.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_multi kernel launch failed: cudaError_t {err}")
    decode_attention_multi.launches += 1
    return y, k_cache, v_cache


decode_attention_multi.launches = 0
