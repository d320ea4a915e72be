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
* K5, ``decode_attention_block_int4``: one decode layer's int4 attention
  block (qkv projection, the new K/V row in a bf16, int8 or packed cache,
  attention over the window, o-proj). Replaces
  ``metavoice_tpu/ops/attention.py:decode_attention_block_int4`` (the Pallas
  TPU kernel ``_decode_block_int4_kernel``); the kernel is
  ``metavoice_tpu_torch/csrc/decode_block_int4.cu``.
* K9, ``decode_attention_block_int8``: one decode layer's plain-int8
  attention block (qkv projection, the new K/V row in a bf16 cache,
  attention over the window, o-proj), MHA. Replaces
  ``metavoice_tpu/ops/attention.py:decode_attention_block_int8`` (the Pallas
  TPU kernel ``_decode_block_kernel``); the kernel is
  ``metavoice_tpu_torch/csrc/decode_block_int8.cu``.

Each kernel's source says what bounds it on the card (the bytes of the cache
window it reads, ``2 * (pos + T - min_start) * B * H_kv * Dh`` elements per
layer) and how its design follows that bound. K1 and K4 share one device
design (``csrc/decode_attention_onepass.cuh``): one launch a call, the
window cut into splits by :func:`attention_plan`. K5 and K9 are three
kernels a call chained by programmatic dependent launch: the tensor-core
qkv product (``csrc/decode_stack_gemv.cuh``), K1's one-pass attention with
the new row made in it, the o-proj; :func:`block_plan` cuts all three. The
merge counters of the products (``decode_stack._stack_tickets``) and of the
attention (``_tickets``) are per device and made by the first eager call,
so calls on one device must not overlap in time (two streams, or two graph
replays at once), and a CUDA-graph capture needs one eager call before it.
A call of K1, K5 or K9, or of K4 at any T (its GQA decode step at T = 1,
the speculative verify at T = gamma), also takes ``pos`` as a one-element
int32 tensor that the kernel reads on the device, planned at a window
bucket (:func:`attention_window`) that holds ``pos + T``: one launch
captured in a CUDA graph then serves every slot of the bucket (the decode
step of ``models/first_stage.py``, the speculative round of
``models/spec_decode.py``), and an int ``pos`` is planned at the same
bucket, so both give the same bits. The plain versions take either, read
over the bucket with the slots past ``pos + T - 1`` zeroed.

Layout: the cache is sequence-major ``(L, S, B, H_kv, Dh)`` as in
``models/transformer.py``. Every function updates the caches IN PLACE at
``(layer, [pos, pos+T))`` and returns them, so callers written against the
JAX signature ``(y, k_cache, v_cache)`` keep working. A start past ``pos``
is taken as ``pos``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops.quantized import (
    CARD_SMS,
    DECODE_MAX_ROWS,
    int8_dot,
    matmul_int4_i32_reference,
    merge_tickets,
)

MULTI_MAX_T = 16  # K4's most query tokens a call
# K1's and K4's plan (csrc/decode_attention_onepass.cuh): one launch a call,
# the splits of a kv row merged by the last of its blocks to finish
ATTN_MAX_SPLITS = 32  # splits of a kv row's window (the kernel's kCMaxSplits)
ATTN_MAX_Q = 16  # queries a block; more of one kv row take further blocks
ATTN_ONE_SPLIT = 384  # windows of at most this many slots take one split
ATTN_MIN_SPLIT = 128  # fewest slots a split of a longer window
ATTN_TICKETS = 4096  # merge counters a device: (kv row, query group) pairs a call
_tickets: dict = {}  # device index -> (ATTN_TICKETS,) int32, all 0 between calls

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)


def attention_window(n: int, seq_len: int) -> int:
    """The window bucket K1 plans a call of ``n`` slots at (slots ``[0, n)``,
    ``n = pos + 1``): ``ATTN_ONE_SPLIT`` up to that many slots, else the
    power of two at or above ``n``; at most ``seq_len``. Every slot of a
    bucket takes the bucket's plan (:func:`attention_plan` of its upper end,
    a split wholly past ``pos`` left empty), so a step captured in a CUDA
    graph serves the whole bucket, and an eager call gives its bits."""
    w = ATTN_ONE_SPLIT if n <= ATTN_ONE_SPLIT else 1 << (n - 1).bit_length()
    return min(w, seq_len)


def _window_of(pos, window, seq_len: int, t: int = 1) -> int:
    """The window a call of ``t`` new rows at ``pos`` is planned at:
    ``window``, or by default the whole cache for a tensor ``pos``, and for
    an int :func:`attention_window` of ``pos + 1`` at T = 1 and ``pos + t``
    itself at T > 1 (the speculative verify's exact window)."""
    if window is not None:
        return window
    if isinstance(pos, torch.Tensor):
        return seq_len
    return attention_window(int(pos) + 1, seq_len) if t == 1 else int(pos) + t


def _check_slot(pos, window, seq_len: int, device, who: str) -> int:
    """A T = 1 call's ``pos`` (an int, or one int32 on ``device``) and its
    window bucket -> the window; raises where they do not fit a cache of
    ``seq_len`` slots. A tensor is not read: its window bounds it."""
    w = _window_of(pos, window, seq_len)
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != device:
            raise ValueError(f"{who}: a device pos is one int32 on {device}, got {tuple(pos.shape)} {pos.dtype} "
                             f"on {pos.device}")
        if not 0 < w <= seq_len:
            raise ValueError(f"{who}: window {w} outside the cache's {seq_len} slots")
    elif not 0 <= pos < w <= seq_len:
        raise ValueError(f"{who}: pos {pos} / window {w} outside the cache's {seq_len} slots")
    return w


def _slot_tensor(pos, device) -> torch.Tensor:
    """``pos`` (an int or a one-element tensor) as a (1,) int64 tensor on
    ``device``, without reading a device tensor back to the host."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.full((1,), int(pos), dtype=torch.int64, device=device)


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None, window=None):
    """Plain PyTorch version of the kernel: the CPU path and the card's oracle.

    Semantics of ``metavoice_tpu/ops/attention.py:decode_attention_reference``:
    write the new row, f32 scores scaled by 1/sqrt(Dh), -1e30 outside
    ``[starts[b], pos]``, softmax, f32 weighted sum, output in q's dtype.
    ``pos`` is an int or a one-element int tensor on q's device, read on
    the device; the sums run over the kernel's window ``[0, window)``
    (default: :func:`attention_window` of an int ``pos``, the whole cache
    for a tensor), so an int and a tensor ``pos`` give the same bits. Slots
    past ``pos`` carry weight exactly 0 and their values are zeroed first,
    which keeps garbage (even NaN) beyond ``pos`` out of the result. A
    start past ``pos`` is taken as ``pos``, as in the kernel.
    """
    dh = q.shape[-1]
    window = _window_of(pos, window, k_cache.shape[1])
    p = _slot_tensor(pos, q.device)
    k_cache[layer].index_copy_(0, p, k_new[None].to(k_cache.dtype))
    v_cache[layer].index_copy_(0, p, v_new[None].to(v_cache.dtype))
    slot = torch.arange(window, device=q.device)
    live = slot <= p  # (window,)
    lk = k_cache[layer, :window].float()  # (window, B, H, Dh)
    lv = torch.where(live[:, None, None, None], v_cache[layer, :window].float(), 0.0)
    s = torch.einsum("bhd,sbhd->bhs", q.float(), lk) / math.sqrt(dh)
    valid = live[None, None, :]
    if starts is not None:
        valid = valid & (slot[None, None, :] >= torch.minimum(starts, p)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhs,sbhd->bhd", p, lv)
    return y.to(q.dtype), k_cache, v_cache


def _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts, window=None):
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
    if isinstance(pos, torch.Tensor):  # read on the device: the window bounds it
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != q.device:
            raise ValueError(f"a device pos is one int32 on {q.device}, got {tuple(pos.shape)} {pos.dtype} "
                             f"on {pos.device}")
        if not (0 <= layer < k_cache.shape[0] and (window is None or n_new <= window <= k_cache.shape[1])):
            raise ValueError(f"layer {layer} / window {window} of {n_new} new rows outside cache "
                             f"{tuple(k_cache.shape)}")
    elif not (0 <= layer < k_cache.shape[0] and 0 <= pos and pos + n_new <= k_cache.shape[1]):
        raise ValueError(f"layer {layer} / rows [{pos}, {pos + n_new}) outside cache {tuple(k_cache.shape)}")
    elif window is not None and not pos + n_new <= window <= k_cache.shape[1]:
        raise ValueError(f"window {window} must hold rows [{pos}, {pos + n_new}) and fit the cache "
                         f"{tuple(k_cache.shape)}")
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


def attention_plan(n: int, kv_rows: int, n_q: int) -> tuple[int, int]:
    """K1's and K4's cut of a window of ``n`` slots into splits -> (split_len,
    n_splits): split i holds slots ``[i * split_len, (i + 1) * split_len)``,
    the last one ends at or past ``n`` and none lies wholly past it; a row's
    start falls anywhere in ``[0, n)`` and the kernel skips what lies below it.

    A split is one block (8 warps) for each kv row and group of up to
    ``ATTN_MAX_Q`` of its ``n_q`` queries. A window of up to
    ``ATTN_ONE_SPLIT`` slots takes one split: merging splits costs more than
    it saves there (on the H100, K1 at a 256-slot window: 0.0056 ms in one
    split, 0.0072 in two). A longer one takes as many splits as give about
    one block an SM, no more than pieces of ``ATTN_MIN_SPLIT`` slots would
    give and at most ``ATTN_MAX_SPLITS``: 4 for K1's 32 rows, 16 for a GQA
    decode's 4 kv rows at 2033 slots (0.0082 ms in 16 splits, 0.0098 in 7).
    """
    if n <= ATTN_ONE_SPLIT:
        return n, 1
    blocks = kv_rows * -(-n_q // ATTN_MAX_Q)  # blocks a split
    n_splits = max(1, min(ATTN_MAX_SPLITS, -(-n // ATTN_MIN_SPLIT), CARD_SMS // blocks))
    split_len = -(-n // n_splits)
    return split_len, -(-n // split_len)


def _onepass_scratch(n_splits: int, kv_rows: int, n_q: int, dh: int, device):
    """The partials and merge counters of one K1/K4 call -> (part, tickets):
    none for one split; else f32 scratch of ``(kv rows x query groups,
    splits, ATTN_MAX_Q, dh + 2)`` and the device's counters, made zero by
    the first call and left zero by every launch (the last block of a row
    resets its own; ``merge_tickets``). The counters are taken on every
    call, so that a CUDA-graph capture before any eager call raises."""
    tickets = merge_tickets(_tickets, ATTN_TICKETS, device, "decode_attention")
    if n_splits == 1:
        return None, None
    groups = -(-n_q // ATTN_MAX_Q)
    if kv_rows * groups > ATTN_TICKETS:
        raise ValueError(f"{kv_rows * groups} kv rows x query groups exceed the {ATTN_TICKETS} merge counters")
    part = torch.empty((kv_rows * groups * n_splits * ATTN_MAX_Q * (dh + 2),), dtype=torch.float32, device=device)
    return part, tickets


BLOCK_FORMATS = ("bf16", "int8", "packed", "int8_plain")  # K5's three caches, then K9
BLOCK_HEAD_DIM = 128  # the attention blocks' head width


class BlockPlan(NamedTuple):
    """The cut of one K5 or K9 call: each product's ``(split_steps, n_splits,
    warps)`` (``decode_stack.stack_gemv_plan``), the attention's ``(split_len,
    n_splits)`` (:func:`attention_plan`, one block a query head) and the f32
    scratch of their split partials (0 where everything is one split)."""

    qkv: tuple[int, int, int]
    o: tuple[int, int, int]
    attn: tuple[int, int]
    part: int  # the products': splits x B x (N + 1) of the larger
    attn_part: int  # the attention's: B x H x splits x (Dh + 2)


def block_plan(fmt: str, b: int, d: int, n_head: int, n_kv_head: int, pos: int) -> BlockPlan:
    """The plan of one attention-block call at (format, B, D, H, H_kv, pos):
    ``fmt`` one of :data:`BLOCK_FORMATS` ("int8_plain" is K9, plain int8
    weights; the others K5's int4 words on that cache). The qkv product is
    (B, D) @ (D, D + 2 * H_kv * 128), the o-proj (B, D) @ (D, D), both in K5's
    int4 words (vpw 8) or K9's plain bytes (vpw 1); the attention's window is
    ``[0, pos]`` in blocks of one query head each. The wrappers plan a call
    at its window bucket's last slot (:func:`attention_window`), whatever
    slot of the bucket it writes."""
    if fmt not in BLOCK_FORMATS:
        raise ValueError(f"fmt must be one of {BLOCK_FORMATS}, got {fmt!r}")
    vpw = 1 if fmt == "int8_plain" else 8
    qout = d + 2 * n_kv_head * BLOCK_HEAD_DIM
    qkv = DS.stack_gemv_plan(d, qout, vpw, b)
    o = DS.stack_gemv_plan(d, d, vpw, b)
    part = max(p[1] * b * (n + 1) if p[1] > 1 else 0 for p, n in ((qkv, qout), (o, d)))
    rows = b * n_head
    split_len, n_splits = attention_plan(pos + 1, rows, 1)
    attn_part = rows * n_splits * (BLOCK_HEAD_DIM + 2) if n_splits > 1 else 0
    return BlockPlan(qkv, o, (split_len, n_splits), part, attn_part)


def _block_scratch(plan: BlockPlan, b: int, d: int, qout: int, rows: int, device, who: str):
    """One K5/K9 call's scratch and counters -> (qkv (B, qout) f32, ya (B, D)
    bf16, product partials, attention partials or None, the products'
    counters, the attention's counters). Both counter tables are taken on
    every call, so that a CUDA-graph capture before any eager call raises."""
    if qout // DS.STACK_TILE_N > DS.STACK_TICKETS or rows > ATTN_TICKETS:
        raise ValueError(f"{who}: {qout // DS.STACK_TILE_N} column tiles / {rows} rows exceed the merge counters")
    f32 = torch.float32
    return (torch.empty((b, qout), dtype=f32, device=device), torch.empty((b, d), dtype=torch.bfloat16, device=device),
            torch.empty((max(plan.part, 1),), dtype=f32, device=device),
            torch.empty((plan.attn_part,), dtype=f32, device=device) if plan.attn_part else None,
            merge_tickets(DS._stack_tickets, DS.STACK_TICKETS, device, who),
            merge_tickets(_tickets, ATTN_TICKETS, device, who))


def decode_attention(q, k_new, v_new, k_cache, v_cache, layer: int, pos, starts=None, *, window: int | None = None):
    """One decode-attention step for one layer: ``(y (B, H, Dh), k_cache, v_cache)``.

    q, k_new, v_new: (B, H, Dh); caches: (L, S, B, H, Dh), updated in place
    at (layer, pos); starts: optional (B,) int per-row first valid slot, on
    q's device (a start past ``pos`` is taken as ``pos``). ``layer`` is an
    int; ``pos`` an int, or a one-element int32 tensor on q's device that
    the kernel reads on the device, so that one launch captured in a CUDA
    graph serves every slot of its window. ``window``: the window
    bucket ``[0, window)`` the call is planned at (:func:`attention_plan`
    of it); it must hold ``pos``. Default: :func:`attention_window` of an
    int ``pos``; a tensor ``pos`` without it takes the whole cache. An int
    and a tensor ``pos`` in one window give the same bits.

    A CUDA tensor launches the hand-written kernel or raises; a CPU tensor
    takes :func:`decode_attention_reference`. ``decode_attention.launches``
    counts kernel launches. GQA (k_new with fewer heads than q) is
    :func:`decode_attention_multi` at T = 1, as in the JAX package: K4 on
    the card, counted in ``decode_attention_multi.launches``.
    """
    if q.dim() == 3 and k_new.dim() == 3 and k_new.shape[1] != q.shape[1]:
        y4, k_cache, v_cache = decode_attention_multi(
            q[:, :, None], k_new[:, :, None], v_new[:, :, None], k_cache, v_cache, layer, pos, starts, window=window
        )
        return y4[:, :, 0], k_cache, v_cache
    if q.dim() != 3:
        raise ValueError(f"q must be (B, H, Dh), got {tuple(q.shape)}")
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts, window)
    seq_len = k_cache.shape[1]
    device_pos = isinstance(pos, torch.Tensor)
    window = _window_of(pos, window, seq_len)
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    b, h, dh = q.shape
    _check_kernel_inputs("decode_attention", (q, k_new, v_new, k_cache, v_cache))
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    split_len, n_splits = attention_plan(window, b * h, 1)
    part, tickets = _onepass_scratch(n_splits, b * h, 1, dh, q.device)
    y = torch.empty_like(q)
    err = _build.kernels().lib.mv_decode_attention(
        _DTYPE_CODE[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if starts is None else starts.data_ptr(),
        b, h, dh, seq_len, layer, window - 1 if device_pos else pos, pos.data_ptr() if device_pos else None,
        split_len, n_splits,
        None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
        ATTN_TICKETS, y.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: cudaError_t {err}")
    decode_attention.launches += 1
    return y, k_cache, v_cache


decode_attention.launches = 0


def decode_attention_multi_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts=None, window=None):
    """Plain PyTorch version of K4: the CPU path and the card's oracle.

    Semantics of ``metavoice_tpu/ops/attention.py:decode_attention_multi_reference``:
    write the T new rows at ``[pos, pos+T)``, f32 scores scaled by
    1/sqrt(Dh), query t masked to ``[starts[b], pos + t]`` (-1e30 outside),
    softmax, f32 weighted sum, output in q's dtype; kv head h // g serves
    query head h (g = H / H_kv). The sums run over the window ``[0,
    window)`` (:func:`_window_of`: by default ``[0, pos+T)`` for an int
    ``pos`` at T > 1) with the values past ``pos + T - 1`` zeroed first,
    which keeps garbage (even NaN) there out of the result; a start past
    ``pos`` is taken as ``pos``.

    ``pos`` may also be a one-element int tensor on q's device, read on the
    device (a T = 1 GQA step, or the speculative verify at T = gamma, in a
    CUDA graph), as in :func:`decode_attention_reference`: an int and a
    tensor ``pos`` in one window give the same bits.
    """
    b, h, t, dh = q.shape
    h_kv = k_new.shape[1]
    rows = _slot_tensor(pos, q.device) + torch.arange(t, device=q.device)
    k_cache[layer].index_copy_(0, rows, k_new.permute(2, 0, 1, 3).to(k_cache.dtype))
    v_cache[layer].index_copy_(0, rows, v_new.permute(2, 0, 1, 3).to(v_cache.dtype))
    n = _window_of(pos, window, k_cache.shape[1], t)
    last = rows[:1]  # query 0's last slot
    slot = torch.arange(n, device=q.device)
    lk = k_cache[layer, :n].float()  # (n, B, H_kv, Dh)
    lv = torch.where((slot < last + t)[:, None, None, None], v_cache[layer, :n].float(), 0.0)
    if h_kv != h:
        lk = torch.repeat_interleave(lk, h // h_kv, dim=2)
        lv = torch.repeat_interleave(lv, h // h_kv, dim=2)
    s = torch.einsum("bhtd,sbhd->bhts", q.float(), lk) / math.sqrt(dh)
    valid = slot[None, None, None, :] <= (last + torch.arange(t, device=q.device))[None, None, :, None]
    if starts is not None:
        valid = valid & (slot[None, None, None, :] >= torch.minimum(starts, last)[:, None, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bhts,sbhd->bhtd", p, lv)
    return y.to(q.dtype), k_cache, v_cache


def decode_attention_multi(q, k_new, v_new, k_cache, v_cache, layer: int, pos, starts=None, *,
                           window: int | None = None):
    """T-query decode attention for one layer: ``(y (B, H, T, Dh), k_cache, v_cache)``.

    q: (B, H, T, Dh); k_new, v_new: (B, H_kv, T, Dh) with H_kv dividing H;
    caches: (L, S, B, H_kv, Dh), updated in place at rows ``[pos, pos+T)``
    of ``layer``; query t attends ``[starts[b], pos + t]``. T <= 16.

    ``pos`` may be a one-element int32 tensor on q's device, read by the
    kernel on the device, at T = 1 (a GQA decode step) and at T > 1 (the
    speculative verify of a round captured in a CUDA graph); the call is
    planned at the window bucket ``window`` (``[0, window)``, holding
    ``pos + T``; default: for an int ``pos`` :func:`attention_window` of
    ``pos + 1`` at T = 1 and ``[0, pos + T)`` at T > 1, the whole cache for
    a tensor), as :func:`decode_attention` plans K1: an int and a tensor
    ``pos`` in one window give the same bits. The caller keeps a tensor
    ``pos`` at or below ``window - T``; a split wholly past ``pos + T - 1``
    leaves an empty partial.

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
    _check(q, k_new, v_new, k_cache, v_cache, layer, pos, starts, window)
    device_pos = isinstance(pos, torch.Tensor)
    window = _window_of(pos, window, k_cache.shape[1], t)
    if q.device.type == "cpu":
        return decode_attention_multi_reference(q, k_new, v_new, k_cache, v_cache, layer, pos, starts, window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_multi runs on cuda or cpu, not {q.device}")
    _check_kernel_inputs("decode_attention_multi", (q, k_new, v_new, k_cache, v_cache))
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    h_kv = k_new.shape[1]
    split_len, n_splits = attention_plan(window, b * h_kv, t * (h // h_kv))
    part, tickets = _onepass_scratch(n_splits, b * h_kv, t * (h // h_kv), dh, q.device)
    y = torch.empty_like(q)
    err = _build.kernels().lib.mv_decode_attention_multi(
        _DTYPE_CODE[q.dtype],
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(),
        None if starts is None else starts.data_ptr(),
        b, h, h_kv, t, dh, k_cache.shape[1], layer, window - t if device_pos else pos,
        pos.data_ptr() if device_pos else None, split_len, n_splits,
        None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
        ATTN_TICKETS, y.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_multi kernel launch failed: cudaError_t {err}")
    decode_attention_multi.launches += 1
    return y, k_cache, v_cache


decode_attention_multi.launches = 0


# ------------------------------------------------------------------ K5: one int4 attention block

_CACHE_FORMAT_CODE = {"bf16": 0, "int8": 1, "packed": 2}


def _cache_format(k_cache, k_scale) -> str:
    """"bf16" (a float cache), "int8" or "packed" (int8 values four
    positions to an int32 word), as ``models/transformer.KVCache`` lays them out."""
    if k_scale is None:
        return "bf16"
    return "packed" if k_cache.dtype == torch.int32 else "int8"


def _quant_row(row):
    """The kernel's quantizer of the new row, per (row, kv head), from the
    f32 row (the JAX kernel's ``_quant_i32``): ``s = max(absmax, 1e-8) *
    f32(1/127)``, ``q = clip(round_half_even(row / s), -127, 127)`` ->
    (int32 values, (..., 1) f32 scales). It multiplies by 1/127 where the
    prefill path's ``quantize_kv_rows`` divides by 127, as in JAX."""
    s = torch.clamp(row.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    return torch.clamp(torch.round(row / s), -127, 127).to(torch.int32), s


def _packed_byte_mask(pos: int) -> int:
    """The int32 word mask that keeps every byte but byte pos % 4."""
    keep = ~(0xFF << (8 * (pos % 4))) & 0xFFFFFFFF
    return keep - (1 << 32) if keep >= 1 << 31 else keep


def decode_attention_block_int4_reference(
    xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache, layer: int, pos, n_head: int, *,
    n_kv_head: int | None = None, starts=None, k_scale=None, v_scale=None, window: int | None = None,
):
    """Plain PyTorch version of K5: the CPU path and the card's oracle.

    The JAX kernel's arithmetic (``_decode_block_int4_kernel``, with
    ``kv8_mode="bf16"``): ``qkv = xa @ Wqkv`` in f32 (the int4 group
    arithmetic of ``matmul_int4_i32_reference``); ``q = qkv[:, :D] *
    1/sqrt(Dh)``; the new K/V row written at (layer, pos), rounded to bf16
    for a float cache or quantized by ``_quant_row`` for an int8 one (the
    packed cache: byte pos % 4 of word pos // 4, the word's other bytes
    kept); attention of query head h over kv head h // (H / H_kv) on
    ``[starts[b], pos]`` (a start past ``pos`` taken as ``pos``), read back
    from the cache. A float cache: q and K/V in f32. An int8 cache: q rounded
    to bf16 against the integer values, the dot in f32 times the k scale,
    ``p = exp(s - max)``, ``l = sum p``, ``bf16(p * v_scale)`` against the
    integer values in f32. Then y rounded to bf16 and ``y @ Wo`` rounded to
    bf16 -> (y (B, D) bf16, k_cache, v_cache, k_scale, v_scale).

    ``pos`` is an int or a one-element int tensor on xa's device, read on
    the device; the sums run over the window ``[0, window)`` (default:
    :func:`attention_window` of an int ``pos``, the whole cache for a
    tensor) with the values and scales past ``pos`` zeroed first, so
    garbage (even NaN) there stays out and an int and a tensor ``pos`` in
    one window give the same bits.
    """
    b, d = xa.shape
    dh = d // n_head
    h_kv = n_kv_head or n_head
    g, dkv, bkv = n_head // h_kv, h_kv * dh, b * h_kv
    fmt = _cache_format(k_cache, k_scale)
    n = _window_of(pos, window, k_cache.shape[1] * (4 if fmt == "packed" else 1))
    p = _slot_tensor(pos, xa.device)
    slot = torch.arange(n, device=xa.device)
    live = slot <= p  # (n,)
    qkv = matmul_int4_i32_reference(xa, wqkv_pw[layer], wqkv_sc[layer])
    q = (qkv[:, :d] * (1.0 / math.sqrt(dh))).reshape(b, n_head, dh)
    rows = [qkv[:, d + i * dkv : d + (i + 1) * dkv].reshape(b, h_kv, dh) for i in range(2)]
    kv, scales = [], []
    for cache, table, row in ((k_cache, k_scale, rows[0]), (v_cache, v_scale, rows[1])):
        if fmt == "bf16":
            cache[layer].index_copy_(0, p, row[None].to(cache.dtype))
            kv.append(torch.where(live[:, None, None, None], cache[layer, :n].float(), 0.0))
            continue
        q8, sc = _quant_row(row)
        if fmt == "int8":
            cache[layer].index_copy_(0, p, q8[None].to(torch.int8))
            table[layer, :, 0, :bkv].index_copy_(0, p, sc.reshape(1, bkv))
            vals = cache[layer, :n].float()
            col = table[layer, :n, 0, :bkv]
        else:
            w, sh = p // 4, (8 * (p % 4)).to(torch.int32)
            word = cache[layer].index_select(0, w)
            keep = ~(torch.full_like(sh, 0xFF) << sh)
            cache[layer].index_copy_(0, w, (word & keep) | ((q8[None] & 0xFF) << sh))
            flat = table[layer].view(-1, *table.shape[3:])  # (4 * S/4, 1, BHpad): residue-major
            flat[:, 0, :bkv].index_copy_(0, (p % 4) * table.shape[2] + w, sc.reshape(1, bkv))
            nw = -(-n // 4)
            words = cache[layer, :nw]
            vals = torch.stack([(words << (24 - 8 * j)) >> 24 for j in range(4)], dim=1)
            vals = vals.reshape(4 * nw, b, h_kv, dh)[:n].float()
            col = table[layer, :, :nw, 0, :bkv].transpose(0, 1).reshape(4 * nw, bkv)[:n]
        kv.append(vals)
        scales.append(torch.where(live[:, None], col, 0.0))
    lk, lv = kv
    if g > 1:
        lk, lv = lk.repeat_interleave(g, dim=2), lv.repeat_interleave(g, dim=2)
        scales = [sc.reshape(n, b, h_kv).repeat_interleave(g, dim=2) for sc in scales]
    scales = [sc.reshape(n, b, n_head).permute(1, 2, 0) for sc in scales]  # (B, H, n)
    if fmt != "bf16":
        q = q.to(torch.bfloat16).float()
    s = torch.einsum("bhd,sbhd->bhs", q, lk)
    if fmt != "bf16":
        s = s * scales[0]
    valid = live[None, None, :]
    if starts is not None:
        valid = valid & (slot[None, None, :] >= torch.minimum(starts, p)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = pr.sum(dim=-1, keepdim=True)
    if fmt != "bf16":
        pr = (pr * scales[1]).to(torch.bfloat16).float()
    y = (torch.einsum("bhs,sbhd->bhd", pr, lv) / l).reshape(b, d).to(torch.bfloat16)
    out = matmul_int4_i32_reference(y, wo_pw[layer], wo_sc[layer]).to(torch.bfloat16)
    return out, k_cache, v_cache, k_scale, v_scale


def _check_block(xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache, layer, pos, n_head, h_kv,
                 starts, k_scale, v_scale, window):
    if xa.dim() != 2:
        raise ValueError(f"xa must be (B, D), got {tuple(xa.shape)}")
    b, d = xa.shape
    if d % n_head or n_head % h_kv:
        raise ValueError(f"D={d}, n_head={n_head}, n_kv_head={h_kv} do not divide")
    dh = d // n_head
    n_layer = k_cache.shape[0]
    qout = d + 2 * h_kv * dh
    for name, pw, sc, n in (("wqkv", wqkv_pw, wqkv_sc, qout), ("wo", wo_pw, wo_sc, d)):
        if tuple(pw.shape) != (n_layer, d // 8, n) or sc.dim() != 3 or sc.shape[0] != n_layer or sc.shape[2] != n:
            raise ValueError(f"{name}: pw {tuple(pw.shape)} / sc {tuple(sc.shape)} do not fit "
                             f"({n_layer}, {d // 8}, {n})")
    fmt = _cache_format(k_cache, k_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale go together")
    packed = fmt == "packed"
    seq_len = k_cache.shape[1] * (4 if packed else 1)
    if k_cache.dim() != 5 or k_cache.shape[2:] != (b, h_kv, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"caches must be (L, S{'/4' if packed else ''}, {b}, {h_kv}, {dh}), got "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    if fmt == "bf16" and not k_cache.dtype.is_floating_point:
        raise ValueError(f"a cache without scales is a float cache, got {k_cache.dtype}")
    if fmt != "bf16":
        want_dtype = torch.int32 if packed else torch.int8
        width = k_scale.shape[-1]
        lead = (n_layer, 4, seq_len // 4, 1) if packed else (n_layer, seq_len, 1)
        if (k_cache.dtype != want_dtype or v_cache.dtype != want_dtype or k_scale.shape != v_scale.shape
                or tuple(k_scale.shape[:-1]) != lead or width % 128 or width < b * h_kv
                or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32):
            raise ValueError(f"an {fmt} cache takes {want_dtype} values and f32 scales {lead + ('BHpad',)}, "
                             f"got {k_cache.dtype} and {tuple(k_scale.shape)} {k_scale.dtype}")
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} outside the cache's {n_layer} layers")
    window = _check_slot(pos, window, seq_len, xa.device, "decode_attention_block_int4")
    tensors = [xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache]
    tensors += [t for t in (starts, k_scale, v_scale) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {sorted({str(t.device) for t in tensors})}")
    if starts is not None and tuple(starts.shape) != (b,):
        raise ValueError(f"starts must be ({b},), got {tuple(starts.shape)}")
    return fmt, seq_len, window


def decode_attention_block_int4(
    xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache, layer: int, pos, n_head: int, *,
    n_kv_head: int | None = None, starts=None, k_scale=None, v_scale=None, window: int | None = None,
):
    """One decode layer's int4 attention block (K5): ``(y (B, D) bf16,
    k_cache, v_cache, k_scale, v_scale)``, the JAX package's return.

    xa: (B, D) normed input; ``wqkv_pw`` (L, D/8, D + 2*H_kv*Dh) and
    ``wo_pw`` (L, D/8, D) int32 with their ``sc`` (L, 2*Gp, N), stacked over
    layers; the cache in one of three formats (``models/transformer.KVCache``):
    float (L, S, B, H_kv, Dh) with no scales, int8 with ``k_scale``/
    ``v_scale`` (L, S, 1, BHpad), or packed int32 (L, S/4, B, H_kv, Dh) with
    residue-split scales (L, 4, S/4, 1, BHpad); updated IN PLACE at (layer,
    pos). ``layer`` is an int; ``pos`` an int, or a one-element int32
    tensor on xa's device that the kernel reads on the device; ``starts``
    optional (B,) first valid slot per batch row. The attention is planned
    at the window bucket ``window`` (``[0, window)``, holding ``pos``;
    default :func:`attention_window` of an int ``pos``, the whole cache for
    a tensor): a split wholly past ``pos`` reads and writes nothing, so one
    call captured in a CUDA graph serves every slot of the bucket, and an
    int and a tensor ``pos`` in one window give the same bits.

    A CUDA tensor launches the hand-written kernel
    (``csrc/decode_block_int4.cu``: a float cache in bf16 or either int8
    format, head_dim 128, 1..8 rows, D a multiple of 1024) or raises; a CPU
    tensor takes
    :func:`decode_attention_block_int4_reference`.
    ``decode_attention_block_int4.launches`` counts kernel launches.
    """
    h_kv = n_kv_head or n_head
    fmt, seq_len, window = _check_block(xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache, layer, pos, n_head,
                                        h_kv, starts, k_scale, v_scale, window)
    args = (xa, wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache, layer, pos, n_head)
    kw = dict(n_kv_head=h_kv, starts=starts, k_scale=k_scale, v_scale=v_scale, window=window)
    if xa.device.type == "cpu":
        return decode_attention_block_int4_reference(*args, **kw)
    if xa.device.type != "cuda":
        raise ValueError(f"decode_attention_block_int4 runs on cuda or cpu, not {xa.device}")
    b, d = xa.shape
    dh = d // n_head
    if dh != 128 or not 1 <= b <= DECODE_MAX_ROWS or d % 1024:
        raise ValueError(f"the kernel takes head_dim 128, 1..{DECODE_MAX_ROWS} rows and D a multiple of 1024; "
                         f"got {dh}, {b}, {d}")
    if fmt == "bf16" and k_cache.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes a bf16 float cache, got {k_cache.dtype}")
    for pw, sc in ((wqkv_pw, wqkv_sc), (wo_pw, wo_sc)):
        if pw.dtype != torch.int32 or sc.dtype != torch.bfloat16:
            raise ValueError(f"packed weights must be int32 pw and bf16 sc, got {pw.dtype}, {sc.dtype}")
    if wo_sc.shape[1] != wqkv_sc.shape[1] or wqkv_sc.shape[1] < 2 * (d // 128):
        raise ValueError(f"wqkv_sc and wo_sc must have the same 2*Gp >= {2 * (d // 128)} rows")
    tensors = [wqkv_pw, wqkv_sc, wo_pw, wo_sc, k_cache, v_cache] + [t for t in (k_scale, v_scale) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention_block_int4 needs contiguous weights, caches and scales")
    dev = xa.device
    x = xa.to(torch.bfloat16).contiguous()
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    qout = wqkv_pw.shape[2]
    device_pos = isinstance(pos, torch.Tensor)
    plan = block_plan(fmt, b, d, n_head, h_kv, window - 1)
    qkv, ya, part, attn_part, tickets, attn_tickets = _block_scratch(plan, b, d, qout, b * n_head, dev,
                                                                     "decode_attention_block_int4")
    plans = (ctypes.c_int * 6)(*plan.qkv, *plan.o)
    y = torch.empty((b, d), dtype=torch.bfloat16, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.kernels().lib.mv_decode_block_int4(
        _CACHE_FORMAT_CODE[fmt], x.data_ptr(), wqkv_pw.data_ptr(), wqkv_sc.data_ptr(), wo_pw.data_ptr(),
        wo_sc.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale), ptr(v_scale), ptr(starts),
        y.data_ptr(), layer, 0 if device_pos else pos, ptr(pos) if device_pos else None, window, b, d, n_head, h_kv,
        dh, seq_len,
        0 if k_scale is None else k_scale.shape[-1], wqkv_sc.shape[1] // 2, ctypes.addressof(plans), *plan.attn,
        qkv.data_ptr(), ya.data_ptr(), part.data_ptr(), part.numel(), tickets.data_ptr(), DS.STACK_TICKETS,
        ptr(attn_part), attn_tickets.data_ptr(), ATTN_TICKETS, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_block_int4 kernel launch failed: cudaError_t {err}")
    decode_attention_block_int4.launches += 1
    return y, k_cache, v_cache, k_scale, v_scale


decode_attention_block_int4.launches = 0


# ------------------------------------------------------------------ K9: one plain-int8 attention block

def decode_attention_block_int8_reference(xa, wqkv_q, wqkv_s, wo_q, wo_s, k_cache, v_cache, layer: int, pos,
                                          n_head: int, starts=None, window: int | None = None):
    """Plain PyTorch version of K9: the CPU path and the card's oracle.

    The TPU kernel's arithmetic (``_decode_block_kernel``): ``qkv = xa @
    Wqkv * s`` in f32 (x rounded to bf16, as in K11); ``q = qkv[:, :D] *
    1/sqrt(Dh)`` in f32; the new K/V row written in the cache's dtype at
    (layer, pos); f32 attention of every head over ``[starts[b], pos]`` (a
    start past ``pos`` taken as ``pos``), read back from the cache; y rounded
    to bf16; ``y @ Wo * s`` rounded to bf16 -> (y (B, D) bf16, k_cache,
    v_cache). ``pos`` is an int or a one-element int tensor on xa's device,
    read on the device; the sums run over the window ``[0, window)``
    (default: :func:`attention_window` of an int ``pos``, the whole cache
    for a tensor) with the values past ``pos`` zeroed first, so garbage
    (even NaN) there stays out (the TPU kernel reads whole chunks and lets
    it through 0 * NaN) and an int and a tensor ``pos`` in one window give
    the same bits."""
    b, d = xa.shape
    dh = d // n_head
    n = _window_of(pos, window, k_cache.shape[1])
    p = _slot_tensor(pos, xa.device)
    slot = torch.arange(n, device=xa.device)
    live = slot <= p
    qkv = int8_dot(xa, wqkv_q, wqkv_s)
    q = (qkv[:, :d] * (1.0 / math.sqrt(dh))).reshape(b, n_head, dh)
    for i, cache in enumerate((k_cache, v_cache)):
        row = qkv[None, :, (i + 1) * d : (i + 2) * d].reshape(1, b, n_head, dh)
        cache[layer].index_copy_(0, p, row.to(cache.dtype))
    s = torch.einsum("bhd,sbhd->bhs", q, k_cache[layer, :n].float())
    valid = live[None, None, :]
    if starts is not None:
        valid = valid & (slot[None, None, :] >= torch.minimum(starts, p)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lv = torch.where(live[:, None, None, None], v_cache[layer, :n].float(), 0.0)
    y = torch.einsum("bhs,sbhd->bhd", pr, lv) / pr.sum(dim=-1, keepdim=True)
    out = int8_dot(y.reshape(b, d).to(torch.bfloat16), wo_q, wo_s).to(torch.bfloat16)
    return out, k_cache, v_cache


def decode_attention_block_int8(xa, wqkv_q, wqkv_s, wo_q, wo_s, k_cache, v_cache, layer: int, pos,
                                n_head: int, starts=None, *, window: int | None = None):
    """One decode layer's plain-int8 attention block (K9): ``(y (B, D) bf16,
    k_cache, v_cache)``, the JAX package's return.

    xa: (B, D) normed input; this layer's ``wqkv_q`` (D, 3D) and ``wo_q``
    (D, D) int8 with their (N,) f32 scales; the float caches (L, S, B, H,
    Dh), MHA, updated IN PLACE at (layer, pos). ``layer`` is an int;
    ``pos`` and ``window`` as for :func:`decode_attention_block_int4` (an
    int or a one-element int32 tensor read on the device, planned at the
    window bucket); ``starts`` optional (B,) first valid slot per batch row.

    A CUDA tensor launches the hand-written kernel
    (``csrc/decode_block_int8.cu``: a bf16 cache, head_dim 128, 1..8 rows) or
    raises; a CPU tensor takes :func:`decode_attention_block_int8_reference`.
    ``decode_attention_block_int8.launches`` counts kernel launches.
    """
    if xa.dim() != 2:
        raise ValueError(f"xa must be (B, D), got {tuple(xa.shape)}")
    b, d = xa.shape
    if d % n_head:
        raise ValueError(f"D={d} is not a multiple of n_head={n_head}")
    dh = d // n_head
    for name, q, sc, n in (("wqkv", wqkv_q, wqkv_s, 3 * d), ("wo", wo_q, wo_s, d)):
        if tuple(q.shape) != (d, n) or tuple(sc.shape) != (n,):
            raise ValueError(f"{name}: q {tuple(q.shape)} / scales {tuple(sc.shape)} do not fit ({d}, {n})")
    if (k_cache.dim() != 5 or k_cache.shape[2:] != (b, n_head, dh) or v_cache.shape != k_cache.shape
            or not k_cache.dtype.is_floating_point or v_cache.dtype != k_cache.dtype):
        raise ValueError(f"caches must be float (L, S, {b}, {n_head}, {dh}), got {tuple(k_cache.shape)} "
                         f"{k_cache.dtype}, {tuple(v_cache.shape)} {v_cache.dtype}")
    n_layer, seq_len = k_cache.shape[:2]
    if not 0 <= layer < n_layer:
        raise ValueError(f"layer {layer} outside the cache's {n_layer} layers")
    window = _check_slot(pos, window, seq_len, xa.device, "decode_attention_block_int8")
    tensors = [xa, wqkv_q, wqkv_s, wo_q, wo_s, k_cache, v_cache] + ([] if starts is None else [starts])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {sorted({str(t.device) for t in tensors})}")
    if starts is not None and tuple(starts.shape) != (b,):
        raise ValueError(f"starts must be ({b},), got {tuple(starts.shape)}")
    args = (xa, wqkv_q, wqkv_s, wo_q, wo_s, k_cache, v_cache, layer, pos, n_head)
    if xa.device.type == "cpu":
        return decode_attention_block_int8_reference(*args, starts=starts, window=window)
    if xa.device.type != "cuda":
        raise ValueError(f"decode_attention_block_int8 runs on cuda or cpu, not {xa.device}")
    if dh != 128 or not 1 <= b <= DECODE_MAX_ROWS or k_cache.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes head_dim 128, 1..{DECODE_MAX_ROWS} rows and a bf16 cache; "
                         f"got {dh}, {b}, {k_cache.dtype}")
    if wqkv_q.dtype != torch.int8 or wo_q.dtype != torch.int8 or wqkv_s.dtype != torch.float32 \
            or wo_s.dtype != torch.float32:
        raise ValueError("plain int8 weights must be int8 q with f32 scales")
    if not all(t.is_contiguous() for t in tensors[1:7]):
        raise ValueError("decode_attention_block_int8 needs contiguous weights, scales and caches")
    dev = xa.device
    x = xa.to(torch.bfloat16).contiguous()
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    device_pos = isinstance(pos, torch.Tensor)
    plan = block_plan("int8_plain", b, d, n_head, n_head, window - 1)
    qkv, ya, part, attn_part, tickets, attn_tickets = _block_scratch(plan, b, d, 3 * d, b * n_head, dev,
                                                                     "decode_attention_block_int8")
    plans = (ctypes.c_int * 6)(*plan.qkv, *plan.o)
    y = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    err = _build.kernels().lib.mv_decode_block_int8(
        x.data_ptr(), wqkv_q.data_ptr(), wqkv_s.data_ptr(), wo_q.data_ptr(), wo_s.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), None if starts is None else starts.data_ptr(), y.data_ptr(),
        layer, 0 if device_pos else pos, pos.data_ptr() if device_pos else None, window, b, d, n_head, seq_len,
        ctypes.addressof(plans), *plan.attn,
        qkv.data_ptr(), ya.data_ptr(), part.data_ptr(), part.numel(), tickets.data_ptr(), DS.STACK_TICKETS,
        None if attn_part is None else attn_part.data_ptr(), attn_tickets.data_ptr(), ATTN_TICKETS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_block_int8 kernel launch failed: cudaError_t {err}")
    decode_attention_block_int8.launches += 1
    return y, k_cache, v_cache


decode_attention_block_int8.launches = 0
