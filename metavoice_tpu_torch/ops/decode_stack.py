"""One decode step through every layer with weights in int32 words: the
CUDA kernels' wrapper and its plain PyTorch version. int4 words
(``wfmt="i4"``) are K3, int8 words (``wfmt="i8"``) K7.

Replaces ``metavoice_tpu/ops/decode_stack.py:decode_stack_int4`` (the Pallas
TPU kernel ``_decode_stack_kernel``, both word formats). The kernels are
``metavoice_tpu_torch/csrc/decode_stack_int4.cu``: one C entry per format
and step launches six chained kernels a layer (and the head's) on the
current stream, the products on the tensor cores
(``csrc/decode_stack_gemv.cuh``); its header says what bounds it on the card
(the packed weight bytes) and how its design follows that bound. The
wrapper owns the cut of each product's K (:func:`stack_gemv_plan`), the
step's scratch and the device's merge counters, which the first eager call
makes (``ops/quantized.merge_tickets``: a CUDA-graph capture that would make
them raises, so warm the wrapper eagerly before capturing a step). The
counters are per device and the scratch per shape, so two steps of one
device must not run at once (on two streams, or two replays of graphs of
one shape): they would race on the counters and give wrong output.

Semantics, per layer, for x (B, D) bf16: RMSNorm (f32, rounded to bf16, then
times the bf16 weight); the qkv projection in f32 (the arithmetic of
:func:`~metavoice_tpu_torch.ops.quantized.matmul_int4_i32_reference`, or of
:func:`~metavoice_tpu_torch.ops.quantized.matmul_int8_i32_reference` for
int8); q * 1/sqrt(Dh) in f32; the k/v rows rounded to bf16 and written
into the cache at (layer, pos) BEFORE the window is read; f32 softmax over
``[starts[b], pos]`` (a start past ``pos`` is taken as ``pos``; query head h
reads kv head ``h // (H / H_kv)``), rounded to bf16; the int4 o-proj rounded
to bf16 and a bf16 residual add; RMSNorm; w1/w3 with ``silu(h1) * h3`` in
f32 rounded to bf16; w2 rounded to bf16 and a bf16 residual add. After the
last layer, int4 only, with ``ln_f_w``/``head_pw``/``head_sc``: RMSNorm and
the int4 tied head -> (B, Vp) f32 logits (the JAX package passes no head
with int8 words).

Both functions update the caches IN PLACE and return them, so callers
written against the JAX signature keep working. Only slots ``[0, pos]`` enter
the result, so garbage (even NaN) beyond ``pos`` never reaches it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.ops.quantized import (
    CARD_SMS,
    DECODE_MAX_ROWS,
    I32_GROUPSIZE,
    matmul_int4_i32_reference,
    matmul_int8_i32_reference,
    merge_tickets,
)

SPLIT_POSITIONS = 64  # cache slots per block of the attention's sequence split
MAX_SPLITS = 32
HEAD_DIM = 128  # the kernel's head width
MAX_BATCH = DECODE_MAX_ROWS
VALUES_PER_WORD = {"i4": 8, "i8": 4}
# The products' tensor-core GEMV (csrc/decode_stack_gemv.cuh) and its plan:
STACK_STEP_ROWS = 16  # word rows a k-step (the mma's depth)
STACK_TILE_N = 32  # output columns a block (the kernel's kSgCols)
STACK_CLUSTER = 2  # column tiles a thread-block cluster, which share the x slice's loads (kSgCluster)
STACK_WARPS = 4  # warps a block (the kernel's kSgWarps)
# k-steps a warp takes, the fewer first: int4 in one batch (2 were 4% slower on the H100), int8 in one or
# two rounds of its ring; plain int8 (vpw 1: K rows of (K, N) bytes, 512 bytes a warp's k-step) in two rounds
# of its ring of 8 (K9 on an NVIDIA H100 80GB HBM3 at 700 W: 6% / 2% faster at pos 255 / 2047 than 8 steps,
# 3% / 4% than 32)
STACK_WARP_STEPS = {8: (4,), 4: (4, 8), 1: (16,)}
STACK_RESIDENT_BLOCKS = CARD_SMS * 3  # blocks of the product the card holds at once (the kernel's kSgMinBlocks)
STACK_X_BYTES = 36 * 1024  # a block's x slice and norm weights' slice in shared memory, at most (kSgXBytes)
STACK_I4_GROUP_STEPS = 8  # int4: k-steps a 128-row group; a split holds whole groups
STACK_I4_MAX_SPLIT_STEPS = 32  # int4: at most 4 groups a split (the kernel's kSgMaxCGroups)
STACK_TICKETS = 1024  # merge counters a device: the widest product's N / 32 at most
_stack_tickets: dict = {}  # device index -> (STACK_TICKETS,) int32, all 0 between steps

_scratch: dict[tuple, dict] = {}


def stack_x_bytes(vpw: int, b: int, split_steps: int) -> int:
    """Shared-memory bytes of a block's x slice and norm weights' slice (the
    kernel's sg_x_bytes): vpw slabs x (b + 1) rows, each padded to a
    multiple of 64 bf16 plus 16 so that the B-fragment reads fall in
    distinct banks."""
    return vpw * (b + 1) * (-(-split_steps * STACK_STEP_ROWS // 64) * 64 + 16) * 2


def stack_gemv_plan(k: int, n: int, vpw: int, b: int, n_mats: int = 1) -> tuple[int, int, int]:
    """The cut of one tensor-core GEMV product, (b, k) @ (k, n) words of
    ``vpw`` values (``n_mats`` matrices side by side: w1 and w3; vpw 1: plain
    int8 bytes, K9's), into splits of K's ``k / vpw / STACK_STEP_ROWS``
    k-steps -> (split_steps, n_splits, warps).
    Split i holds steps ``[i * split_steps, (i + 1) * split_steps)``, the
    last ends at or past the last step and none lies wholly past it; a block
    of ``warps`` (``STACK_WARPS``) warps takes one split of a
    ``STACK_TILE_N``-column tile, each warp ``ceil(split_steps / warps)``
    steps of it in a row.

    A warp takes the fewest steps of ``STACK_WARP_STEPS[vpw]`` whose grid
    the card holds at once (``STACK_RESIDENT_BLOCKS``), else the most: every
    word of the product is then requested at once, much of it before the
    kernel before has finished (the first batch goes out before the
    programmatic wait), and more, shorter warps spread the stream over more
    SMs (an SM pulls only so many bytes at a time), at the price of a merge
    when K takes more than one split. int4 K is cut at whole 128-row groups
    (8 k-steps), so that a block sums its groups' x for the c terms from
    its own slice, at most four groups a split; a split shrinks where a
    block's slices would not fit ``STACK_X_BYTES``."""
    steps = k // vpw // STACK_STEP_ROWS
    warps = STACK_WARPS
    unit = STACK_I4_GROUP_STEPS if vpw == 8 else warps
    for warp_steps in STACK_WARP_STEPS[vpw]:
        split_steps = min(-(-steps // unit) * unit, warps * warp_steps)
        while split_steps > unit and (stack_x_bytes(vpw, b, split_steps) > STACK_X_BYTES
                                      or vpw == 8 and split_steps > STACK_I4_MAX_SPLIT_STEPS):
            split_steps -= unit
        n_splits = -(-steps // split_steps)
        if n // STACK_TILE_N * n_mats * n_splits <= STACK_RESIDENT_BLOCKS:
            break
    return split_steps, n_splits, warps


def ffn_plan(vpw: int, b: int, d: int, ip: int) -> tuple[tuple[int, int, int], tuple[int, int, int], int]:
    """The cut of one per-layer FFN call, K6 (int4 words, vpw 8) or K10
    (plain int8, vpw 1), on rows (b, d): the w1/w3 product (b, d) @ (d, ip)
    twice side by side and the w2 product (b, ip) @ (ip, d), each as
    :func:`stack_gemv_plan` cuts it -> (w1/w3 plan, w2 plan, f32 partials
    the call needs: ``mats x splits x b x (N + 1)`` of the larger, w2's
    only where it has more than one split)."""
    w13 = stack_gemv_plan(d, ip, vpw, b, n_mats=2)
    w2 = stack_gemv_plan(ip, d, vpw, b)
    part = max(2 * w13[1] * b * (ip + 1), w2[1] * b * (d + 1) if w2[1] > 1 else 0)
    return w13, w2, part


def stack_plans(b: int, d: int, qout: int, ip: int, vp: int, vpw: int) -> list[tuple[int, int, int]]:
    """The plans of a step's five products: qkv, o-proj, w1/w3, w2 and the
    head (vp 0: no head, its plan unused)."""
    head = stack_gemv_plan(d, vp, vpw, b) if vp else (1, 1, 1)
    return [stack_gemv_plan(d, qout, vpw, b), stack_gemv_plan(d, d, vpw, b),
            stack_gemv_plan(d, ip, vpw, b, n_mats=2), stack_gemv_plan(ip, d, vpw, b), head]


def _rmsnorm(x, w, eps: float):
    """f32 RMSNorm, rounded to bf16, THEN times the bf16 weight."""
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return nrm.to(torch.bfloat16) * w.to(torch.bfloat16)


def _attend(q, k_cache, v_cache, layer: int, pos, starts, n_kv_head: int):
    """q (B, H, Dh) f32, already scaled -> (B, H*Dh) bf16 over [starts, pos].
    ``pos`` (1,) int64 on q's device: the sums run over the whole cache, as
    the kernel's plan does, and the values past ``pos`` are zeroed first."""
    b, h, dh = q.shape
    slot = torch.arange(k_cache.shape[1], device=q.device)
    live = slot <= pos
    lk = k_cache[layer].float()  # (S, B, H_kv, Dh)
    lv = torch.where(live[:, None, None, None], v_cache[layer].float(), 0.0)
    if n_kv_head != h:
        lk = lk.repeat_interleave(h // n_kv_head, dim=2)
        lv = lv.repeat_interleave(h // n_kv_head, dim=2)
    s = torch.einsum("bhd,sbhd->bhs", q, lk)
    valid = live[None, None, :]
    if starts is not None:
        valid = valid & (slot[None, None, :] >= torch.minimum(starts, pos)[:, None, None])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,sbhd->bhd", p, lv).reshape(b, h * dh).to(torch.bfloat16)


def decode_stack_int4_reference(
    x, norm1_w, norm2_w, wqkv_pw, wqkv_sc, wo_pw, wo_sc, w1_pw, w1_sc, w3_pw, w3_sc,
    w2_pw, w2_sc, k_cache, v_cache, pos, n_head: int, *, n_kv_head: int | None = None,
    starts=None, norm_eps: float = 1e-5, ln_f_w=None, head_pw=None, head_sc=None,
    groupsize: int = I32_GROUPSIZE, wfmt: str = "i4",
):
    """Plain PyTorch version of the K3 and K7 kernels: the CPU path and the
    card's oracle. Loops over the layers as the kernels do; same arguments
    and returns as :func:`decode_stack_int4`. ``pos`` is read on the
    device as the kernels read it: an int and a tensor give the same bits."""
    b, d = x.shape
    dh = d // n_head
    n_kv_head = n_kv_head or n_head
    dkv = n_kv_head * dh
    if isinstance(pos, torch.Tensor):
        pos = pos.reshape(1).to(device=x.device, dtype=torch.int64)
    else:
        pos = torch.full((1,), int(pos), dtype=torch.int64, device=x.device)

    def mm(a, pw, sc):
        if wfmt == "i8":
            return matmul_int8_i32_reference(a, pw, sc)
        return matmul_int4_i32_reference(a, pw, sc, groupsize)

    x = x.to(torch.bfloat16)
    for li in range(k_cache.shape[0]):
        qkv = mm(_rmsnorm(x, norm1_w[li], norm_eps), wqkv_pw[li], wqkv_sc[li])
        q = (qkv[:, :d] * (1.0 / math.sqrt(dh))).reshape(b, n_head, dh)
        for i, cache in enumerate((k_cache, v_cache)):
            row = qkv[:, d + i * dkv : d + (i + 1) * dkv].reshape(1, b, n_kv_head, dh)
            cache[li].index_copy_(0, pos, row.to(cache.dtype))
        ya = _attend(q, k_cache, v_cache, li, pos, starts, n_kv_head)
        x = x + mm(ya, wo_pw[li], wo_sc[li]).to(torch.bfloat16)
        hn = _rmsnorm(x, norm2_w[li], norm_eps)
        hh = (F.silu(mm(hn, w1_pw[li], w1_sc[li])) * mm(hn, w3_pw[li], w3_sc[li])).to(torch.bfloat16)
        x = x + mm(hh, w2_pw[li], w2_sc[li]).to(torch.bfloat16)
    if head_pw is None:
        return x, k_cache, v_cache
    return x, k_cache, v_cache, mm(_rmsnorm(x, ln_f_w, norm_eps), head_pw, head_sc)


def _check(x, norm1_w, norm2_w, mats, k_cache, v_cache, n_head, n_kv_head, starts, head, wfmt):
    if wfmt not in VALUES_PER_WORD:
        raise ValueError(f"wfmt must be one of {sorted(VALUES_PER_WORD)}, got {wfmt!r}")
    vpw = VALUES_PER_WORD[wfmt]
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got {tuple(x.shape)}")
    b, d = x.shape
    if d % n_head or n_head % n_kv_head:
        raise ValueError(f"D={d}, n_head={n_head}, n_kv_head={n_kv_head} do not divide")
    dh = d // n_head
    (wqkv_pw, _), (wo_pw, _), (w1_pw, _), (w3_pw, _), (w2_pw, _) = mats
    n_layer = k_cache.shape[0]
    ip = w1_pw.shape[2]
    want = {
        "wqkv": (n_layer, d // vpw, d + 2 * n_kv_head * dh), "wo": (n_layer, d // vpw, d),
        "w1": (n_layer, d // vpw, ip), "w3": (n_layer, d // vpw, ip), "w2": (n_layer, ip // vpw, d),
    }
    for (name, shape), (pw, sc) in zip(want.items(), mats):
        if tuple(pw.shape) != shape or sc.dim() != 3 or sc.shape[0] != n_layer or sc.shape[2] != shape[2]:
            raise ValueError(f"{name}: pw {tuple(pw.shape)} / sc {tuple(sc.shape)} do not fit {shape}")
    if norm1_w.shape != (n_layer, d) or norm2_w.shape != (n_layer, d):
        raise ValueError(f"norm weights must be ({n_layer}, {d})")
    if k_cache.dim() != 5 or k_cache.shape[2:] != (b, n_kv_head, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"caches must be (L, S, {b}, {n_kv_head}, {dh}), got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}"
        )
    if starts is not None and tuple(starts.shape) != (b,):
        raise ValueError(f"starts must be ({b},), got {tuple(starts.shape)}")
    ln_f_w, head_pw, head_sc = head
    if (head_pw is None) != (head_sc is None) or (head_pw is None) != (ln_f_w is None):
        raise ValueError("ln_f_w, head_pw and head_sc go together")
    if head_pw is not None and wfmt != "i4":
        raise ValueError("only int4 words have a fused head; the int8 stack takes none")
    if head_pw is not None and (head_pw.shape[0] * 8 != d or head_sc.shape[1] != head_pw.shape[1]):
        raise ValueError(f"head pw {tuple(head_pw.shape)} / sc {tuple(head_sc.shape)} do not fit D={d}")
    tensors = [x, norm1_w, norm2_w, k_cache, v_cache, *[t for m in mats for t in m]]
    tensors += [t for t in (starts, *head) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"all tensors must share one device, got {sorted({str(t.device) for t in tensors})}")


def _scratch_for(dev, b, d, qout, ip, vp, n_rows, n_splits, vpw):
    """The step's scratch and plans, made once for a shape and device: f32
    qkv, bf16 attention output and SwiGLU hidden, the products' split
    partials (as many as the largest plan needs, and beside them int8's
    per-split sums of x), the residual's sums of squares by 32-column tile,
    the attention's partials, and the plans as the C entry reads them."""
    key = (dev, b, d, qout, ip, vp, n_rows, n_splits, vpw)
    if key not in _scratch:
        plans = stack_plans(b, d, qout, ip, vp, vpw)
        widths = (qout, d, ip, d, vp)
        mats = (1, 1, 2, 1, 1)
        part = max(m * p[1] * b * (n + 1) for m, p, n in zip(mats, plans, widths))  # + int8's sums of x
        f32, bf16 = torch.float32, torch.bfloat16
        _scratch[key] = {
            "qkv": torch.empty((b, qout), dtype=f32, device=dev),
            "ya": torch.empty((b, d), dtype=bf16, device=dev),
            "h": torch.empty((b, ip), dtype=bf16, device=dev),
            "part": torch.empty((part,), dtype=f32, device=dev),
            "ssq": torch.empty((d // STACK_TILE_N * b,), dtype=f32, device=dev),
            "part_ml": torch.empty((n_rows * n_splits * 2,), dtype=f32, device=dev),
            "part_acc": torch.empty((n_rows * n_splits * HEAD_DIM,), dtype=f32, device=dev),
            "plans": (ctypes.c_int * 15)(*[v for p in plans for v in p]),
        }
    return _scratch[key]


def decode_stack_int4(
    x, norm1_w, norm2_w, wqkv_pw, wqkv_sc, wo_pw, wo_sc, w1_pw, w1_sc, w3_pw, w3_sc,
    w2_pw, w2_sc, k_cache, v_cache, pos, n_head: int, *, n_kv_head: int | None = None,
    starts=None, norm_eps: float = 1e-5, ln_f_w=None, head_pw=None, head_sc=None,
    groupsize: int = I32_GROUPSIZE, wfmt: str = "i4",
):
    """All layers of one T=1 decode step: K3 (``wfmt="i4"``) or K7 (``"i8"``).

    x: (B, D) residual stream (not normed); norm weights (L, D); packed
    weights stacked over layers: int4 ``pw`` (L, K/8, N) int32 and ``sc``
    (L, 2*Gp, N) bf16, or int8 ``p8`` (L, K/4, N) int32 and ``sc8``
    (L, 16, N) bf16 (s at row 0, c at row 8); caches (L, S, B, H_kv, Dh),
    updated in place at (layer, pos); ``pos`` an int or a 0-d int32 tensor
    on x's device (the kernel reads it on the device); ``starts`` optional
    (B,) first valid slot.

    Returns ``(x_out (B, D) bf16, k_cache, v_cache)``, and ``logits
    (B, Vp) f32`` fourth when ``ln_f_w``/``head_pw``/``head_sc`` are given
    (int4 only). A CUDA tensor launches the hand-written kernel or raises; a
    CPU tensor takes :func:`decode_stack_int4_reference`.
    ``decode_stack_int4.launches`` counts K3 launches and
    ``decode_stack_int4.launches_i8`` K7 launches (one per step).
    """
    n_kv_head = n_kv_head or n_head
    mats = ((wqkv_pw, wqkv_sc), (wo_pw, wo_sc), (w1_pw, w1_sc), (w3_pw, w3_sc), (w2_pw, w2_sc))
    head = (ln_f_w, head_pw, head_sc)
    _check(x, norm1_w, norm2_w, mats, k_cache, v_cache, n_head, n_kv_head, starts, head, wfmt)
    args = (x, norm1_w, norm2_w, *[t for m in mats for t in m], k_cache, v_cache, pos, n_head)
    kw = dict(n_kv_head=n_kv_head, starts=starts, norm_eps=norm_eps, ln_f_w=ln_f_w,
              head_pw=head_pw, head_sc=head_sc, groupsize=groupsize, wfmt=wfmt)
    if x.device.type == "cpu":
        return decode_stack_int4_reference(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"decode_stack_int4 runs on cuda or cpu, not {x.device}")

    b, d = x.shape
    n_layer, seq_len = k_cache.shape[:2]
    dh = d // n_head
    ip = w1_pw.shape[2]
    qout = wqkv_pw.shape[2]
    if dh != HEAD_DIM or not 1 <= b <= MAX_BATCH or (wfmt == "i4" and groupsize != I32_GROUPSIZE):
        raise ValueError(f"the kernel takes head_dim {HEAD_DIM}, 1..{MAX_BATCH} rows, groupsize 128; "
                         f"got {dh}, {b}, {groupsize}")
    if d % 1024 or ip % 1024:
        raise ValueError(f"the kernel takes D and Ip multiples of 1024, got {d}, {ip}")
    if k_cache.dtype != torch.bfloat16 or v_cache.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes a bf16 cache, got {k_cache.dtype}")
    for pw, sc in mats + (((head_pw, head_sc),) if head_pw is not None else ()):
        if pw.dtype != torch.int32 or sc.dtype != torch.bfloat16:
            raise ValueError(f"packed weights must be int32 pw and bf16 sc, got {pw.dtype}, {sc.dtype}")
    gp, gp2 = wqkv_sc.shape[-2] // 2, w2_sc.shape[-2] // 2  # int8: c at row gp, not K/128
    if any(sc.shape[-2] != 2 * gp for sc in (wo_sc, w1_sc, w3_sc)) or (
        head_sc is not None and head_sc.shape[0] != 2 * gp
    ):
        raise ValueError("every D-contraction sc must have the same 2*Gp rows")
    vp = 0 if head_pw is None else head_pw.shape[1]
    if vp % 128:
        raise ValueError(f"the kernel takes a head width that is a multiple of 128, got {vp}")
    tensors = [x, k_cache, v_cache, *[t for m in mats for t in m]]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_stack_int4 needs contiguous x, caches and packed weights")
    dev = x.device
    n_splits = min(-(-seq_len // SPLIT_POSITIONS), MAX_SPLITS)
    split_len = -(-seq_len // n_splits)
    s = _scratch_for(dev, b, d, qout, ip, vp, b * n_head, n_splits, VALUES_PER_WORD[wfmt])
    if isinstance(pos, torch.Tensor):
        pos_t = pos.reshape(1).to(device=dev, dtype=torch.int32)
    else:
        pos_t = torch.full((1,), int(pos), dtype=torch.int32, device=dev)
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    x_out = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    x_in = x.to(torch.bfloat16).contiguous()
    n1 = norm1_w.to(torch.bfloat16).contiguous()
    n2 = norm2_w.to(torch.bfloat16).contiguous()
    lnf = logits = None
    if head_pw is not None:
        lnf = ln_f_w.to(torch.bfloat16).contiguous()
        logits = torch.empty((b, vp), dtype=torch.float32, device=dev)
        head_pw, head_sc = head_pw.contiguous(), head_sc.contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    if max(qout, ip, d, vp) // STACK_TILE_N > STACK_TICKETS:
        raise ValueError(f"{max(qout, ip, d, vp) // STACK_TILE_N} column tiles exceed the {STACK_TICKETS} "
                         "merge counters")
    tickets = merge_tickets(_stack_tickets, STACK_TICKETS, dev, "decode_stack_int4")
    lead = (x_in.data_ptr(), x_out.data_ptr(), n1.data_ptr(), n2.data_ptr(),
            *[t.data_ptr() for m in mats for t in m],
            k_cache.data_ptr(), v_cache.data_ptr(), pos_t.data_ptr(), ptr(starts))
    dims = (n_layer, b, d, n_head, n_kv_head, dh, seq_len, ip)
    tail = (float(norm_eps), n_splits, split_len,
            s["qkv"].data_ptr(), s["ya"].data_ptr(), s["h"].data_ptr(),
            s["part"].data_ptr(), s["part"].numel(), s["ssq"].data_ptr(), s["part_ml"].data_ptr(),
            s["part_acc"].data_ptr(),
            tickets.data_ptr(), STACK_TICKETS, ctypes.addressof(s["plans"]),
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _build.kernels().lib
    if wfmt == "i8":
        err = lib.mv_decode_stack_int8(*lead, *dims, gp, gp2, *tail)
    else:
        err = lib.mv_decode_stack_int4(*lead, ptr(lnf), ptr(head_pw), ptr(head_sc), ptr(logits),
                                       *dims, vp, gp, gp2, *tail)
    if err != 0:
        raise RuntimeError(f"decode_stack_int4 (wfmt={wfmt!r}) kernel launch failed: cudaError_t {err}")
    if wfmt == "i8":
        decode_stack_int4.launches_i8 += 1
    else:
        decode_stack_int4.launches += 1
    if logits is None:
        return x_out, k_cache, v_cache
    return x_out, k_cache, v_cache, logits


decode_stack_int4.launches = 0
decode_stack_int4.launches_i8 = 0
