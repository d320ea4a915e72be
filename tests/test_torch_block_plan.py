"""The plan of the attention blocks K5 and K9 (``ops/attention.block_plan``)
and of the FFNs K6 and K10 (``ops/decode_stack.ffn_plan``) and their
scratch, on the CPU.

A K5 or K9 call is three kernels: the qkv product and the o-proj on the
tensor-core GEMV (``csrc/decode_stack_gemv.cuh``, K cut into splits of
``split_steps`` k-steps, int4 words for K5, plain int8 bytes for K9), and the
one-pass attention (``csrc/decode_attention_onepass.cuh``, one block a query
head and split, the window ``[0, pos]`` cut into splits ``[i * split_len,
(i + 1) * split_len)`` and clipped to ``[start, pos + 1)``). The C entries
refuse a plan the kernels cannot run (``sg_plan_ok`` and the window checks):
these tests walk the same arithmetic over every window of the cache, the
main path's widths (MHA and GQA with 2 kv heads), the small models' and
every row count 1..8, and hold each plan to the kernels' conditions.

A K6 or K10 call is two launches of the same GEMV: w1 and w3 side by side
(two matrices, the SwiGLU epilogue) and w2, int4 words for K6 (vpw 8),
plain int8 bytes for K10 (vpw 1).
"""

import pytest
import torch

from metavoice_tpu_torch.ops import attention as A
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

WINDOWS = range(1, 2049)
STARTS = (0, 1, 37, 255, 256, 257, 1000, 2047)
DH = A.BLOCK_HEAD_DIM
# (format, rows, dim, heads, kv heads): K9 is MHA, K5 takes every cache format, MHA and GQA
CALLS = [("int8_plain", b, 2048, 16, 16) for b in (1, 2, 8)]
CALLS += [(fmt, 2, 2048, 16, h_kv) for fmt in ("bf16", "int8", "packed") for h_kv in (16, 2)]


def _vpw(fmt: str) -> int:
    return 1 if fmt == "int8_plain" else 8


def _products(fmt, d, h_kv):
    """(name, k, n) of a call's two products."""
    return [("qkv", d, d + 2 * h_kv * DH), ("o", d, d)]


@pytest.mark.parametrize("fmt,b,d,h,h_kv", CALLS)
def test_attention_covers_every_window_once(fmt, b, d, h, h_kv):
    """One block a query head: the window's splits back to back from the
    row's start to pos + 1, at most ATTN_MAX_SPLITS, the last holding pos
    (the split that makes the new row)."""
    for n in WINDOWS:
        split_len, n_splits = A.block_plan(fmt, b, d, h, h_kv, n - 1).attn
        assert (split_len, n_splits) == A.attention_plan(n, b * h, 1), n
        assert 1 <= n_splits <= A.ATTN_MAX_SPLITS, (n, n_splits)
        assert (n_splits - 1) * split_len < n <= n_splits * split_len, (n, split_len, n_splits)
        assert (n_splits - 1) * split_len <= n - 1, n  # the last split holds pos
        for start in STARTS:
            lo = min(start, n - 1)
            spans = [(max(i * split_len, lo), min((i + 1) * split_len, n)) for i in range(n_splits)]
            spans = [(s0, s1) for s0, s1 in spans if s0 < s1]
            ends = [lo] + [s1 for _, s1 in spans]
            assert [s0 for s0, _ in spans] == ends[:-1] and ends[-1] == n, (n, start, spans)


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("fmt,d,h_kv", [("int8_plain", 2048, 16), ("int8_plain", 1024, 8), ("int8_plain", 512, 4),
                                        ("int8", 2048, 16), ("int8", 2048, 2), ("bf16", 1024, 8)])
def test_products_cover_k(fmt, d, h_kv, b):
    """Each product's cut covers K's k-steps once, as the kernel's
    sg_plan_ok asks: whole int4 groups (8 k-steps) and at most 4 a split, the
    x slice within STACK_X_BYTES, column tiles in whole clusters."""
    plan = A.block_plan(fmt, b, d, d // DH, h_kv, 255)
    vpw = _vpw(fmt)
    for (name, k, n), (split_steps, n_splits, warps) in zip(_products(fmt, d, h_kv), (plan.qkv, plan.o)):
        steps = k // vpw // DS.STACK_STEP_ROWS
        assert k % (vpw * DS.STACK_STEP_ROWS) == 0 and n % (DS.STACK_TILE_N * DS.STACK_CLUSTER) == 0, name
        assert warps == DS.STACK_WARPS and split_steps >= 1, name
        assert (n_splits - 1) * split_steps < steps <= n_splits * split_steps, (name, split_steps, n_splits)
        assert DS.stack_x_bytes(vpw, b, split_steps) <= DS.STACK_X_BYTES, name
        if vpw == 8:
            assert split_steps % DS.STACK_I4_GROUP_STEPS == 0 and split_steps <= DS.STACK_I4_MAX_SPLIT_STEPS, name
        # the grid the card holds at once, where a shorter cut exists
        assert n // DS.STACK_TILE_N * n_splits <= DS.STACK_RESIDENT_BLOCKS or split_steps == steps, name


@pytest.mark.parametrize("fmt,b,d,h,h_kv", CALLS)
@pytest.mark.parametrize("pos", [0, 255, 383, 384, 1000, 2047])
def test_scratch_holds_every_partial(fmt, b, d, h, h_kv, pos):
    """The products' partials (the kernel's mats * splits * B * (N + 1)),
    the attention's ((B*H, splits, Dh) sums and (max, sum) pairs), the
    counters of both made zero once and the same tables on every call."""
    plan = A.block_plan(fmt, b, d, h, h_kv, pos)
    cpu = torch.device("cpu")
    for (_, _, n), p in zip(_products(fmt, d, h_kv), (plan.qkv, plan.o)):
        if p[1] > 1:
            assert plan.part >= p[1] * b * (n + 1)
    split_len, n_splits = plan.attn
    assert plan.attn_part == (b * h * n_splits * (DH + 2) if n_splits > 1 else 0)
    qout = d + 2 * h_kv * DH
    qkv, ya, part, attn_part, tickets, attn_tickets = A._block_scratch(plan, b, d, qout, b * h, cpu, "test")
    assert qkv.shape == (b, qout) and qkv.dtype == torch.float32 and ya.shape == (b, d)
    assert ya.dtype == torch.bfloat16 and part.numel() >= max(plan.part, 1)
    assert (attn_part is None) == (n_splits == 1) and (attn_part is None or attn_part.numel() == plan.attn_part)
    assert tickets.dtype == attn_tickets.dtype == torch.int32 and not tickets.any() and not attn_tickets.any()
    assert tickets.numel() == DS.STACK_TICKETS >= qout // DS.STACK_TILE_N
    assert attn_tickets.numel() == A.ATTN_TICKETS >= b * h
    again = A._block_scratch(plan, b, d, qout, b * h, cpu, "test")
    assert again[4] is tickets and again[5] is attn_tickets


def test_block_plan_refuses_an_unknown_format():
    with pytest.raises(ValueError, match="fmt must be one of"):
        A.block_plan("fp8", 2, 2048, 16, 16, 0)


# (kernel, vpw, dim, FFN width): the main path's (K6's FFN 5632 packs to 6144), small-kv8's (1024 wide, 2816 packed
# to 3072) and small-int8p's (512 wide, 1536), and a narrow K10 on the 64 grid
FFNS = [("K6", 8, 2048, 6144), ("K6", 8, 1024, 3072), ("K10", 1, 2048, 5632), ("K10", 1, 512, 1536),
        ("K10", 1, 256, 704)]


def _ffn_products(d, ip):
    """(name, k, n, matrices) of a K6 / K10 call's two products."""
    return [("w13", d, ip, 2), ("w2", ip, d, 1)]


@pytest.mark.parametrize("b", range(1, 9))
@pytest.mark.parametrize("kernel,vpw,d,ip", FFNS)
def test_ffn_products_cover_k(kernel, vpw, d, ip, b):
    """Each FFN product's cut covers K's k-steps once and meets the C entry's
    sg_plan_ok: whole int4 groups (8 k-steps) and at most 4 a split, the x
    slice within STACK_X_BYTES (w2's K is the FFN width: up to 6144 int4
    values or 5632 bytes a row), column tiles in whole clusters, the
    partials as many as mats x splits x B x (N + 1) of either product."""
    w13, w2, part = DS.ffn_plan(vpw, b, d, ip)
    assert (w13, w2) == (DS.stack_gemv_plan(d, ip, vpw, b, n_mats=2), DS.stack_gemv_plan(ip, d, vpw, b))
    assert kernel != "K10" or Q.ffn_int8_kernel_ok(b, d, ip)
    for (name, k, n, mats), (split_steps, n_splits, warps) in zip(_ffn_products(d, ip), (w13, w2)):
        steps = k // vpw // DS.STACK_STEP_ROWS
        assert k % (vpw * DS.STACK_STEP_ROWS) == 0 and n % (DS.STACK_TILE_N * DS.STACK_CLUSTER) == 0, name
        assert warps == DS.STACK_WARPS and split_steps >= 1 and 1 <= n_splits <= 65535, name
        assert n_splits == -(-steps // split_steps), name
        assert (n_splits - 1) * split_steps < steps <= n_splits * split_steps, (name, split_steps, n_splits)
        assert DS.stack_x_bytes(vpw, b, split_steps) <= DS.STACK_X_BYTES, name
        if vpw == 8:
            assert split_steps % DS.STACK_I4_GROUP_STEPS == 0 and split_steps <= DS.STACK_I4_MAX_SPLIT_STEPS, name
        assert n // DS.STACK_TILE_N <= DS.STACK_TICKETS, name
        if mats * n_splits > 1:
            assert part >= mats * n_splits * b * (n + 1), name
    assert part == max(2 * w13[1] * b * (ip + 1), w2[1] * b * (d + 1) if w2[1] > 1 else 0)


@pytest.mark.parametrize("kernel,vpw,d,ip", FFNS)
def test_ffn_scratch_takes_the_counters_made_once(kernel, vpw, d, ip, monkeypatch):
    """A K6/K10 call's scratch: the plans as the C entry reads them, h (B,
    FFN width) bf16, the partials the plan asks for, and K3's merge counters,
    made zero by the first call and the same table on every later one."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    cpu = torch.device("cpu")
    plans, h, part, tickets = Q._ffn_scratch(vpw, 2, d, ip, cpu, "test")
    w13, w2, n_part = DS.ffn_plan(vpw, 2, d, ip)
    assert list(plans) == [*w13, *w2]
    assert h.shape == (2, ip) and h.dtype == torch.bfloat16
    assert part.dtype == torch.float32 and part.numel() == n_part
    assert tickets.dtype == torch.int32 and tickets.numel() == DS.STACK_TICKETS and not tickets.any()
    assert DS._stack_tickets == {None: tickets}
    assert Q._ffn_scratch(vpw, 2, d, ip, cpu, "test")[3] is tickets


@pytest.mark.parametrize("m,d,ip,ok", [(1, 2048, 5632, True), (8, 512, 1536, True), (9, 2048, 5632, False),
                                       (0, 2048, 5632, False), (2, 2048, 5648, False), (2, 528, 1536, False),
                                       (2, 256, 704, True)])
def test_ffn_int8_kernel_takes_the_64_grid(m, d, ip, ok):
    """K10's kernel takes 1..8 rows and D, I multiples of 64 (32-column tiles,
    two a cluster), where it took multiples of 16 before."""
    assert Q.ffn_int8_kernel_ok(m, d, ip) is ok
