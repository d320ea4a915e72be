"""The plan of K2's and K8's prefill matmul (``ops/quantized.prefill_plan``)
and its merge scratch (``_prefill_scratch``), on the CPU.

The kernel (``csrc/matmul_int4_i32.cu``, ``prefill_kernel``) takes a tile of
``bm`` rows by ``bn`` columns a block and cuts the word rows (K/8 of int4
words, K/4 of int8) into splits of ``split_wb`` blocks of 128 word rows;
split i holds word blocks ``[i * split_wb, (i + 1) * split_wb)``. A K2 word
block holds one 128-row group of each of its 8 slabs, so a split applies its
groups' affine itself; K8's one group spans K, so a split leaves f32 dots
and f32 sums of x, and the last block of a tile adds them in split order,
rounds the sums once and applies ``s * dot + bf16(sum x) * c``. These tests
hold the plan to what the kernel needs at the prefill and unfused row
counts, the main path's projection shapes and K8's off-grid K, and emulate
the split-and-merge arithmetic it prescribes in plain torch against the
plain versions.
"""

import pytest
import torch

from chip_smoke import K2_TOL, K8_TOL, k8_row_gap
from metavoice_tpu_torch.ops import quantized as Q

ROWS = [1, 2, 8, 9, 16, 32, 64, 65, 200, 256, 300, 512]
D, IP = 2048, 6144  # model width, FFN width as packed
# (wfmt, K, N): qkv, wo, w1 and w3, w2 in both formats, then K8's off-grid K
# (160: 40 word rows, most of a 128-row block empty; 512: a narrow model's)
SHAPES = [("i4", D, 3 * D), ("i4", D, D), ("i4", D, IP), ("i4", IP, D),
          ("i8", D, 3 * D), ("i8", D, D), ("i8", D, IP), ("i8", IP, D),
          ("i8", 160, 72), ("i8", 512, 1536)]
EMULATED_N = 64  # columns are independent: the emulation takes the plan of the full N on one block's columns


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _word_rows(k: int, wfmt: str) -> int:
    return k // (8 if wfmt == "i4" else 4)


def _splits(k: int, wfmt: str, plan) -> list[tuple[int, int]]:
    """Each split's [first, end) word row, as the kernel walks them."""
    _, _, split_wb, n_splits = plan
    kw = _word_rows(k, wfmt)
    step = split_wb * Q.PREFILL_WORD_BLOCK
    return [(i * step, min((i + 1) * step, kw)) for i in range(n_splits)]


def _most_splits(m: int, n: int, n_wb: int) -> int:
    """The most splits on whole word blocks whose partials stay within the cap."""
    best = 1
    for wb in range(1, n_wb + 1):
        s = -(-n_wb // wb)
        if s * 4 * m * n <= Q.PREFILL_PART_BYTES:
            best = max(best, s)
    return best


@pytest.mark.parametrize("wfmt,k,n", SHAPES)
@pytest.mark.parametrize("m", ROWS)
def test_plan_covers_every_word_row_once(m, wfmt, k, n):
    plan = Q.prefill_plan(m, k, n, wfmt)
    bm, bn, split_wb, n_splits = plan
    kw = _word_rows(k, wfmt)
    n_wb = -(-kw // Q.PREFILL_WORD_BLOCK)
    # the kernel's tiles: the fewest of 16, 32, 64 and 128 rows that hold M, up to 128; its 64 columns
    assert bm == next(b for b in (16, 32, 64, 128) if b >= min(m, 128)) and bn == Q.PREFILL_BN
    # whole word blocks, the last split ending at or past the last one and none wholly past it
    assert 1 <= split_wb <= n_wb and (n_splits - 1) * split_wb < n_wb <= n_splits * split_wb
    seen = torch.zeros(kw, dtype=torch.int32)
    for r0, r1 in _splits(k, wfmt, plan):
        assert r0 % Q.PREFILL_WORD_BLOCK == 0 and r1 > r0
        seen[r0:r1] += 1
    assert (seen == 1).all()
    # the grid reaches the fill target where the word blocks and the partials' cap allow, with the
    # fewest splits that do
    tiles = -(-m // bm) * -(-n // bn)
    target = Q.CARD_SMS * Q.PREFILL_BLOCKS_PER_SM
    assert tiles * n_splits >= min(target, tiles * _most_splits(m, n, n_wb))
    for wb in range(split_wb + 1, n_wb + 1):
        fewer = -(-n_wb // wb)
        if fewer < n_splits:
            assert tiles * fewer < target, (wb, fewer)
    # the partials' bytes within their bound, and a counter for every tile
    if n_splits > 1:
        assert n_splits * m * n * 4 <= Q.PREFILL_PART_BYTES
        assert tiles <= Q.PREFILL_TICKETS


def test_plan_of_the_main_path_fills_the_card():
    """At M 256 (two 128-row tiles) qkv, w1, w3 and w2 make two blocks an SM
    or more; wo (2048 x 2048, 64 tiles) splits at every word block."""
    for wfmt in ("i4", "i8"):
        for k, n in [(D, 3 * D), (D, D), (D, IP), (IP, D)]:
            bm, bn, _, n_splits = Q.prefill_plan(256, k, n, wfmt)
            tiles = -(-256 // bm) * -(-n // bn)
            n_wb = -(-_word_rows(k, wfmt) // Q.PREFILL_WORD_BLOCK)
            assert bm == 128
            if (k, n) == (D, D):
                assert n_splits == n_wb, wfmt
            else:
                assert tiles * n_splits >= 2 * Q.CARD_SMS, (wfmt, k, n)


def test_plan_takes_one_split_past_the_counters():
    m, k, n = 16, D, Q.PREFILL_BN * (Q.PREFILL_TICKETS + 1)
    assert Q.prefill_plan(m, k, n, "i8")[3] == 1


def test_plan_refuses_an_unknown_format():
    with pytest.raises(ValueError, match="wfmt"):
        Q.prefill_plan(16, D, D, "i2")


@pytest.mark.parametrize("wfmt", ["i4", "i8"])
@pytest.mark.parametrize("m,k,n", [(256, D, 3 * D), (16, IP, D), (512, D, 3 * D)])
def test_scratch_holds_every_partial(m, k, n, wfmt):
    """The wrapper's scratch covers the kernel's partials, each call its own,
    and the counters are zeros made once for the device."""
    n_splits = Q.prefill_plan(m, k, n, wfmt)[3]
    cpu = torch.device("cpu")
    part, xpart, tickets = Q._prefill_scratch(n_splits, m, n, wfmt, cpu, "test")
    if n_splits == 1:
        assert part is None and xpart is None and tickets is None
        return
    assert part.dtype == torch.float32 and part.numel() == n_splits * m * n
    if wfmt == "i8":
        assert xpart.dtype == torch.float32 and xpart.numel() == n_splits * -(-n // Q.PREFILL_BN) * m
    else:
        assert xpart is None
    assert tickets.dtype == torch.int32 and tickets.numel() == Q.PREFILL_TICKETS and not tickets.any()
    again = Q._prefill_scratch(n_splits, m, n, wfmt, cpu, "test")
    assert again[0] is not part and again[2] is tickets


def _emulate_k2(x, pw, sc, plan):
    """K2 as the plan cuts it: each split sums s_g * (x_g @ nib_g) + bf16(sum
    x_g) * c_g over its groups (word block by word block, slab by slab), the
    partials added in split order."""
    m, k = x.shape
    kw, n_wb, gp = k // 8, k // 8 // Q.PREFILL_WORD_BLOCK, sc.shape[0] // 2
    xb = x.to(torch.bfloat16).float()
    s, c = sc.float()[:gp], sc.float()[gp:]
    parts = []
    for r0, r1 in _splits(k, "i4", plan):
        part = torch.zeros((m, pw.shape[1]))
        for mb in range(r0 // Q.PREFILL_WORD_BLOCK, r1 // Q.PREFILL_WORD_BLOCK):
            rows = slice(mb * Q.PREFILL_WORD_BLOCK, (mb + 1) * Q.PREFILL_WORD_BLOCK)
            for j in range(8):
                g = j * n_wb + mb
                xg = xb[:, j * kw + rows.start : j * kw + rows.stop]
                dot = xg @ ((pw[rows] >> (4 * j)) & 0xF).float()
                part = part + dot * s[g] + xg.sum(-1, keepdim=True).to(torch.bfloat16).float() * c[g]
        parts.append(part)
    y = parts[0]
    for part in parts[1:]:
        y = y + part
    return y


def _emulate_k8(x, p8, sc8, plan):
    """K8 as the plan cuts it: each split's f32 dots and f32 sums of x over its
    word rows of every slab, both added in split order, the sums rounded to
    bf16 once, then s * dot + bf16(sum x) * c."""
    m, k = x.shape
    kw, gp = k // 4, sc8.shape[0] // 2
    xb = x.to(torch.bfloat16).float()
    dots, sums = [], []
    for r0, r1 in _splits(k, "i8", plan):
        dot = torch.zeros((m, p8.shape[1]))
        xsum = torch.zeros((m, 1))
        for j in range(4):
            xj = xb[:, j * kw + r0 : j * kw + r1]
            dot = dot + xj @ ((p8[r0:r1] >> (8 * j)) & 0xFF).float()
            xsum = xsum + xj.sum(-1, keepdim=True)
        dots.append(dot)
        sums.append(xsum)
    dot, xsum = dots[0], sums[0]
    for d, t in zip(dots[1:], sums[1:]):
        dot, xsum = dot + d, xsum + t
    return dot * sc8[0].float() + xsum.to(torch.bfloat16).float() * sc8[gp].float()


@pytest.mark.parametrize("wfmt,k,n", SHAPES)
@pytest.mark.parametrize("m", ROWS)
def test_emulated_split_and_merge_match_plain(m, wfmt, k, n):
    plan = Q.prefill_plan(m, k, n, wfmt)
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    cols = min(n, EMULATED_N)
    w = torch.randn((k, cols), generator=gen) * 0.02
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    if wfmt == "i4":
        pw, sc = Q.quantize_int4_i32(w)
        y, ref = _emulate_k2(x, pw, sc, plan), Q.matmul_int4_i32_reference(x, pw, sc)
        assert (y - ref).abs().max().item() <= K2_TOL * ref.abs().max().item()
    else:
        p8, sc8 = Q.quantize_int8_i32(w)
        y, ref = _emulate_k8(x, p8, sc8, plan), Q.matmul_int8_i32_reference(x, p8, sc8)
        assert k8_row_gap(torch, y, ref, x, sc8) <= K8_TOL
    assert y.shape == (m, cols) and torch.isfinite(y).all()
