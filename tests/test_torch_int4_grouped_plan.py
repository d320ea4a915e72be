"""The plans of K12's and K13's one-launch GEMV (``ops/quantized.int4g_plan``)
and of their ring of tensor-core tiles (``int4g_tile_plan``), and their
scratch (``_int4g_scratch``), on the CPU.

The kernel (``csrc/matmul_int4_grouped.cu``, ``int4g_mma_gemv``) cuts K's
k-steps of 16 into splits ``[i * split_steps, (i + 1) * split_steps)`` and
deals a split to its block's warps in runs of ``ceil(split_steps / warps)``;
K12's step s reads rows ``[16 s, 16 s + 16)`` of q, K13's packed rows ``[8 s,
8 s + 8)`` of p, each the k of its low nibble and that plus K/2 of its high
one. These tests walk the same arithmetic at every row count of the GEMV,
the main path's five projection shapes and groupsizes 64 and 128, and hold
it to what the kernel needs.

The ring (``int4g_ring_kernel``, more than 8 rows or a groupsize that is no
multiple of 16) takes a tile of ``bm`` rows by 128 columns a block and cuts
the rows of w (K12's K, K13's K/2 packed rows) into splits of
``split_chunks`` staged blocks of 64 rows; a K13 block feeds 64 k of each
half. Each split leaves an f32 partial, and the last block of a tile adds
them in split order and casts the sum to x's dtype once. Its tests walk the
plan at the prefill, verify and batched row counts, the main shapes, short
K and groupsizes 8, 24, 64 and 128, and emulate the prescribed
split-and-merge in plain torch against the plain versions.
"""

import pytest
import torch

from chip_smoke import K12_TOL, _bf16_ulp
from metavoice_tpu_torch.ops import quantized as Q

D, I_SZ = 2048, 5632
SHAPES = [(D, 3 * D), (D, D), (D, I_SZ), (I_SZ, D)]  # qkv, wo, w1 and w3, w2


def _warp_runs(k: int, split_steps: int, n_splits: int, warps: int) -> list[tuple[int, int]]:
    """Each warp's [first, end) k-step, as the kernel computes them (empty ones too)."""
    steps = k // Q.INT4G_STEP_K
    warp_steps = -(-split_steps // warps)
    runs = []
    for split in range(n_splits):
        s_end = min((split + 1) * split_steps, steps)
        for warp in range(warps):
            begin = split * split_steps + warp * warp_steps
            runs.append((begin, min(begin + warp_steps, s_end)))
    return runs


@pytest.mark.parametrize("gs", [64, 128])
@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", range(1, Q.DECODE_MAX_ROWS + 1))
def test_plan_covers_every_row_once(m, k, n, packed, gs):
    split_steps, n_splits, warps = Q.int4g_plan(m, k, n, packed)
    steps = k // Q.INT4G_STEP_K
    # within the kernel's limits
    assert 1 <= warps <= 8
    assert 1 <= n_splits <= min(Q.INT4G_MAX_SPLITS, 65535)
    # the last split reaches the last step, and none lies wholly past it
    assert (n_splits - 1) * split_steps < steps <= n_splits * split_steps
    # the partials stay within their share of the weights' bytes
    weight_bytes = k * n // (2 if packed else 1)
    assert n_splits == 1 or n_splits * m * n * 4 <= Q.INT4G_PART_SHARE * weight_bytes
    tiles = -(-n // Q.INT4G_TILE_N)
    assert tiles <= Q.INT4G_TICKETS
    # every k row in exactly one warp's run
    seen = torch.zeros(k, dtype=torch.int32)
    for begin, end in _warp_runs(k, split_steps, n_splits, warps):
        for step in range(begin, end):
            if packed:
                rows = torch.arange(8 * step, 8 * step + 8)
                rows = torch.cat([rows, rows + k // 2])
            else:
                rows = torch.arange(16 * step, 16 * step + 16)
            seen[rows] += 1
            # a step lies in one group (each half, for K13): one load of the group's scales
            groups = rows.view(2 if packed else 1, -1) // gs
            assert (groups == groups[:, :1]).all(), (step, gs)
    assert (seen == 1).all()


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("k,n", SHAPES)
@pytest.mark.parametrize("m", [1, 2, 5, 8])
def test_scratch_holds_every_partial(m, k, n, packed):
    """The wrapper's scratch covers the kernel's (splits, m, n) partials, each
    call its own, and the tickets are zeros made once for the device."""
    _, n_splits, _ = Q.int4g_plan(m, k, n, packed)
    cpu = torch.device("cpu")
    part, tickets = Q._int4g_scratch(n_splits, m, n, cpu)
    if n_splits == 1:
        assert part is None and tickets is None
        return
    assert part.dtype == torch.float32 and part.numel() == n_splits * m * n
    assert tickets.dtype == torch.int32 and tickets.numel() == Q.INT4G_TICKETS and not tickets.any()
    again = Q._int4g_scratch(n_splits, m, n, cpu)
    assert again[0] is not part and again[1] is tickets


def test_scratch_refuses_more_tiles_than_tickets():
    n = Q.INT4G_TILE_N * (Q.INT4G_TICKETS + 1)
    with pytest.raises(ValueError, match="merge counters"):
        Q._int4g_scratch(2, 2, n, torch.device("cpu"))


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_plan_of_short_k_and_narrow_n(packed):
    """The smallest calls the kernel takes: one k-step, a 16-column N."""
    for k in (16, 32, 128):
        split_steps, n_splits, warps = Q.int4g_plan(2, k, 16, packed)
        assert n_splits == 1 and 1 <= warps <= k // Q.INT4G_STEP_K and split_steps >= k // Q.INT4G_STEP_K


# ---- the ring of tensor-core tiles

RING_ROWS = [1, 2, 8, 9, 16, 32, 64, 65, 200, 256]
# (K, N, groupsizes): the main shapes, then short K (K13's halves of 576 and 264 rows)
RING_SHAPES = [(D, 3 * D, (128, 64)), (D, D, (128, 24)), (D, I_SZ, (128, 8)), (I_SZ, D, (128, 64)),
               (1152, D, (24, 8)), (528, 2064, (24, 8))]
# the calls the ring takes: more than 8 rows, or a groupsize that is no multiple of the GEMV's k-step
RING_CASES = [(m, k, n, gs) for m in RING_ROWS for k, n, gss in RING_SHAPES for gs in gss
              if m > Q.DECODE_MAX_ROWS or gs % Q.INT4G_STEP_K]


@pytest.fixture(scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring_splits(k: int, packed: bool, plan) -> list[list[tuple[int, int]]]:
    """Each split's staged blocks as the kernel walks them: [(first k, end k)
    of each consumer step]; K13's block gives its low half, then its high."""
    _, split_chunks, n_splits = plan
    rows_w = k // 2 if packed else k
    n_chunks = -(-rows_w // Q.INT4G_RING_CHUNK)
    out = []
    for z in range(n_splits):
        steps = []
        for c in range(z * split_chunks, min(n_chunks, (z + 1) * split_chunks)):
            r0, r1 = c * Q.INT4G_RING_CHUNK, min((c + 1) * Q.INT4G_RING_CHUNK, rows_w)
            steps.append((r0, r1))
            if packed:
                steps.append((r0 + k // 2, r1 + k // 2))
        out.append(steps)
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m,k,n,gs", RING_CASES)
def test_ring_plan_covers_every_k_once(m, k, n, gs, packed):
    plan = Q.int4g_tile_plan(m, k, n, packed)
    bm, split_chunks, n_splits = plan
    rows_w = k // 2 if packed else k
    n_chunks = -(-rows_w // Q.INT4G_RING_CHUNK)
    # the kernel's tiles: the fewest of 16 .. 256 rows that hold M, or half of it from 128 up
    bm0 = next(b for b in Q.INT4G_RING_ROWS if b >= min(m, 256))
    assert bm == bm0 or (bm0 >= 128 and bm == bm0 // 2)
    # whole staged blocks, the last split ending at or past the last one and none wholly past it
    assert 1 <= split_chunks <= n_chunks and (n_splits - 1) * split_chunks < n_chunks <= n_splits * split_chunks
    assert n_splits <= 65535 and -(-m // bm) <= 65535
    seen = torch.zeros(k, dtype=torch.int32)
    for steps in _ring_splits(k, packed, plan):
        assert steps
        for k0, k1 in steps:
            assert k0 % Q.INT4G_RING_CHUNK == 0 or (packed and (k0 - k // 2) % Q.INT4G_RING_CHUNK == 0)
            seen[k0:k1] += 1
            if gs % 8 == 0:  # the kernel stages a step's group rows: 8 at most
                assert (k1 - 1) // gs - k0 // gs + 1 <= 8, (k0, k1, gs)
    assert (seen == 1).all()
    # the grid reaches the fill target where the staged blocks allow
    tiles = -(-m // bm) * -(-n // Q.INT4G_RING_BN)
    slots = Q.CARD_SMS * Q.INT4G_RING_BLOCKS_PER_SM[bm]
    assert tiles * n_splits >= Q.INT4G_RING_FILL * min(slots, tiles * n_chunks)
    # the partials' bytes within their bound, and a counter for every tile
    if n_splits > 1:
        assert n_splits * m * n * 4 <= Q.INT4G_RING_PART_BYTES
        assert tiles <= Q.INT4G_TICKETS
    # no other cut that meets the fill target is cheaper in the plan's model
    cost = Q._int4g_ring_cost(bm, split_chunks, n_splits, m, n, packed)
    for bm2 in (bm0, bm0 // 2) if bm0 >= 128 else (bm0,):
        tiles2 = -(-m // bm2) * -(-n // Q.INT4G_RING_BN)
        slots2 = Q.CARD_SMS * Q.INT4G_RING_BLOCKS_PER_SM[bm2]
        for sc in range(1, n_chunks + 1):
            ns = -(-n_chunks // sc)
            if ns > 1 and (tiles2 > Q.INT4G_TICKETS or ns * m * n * 4 > Q.INT4G_RING_PART_BYTES):
                continue
            if tiles2 * ns >= Q.INT4G_RING_FILL * min(slots2, tiles2 * n_chunks):
                assert Q._int4g_ring_cost(bm2, sc, ns, m, n, packed) >= cost, (bm2, sc)


def test_ring_plan_of_the_main_path_fills_the_card():
    """At M 256 each of the five projections takes two 128-row tiles (each
    weight converted twice: the card measured it faster than one 256-row
    tile with twice the splits) and a grid of two thirds of the SMs or more,
    at most two waves."""
    for packed in (False, True):
        for k, n in [(D, 3 * D), (D, D), (D, I_SZ), (I_SZ, D)]:
            bm, _, n_splits = Q.int4g_tile_plan(256, k, n, packed)
            blocks = -(-256 // bm) * -(-n // Q.INT4G_RING_BN) * n_splits
            assert bm == 128, (packed, k, n, bm)
            assert 2 * Q.CARD_SMS / 3 <= blocks <= 2 * Q.CARD_SMS, (packed, k, n, bm, n_splits)


def test_ring_plan_takes_one_split_past_the_counters():
    n = Q.INT4G_RING_BN * (Q.INT4G_TICKETS + 1)
    assert Q.int4g_tile_plan(16, D, n, False)[2] == 1


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
def test_ring_scratch_counts_the_tiles(packed):
    """The ring's partials and counters: one counter a (row x column) tile."""
    m, k, n = 256, D, D
    bm, _, n_splits = Q.int4g_tile_plan(m, k, n, packed)
    assert n_splits > 1
    tiles = -(-m // bm) * -(-n // Q.INT4G_RING_BN)
    part, tickets = Q._int4g_scratch(n_splits, m, n, torch.device("cpu"), tiles)
    assert part.numel() == n_splits * m * n and tickets.numel() == Q.INT4G_TICKETS and not tickets.any()
    with pytest.raises(ValueError, match="merge counters"):
        Q._int4g_scratch(n_splits, m, n, torch.device("cpu"), Q.INT4G_TICKETS + 1)


def _emulate_ring(x, q, s, z, gs, plan, packed):
    """The ring as the plan cuts it: bf16 x and bf16 weights, each split's f32
    partial over its steps (K13: each staged block's low half, then its
    high), the partials added in split order, cast to x's dtype once."""
    w = Q.dequantize_int4_grouped(q, s, z, gs).to(torch.bfloat16).float()
    xb = x.to(torch.bfloat16).float()
    y = torch.zeros((x.shape[0], q.shape[1]))
    for steps in _ring_splits(x.shape[1], packed, plan):
        part = torch.zeros_like(y)
        for k0, k1 in steps:
            part = part + xb[:, k0:k1] @ w[k0:k1]
        y = y + part
    return y.to(x.dtype)


@pytest.mark.parametrize("packed", [False, True], ids=["K12", "K13"])
@pytest.mark.parametrize("m,k,n,gs", [(256, D, 3 * D, 128), (256, D, D, 64), (256, I_SZ, D, 128), (16, I_SZ, D, 128),
                                      (32, D, I_SZ, 64), (65, D, D, 128), (200, D, 3 * D, 128), (9, D, D, 128),
                                      (2, D, D, 8), (8, 1152, D, 24), (16, 528, 2064, 24)])
def test_emulated_ring_split_and_merge_match_plain(_one_torch_thread, m, k, n, gs, packed):
    """The plan of the full N, emulated on one tile's 128 columns (columns are
    independent): within chip_smoke's K12_TOL of max |ref| plus one bf16 ulp
    of the plain versions."""
    plan = Q.int4g_tile_plan(m, k, n, packed)
    gen = torch.Generator().manual_seed(m * 5 + k + n + gs)
    q, s, z = Q.quantize_int4_grouped(torch.randn((k, Q.INT4G_RING_BN), generator=gen) * 0.02, gs)
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    y = _emulate_ring(x, q, s, z, gs, plan, packed)
    ref = (Q.matmul_int4_packed_reference(x, Q.pack_int4(q), s, z, gs) if packed
           else Q.matmul_int4_reference(x, q, s, z, gs))
    assert y.shape == ref.shape and y.dtype == ref.dtype and torch.isfinite(y).all()
    gap = (y.float() - ref.float()).abs()
    assert (gap <= K12_TOL * ref.float().abs().max() + _bf16_ulp(torch, ref)).all()
