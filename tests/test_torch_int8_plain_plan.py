"""K11's route and cuts (``ops/quantized.int8_gemv_ok``, ``int8_route``,
``int8_tile_plan``) and its merge scratch, on the CPU.

K11 (``csrc/matmul_int8.cu``) takes up to 8 rows with K a multiple of 16 and
N of 64 on the tensor-core decode GEMV (``decode_stack_gemv.cuh``, cut by
``decode_stack.stack_gemv_plan(k, n, 1, m)``: k-steps of 16 rows of q in
splits dealt to 4 warps), and any other call on the ring of tensor-core
tiles (``matmul_ring.cuh``, K12/K13's): a tile of ``bm`` rows by 128
columns a block, K cut into splits of ``split_chunks`` staged blocks of 64
rows of q, more than 256 rows in more row tiles. Either way each split
leaves an f32 partial of raw sums, and the last block of a tile adds them
in split order, multiplies by the column scale once and casts to x's
dtype. These tests walk the route predicate and both cuts at the main
path's shapes, the card tests' rows and widths, short K and more than 256
rows, hold each cut to what the kernel needs, and emulate the prescribed
split-and-merge in plain torch against the plain version.
"""

import pytest
import torch

from chip_smoke import K11_CASES, K11_TIMED_M, K11_TOL, _bf16_ulp
from metavoice_tpu_torch.ops import decode_stack as DS
from metavoice_tpu_torch.ops import quantized as Q

D, I_SZ = 2048, 5632
SHAPES = [(D, 3 * D), (D, D), (D, I_SZ), (I_SZ, D)]  # qkv, wo, w1 and w3, w2
# the GQA first stages' qkv and the small models' projections, and widths off the GEMV's grids
OTHER_SHAPES = [(D, D + 2 * 2 * 128), (512, 1024), (512, 512), (512, 1536), (1536, 512), (D, 2064), (D, 16),
                (40, 32), (48, 64), (1152, D), (528, 2064)]
ROWS = [1, 2, 3, 5, 8, 9, 16, 17, 32, 33, 64, 65, 128, 200, 256, 257, 300, 600, 1024]
CUT_CASES = [(m, k, n) for m in ROWS for k, n in SHAPES + OTHER_SHAPES]


@pytest.fixture(scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("m,k,n,want", [
    (1, D, 3 * D, True), (2, D, D, True), (8, I_SZ, D, True), (2, 512, 1024, True), (2, 16, 64, True),
    (9, D, D, False),  # more rows than the GEMV's mma holds
    (0, D, D, False), (256, D, D, False),
    (2, D, 2064, False), (2, D, 16, False), (2, D, 96, False),  # N off the 64-column grid
    (2, 40, 32, False), (2, 1160, D, False),  # K off the 16-row k-step
    (2, D, 64 * (DS.STACK_TICKETS // 2), True), (2, D, 64 * (DS.STACK_TICKETS // 2 + 1), False),  # the counters
])
def test_route_predicate(m, k, n, want):
    assert Q.int8_gemv_ok(m, k, n) is want
    route, cut = Q.int8_route(m, k, n) if m else ("ring", None)
    assert route == ("gemv" if want else "ring")


@pytest.mark.parametrize("m", K11_TIMED_M)
def test_main_path_routes(m):
    """M 2 (a GQA decode step of the CFG pair) takes the GEMV at every
    projection of a layer; the verify and batched rows and the prefill the
    ring."""
    for k, n in SHAPES:
        assert Q.int8_route(m, k, n)[0] == ("gemv" if m <= Q.DECODE_MAX_ROWS else "ring")


def _steps_of_warps(k: int, cut) -> torch.Tensor:
    """How often each row of q is read by the GEMV's warps under ``cut``."""
    split_steps, n_splits, warps = cut
    steps = k // DS.STACK_STEP_ROWS
    warp_steps = -(-split_steps // warps)
    seen = torch.zeros(k, dtype=torch.int32)
    for split in range(n_splits):
        s_end = min((split + 1) * split_steps, steps)
        for warp in range(warps):
            begin = split * split_steps + warp * warp_steps
            for step in range(begin, min(begin + warp_steps, s_end)):
                seen[DS.STACK_STEP_ROWS * step:DS.STACK_STEP_ROWS * (step + 1)] += 1
    return seen


GEMV_CASES = [(m, k, n) for m, k, n in CUT_CASES if Q.int8_gemv_ok(m, k, n)]


@pytest.mark.parametrize("m,k,n", GEMV_CASES)
def test_gemv_cut_is_one_the_kernel_runs(m, k, n):
    """The C entry's conditions (sg_plan_ok with vpw 1), every row of q read
    by exactly one warp, the last split reaching the last k-step and none
    wholly past it."""
    route, cut = Q.int8_route(m, k, n)
    split_steps, n_splits, warps = cut
    steps = k // DS.STACK_STEP_ROWS
    assert route == "gemv" and cut == DS.stack_gemv_plan(k, n, 1, m)
    assert warps == DS.STACK_WARPS and 1 <= n_splits <= 65535 and n_splits == -(-steps // split_steps)
    assert (n_splits - 1) * split_steps < steps <= n_splits * split_steps
    assert DS.stack_x_bytes(1, m, split_steps) <= DS.STACK_X_BYTES
    assert (_steps_of_warps(k, cut) == 1).all()


RING_CASES = [(m, k, n) for m, k, n in CUT_CASES if not Q.int8_gemv_ok(m, k, n)]


def _ring_splits(k: int, cut) -> list[list[tuple[int, int]]]:
    """Each split's staged blocks as the kernel walks them: [(first k, end k)]."""
    _, split_chunks, n_splits = cut
    n_chunks = -(-k // Q.INT4G_RING_CHUNK)
    return [[(c * Q.INT4G_RING_CHUNK, min((c + 1) * Q.INT4G_RING_CHUNK, k))
             for c in range(z * split_chunks, min(n_chunks, (z + 1) * split_chunks))] for z in range(n_splits)]


@pytest.mark.parametrize("m,k,n", RING_CASES)
def test_ring_cut_covers_every_staged_block_once(m, k, n):
    """Whole staged blocks of 64 rows of q, each in one split, none wholly
    past K; the tiles the kernel has (the fewest of 16 .. 256 rows that hold
    M, or half of it from 128 rows up), row tiles for all of M; a counter for
    every tile and the partials within their bound where K is split; no
    other cut that meets the fill target cheaper in K11's model."""
    route, cut = Q.int8_route(m, k, n)
    bm, split_chunks, n_splits = cut
    assert route == "ring" and cut == Q.int8_tile_plan(m, k, n)
    n_chunks = -(-k // Q.INT4G_RING_CHUNK)
    bm0 = next(b for b in Q.INT4G_RING_ROWS if b >= min(m, 256))
    assert bm == bm0 or (bm0 >= 128 and bm == bm0 // 2)
    assert 1 <= split_chunks <= n_chunks and (n_splits - 1) * split_chunks < n_chunks <= n_splits * split_chunks
    assert n_splits <= 65535 and -(-m // bm) <= 65535 and -(-m // bm) * bm >= m
    seen = torch.zeros(k, dtype=torch.int32)
    for steps in _ring_splits(k, cut):
        assert steps
        for k0, k1 in steps:
            seen[k0:k1] += 1
    assert (seen == 1).all()
    tiles = -(-m // bm) * -(-n // Q.INT4G_RING_BN)
    slots = Q.CARD_SMS * Q.INT4G_RING_BLOCKS_PER_SM[bm]
    assert tiles * n_splits >= Q.INT4G_RING_FILL * min(slots, tiles * n_chunks)
    if n_splits > 1:
        assert n_splits * m * n * 4 <= Q.INT4G_RING_PART_BYTES and tiles <= Q.INT4G_TICKETS
    cost = Q._int8_ring_cost(bm, split_chunks, n_splits, m, n)
    for bm2 in (bm0, bm0 // 2) if bm0 >= 128 else (bm0,):
        tiles2 = -(-m // bm2) * -(-n // Q.INT4G_RING_BN)
        slots2 = Q.CARD_SMS * Q.INT4G_RING_BLOCKS_PER_SM[bm2]
        for sc in range(1, n_chunks + 1):
            ns = -(-n_chunks // sc)
            if ns > 1 and (tiles2 > Q.INT4G_TICKETS or ns * m * n * 4 > Q.INT4G_RING_PART_BYTES):
                continue
            if tiles2 * ns >= Q.INT4G_RING_FILL * min(slots2, tiles2 * n_chunks):
                assert Q._int8_ring_cost(bm2, sc, ns, m, n) >= cost, (bm2, sc)


@pytest.mark.parametrize("m", [257, 300, 600, 1024, 4096])
def test_ring_takes_more_than_256_rows_in_row_tiles(m):
    """K11 has no cap on rows: more than 256 take ceil(M / bm) row tiles of
    at most 256 rows, within the grid's and the counters' limits."""
    for k, n in SHAPES:
        bm, _, n_splits = Q.int8_tile_plan(m, k, n)
        assert bm in (128, 256) and -(-m // bm) * bm >= m
        tiles = -(-m // bm) * -(-n // Q.INT4G_RING_BN)
        assert n_splits == 1 or (tiles <= Q.INT4G_TICKETS and n_splits * m * n * 4 <= Q.INT4G_RING_PART_BYTES)


def test_ring_takes_one_split_past_the_counters():
    n = Q.INT4G_RING_BN * (Q.INT4G_TICKETS + 1)
    assert Q.int8_tile_plan(16, D, n)[2] == 1


def test_card_cases_cover_both_routes():
    """chip_smoke's K11_CASES (the card tests' cases too) reach every GEMV row
    count, the ring's row tiles, more than 256 rows and both widths off the
    GEMV's grid."""
    routes = {Q.int8_route(m, k, n)[0] for m, k, n, _ in K11_CASES}
    assert routes == {"gemv", "ring"}
    assert {m for m, k, n, _ in K11_CASES if Q.int8_route(m, k, n)[0] == "gemv"} == set(range(1, 9))
    assert {Q.int8_tile_plan(m, k, n)[0] for m, k, n, _ in K11_CASES if Q.int8_route(m, k, n)[0] == "ring"} >= \
        {16, 32, 64, 128}
    assert max(m for m, *_ in K11_CASES) > 256 and {16, 2064} <= {n for _, _, n, _ in K11_CASES}


@pytest.mark.parametrize("m,k,n", [(2, D, 3 * D), (8, I_SZ, D), (16, D, D), (256, D, D), (600, D, D), (2, D, 2064)])
def test_scratch_fits_the_route(monkeypatch, m, k, n):
    """The partials the C entry needs (the GEMV's splits x m x (N + 1), the
    ring's splits x m x N) where K is split, none where it is not, and the
    counters of the route's own table, made zero, on every call."""
    monkeypatch.setattr(DS, "_stack_tickets", {})
    monkeypatch.setattr(Q, "_int4g_tickets", {})
    route, cut = Q.int8_route(m, k, n)
    part, tickets, n_tickets = Q._int8_scratch(route, cut, m, n, torch.device("cpu"))
    splits = cut[1] if route == "gemv" else cut[2]
    if splits == 1:
        assert part is None
    else:
        assert part.numel() == splits * m * (n + 1 if route == "gemv" else n)
    table = DS._stack_tickets if route == "gemv" else Q._int4g_tickets
    assert list(table) == [None] and tickets is table[None] and not tickets.any()
    assert n_tickets == tickets.numel() == (DS.STACK_TICKETS if route == "gemv" else Q.INT4G_TICKETS)


def _emulate(x, q, s, route, cut):
    """K11 as its route cuts it: bf16 x, exact q, each split's f32 partial
    of raw sums over its k-steps or staged blocks, the partials added in
    split order, times the column scale once, cast to x's dtype."""
    xb, qf = x.to(torch.bfloat16).float(), q.float()
    k = x.shape[1]
    if route == "gemv":
        split_steps, n_splits, _ = cut
        step = DS.STACK_STEP_ROWS
        splits = [[(z * split_steps * step, min((z + 1) * split_steps * step, k))] for z in range(n_splits)]
    else:
        splits = _ring_splits(k, cut)
    y = torch.zeros((x.shape[0], q.shape[1]))
    for blocks in splits:
        part = torch.zeros_like(y)
        for k0, k1 in blocks:
            part = part + xb[:, k0:k1] @ qf[k0:k1]
        y = y + part
    return (y * s.float()).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", [(2, D, 3 * D), (8, I_SZ, D), (1, D, D), (2, D, 2064), (16, D, D), (32, I_SZ, D),
                                   (65, D, D), (256, D, 3 * D), (256, I_SZ, D), (300, D, D)])
def test_emulated_split_and_merge_match_plain(_one_torch_thread, m, k, n, dtype):
    """The cut of the full N, emulated on its first 128 columns (columns are
    independent): within chip_smoke's K11_TOL of max |ref| plus one bf16 ulp
    of the plain version."""
    route, cut = Q.int8_route(m, k, n)
    gen = torch.Generator().manual_seed(m * 7 + k + n)
    q, s = Q.quantize_int8(torch.randn((k, 128), generator=gen) * 0.02)
    x = torch.randn((m, k), generator=gen).to(dtype)
    y = _emulate(x, q, s, route, cut)
    ref = Q.matmul_int8_reference(x, q, s)
    assert y.shape == ref.shape and y.dtype == ref.dtype == dtype and torch.isfinite(y).all()
    gap = (y.float() - ref.float()).abs()
    ulp = _bf16_ulp(torch, ref) if dtype == torch.bfloat16 else torch.zeros_like(gap)
    assert (gap <= K11_TOL * ref.float().abs().max() + ulp).all()


def test_cpu_calls_take_the_plain_version_and_count_nothing():
    gen = torch.Generator().manual_seed(3)
    q, s = Q.quantize_int8(torch.randn((64, 128), generator=gen))
    x = torch.randn((2, 64), generator=gen)
    before = (Q.matmul_int8.launches, Q.matmul_int8.gemv_launches)
    assert torch.equal(Q.matmul_int8(x, q, s), Q.matmul_int8_reference(x, q, s))
    assert (Q.matmul_int8.launches, Q.matmul_int8.gemv_launches) == before
