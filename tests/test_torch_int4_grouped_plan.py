"""The plan of K12's and K13's one-launch GEMV (``ops/quantized.int4g_plan``)
and its scratch (``_int4g_scratch``), on the CPU.

The kernel (``csrc/matmul_int4_grouped.cu``, ``int4g_mma_gemv``) cuts K's
k-steps of 16 into splits ``[i * split_steps, (i + 1) * split_steps)`` and
deals a split to its block's warps in runs of ``ceil(split_steps / warps)``;
K12's step s reads rows ``[16 s, 16 s + 16)`` of q, K13's packed rows ``[8 s,
8 s + 8)`` of p, each the k of its low nibble and that plus K/2 of its high
one. These tests walk the same arithmetic at every row count of the GEMV,
the main path's five projection shapes and groupsizes 64 and 128, and hold
it to what the kernel needs.
"""

import pytest
import torch

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
