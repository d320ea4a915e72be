"""The plans of the decode stack's tensor-core GEMV
(``ops/decode_stack.stack_gemv_plan``) and the step's scratch, on the CPU.

The kernel (``csrc/decode_stack_gemv.cuh``, ``stack_gemv``) cuts a product's
``k / vpw / 16`` k-steps into splits ``[i * split_steps, (i + 1) *
split_steps)`` and deals a split to its block's warps in runs of
``ceil(split_steps / warps)``; k-step s reads word rows ``[16 s, 16 s + 16)``
of every slab. The C entry refuses a plan it cannot run (``sg_plan_ok``):
these tests walk the same arithmetic for every product of a step at the
main path's shapes, GQA and the small models' widths, at every row count
1..8, in both word formats, and hold each plan to the kernel's conditions.
"""

import pytest
import torch

from metavoice_tpu_torch.ops import decode_stack as DS

D, IP, VP = 2048, 6144, 3072  # the first stage; its FFN 5632 packs to 6144
# (dim, qout, packed FFN width, head width): MHA, GQA with 2 kv heads, the 1024-wide test models
STEPS = [(D, 3 * D, IP, VP), (D, D + 2 * 2 * 128, IP, VP), (1024, 3 * 1024, 2048, 1024)]


def _products(d, qout, ip, vp):
    """(name, k, n, matrices) of a step's five products."""
    return [("qkv", d, qout, 1), ("o", d, d, 1), ("w13", d, ip, 2), ("w2", ip, d, 1), ("head", d, vp, 1)]


def _warp_runs(steps: int, split_steps: int, n_splits: int, warps: int) -> list[tuple[int, int]]:
    """Each warp's [first, end) k-step, as the kernel computes them (empty ones too)."""
    warp_steps = -(-split_steps // warps)
    runs = []
    for split in range(n_splits):
        s_end = min((split + 1) * split_steps, steps)
        for warp in range(warps):
            begin = split * split_steps + warp * warp_steps
            runs.append((begin, min(begin + warp_steps, s_end)))
    return runs


@pytest.mark.parametrize("vpw", [8, 4], ids=["K3", "K7"])
@pytest.mark.parametrize("shape", STEPS, ids=["mha", "gqa", "1024"])
@pytest.mark.parametrize("b", range(1, DS.MAX_BATCH + 1))
def test_plan_is_one_the_kernel_runs(b, shape, vpw):
    plans = DS.stack_plans(b, *shape, vpw)
    for (name, k, n, mats), (split_steps, n_splits, warps) in zip(_products(*shape), plans):
        steps = k // vpw // DS.STACK_STEP_ROWS
        assert k % (vpw * DS.STACK_STEP_ROWS) == 0 and n % (DS.STACK_TILE_N * DS.STACK_CLUSTER) == 0, name
        # the C entry's conditions (sg_plan_ok)
        assert warps == DS.STACK_WARPS and 1 <= n_splits <= 65535, name
        assert n_splits == -(-steps // split_steps), name
        assert DS.stack_x_bytes(vpw, b, split_steps) <= DS.STACK_X_BYTES, name
        # int4: whole 128-row groups a split, at most 4
        assert vpw != 8 or (split_steps % DS.STACK_I4_GROUP_STEPS == 0 and split_steps <= DS.STACK_I4_MAX_SPLIT_STEPS)
        assert n // DS.STACK_TILE_N <= DS.STACK_TICKETS, name
        # the last split reaches the last step and none lies wholly past it
        assert (n_splits - 1) * split_steps < steps <= n_splits * split_steps, name
        # every word row in exactly one warp's run
        seen = torch.zeros(k // vpw, dtype=torch.int32)
        for begin, end in _warp_runs(steps, split_steps, n_splits, warps):
            for step in range(begin, end):
                seen[DS.STACK_STEP_ROWS * step : DS.STACK_STEP_ROWS * (step + 1)] += 1
        assert (seen == 1).all(), name


@pytest.mark.parametrize("vpw", [8, 4], ids=["K3", "K7"])
@pytest.mark.parametrize("b", range(1, DS.MAX_BATCH + 1))
def test_plan_fits_the_card_at_once(b, vpw):
    """No warp takes more than the most steps of its format, and at the CFG
    pair's 2 rows every product's grid is resident at once (3 blocks an SM):
    the fewer steps a warp where that holds (qkv, o-proj, w2, head), the more
    where it would not (w1/w3, two matrices; int4 has one choice)."""
    d, qout, ip, vp = STEPS[0]
    plans = DS.stack_plans(b, d, qout, ip, vp, vpw)
    for (name, k, n, mats), (split_steps, n_splits, warps) in zip(_products(d, qout, ip, vp), plans):
        warp_steps = -(-split_steps // warps)
        assert warp_steps <= max(DS.STACK_WARP_STEPS[vpw]), name
        if b == 2:
            assert n // DS.STACK_TILE_N * mats * n_splits <= DS.STACK_RESIDENT_BLOCKS, name
            assert warp_steps == DS.STACK_WARP_STEPS[vpw][-1 if name == "w13" else 0], name


@pytest.mark.parametrize("b", [1, 2, 5, 8])
@pytest.mark.parametrize("vpw", [8, 4], ids=["K3", "K7"])
def test_scratch_holds_every_partial(b, vpw):
    """The step's scratch holds every product's (matrices, splits, b, n)
    partials, and its plans are those of stack_plans, in the C entry's order."""
    d, qout, ip, vp = STEPS[0]
    vp = vp if vpw == 8 else 0
    s = DS._scratch_for(torch.device("cpu"), b, d, qout, ip, vp, b * 16, 32, vpw)
    plans = DS.stack_plans(b, d, qout, ip, vp, vpw)
    assert list(s["plans"]) == [v for p in plans for v in p]
    for (name, k, n, mats), (_, n_splits, _) in zip(_products(d, qout, ip, vp), plans):
        if n:
            assert s["part"].numel() >= mats * n_splits * b * (n + 1), name  # and int8's sums of x
    assert s["qkv"].shape == (b, qout) and s["h"].shape == (b, ip) and s["ya"].dtype == torch.bfloat16


def test_x_slice_bytes_follow_the_kernel_padding():
    """Rows of the x slice padded to a multiple of 64 bf16 plus 16 (the
    kernel's sg_x_stride): 8-byte B reads of a half warp in distinct banks."""
    assert DS.stack_x_bytes(8, 2, 8) == 8 * 3 * (128 + 16) * 2  # 2 rows of x and the norm weights
    assert DS.stack_x_bytes(4, 1, 1) == 4 * 2 * (64 + 16) * 2
    for split_steps in range(1, 40):
        row_bytes = DS.stack_x_bytes(1, 0, split_steps)
        assert row_bytes % 128 == 32 and row_bytes >= 2 * 16 * split_steps
