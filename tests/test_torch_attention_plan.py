"""The plan of K1's and K4's one-launch kernels (``ops/attention.attention_plan``),
on the CPU (K5's and K9's, which take it too: ``test_torch_block_plan.py``).

The kernels cut a window of ``n`` slots into splits ``[i * split_len, (i + 1)
* split_len)`` and clip each to ``[start, n)``
(``csrc/decode_attention_onepass.cuh``); these tests walk the same arithmetic
over every window of the cache and hold it to what the kernels need.
"""

import pytest
import torch

from metavoice_tpu_torch.ops import attention as A

WINDOWS = range(1, 2049)
STARTS = (0, 1, 37, 255, 256, 257, 1000, 2047)


def _clipped(split_len: int, n_splits: int, n: int, start: int) -> list[tuple[int, int]]:
    """Each block's [s_begin, s_end), as the kernels compute it (empty ones too)."""
    lo = min(start, n - 1)  # a start past the last slot is taken as the last slot (pos)
    return [(max(i * split_len, lo), min((i + 1) * split_len, n)) for i in range(n_splits)]


@pytest.mark.parametrize("kv_rows", [4, 32, 48])
@pytest.mark.parametrize("n_q", range(1, 17))
def test_plan_covers_every_window_once(kv_rows, n_q):
    groups = -(-n_q // A.ATTN_MAX_Q)
    for n in WINDOWS:
        split_len, n_splits = A.attention_plan(n, kv_rows, n_q)
        assert 1 <= n_splits <= A.ATTN_MAX_SPLITS, (n, n_splits)
        # the last split reaches n, and none lies wholly past it
        assert (n_splits - 1) * split_len < n <= n_splits * split_len, (n, split_len, n_splits)
        # a short window is one split; a longer one in no more splits than
        # pieces of the floor's length would make
        assert n_splits == 1 if n <= A.ATTN_ONE_SPLIT else (n_splits - 1) * A.ATTN_MIN_SPLIT < n, (n, n_splits)
        # more than one split only while the grid fits the card in one wave
        assert n_splits == 1 or kv_rows * groups * n_splits <= A.CARD_SMS, (n, n_splits)
        for start in STARTS:
            lo = min(start, n - 1)
            spans = [(b, e) for b, e in _clipped(split_len, n_splits, n, start) if b < e]
            # back to back from lo to n: every slot of the window in exactly one split
            ends = [lo] + [e for _, e in spans]
            assert [b for b, _ in spans] == ends[:-1] and ends[-1] == n, (n, start, spans)


@pytest.mark.parametrize("kv_rows,n_q,n", [(32, 1, 1), (32, 1, 2048), (4, 8, 2033), (16, 16, 300), (2, 16, 2048)])
def test_onepass_scratch_holds_every_partial(kv_rows, n_q, n):
    """The wrapper's scratch covers the kernel's (kv rows x query groups,
    splits, 16, Dh + 2) partials, and the tickets are zeros made once."""
    dh = 128
    split_len, n_splits = A.attention_plan(n, kv_rows, n_q)
    part, tickets = A._onepass_scratch(n_splits, kv_rows, n_q, dh, torch.device("cpu"))
    if n_splits == 1:
        assert part is None and tickets is None
        return
    groups = -(-n_q // A.ATTN_MAX_Q)
    assert part.dtype == torch.float32 and part.numel() >= kv_rows * groups * n_splits * A.ATTN_MAX_Q * (dh + 2)
    assert tickets.dtype == torch.int32 and tickets.numel() == A.ATTN_TICKETS and not tickets.any()
    assert A._onepass_scratch(n_splits, kv_rows, n_q, dh, torch.device("cpu"))[1] is tickets


def test_onepass_scratch_refuses_more_rows_than_tickets():
    with pytest.raises(ValueError, match="merge counters"):
        A._onepass_scratch(2, A.ATTN_TICKETS + 1, 1, 128, torch.device("cpu"))
