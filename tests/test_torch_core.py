"""Framework-free core of the port (tokens, text, tokenizer) against the JAX
package's, including the tokenizer's ``re`` fallback when ``regex`` is absent."""

import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from metavoice_tpu import tokenizer as jtok  # noqa: E402
from metavoice_tpu.core import text as jtext  # noqa: E402
from metavoice_tpu.core import tokens as jtokens  # noqa: E402
from metavoice_tpu_torch import tokenizer as tok  # noqa: E402
from metavoice_tpu_torch.core import text, tokens  # noqa: E402

TEXTS = [
    "Hello world.",
    "This is a test of the  emergency\tbroadcast system; it's only a test!",
    "Numbers 123 and 4.56, quotes “like this” — and more. " * 6,
]


@pytest.mark.parametrize("s", TEXTS)
def test_text_normalize_and_chunk_match_jax(s):
    assert text.normalize_text(s) == jtext.normalize_text(s)
    norm = text.normalize_text(s)
    assert text.chunk_text(norm, 60) == jtext.chunk_text(norm, 60)


@pytest.mark.parametrize("with_regex", [True, False])
def test_tokenizer_matches_jax_with_and_without_regex(monkeypatch, with_regex):
    """The reference side runs the JAX tokenizer on the ``regex`` module; the
    port must give the same ids with ``regex`` and through its ``re``
    translation of the pattern."""
    pytest.importorskip("regex")
    ranks = {bytes([i]): i for i in range(256)} | {b"th": 256, b"the": 257, b" t": 258}
    ref = jtok.TrainedBPETokeniser()
    ref_merged = jtok.TrainedBPETokeniser(mergeable_ranks=ranks)
    if not with_regex:
        monkeypatch.setitem(sys.modules, "regex", None)  # import regex -> ImportError
    ours = tok.TrainedBPETokeniser()
    ours_merged = tok.TrainedBPETokeniser(mergeable_ranks=ranks)
    if not with_regex:
        assert ours.engine.pattern.__class__.__module__ == "re"
    for s in TEXTS:
        s = text.normalize_text(s)
        assert ours.encode(s) == ref.encode(s)
        assert ours_merged.encode(s) == ref_merged.encode(s)
        assert ours_merged.decode(ours_merged.encode(s)) == s
    assert ours.eot_token == ref.eot_token


def test_token_split_matches_jax():
    rng = np.random.default_rng(0)
    stream = np.concatenate([rng.integers(2049, 2562, 10), rng.integers(0, 2049, 40)])
    assert tokens.split_flattened_interleaved(stream, 1024) == jtokens.split_flattened_interleaved(
        stream, 1024
    )
    text_ids = list(range(2100, 2110))
    coarse = [list(range(5, 25)), list(range(7, 27))]
    np.testing.assert_array_equal(
        tokens.build_second_stage_input(text_ids, coarse, 64),
        jtokens.build_second_stage_input(text_ids, coarse, 64),
    )
