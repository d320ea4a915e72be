"""Trained-BPE tokenizer with checkpoint-embedded vocabulary.

API parity with the reference ``TrainedBPETokeniser``
(fam/quantiser/text/tokenise.py:4-32): constructed from the checkpoint's
``meta["tokenizer"]`` dict (name, pat_str, mergeable_ranks, special_tokens),
appends the end-of-text token on encode, and offsets all ids by +2049 into
the first-stage flat token space.

Port of metavoice_tpu/tokenizer.py. The merge hot loop runs in the port's
C++ engine (metavoice_tpu_torch/native, built with g++ at first use) where
it builds, as in the JAX package (``use_native=True``); without a compiler
the pure-Python merge, which has the same semantics. ``BPEEngine.path``
names the one taken ("native" or "python"). Works without the ``regex``
package through the std-lib ``re`` translation of the pre-tokenization
pattern.
"""

from __future__ import annotations

import re
from functools import lru_cache

from metavoice_tpu_torch.core.tokens import TEXT_OFFSET

# GPT-2-style pre-tokenization pattern. Checkpoint pat_strs use \p{L}/\p{N}
# unicode classes (regex-module syntax); std-lib `re` equivalents below. The
# negated class comes first: `re` cannot nest the letter class inside it, and
# the plain substitution would drop punctuation ("not space, letter or digit"
# is "not space or word character, or an underscore").
_PAT_TRANSLATIONS = {
    r"[^\s\p{L}\p{N}]": r"(?:[^\s\w]|_)",
    r"\p{L}": "[^\\W\\d_]",
    r"\p{N}": "\\d",
}


def _compile_pattern(pat_str: str) -> "re.Pattern":
    try:  # the `regex` module supports \p{..} natively, if present
        import regex

        return regex.compile(pat_str)
    except ImportError:
        pass
    translated = pat_str
    for src, dst in _PAT_TRANSLATIONS.items():
        translated = translated.replace(src, dst)
    # strip possessive quantifiers (`++`, `*+`) unsupported by re
    translated = re.sub(r"([+*?])\+", r"\1", translated)
    return re.compile(translated)


class BPEEngine:
    """Greedy lowest-rank-first byte-pair merging over a rank table: in the
    native engine when ``use_native`` and it builds (``path == "native"``),
    else in Python (``path == "python"``, with the reason in
    ``native_error``)."""

    def __init__(self, mergeable_ranks: dict[bytes, int], pat_str: str, use_native: bool = True):
        self.ranks = dict(mergeable_ranks)
        self.pattern = _compile_pattern(pat_str)
        self.decoder = {rank: token for token, rank in self.ranks.items()}
        self.native = None
        self.native_error = "use_native=False"
        if use_native:
            from metavoice_tpu_torch.native import NativeBPE, NativeUnavailable

            try:
                self.native = NativeBPE(self.ranks)
                self.native_error = None
            except NativeUnavailable as e:
                self.native_error = str(e)

    @property
    def path(self) -> str:
        return "python" if self.native is None else "native"

    def _encode_piece(self, piece: bytes) -> list[int]:
        if self.native is not None:
            ids = self.native.encode_piece(piece)
            if ids is not None:
                return ids
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self.ranks[p] for p in parts]

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self.pattern.findall(text):
            ids.extend(self._encode_piece(piece.encode("utf-8")))
        return ids

    def decode_bytes(self, ids: list[int]) -> bytes:
        return b"".join(self.decoder[i] for i in ids if i in self.decoder)


class TrainedBPETokeniser:
    """Checkpoint-vocabulary tokenizer with first-stage id offset.

    ``special_tokens`` maps e.g. "<|endoftext|>" -> id; the EOT id is
    appended to every encode (reference tokenise.py:17-20).
    """

    def __init__(
        self,
        name: str = "metavoice-bpe",
        pat_str: str = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
        mergeable_ranks: dict[bytes, int] | None = None,
        special_tokens: dict[str, int] | None = None,
        offset: int | None = TEXT_OFFSET,
    ):
        if mergeable_ranks is None:
            mergeable_ranks = _byte_fallback_ranks()
        self.name = name
        self.engine = BPEEngine(mergeable_ranks, pat_str)
        self.special_tokens = dict(special_tokens or {})
        self.offset = offset
        if self.special_tokens:
            self._eot = max(self.special_tokens.values())
            for tok, tid in self.special_tokens.items():
                if "endoftext" in tok:
                    self._eot = tid
        else:
            self._eot = max(mergeable_ranks.values()) + 1

    def encode(self, text: str) -> list[int]:
        tokens = self.engine.encode(text) + [self._eot]
        if self.offset is not None:
            tokens = [t + self.offset for t in tokens]
        return tokens

    def decode(self, tokens: list[int]) -> str:
        if self.offset is not None:
            tokens = [t - self.offset for t in tokens]
        tokens = [t for t in tokens if t != self._eot]
        return self.engine.decode_bytes(tokens).decode("utf-8", errors="replace")

    @property
    def eot_token(self) -> int:
        return self._eot + self.offset if self.offset is not None else self._eot


@lru_cache(maxsize=1)
def _byte_fallback_ranks() -> dict[bytes, int]:
    """Degenerate byte-level vocab (256 single-byte tokens) used when no
    checkpoint vocabulary is available (random-weight/dev runs)."""
    return {bytes([i]): i for i in range(256)}
