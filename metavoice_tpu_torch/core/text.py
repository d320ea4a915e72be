"""Host-side text normalization.

Behaviorally equivalent to reference fam/llm/utils.py:12-52 (normalize_text):
maps common unicode punctuation onto ASCII, rejects characters outside the
BPE byte range, collapses whitespace.
"""

from __future__ import annotations

import re

_UNICODE_CONVERSION = {
    8175: "'",
    8189: "'",
    8190: "'",
    8208: "-",
    8209: "-",
    8210: "-",
    8211: "-",
    8212: "-",
    8213: "-",
    8214: "||",
    8216: "'",
    8217: "'",
    8218: ",",
    8219: "`",
    8220: '"',
    8221: '"',
    8222: ",,",
    8223: '"',
    8228: ".",
    8229: "..",
    8230: "...",
    8242: "'",
    8243: '"',
    8245: "'",
    8246: '"',
    180: "'",
    2122: "TM",  # Trademark sign
}

_WS_RE = re.compile(r"\s\s+")


def normalize_text(text: str) -> str:
    text = text.translate(_UNICODE_CONVERSION)

    non_bpe_chars = {c for c in text if ord(c) >= 256}
    if non_bpe_chars:
        points = [(c, ord(c)) for c in non_bpe_chars]
        raise ValueError(f"Non-supported character found: {points}")

    text = (
        text.replace("\t", " ")
        .replace("\n", " ")
        .replace("\r", " ")
        .replace("*", " ")
        .strip()
    )
    return _WS_RE.sub(" ", text)


_SENTENCE_SPLIT_RE = re.compile(r"(?<=[.!?])\s+")


def chunk_text(text: str, max_chars: int = 220) -> list[str]:
    """Split arbitrary-length text into synthesis chunks of <= max_chars.

    The reference hard-truncates at 220 chars (fam/llm/inference.py:534-541)
    and leaves "arbitrary length text" unshipped (README.md:150-153); we ship
    it via sentence-boundary chunking with a greedy repack, reusing one
    speaker embedding across chunks for voice consistency.
    """
    text = text.strip()
    if len(text) <= max_chars:
        return [text] if text else []
    sentences = _SENTENCE_SPLIT_RE.split(text)
    chunks: list[str] = []
    current = ""
    for sentence in sentences:
        # A single overlong sentence is split at word boundaries.
        while len(sentence) > max_chars:
            cut = sentence.rfind(" ", 0, max_chars)
            if cut <= 0:
                cut = max_chars
            piece, sentence = sentence[:cut].strip(), sentence[cut:].strip()
            if current:
                chunks.append(current)
                current = ""
            chunks.append(piece)
        if not sentence:
            continue
        if current and len(current) + 1 + len(sentence) > max_chars:
            chunks.append(current)
            current = sentence
        else:
            current = f"{current} {sentence}".strip()
    if current:
        chunks.append(current)
    return chunks
