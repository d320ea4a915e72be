"""Token-space layout and hierarchy combine/split math.

The first-stage LLM operates on a single flat vocabulary of 2562 ids
(reference: fam/llm/fast_model.py:87-94, fam/llm/preprocessing/audio_token_mode.py:35-49):

  * ``0 .. 1023``      — EnCodec hierarchy-0 audio codes
  * ``1024 .. 2047``   — EnCodec hierarchy-1 audio codes (offset by +1024)
  * ``2048``           — end-of-audio token (2 * 1024)
  * ``2049 .. 2561``   — 512-token BPE text vocab, offset by 2049 (= 2*1024 + 1)

Training sequences are "flattened interleaved": text tokens followed by
h0[0], h1[0]+1024, h0[1], h1[1]+1024, ... (reference:
fam/llm/preprocessing/audio_token_mode.py:11-32).

Everything in this module is host-side numpy / pure python: it runs once per
utterance, outside the XLA-compiled compute path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# --- canonical token-space constants ------------------------------------------------
CODEBOOK_SIZE = 1024  # EnCodec codes per hierarchy
END_OF_AUDIO_TOKEN = 2 * CODEBOOK_SIZE  # 2048 in the flat first-stage space
TEXT_OFFSET = 2 * CODEBOOK_SIZE + 1  # 2049; BPE ids are shifted by this
SECOND_HIERARCHY_OFFSET = CODEBOOK_SIZE  # +1024 applied to h1 when flattening
FIRST_STAGE_VOCAB_SIZE = 2562  # 2049 + 512 text tokens + 1
END_OF_TEXT_TOKEN = 1537  # unshifted BPE EOT ids appear as offset+eot
# The end-of-audio id *within one hierarchy's* 0..1024 space (used by the
# second stage / adapters, reference fam/llm/fast_inference.py:39):
HIERARCHY_EOA = CODEBOOK_SIZE  # 1024
ENCODEC_PAD_TOKEN = CODEBOOK_SIZE  # 1024, pad in second-stage input space
NUM_ENCODEC_CODEBOOKS = 8
ENCODEC_FRAME_RATE_HZ = 75  # 24 kHz EnCodec at bw=6 emits 75 frames/sec


def combine_flattened_interleaved(
    audio_tokens: np.ndarray,
    text_tokens: np.ndarray,
    second_hierarchy_offset: int = SECOND_HIERARCHY_OFFSET,
) -> np.ndarray:
    """Interleave the first two audio hierarchies and prepend text tokens.

    ``audio_tokens``: (num_hierarchies >= 2, T) integer codes in 0..1023.
    ``text_tokens``: (S,) already-offset BPE ids.
    Returns (1, S + 2T). Matches reference
    fam/llm/preprocessing/audio_token_mode.py:11-32.
    """
    audio_tokens = np.asarray(audio_tokens)
    text_tokens = np.asarray(text_tokens)
    if not np.issubdtype(audio_tokens.dtype, np.integer):
        raise TypeError(f"audio tokens must be integers, got {audio_tokens.dtype}")
    if not np.issubdtype(text_tokens.dtype, np.integer):
        raise TypeError(f"text tokens must be integers, got {text_tokens.dtype}")
    if audio_tokens.shape[0] < 2:
        raise ValueError(f"need >= 2 hierarchies, got {audio_tokens.shape[0]}")

    h0, h1 = audio_tokens[0], audio_tokens[1]
    interleaved = np.empty(len(h0) + len(h1), dtype=np.int64)
    interleaved[0::2] = h0
    interleaved[1::2] = h1 + second_hierarchy_offset
    return np.concatenate([text_tokens.astype(np.int64), interleaved])[None, :]


def split_flattened_interleaved(
    tokens: np.ndarray | list[int],
    end_of_audio_token: int = HIERARCHY_EOA,
) -> tuple[list[int], list[list[int]]]:
    """Inverse of :func:`combine_flattened_interleaved` on a sampled stream.

    Splits a flat first-stage output stream into (text_ids, [h0, h1]) by id
    range; drops the end-of-audio token and truncates hierarchies to equal
    length. Matches reference fam/llm/adapters/flattened_encodec.py:8-32
    (class FlattenedInterleavedEncodec2Codebook), including dropping the last
    text id (the end-of-text token).
    """
    tokens = np.asarray(tokens).reshape(-1)
    eoa = end_of_audio_token
    text_ids = tokens[tokens > 2 * eoa].tolist()
    h0 = tokens[tokens < eoa].tolist()
    h1_mask = (tokens >= eoa) & (tokens < 2 * eoa)
    h1 = (tokens[h1_mask] - eoa).tolist()
    if len(h0) != len(h1):
        min_len = min(len(h0), len(h1))
        h0, h1 = h0[:min_len], h1[:min_len]
    return text_ids[:-1], [h0, h1]


def split_tilted(
    tokens: list[list[int]] | np.ndarray,
    end_of_audio_token: int = HIERARCHY_EOA,
) -> tuple[list[int], list[list[int]]]:
    """Split explicit multi-hierarchy output into (text_ids, hierarchies).

    Hierarchy 0 contains text tokens (ids > eoa) intermixed with audio codes
    (ids < eoa); remaining hierarchies contain only audio codes (< eoa);
    id == eoa entries (pad/EOA) are dropped everywhere. Hierarchies are
    truncated to a common length. Matches reference
    fam/llm/adapters/tilted_encodec.py:8-39 (class TiltedEncodec).
    """
    if len(tokens) <= 1:
        raise ValueError("tilted split needs > 1 hierarchy")
    first = np.asarray(tokens[0]).reshape(-1)
    eoa = end_of_audio_token
    text_ids = first[first > eoa].tolist()
    hierarchies = [first[first < eoa].tolist()]
    for level in tokens[1:]:
        level = np.asarray(level).reshape(-1)
        hierarchies.append(level[level < eoa].tolist())
    lengths = {len(h) for h in hierarchies}
    if len(lengths) != 1:
        min_len = min(lengths)
        hierarchies = [h[:min_len] for h in hierarchies]
    return text_ids[:-1], hierarchies


@dataclass(frozen=True)
class AudioTokenModeParams:
    """Parameters of an audio-token packing mode.

    Mirrors reference fam/llm/preprocessing/audio_token_mode.py:35-49
    (``get_params_for_mode``) for mode "flattened_interleaved".
    """

    text_tokenisation_offset: int
    pad_token: int
    ctx_window: int | None
    second_hierarchy_flattening_offset: int

    def combine(self, audio_tokens: np.ndarray, text_tokens: np.ndarray) -> np.ndarray:
        return combine_flattened_interleaved(
            audio_tokens, text_tokens, self.second_hierarchy_flattening_offset
        )


def get_params_for_mode(
    audio_token_mode: str = "flattened_interleaved",
    num_max_audio_tokens_timesteps: int | None = None,
) -> AudioTokenModeParams:
    if audio_token_mode != "flattened_interleaved":
        raise ValueError(f"Unknown audio token mode: {audio_token_mode}")
    return AudioTokenModeParams(
        text_tokenisation_offset=TEXT_OFFSET,
        pad_token=END_OF_AUDIO_TOKEN,
        ctx_window=(
            num_max_audio_tokens_timesteps * 2 if num_max_audio_tokens_timesteps else None
        ),
        second_hierarchy_flattening_offset=SECOND_HIERARCHY_OFFSET,
    )


def pad_tokens(
    tokens: np.ndarray, ctx_window: int, pad_token: int = END_OF_AUDIO_TOKEN
) -> np.ndarray:
    """Right-pad a (1, T) token row to ``ctx_window + 1`` with ``pad_token``.

    Training sequences carry one extra position for the shift-by-one targets.
    Matches reference fam/llm/preprocessing/data_pipeline.py:7-21.
    """
    tokens = np.asarray(tokens)
    if tokens.ndim != 2 or tokens.shape[0] != 1:
        raise ValueError(f"expected shape (1, T), got {tokens.shape}")
    t = tokens.shape[1]
    target = ctx_window + 1
    if t > target:
        return tokens[:, :target]
    out = np.full((1, target), pad_token, dtype=tokens.dtype)
    out[:, :t] = tokens
    return out


def build_second_stage_input(
    text_tokens: list[int],
    coarse_hierarchies: list[list[int]],
    ctx_window: int,
    pad_token: int = ENCODEC_PAD_TOKEN,
) -> np.ndarray:
    """Build the (2, ctx_window) second-stage input hierarchies.

    Row 0: text tokens ++ h0 codes ++ [pad]; row 1: [pad]*len(text) ++ h1
    codes ++ [pad]; both right-padded (or truncated) to ``ctx_window``.
    Matches reference fam/llm/inference.py:279-301.
    """
    if len(coarse_hierarchies) < 2:
        raise ValueError("need two coarse hierarchies")
    h0, h1 = list(coarse_hierarchies[0]), list(coarse_hierarchies[1])
    rows = [
        list(text_tokens) + h0 + [pad_token],
        [pad_token] * len(text_tokens) + h1 + [pad_token],
    ]
    out = np.full((2, ctx_window), pad_token, dtype=np.int64)
    for i, row in enumerate(rows):
        row = row[:ctx_window]
        out[i, : len(row)] = row
    return out
