"""On-the-fly finetuning dataset: audio + text -> flattened-interleaved tokens.

Port of metavoice_tpu/training/data.py, the reference's
``DynamicComputeDataset`` (fam/llm/loaders/training_data.py:24-116): a
"|"-separated CSV of (audio_path, caption) rows with a header row, read with
the stdlib ``csv`` module (pandas' ``read_csv(delimiter="|",
index_col=False)``: the first two fields of a row are taken, blank lines
skipped). Per item, on the fly:

  * normalize and BPE-encode the caption (offset ids + EOT);
  * resample the audio to 24 kHz and EnCodec-encode it on the codec's device
    -> (8, T) codes;
  * the speaker embedding from the same audio at 16 kHz;
  * combine to flattened-interleaved and pad to ctx_window + 1
    (fam/llm/preprocessing/data_pipeline.py:7-21).

``training_batches`` yields the shift-by-one (x, y, spk_emb) training batches
in the JAX package's order for the same seed
(fam/llm/preprocessing/data_pipeline.py:24-43).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.text import normalize_text
from metavoice_tpu_torch.models import encodec as ec
from metavoice_tpu_torch.models import speaker_encoder as se
from metavoice_tpu_torch.ops.audio import resample
from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
from metavoice_tpu_torch.utils import audio_io as aio

MBD_SAMPLE_RATE = 24000


def read_rows(csv_path: str) -> list[list[str]]:
    """The data rows of a "|"-separated CSV with a header row (blank lines
    skipped)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter="|") if r]
    return rows[1:]


@dataclass
class DynamicComputeDataset:
    rows: list[list[str]]
    encodec_params: dict
    encodec_cfg: ec.EncodecConfig
    tokenizer: TrainedBPETokeniser
    spk_params: dict
    mode_params: T.AudioTokenModeParams
    base_dir: str = ""  # the CSV's directory: relative row paths resolve here

    @classmethod
    def from_csv(
        cls,
        csv_path: str,
        encodec_params: dict,
        encodec_cfg: ec.EncodecConfig,
        tokenizer: TrainedBPETokeniser,
        spk_params: dict,
        num_max_audio_tokens_timesteps: int = 1024,
    ) -> "DynamicComputeDataset":
        mode = T.get_params_for_mode("flattened_interleaved", num_max_audio_tokens_timesteps)
        return cls(read_rows(csv_path), encodec_params, encodec_cfg, tokenizer, spk_params, mode,
                   base_dir=os.path.dirname(os.path.abspath(csv_path)))

    def _resolve(self, path: str) -> str:
        """Relative row paths resolve against the CSV's directory (the
        reference's sample dataset uses ./data/... paths)."""
        if os.path.isabs(path) or os.path.exists(path):
            return path
        return os.path.join(self.base_dir, path)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        audio_path, text = self.rows[idx][:2]
        # as in the JAX package: a caption field that is a .txt path (the
        # reference's datasets/sample_dataset.csv layout) reads the caption
        # from that file, resolved against the CSV's directory; a missing
        # file raises rather than training on the path string
        if text.endswith(".txt"):
            cap_path = self._resolve(text)
            if not os.path.exists(cap_path):
                raise FileNotFoundError(f"caption file not found: {text!r} (resolved {cap_path!r})")
            with open(cap_path, encoding="utf-8") as f:
                text = f.read().strip()
        text_tokens = np.asarray(self.tokenizer.encode(normalize_text(text)), np.int64)

        wav, sr = aio.load_audio(self._resolve(audio_path))
        wav24 = resample(wav, sr, MBD_SAMPLE_RATE) if sr != MBD_SAMPLE_RATE else wav
        codes = ec.encode_codes(self.encodec_params, self.encodec_cfg, wav24[None]).cpu().numpy()[0]  # (8, T)

        wav16 = resample(wav, sr, se.SAMPLING_RATE) if sr != se.SAMPLING_RATE else wav
        spkemb = se.embed_utterance(self.spk_params, wav16.astype(np.float32))

        combined = self.mode_params.combine(codes, text_tokens)  # (1, S+2T)
        padded = T.pad_tokens(combined, self.mode_params.ctx_window, self.mode_params.pad_token)
        return {"tokens": padded, "spkemb": spkemb[None].astype(np.float32)}


def training_batches(
    dataset: DynamicComputeDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 1337,
    epochs: int | None = None,
    drop_last: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield {x: (B, ctx), y: (B, ctx), spk_emb: (B, 256)} batches forever
    (or for ``epochs``); x and y are the shift-by-one pair."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            if drop_last and len(idxs) < batch_size:
                continue
            items = [dataset[int(i)] for i in idxs]
            tokens = np.concatenate([it["tokens"] for it in items], axis=0)
            spk = np.concatenate([it["spkemb"] for it in items], axis=0)
            yield {
                "x": tokens[:, :-1].astype(np.int32),
                "y": tokens[:, 1:].astype(np.int32),
                "spk_emb": spk,
            }
        epoch += 1
