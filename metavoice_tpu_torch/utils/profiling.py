"""Profiling and observability hooks (port of metavoice_tpu/utils/profiling.py).

  * ``trace``: a ``torch.profiler`` trace of the block, written as a
    TensorBoard/Chrome trace to ``trace_dir`` or ``MVTPU_TRACE_DIR``; with
    neither it does nothing. A trace that was asked for and fails raises
    (the JAX package's swallows the profiler's failure);
  * ``DecodeMetrics``: tokens/s, achieved weight bandwidth, the first stage's
    real-time factor and MFU, with the JAX package's formulas;
  * ``MetricsLogger``: an append-only JSONL metrics spool;
  * ``Stopwatch``: named wall-clock laps.

The MFU's peak is the card's: by default NVIDIA's data-sheet figure for one
H100 SXM (80 GB HBM3) at its 700 W power limit; pass ``peak_flops`` for
another card or limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass

import torch

from metavoice_tpu_torch.core import tokens as T

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak at the 700 W power limit
H100_SXM_PEAK_BF16_FLOPS = 989e12


@contextlib.contextmanager
def trace(trace_dir: str | None = None):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present), exported to ``trace_dir`` (default ``MVTPU_TRACE_DIR``);
    yields the profiler, or None when no directory is set."""
    trace_dir = trace_dir or os.environ.get("MVTPU_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir)) as prof:
        yield prof


@dataclass
class DecodeMetrics:
    """Throughput metrics of an autoregressive decode run."""

    tokens: int
    seconds: float
    param_bytes: int
    params: int
    cfg_batch: int = 2
    peak_flops: float = H100_SXM_PEAK_BF16_FLOPS

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / max(self.seconds, 1e-9)

    @property
    def bandwidth_gb_s(self) -> float:
        """Achieved weight-read bandwidth: model bytes x tokens/s."""
        return self.param_bytes * self.tokens_per_sec / 1e9

    @property
    def stage1_rtf(self) -> float:
        """First-stage real-time factor: 150 interleaved tokens an audio
        second (75 Hz EnCodec frames x 2 hierarchies)."""
        return (2 * T.ENCODEC_FRAME_RATE_HZ) / max(self.tokens_per_sec, 1e-9)

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization: 2 * params * cfg_batch FLOPs a token over
        ``peak_flops``."""
        return 2.0 * self.params * self.cfg_batch * self.tokens_per_sec / self.peak_flops

    def summary(self) -> dict:
        return {
            "tokens_per_sec": round(self.tokens_per_sec, 2),
            "bandwidth_gb_s": round(self.bandwidth_gb_s, 1),
            "stage1_rtf": round(self.stage1_rtf, 3),
            "mfu": round(self.mfu, 4),
        }


class MetricsLogger:
    """Append-only JSONL metrics (an offline stand-in for W&B)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, metrics: dict, step: int | None = None) -> None:
        record = dict(metrics)
        record["_time"] = time.time()
        if step is not None:
            record["_step"] = step
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")


class Stopwatch:
    """Wall-clock section timer collecting named laps."""

    def __init__(self):
        self.laps: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> float:
        now = time.perf_counter()
        dt = now - self._t
        self.laps[name] = self.laps.get(name, 0.0) + dt
        self._t = now
        return dt
