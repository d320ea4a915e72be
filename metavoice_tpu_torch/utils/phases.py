"""Lightweight per-phase wall-clock timers for orchestration profiling.

Port of metavoice_tpu/utils/phases.py: named phases of runtime/engine.py
(``eng.group_prefill``, ``eng.join``, ``eng.decode``, ``eng.note``,
``eng.rebase``, ``eng.stream_render``, ``eng.render_full``,
``eng.write_wav``) add their wall seconds here, so a serving run says where
its time goes between the decode, the joins and the renders.

Disabled by default (one truthiness check a phase); enable with
``phases.enable()`` or ``MVTPU_PHASE_TIMERS=1``. A phase's wall time
includes the time its thread waits for the device: on a card the work is
asynchronous, so a phase that must own its device time ends in ``sync``,
which waits for the tensor's current stream, and only while the timers are
on.

Usage:
    with phases.phase("eng.decode"):
        ...
    phases.report()   # {"eng.decode": {"total_s": ..., "count": ...}, ...}
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

_enabled = os.environ.get("MVTPU_PHASE_TIMERS", "0") == "1"
_lock = threading.Lock()
_stats: dict[str, list] = {}  # name -> [total_s, count]


def enable(flag: bool = True) -> None:
    global _enabled
    _enabled = flag


def enabled() -> bool:
    return _enabled


def reset() -> None:
    with _lock:
        _stats.clear()


def add(name: str, dt: float) -> None:
    with _lock:
        s = _stats.setdefault(name, [0.0, 0])
        s[0] += dt
        s[1] += 1


@contextmanager
def phase(name: str):
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(name, time.perf_counter() - t0)


def sync(x):
    """Wait for the work queued on ``x``'s device stream, only while the
    timers are on, so the phase that queued it owns its device time. A CPU
    tensor, ``None`` or disabled timers: nothing to wait for."""
    if _enabled and x is not None and x.device.type == "cuda":
        import torch

        torch.cuda.current_stream(x.device).synchronize()
    return x


def report() -> dict:
    with _lock:
        return {k: {"total_s": round(v[0], 4), "count": v[1]} for k, v in sorted(_stats.items())}


def format_report(wall_s: float | None = None) -> str:
    rows = report()
    width = max((len(k) for k in rows), default=10)
    lines = []
    for k, v in sorted(rows.items(), key=lambda kv: -kv[1]["total_s"]):
        avg = v["total_s"] / max(v["count"], 1)
        frac = f"  {100 * v['total_s'] / wall_s:5.1f}%" if wall_s else ""
        lines.append(f"{k:<{width}}  {v['total_s']:8.3f}s  x{v['count']:<5d} avg {avg * 1000:8.2f} ms{frac}")
    if wall_s is not None:
        lines.append(f"{'WALL':<{width}}  {wall_s:8.3f}s")
    return "\n".join(lines)
