"""Data-parallel replica serving: one engine per card, least-loaded dispatch.

Port of metavoice_tpu/runtime/replicas.py. The 1B first stage fits one card
many times over, so multi-card THROUGHPUT serving is data parallelism: every
card holds a whole model with its own continuous-batching slot pool, and a
request goes to the least-loaded replica.

The pool has the engine's surface that the HTTP server uses (``submit``,
``stats``, ``load``, ``shutdown``), so ``make_handler`` takes a pool
wherever it takes an engine. Replica i's TTS is built by ``build_tts(i)``
inside ``torch.cuda.device(devices[i])``, and must come out on that device
(a TTS built on ``device="cuda"`` takes the current card); its engine's
threads enter that card (runtime/engine.py). One H100 runs a one-replica
pool; dispatch over several replicas is tested on the CPU, with an explicit
list of CPU devices.

Reference counterpart: none (serving.py holds one global model and
serializes requests).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine


class ReplicaPool:
    """N independent (TTS, engine) replicas behind one submit.

    ``devices`` defaults to every CUDA device; ``n_replicas`` to their count.
    ``warmup=True`` runs each engine's warmup after it is built."""

    def __init__(
        self,
        build_tts: Callable[[int], object],
        n_replicas: int | None = None,
        devices: Sequence | None = None,
        warmup: bool = False,
        **engine_kwargs,
    ):
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = [torch.device(d) for d in devices]
        n = n_replicas or len(devices)
        if n < 1:
            raise ValueError(f"need >= 1 replica, got {n}")
        if n > len(devices):
            # stacking several whole replicas (weights + cache) on one card
            # runs out of memory at full size and scales nothing
            raise ValueError(
                f"{n} replicas > {len(devices)} devices: one full model + engine per device is the contract; "
                "add devices or lower the replica count"
            )
        self.engines: list[ContinuousBatchingEngine] = []
        self.devices: list[torch.device] = []
        self._submitted: list[int] = []
        try:
            for i in range(n):
                dev = devices[i]
                if dev.type == "cuda" and dev.index is None:
                    dev = torch.device("cuda", i)
                with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    tts = build_tts(i)
                if tts.device != dev:
                    raise ValueError(f"build_tts({i}) built its TTS on {tts.device}, not on replica {i}'s {dev}")
                eng = ContinuousBatchingEngine(tts, **engine_kwargs)
                self.engines.append(eng)
                if warmup:
                    eng.warmup()
                self.devices.append(dev)
                self._submitted.append(0)
        except BaseException:
            self.shutdown()
            raise

    # --------------------------------------------------------------- engine API
    def _pick(self) -> int:
        # engine.load has a blind window (a request taken from the queue but
        # not yet slotted reads as 0), so a burst would pile onto one
        # replica; the submitted-count tiebreak round-robins equal loads
        return min(range(len(self.engines)), key=lambda i: (self.engines[i].load, self._submitted[i]))

    def submit(self, text: str, spk_ref_path: str, *, stream: bool = False, **sampling):
        """Route to the least-loaded replica (the engine's contract)."""
        i = self._pick()
        self._submitted[i] += 1
        return self.engines[i].submit(text, spk_ref_path, stream=stream, **sampling)

    @property
    def load(self) -> int:
        return sum(e.load for e in self.engines)

    @property
    def stats(self) -> dict:
        """Summed engine counters plus each replica's load (for /metrics)."""
        out: dict = {}
        for e in self.engines:
            for k, v in e.stats.items():
                out[k] = out.get(k, 0) + v
        for i, e in enumerate(self.engines):
            out[f"replica_{i}_load"] = e.load
            out[f"replica_{i}_submitted"] = self._submitted[i]
        return out

    def shutdown(self):
        for e in self.engines:
            e.shutdown()


__all__ = ["ReplicaPool"]
