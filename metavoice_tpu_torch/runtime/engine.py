"""Continuous-batching synthesis engine: mid-flight joins, per-slot streaming.

Port of metavoice_tpu/runtime/engine.py, with its scheduling:

  * a fixed SLOT POOL decodes in lockstep through one shared ``2 * slots``-row
    KV cache, in SEGMENTS of ``segment_tokens`` steps (first_stage.decode with
    ``pad_lens``: per-row windows and logical positions), one host read a
    segment;
  * between segments the worker admits queued requests into free slots: a
    joiner is prefilled into a 2-row temp cache and its rows are landed so
    that its prompt ENDS at the group's physical position P
    (first_stage.merge_slot_*; any alignment on the packed cache), with
    ``pad = P - len(prompt)``, so a join decodes as a fresh request would;
  * when the shared timeline nears ``block_size`` the dead prefix is
    reclaimed by sliding the cache left (first_stage.shift_*_left, REBASE);
  * rows that reach end-of-audio free their slot at the next boundary (an
    empty window, ``pad = pos``), and their render (second stage + vocoder +
    enhancer + write) runs on a 2-worker render pool while the group keeps
    decoding; STREAMING requests ride the same batch, their new tokens
    rendered in chained, coalescing renders a segment at a time;
  * an empty queue costs nothing: the worker blocks on it.

Threads and the card. One thread, the worker, launches every hand-written
kernel: the group prefill, the joins (temp prefill and merges), the segment
decodes and the rebases. The kernels' merge counters are per device and
the decode stack's scratch per shape, so two of their launches must not
overlap: one decode stream a device. A segment's steps (every route but
tensor parallelism's) are replays of CUDA graphs (first_stage.decode) with those counters
and that scratch baked in, so no eager step on another stream and no second
replay may overlap them either; they would race with no error. The renders
and the speaker embedding (in ``submit``, on the caller's thread) launch
only PyTorch's own kernels. On a card each render
task runs on a CUDA stream of its own (and the speaker embedding on one of
its own), so it does not queue behind the decode on the device's default
stream; every thread of an engine first enters the TTS's device, since the
current CUDA device is per thread and the kernel wrappers launch on it.

Random draws: the engine owns one generator on the device, seeded with
``runtime.seed + 1``; the worker's prefills, joins and decodes draw from it
in order. Each render takes a generator of its own, seeded by a draw the
worker makes where the JAX package splits a render key, so the order of
draws is the same from run to run.

Failures: an exception in the worker fails every request in flight and
rebuilds the cache on the same device. A CUDA error is sticky: after one the
process cannot serve, the rebuild raises too, and the engine then fails
everything queued and refuses new requests instead of carrying on.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.text import normalize_text
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.utils import audio_io as aio
from metavoice_tpu_torch.utils import phases


def land_rows(kv: tfm.KVCache, temp: tfm.KVCache, phys_start: int, row_c: int, row_u: int, n_head: int):
    """Land a 2-row temp cache (rows: cond, uncond) as rows ``row_c`` and
    ``row_u`` of ``kv`` at ``[phys_start, phys_start + Tpad)``, in any of the
    three formats (the packed one byte by byte, at any alignment)."""
    if kv.packed:
        fs.merge_slot_cache_packed(kv.k, kv.v, temp.k, temp.v, phys_start, row_c, row_u)
        fs.merge_slot_scales_packed(kv.k_scale, kv.v_scale, temp.k_scale, temp.v_scale, phys_start, row_c, row_u,
                                    n_head)
    else:
        fs.merge_slot_cache(kv.k, kv.v, temp.k, temp.v, phys_start, row_c, row_u)
        if kv.quantized:
            fs.merge_slot_scales(kv.k_scale, kv.v_scale, temp.k_scale, temp.v_scale, phys_start, row_c, row_u,
                                 n_head)


def shift_rows(kv: tfm.KVCache, s: int, pos: int):
    """Slide the valid prefix ``[s, pos)`` of every row of ``kv`` to the
    origin (a group rebase), in any of the three formats; ``s`` a multiple
    of ``first_stage.REBASE_ALIGN``, so that the packed words move whole."""
    if kv.packed:
        fs.shift_cache_left_packed(kv.k, kv.v, s, pos)
        fs.shift_scales_left_packed(kv.k_scale, kv.v_scale, s, pos)
    else:
        fs.shift_cache_left(kv.k, kv.v, s, pos)
        if kv.quantized:
            fs.shift_scales_left(kv.k_scale, kv.v_scale, s, pos)


def _enter_render_thread(device: torch.device):
    """Render-pool thread start: the engine's card and a stream of its own.
    A render launches PyTorch's kernels only, never a decode kernel or a
    decode graph: the worker's stream is the device's one decode stream."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.set_stream(torch.cuda.Stream(device))


class StreamHandle:
    """Iterator over wav segments of a streaming request.

    Yields float32 24 kHz arrays as decode progresses; raises the request's
    error (if any) from __next__. Obtained from ``submit(..., stream=True)``.
    """

    def __init__(self):
        self._q: "queue.Queue[np.ndarray | None | Exception]" = queue.Queue()
        self._closed = False

    def close(self):
        """Abandon the stream (e.g. the client disconnected): the engine
        frees the slot at the next segment boundary and stops rendering."""
        self._closed = True

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    # engine-side
    def _push(self, wav: np.ndarray):
        self._q.put(wav)

    def _finish(self, error: Exception | None = None):
        if error is not None:
            self._q.put(error)
        self._q.put(None)


@dataclass
class SynthesisRequest:
    text: str
    prompt_tokens: list
    spk_emb: np.ndarray
    top_p: float = 0.95
    guidance_scale: float = 3.0
    temperature: float = 1.0
    max_new_tokens: int | None = None  # per-request budget, cut at a segment boundary
    stream: bool = False
    future: Future = field(default_factory=Future)
    handle: StreamHandle | None = None


@dataclass
class _Slot:
    req: SynthesisRequest | None = None
    tokens: list = field(default_factory=list)  # generated audio tokens (no EOA)
    rendered: int = 0  # tokens already sent to a streaming render
    # a streaming request's renders are CHAINED on the render pool, so its
    # segments stay in order while the worker keeps decoding; chunks queue
    # in `pending` and each chained task renders ALL of it at once, so a
    # backlog coalesces into fewer, larger renders
    render_chain: Future | None = None
    pending: deque = field(default_factory=deque)
    lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def free(self) -> bool:
        return self.req is None


class ContinuousBatchingEngine:
    """Slot-pool continuous-batching engine around a TTS instance.

    ``submit`` returns a Future resolving to the output wav path, or (with
    ``stream=True``) a StreamHandle yielding wav segments. Requests join the
    running batch at the next segment boundary instead of waiting for the
    group to finish. ``pad_multiple`` is the prompt bucket; it must exceed
    16 tokens (first_stage.prefill_batch refuses a shorter bucket) and be a
    multiple of 4 with the packed int8 cache. ``slots="auto"`` sizes the
    pool from the card's memory (``_auto_slots``); on the CPU there is none
    to plan from, and it raises ``ValueError``.
    """

    def __init__(
        self,
        tts,
        slots: int | str = 8,
        segment_tokens: int = 64,
        pad_multiple: int = 128,
        min_decode_budget: int = 64,
        rebase_margin: int | None = None,
    ):
        if tts.tensor_parallel > 1:
            # the batched ragged decode (generate_batch, joins, rebase) is
            # single-device, as in the JAX package: scale throughput with
            # data-parallel replicas and latency with tensor_parallel on the
            # direct synthesise path
            raise ValueError(
                "the batching engine does not support tensor_parallel TTS instances; use tensor_parallel for the "
                "direct synthesise path and data-parallel replicas for batched serving"
            )
        if slots == "auto":
            slots = self._auto_slots(tts)
        if segment_tokens % 2 != 0:
            raise ValueError("segment_tokens must be even (whole frames)")
        if pad_multiple <= tfm.MULTI_MAX_T:
            raise ValueError(
                f"pad_multiple must exceed {tfm.MULTI_MAX_T} tokens: a shorter prompt bucket takes the "
                f"short-window route, which cannot mask the left padding (got {pad_multiple})"
            )
        if tts.kv_cache_dtype == "int8_packed" and pad_multiple % tfm.KV_PACK != 0:
            raise ValueError(
                f"pad_multiple must be a multiple of {tfm.KV_PACK} with the packed int8 KV cache (got {pad_multiple})"
            )
        self.tts = tts
        self.n_slots = slots
        # rebase when within this many positions of block_size (None: a quarter of the block)
        self.rebase_margin = rebase_margin if rebase_margin is not None else tts.c.first_stage_cfg.block_size // 4
        self.segment_tokens = segment_tokens
        self.pad_multiple = pad_multiple
        self.min_decode_budget = min_decode_budget
        self.device = tts.device
        self._cfg = tts.c.first_stage_cfg
        self._block = self._cfg.block_size
        self._cache_dtype = tts._cache_format(False)
        self._kv = self._new_cache()
        self._pos = 0
        # per-slot host state
        self._slots = [_Slot() for _ in range(slots)]
        self._cur = np.full((slots,), T.END_OF_AUDIO_TOKEN, np.int64)
        self._pad = np.zeros((slots,), np.int32)
        self._spk = np.zeros((slots, self._cfg.speaker_emb_dim), np.float32)
        self._t = np.ones((slots, 1), np.float32)
        self._p = np.full((slots, 1), 0.95, np.float32)
        self._g = np.full((slots, 1), 3.0, np.float32)
        self._gen = torch.Generator(device=self.device).manual_seed(tts.runtime.seed + 1)
        self._render_seeds = np.random.default_rng(tts.runtime.seed + 1)
        # a joiner's first token stays on the device until the segment's one
        # host read: reading it at join time would wait for the whole queue
        self._pending_first: dict[int, torch.Tensor] = {}
        self._queue: "queue.Queue[SynthesisRequest | None]" = queue.Queue()
        self._deferred: list[SynthesisRequest] = []
        self._broken: BaseException | None = None
        # held by submit's enqueue, shutdown and the worker's fatal path
        self._open_lock = threading.Lock()
        # scheduling counters (read by /metrics): row_tokens / (segments *
        # n_slots * segment_tokens) is the share of decoded rows doing real
        # work; groups and decode_steps count the group prefills and the T=1
        # steps the segments ran
        self.stats = {
            "rebases": 0, "reclaimed_positions": 0, "truncations": 0,
            "segments": 0, "row_tokens": 0, "joins": 0, "groups": 0, "decode_steps": 0,
        }
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the weights and cache are ready for every stream
        # the initializer takes the device, not the engine: a pool thread
        # holds its initializer while it lives, and a bound method would keep
        # the engine and its cache alive after shutdown
        self._render_pool = ThreadPoolExecutor(max_workers=2, initializer=_enter_render_thread,
                                               initargs=(self.device,))
        self._running = True
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @staticmethod
    def _auto_slots(tts) -> int:
        """The pool from the exact plan of the card's memory
        (utils/capacity.py): the weight mode from the TTS's first stage and
        the cache format from its runtime, as the JAX package's
        ``_auto_slots`` detects them (a groupwise int4 first stage is planned
        as bf16 there too), the largest slot count that fits, capped at
        ``MAX_AUTO_SLOTS``; at least 1."""
        from metavoice_tpu_torch.utils import capacity as cap

        if tts.device.type != "cuda":
            raise ValueError(f"slots='auto' plans from the card's memory, and {tts.device} has none to plan "
                             "from: pass a slot count")
        kvd = tts._cache_format(False)
        n = cap.max_slots(tts.c.first_stage_cfg, hbm_bytes=cap.device_memory_bytes(tts.device),
                          quantisation_mode=tts.quantisation_mode,
                          kv_cache_dtype=kvd if isinstance(kvd, str) else None,
                          limit=cap.MAX_AUTO_SLOTS)
        return max(1, n)

    def _new_cache(self) -> tfm.KVCache:
        return tfm.KVCache.create(self._cfg, 2 * self.n_slots, self._block, dtype=self._cache_dtype,
                                  device=self.device)

    def _on_device(self):
        """Enter the engine's card in this thread (a no-op on the CPU)."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" else contextlib.nullcontext()

    def _side_stream(self):
        """A CUDA stream of its own for work off the worker (a no-op on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    # ------------------------------------------------------------------ API
    @property
    def load(self) -> int:
        """Queued + in-flight request count (replica-pool dispatch signal).

        Racy by design: a point-in-time scheduling hint, not an invariant.
        """
        busy = sum(1 for s in self._slots if not s.free)
        return self._queue.qsize() + len(self._deferred) + busy

    def submit(self, text: str, spk_ref_path: str, *, stream: bool = False, **sampling):
        """Queue a request -> a Future of the wav path, or a StreamHandle.
        Raises RuntimeError once the engine is shut down or stopped by a
        failure it cannot recover from."""
        self._check_open()
        text = normalize_text(text)
        spk_ref_path = aio.get_cached_file(spk_ref_path)
        with self._on_device(), self._side_stream():
            spk_emb = self.tts._get_speaker_embedding(spk_ref_path)
        req = SynthesisRequest(
            text=text,
            prompt_tokens=self.tts.c.tokenizer.encode(text),
            spk_emb=np.asarray(spk_emb, np.float32).reshape(-1),
            stream=stream,
            **sampling,
        )
        if stream:
            req.handle = StreamHandle()
        # checked again under the lock that shutdown and the worker's fatal
        # path take before they drain the queue: a request queued after that
        # drain would wait for a worker that is gone
        with self._open_lock:
            self._check_open()
            self._queue.put(req)
        return req.handle if stream else req.future

    def _check_open(self):
        if self._broken is not None:
            raise RuntimeError(f"engine stopped after an unrecoverable failure: {self._broken!r}")
        if not self._running:
            raise RuntimeError("engine shut down")

    @torch.inference_mode()
    def warmup(self, prompt_buckets: tuple[int, ...] = (128, 256), warm_tts: bool = True):
        """Run the engine's whole envelope once before serving: the group
        prefill at each prompt bucket, a join (temp prefill and the cache
        landing), a segment decode and the rebase shifts, on the engine's own
        cache, so each route's kernels and merge counters exist before the
        first request, and each window bucket's decode step captured in its
        CUDA graph (``first_stage.capture_decode_graphs``). ``warm_tts``
        also runs ``TTS.warmup()`` (the kernel library and the render
        buckets). The draws come from a generator of
        its own; the group state is reset afterwards. Must run before
        serving traffic."""
        if self._actives():
            raise RuntimeError("engine warmup must run before serving traffic")
        if warm_tts:
            self.tts.warmup()
        c, cfg, dev = self.tts.c, self._cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(0)
        cdt = self.tts._compute_dtype
        prompt = [T.TEXT_OFFSET, T.TEXT_OFFSET + 1]
        t, p, g, spk = (torch.as_tensor(a, device=dev) for a in (self._t, self._p, self._g, self._spk))
        with self._on_device():
            for b in dict.fromkeys(self._bucket(x) for x in prompt_buckets):
                padded, lens = fs.left_pad_prompts([prompt] * self.n_slots, b)
                fs.prefill_batch(c.first_stage_params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev),
                                 torch.as_tensor(lens, device=dev), spk, self._kv, t, p, g, cdt, generator=gen)
                self._pos = b
                temp = tfm.KVCache.create(cfg, 2, b, dtype=self._cache_dtype, device=dev)
                padded1, lens1 = fs.left_pad_prompts([prompt], b)
                f1 = fs.prefill_batch(c.first_stage_params, cfg,
                                      torch.as_tensor(padded1, dtype=torch.int64, device=dev),
                                      torch.as_tensor(lens1, device=dev), spk[:1], temp, t[:1], p[:1], g[:1], cdt,
                                      generator=gen)
                self._land(temp, 0, 0)
            cur = torch.as_tensor(self._cur, device=dev)
            cur[0] = f1[0]
            buf, lens = fs.decode(c.first_stage_params, cfg, cur, self._pos, self._kv, spk, 2,
                                  temperature=t, top_p=p, guidance_scale=g,
                                  pad_lens=torch.as_tensor(self._pad, device=dev),
                                  end_of_audio_token=T.END_OF_AUDIO_TOKEN, compute_dtype=cdt, generator=gen)
            torch.cat([cur[:, None], lens[:, None], buf], dim=1).cpu()
            fs.capture_decode_graphs(c.first_stage_params, cfg, self._kv, spk, compute_dtype=cdt, generator=gen,
                                     pad_lens=torch.zeros((self.n_slots,), dtype=torch.int32, device=dev))
            shift_rows(self._kv, fs.REBASE_ALIGN, self._pos)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        # reset the group state: the next real group prefills from position 0
        self._pos = 0
        self._cur[:] = T.END_OF_AUDIO_TOKEN
        self._pad[:] = 0

    def shutdown(self):
        with self._open_lock:
            self._running = False
            self._queue.put(None)
        self._thread.join(timeout=10)
        # fail anything still in flight or queued so no caller blocks forever
        err = RuntimeError("engine shut down")
        for i, s in enumerate(self._slots):
            if not s.free:
                self._fail(i, err)
        self._fail_waiting(err)
        self._render_pool.shutdown(wait=False)

    def _fail_waiting(self, err: Exception):
        """Fail every deferred and queued request."""
        for req in self._deferred:
            self._fail_request(req, err)
        self._deferred = []
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                self._fail_request(req, err)

    # ------------------------------------------------------------------ worker
    def _actives(self) -> list[int]:
        return [i for i, s in enumerate(self._slots) if not s.free]

    def _worker(self):
        with self._on_device(), torch.inference_mode():
            self._serve()

    def _serve(self):
        while self._running:
            try:
                if not self._actives():
                    if self._deferred:
                        # deferred requests must not wait for an unrelated submit to wake the worker
                        self._start_group(self._drain_queue())
                    else:
                        req = self._queue.get()  # idle: block on the queue
                        if req is None:
                            if not self._running:
                                return
                            continue
                        self._start_group(self._drain_queue(first=req))
                else:
                    self._admit_joins()
                    self._step_segment()
            except Exception as e:
                # a failure anywhere (prefill, join, decode): fail every
                # request in flight and rebuild the cache on the same device
                self._pending_first.clear()
                for i in self._actives():
                    self._fail(i, e)
                self._kv = None  # free the old cache before making the new one
                try:
                    self._kv = self._new_cache()
                except Exception as fatal:  # a sticky CUDA error: this process cannot serve
                    with self._open_lock:
                        self._broken = fatal
                        self._running = False
                    self._fail_waiting(RuntimeError(f"engine stopped: {fatal!r}"))
                    return
                self._pos = 0
            if not self._running:
                return

    def _drain_queue(self, first=None) -> list[SynthesisRequest]:
        out = ([first] if first is not None else []) + self._deferred
        self._deferred = []
        while len(out) < self.n_slots:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)
                break
            out.append(nxt)
        return out

    def _knobs(self) -> tuple[torch.Tensor, ...]:
        """The per-row knobs and speakers on the device: (t, p, g, spk)."""
        return tuple(torch.as_tensor(a, device=self.device) for a in (self._t, self._p, self._g, self._spk))

    def _render_generator(self) -> torch.Generator:
        """A render's own generator, seeded by the worker's next draw."""
        return torch.Generator(device=self.device).manual_seed(int(self._render_seeds.integers(2**62)))

    # ------------------------------------------------------------------ group start
    def _bucket(self, n: int) -> int:
        b = max(self.pad_multiple, -(-n // self.pad_multiple) * self.pad_multiple)
        # cap so a group always keeps decode budget (an over-long prompt keeps its last tokens)
        cap = max(self.pad_multiple,
                  (self._block - self.min_decode_budget) // self.pad_multiple * self.pad_multiple)
        return min(b, cap)

    def _start_group(self, reqs: list[SynthesisRequest]):
        """A fresh group at physical position 0: one ragged batch prefill."""
        c, dev = self.tts.c, self.device
        self._deferred.extend(reqs[self.n_slots :])
        reqs = reqs[: self.n_slots]
        bucket = self._bucket(max(len(r.prompt_tokens) for r in reqs))
        prompts = []
        for i in range(self.n_slots):
            if i < len(reqs):
                r = reqs[i]
                self._slots[i] = _Slot(req=r)
                self._spk[i] = r.spk_emb
                self._t[i, 0] = r.temperature
                self._p[i, 0] = r.top_p
                self._g[i, 0] = r.guidance_scale
                prompts.append(r.prompt_tokens[-bucket:])
            else:
                self._slots[i] = _Slot()
                prompts.append([0])
        padded, pad_lens = fs.left_pad_prompts(prompts, bucket)
        t, p, g, spk = self._knobs()
        with phases.phase("eng.group_prefill"):
            first = fs.prefill_batch(
                c.first_stage_params, self._cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev),
                torch.as_tensor(pad_lens, device=dev), spk, self._kv, t, p, g, self.tts._compute_dtype,
                generator=self._gen,
            ).cpu().numpy()
        self.stats["groups"] += 1
        self._pos = bucket
        self._pad = np.asarray(pad_lens, np.int32).copy()
        for i in range(self.n_slots):
            if i < len(reqs):
                self._cur[i] = first[i]
                self._note_tokens(i, [int(first[i])])
            else:
                self._cur[i] = T.END_OF_AUDIO_TOKEN

    # ------------------------------------------------------------------ cache moves
    def _land(self, temp: tfm.KVCache, phys_start: int, slot: int):
        land_rows(self._kv, temp, phys_start, slot, self.n_slots + slot, self._cfg.n_local_heads)

    # ------------------------------------------------------------------ rebase
    def _maybe_rebase(self):
        """Reclaim the dead cache prefix when the timeline nears block_size.

        Every active row's valid window is [pad, pos); once the oldest active
        start s = min(pad) is far from the origin, slide the whole cache left
        by s (floored to REBASE_ALIGN): admissions reopen and late joiners
        regain budget instead of being truncated. Window contents, logical
        positions (pos - pad) and the draws are unchanged, so a rebased
        decode gives the unrebased one's tokens.
        """
        if self._pos < self._block - self.rebase_margin:
            return
        actives = self._actives()
        if not actives:
            return
        s = int(min(self._pad[i] for i in actives))
        s = (s // fs.REBASE_ALIGN) * fs.REBASE_ALIGN
        if s <= 0:
            return  # nothing to reclaim
        t0 = time.perf_counter() if phases.enabled() else 0.0
        shift_rows(self._kv, s, self._pos)
        if phases.enabled():
            phases.sync(self._kv.k)
            phases.add("eng.rebase", time.perf_counter() - t0)
        self._pos -= s
        self._pad = np.maximum(self._pad - s, 0)
        self.stats["rebases"] += 1
        self.stats["reclaimed_positions"] += s

    # ------------------------------------------------------------------ joining
    def _admit_joins(self):
        self._maybe_rebase()
        if self._pos >= self._block - self.min_decode_budget:
            return  # group near the block limit: no more admissions
        free = [i for i, s in enumerate(self._slots) if s.free]
        if not free:
            return
        for req in self._drain_queue():
            if not free:
                self._deferred.append(req)
                continue
            bucket = self._bucket(len(req.prompt_tokens))
            if bucket > self._pos:
                # longer than the elapsed timeline: it cannot end at P yet;
                # admitted a few segments later, or into the next group
                self._deferred.append(req)
                continue
            self._join(free.pop(0), req, bucket)

    def _join(self, slot: int, req: SynthesisRequest, bucket: int):
        """Prefill into a temp cache, then land the rows at [P - bucket, P)."""
        with phases.phase("eng.join"):
            self._join_inner(slot, req, bucket)
        self.stats["joins"] += 1

    def _join_inner(self, slot: int, req: SynthesisRequest, bucket: int):
        c, dev = self.tts.c, self.device
        # the joiner's knobs before its first token is sampled: a previous
        # occupant's must not leak into it
        self._t[slot, 0] = req.temperature
        self._p[slot, 0] = req.top_p
        self._g[slot, 0] = req.guidance_scale
        temp = tfm.KVCache.create(self._cfg, 2, bucket, dtype=self._cache_dtype, device=dev)
        padded, pad_lens = fs.left_pad_prompts([req.prompt_tokens[-bucket:]], bucket)
        knob = [torch.as_tensor(a[slot : slot + 1], device=dev) for a in (self._t, self._p, self._g)]
        first = fs.prefill_batch(
            c.first_stage_params, self._cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev),
            torch.as_tensor(pad_lens, device=dev), torch.as_tensor(req.spk_emb[None], device=dev), temp,
            *knob, self.tts._compute_dtype, generator=self._gen,
        )
        self._land(temp, self._pos - bucket, slot)
        phases.sync(self._kv.k)  # the merge's device time belongs to the join
        self._slots[slot] = _Slot(req=req)
        self._spk[slot] = req.spk_emb
        # window start = P - len(prompt): the logical positions continue the prompt's own
        self._pad[slot] = self._pos - min(len(req.prompt_tokens), bucket)
        self._pending_first[slot] = first.reshape(-1)  # read with the next segment

    # ------------------------------------------------------------------ decode segment
    def _step_segment(self):
        c, dev = self.tts.c, self.device
        if self._pos >= self._block:
            # physical timeline exhausted: truncate what is still active
            for i in self._actives():
                self.stats["truncations"] += 1
                self._complete(i)
            return
        seg = min(self.segment_tokens, self._block - self._pos)
        # joiners' first tokens go into cur on the device and ride the segment's one read
        cur = torch.as_tensor(self._cur, device=dev)
        for slot, fd in self._pending_first.items():
            cur[slot] = fd[0]
        t, p, g, spk = self._knobs()
        run = {}
        with phases.phase("eng.decode"):
            buf, lens = fs.decode(
                c.first_stage_params, self._cfg, cur, self._pos, self._kv, spk, seg,
                temperature=t, top_p=p, guidance_scale=g, pad_lens=torch.as_tensor(self._pad, device=dev),
                end_of_audio_token=T.END_OF_AUDIO_TOKEN, compute_dtype=self.tts._compute_dtype,
                generator=self._gen, stats=run,
            )
            fetch = torch.cat([cur[:, None], lens[:, None].to(cur.dtype), buf.to(cur.dtype)], dim=1)
            fetch = fetch.cpu().numpy()
        cur_h, lens_h = fetch[:, 0], fetch[:, 1]
        # the joiners' first tokens come before this segment's tokens of their slot
        pend, self._pending_first = self._pending_first, {}
        for slot in sorted(pend):
            if self._slots[slot].free:
                continue
            self._cur[slot] = cur_h[slot]
            self._note_tokens(slot, [int(cur_h[slot])])
        # decode runs up to DONE_CHECK_EVERY - 1 steps past the last live
        # row's end; those steps write slots past the new pos, which the next
        # segment rewrites before any window reads them
        steps = int(lens_h.max()) if len(lens_h) else 0
        self.stats["decode_steps"] += run["decode_steps"]
        self.stats["segments"] += 1
        self.stats["row_tokens"] += int(lens_h.sum())
        if steps == 0:
            for i in self._actives():  # no row advanced: finish the actives
                self._complete(i)
            return
        self._pos += steps
        with phases.phase("eng.note"):
            for i in self._actives():
                n = int(lens_h[i])
                if n == 0:
                    continue
                toks = fetch[i, 2 : 2 + n].tolist()
                self._cur[i] = toks[-1]
                self._note_tokens(i, toks)

    # ------------------------------------------------------------------ per-slot plumbing
    def _note_tokens(self, slot: int, toks: list):
        """Record newly decoded tokens; stream or complete as they land."""
        s = self._slots[slot]
        if s.req is not None and s.req.stream and s.req.handle._closed:
            # the client abandoned the stream: free the slot, stop decoding it
            self._slots[slot] = _Slot()
            self._cur[slot] = T.END_OF_AUDIO_TOKEN
            self._pad[slot] = self._pos  # an empty window: lets min(starts) rise
            s.req.handle._finish()
            return
        finished = False
        for t in toks:
            if t == T.END_OF_AUDIO_TOKEN:
                finished = True
                break
            s.tokens.append(int(t))
        if s.req is not None and s.req.max_new_tokens is not None and len(s.tokens) >= s.req.max_new_tokens:
            s.tokens = s.tokens[: s.req.max_new_tokens]
            finished = True
        if s.req is not None and s.req.stream and not finished:
            self._stream_render(slot)
        if finished:
            self._complete(slot)

    def _chain_render(self, s: _Slot, fn):
        """Queue ``fn`` on the render pool strictly after this slot's previous
        render, so a request's segments arrive in order, without blocking the
        worker and without a pool worker waiting on another (chained by a
        done-callback)."""
        done = Future()

        def run():
            try:
                fn()
            finally:
                done.set_result(None)

        prev, s.render_chain = s.render_chain, done
        if prev is None:
            try:
                self._render_pool.submit(run)
            except RuntimeError:  # pool shut down: run inline, so a stream's finalize still closes its handle
                run()
        else:

            def _go(_):
                try:
                    self._render_pool.submit(run)
                except RuntimeError:  # pool shut down mid-chain
                    run()

            prev.add_done_callback(_go)

    def _render_stream_chunk(self, req: SynthesisRequest, toks: np.ndarray, gen: torch.Generator):
        with phases.phase("eng.stream_render"):
            wav = self.tts._tokens_to_wav(req.text, req.prompt_tokens, toks, req.spk_emb, generator=gen,
                                          streaming_segment=True)
        req.handle._push(wav)

    def _stream_render(self, slot: int):
        """Queue this slot's un-rendered whole frames for a render.

        The worker only moves the chunk into ``pending``; each chained task
        renders everything pending at once. A render that raises
        RuntimeError (no whole audio frame in the span yet) puts its tokens
        back at the front of ``pending``.
        """
        s = self._slots[slot]
        req = s.req
        avail = len(s.tokens) - s.rendered
        if avail < self.segment_tokens:
            return  # a full segment first
        n = (avail // 2) * 2
        chunk = np.asarray(s.tokens[s.rendered : s.rendered + n], np.int32)
        s.rendered += n
        with s.lock:
            s.pending.append(chunk)
        gen = self._render_generator()

        def task():
            with s.lock:
                if not s.pending:
                    return  # drained by an earlier coalesced render
                parts = list(s.pending)
                s.pending.clear()
            toks = parts[0] if len(parts) == 1 else np.concatenate(parts)
            try:
                self._render_stream_chunk(req, toks, gen)
            except RuntimeError:
                with s.lock:  # no complete audio frame yet: retry with the next chunk
                    s.pending.appendleft(toks)
            except Exception as e:  # surface other render errors to the consumer
                req.handle._finish(e)

        self._chain_render(s, task)

    def _complete(self, slot: int):
        s = self._slots[slot]
        req = s.req
        self._slots[slot] = _Slot()  # free at once; render off the worker
        self._cur[slot] = T.END_OF_AUDIO_TOKEN
        # a freed row's window is empty: its start moves to pos, so the
        # kernels' min(starts) rises and a rebase can reclaim more
        self._pad[slot] = self._pos
        if req is None:
            return
        if req.stream:
            self._finalize_stream(s, req)  # behind the request's renders in flight
            return
        self._render_pool.submit(self._render_full, req, list(s.tokens), self._render_generator())

    def _finalize_stream(self, s: _Slot, req: SynthesisRequest):
        n = ((len(s.tokens) - s.rendered) // 2) * 2
        if n > 0:
            with s.lock:
                s.pending.append(np.asarray(s.tokens[s.rendered : s.rendered + n], np.int32))
            s.rendered += n
        gen = self._render_generator()

        def task():
            try:
                with s.lock:
                    parts = list(s.pending)
                    s.pending.clear()
                if parts:
                    toks = parts[0] if len(parts) == 1 else np.concatenate(parts)
                    try:
                        self._render_stream_chunk(req, toks, gen)
                    except RuntimeError:
                        pass  # the leftover tokens held no whole audio frame
                req.handle._finish()
            except Exception as e:
                req.handle._finish(e)

        self._chain_render(s, task)

    def _render_full(self, req: SynthesisRequest, tokens: list, gen: torch.Generator):
        try:
            if not tokens:
                raise RuntimeError(f"first stage produced no audio tokens for: {req.text!r}")
            with phases.phase("eng.render_full"):
                wav = self.tts._tokens_to_wav(req.text, req.prompt_tokens, np.asarray(tokens, np.int32),
                                              req.spk_emb, generator=gen)
            with phases.phase("eng.write_wav"):
                req.future.set_result(self.tts.write_wav_output(req.text, wav))
        except Exception as e:
            req.future.set_exception(e)

    def _fail(self, slot: int, e: Exception):
        s = self._slots[slot]
        self._slots[slot] = _Slot()
        self._cur[slot] = T.END_OF_AUDIO_TOKEN
        self._pad[slot] = self._pos
        if s.req is not None:
            self._fail_request(s.req, e)

    @staticmethod
    def _fail_request(req: SynthesisRequest, e: Exception):
        if req.stream:
            req.handle._finish(e)
        elif not req.future.done():
            req.future.set_exception(e)

