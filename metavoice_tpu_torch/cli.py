"""Command-line interface of the PyTorch port: ``python -m metavoice_tpu_torch.cli
{synth|serve|quantize|capacity|finetune} [args]``, with the JAX package's
commands, arguments and defaults (metavoice_tpu/cli.py), plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path).

  * ``synth``: texts and one speaker reference -> wav files, with the
    reference's sampling defaults (``--guidance_scale`` one value, or two for
    (speaker, prompt) guidance);
  * ``serve``: the HTTP server (runtime/server.py), with ``--batching N|auto``
    on the continuous-batching engine and ``--replicas N`` on
    runtime/replicas.ReplicaPool; SIGTERM or SIGINT stop it cleanly;
  * ``synth`` and ``serve`` with ``--tensor_parallel N``: N ranks, one
    process and one card each over NCCL (``--device cpu``: N CPU ranks over
    gloo), started by ``parallel/mesh.spawn``; the first stage runs
    Megatron TP over them. ``serve``'s rank 0 runs the HTTP server and
    sends each request's arguments to the other ranks, which run the same
    synthesis; it serves without the batching engine, as in the JAX package;
  * ``quantize``: a first-stage ``.pt`` -> a pre-quantized serving ``.npz``,
    key for key and bit for bit the JAX package's;
  * ``capacity``: the device-memory plan of a serving configuration
    (utils/capacity.py), against the card's memory or ``--hbm_gib``;
  * ``finetune``: the first-stage finetuning loop (training/trainer.py) on a
    "|"-separated CSV dataset, with ``--device`` too.
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import sys

QUANT_MODES = ["int4", "int8", "int8_packed", "int8_plain"]


def _add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--first_stage_path", help="first-stage checkpoint (.pt, or a native/quantized .npz)")
    ap.add_argument("--second_stage_path", help="second-stage checkpoint (.pt or .npz)")
    ap.add_argument("--speaker_encoder_path", help="speaker encoder checkpoint (.pt)")
    ap.add_argument("--encodec_path", help="pretrained EnCodec 24 kHz vocoder (encodec-package .pt or native "
                                           ".npz); without it the vocoder is random-weight")
    ap.add_argument("--random_weights", action="store_true", help="dev mode: random init")
    ap.add_argument("--small", action="store_true", help="small dev models")
    ap.add_argument("--quantisation_mode", choices=QUANT_MODES,
                    help="weight-only quantisation of the first stage (int8 = int8-in-int32 packed; "
                         "int8_plain = plain int8 arrays)")
    ap.add_argument("--kv_cache_dtype", choices=["int8", "int8_packed"],
                    help="quantize the first-stage KV cache (half the bf16 cache's bytes); 'int8_packed' "
                         "stores the same values four to an int32 word")
    ap.add_argument("--draft_checkpoint", help="small first-stage-format checkpoint (.pt/.npz) enabling "
                                               "speculative decoding for single-stream synthesis")
    ap.add_argument("--speculative_gamma", type=int, default=4,
                    help="tokens proposed a speculation round (with --draft_checkpoint)")
    ap.add_argument("--draft_no_cfg", action="store_true",
                    help="run the draft without classifier-free guidance")
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--output_dir", default="outputs")
    ap.add_argument("--tensor_parallel", type=int, default=1,
                    help="shard the first stage Megatron-style over this many ranks, one process and one card "
                         "each (parallel/tp_decode.py); needs a dense .pt first stage, not a pre-quantized .npz")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def _build_tts(args):
    """The TTS the model arguments ask for, on ``--device`` ("cuda": the
    thread's current card, which a replica pool sets)."""
    from metavoice_tpu_torch.runtime.tts import TTS

    common = dict(output_dir=args.output_dir, quantisation_mode=args.quantisation_mode,
                  kv_cache_dtype=args.kv_cache_dtype, tensor_parallel=args.tensor_parallel,
                  device=args.device)
    if args.random_weights or not args.first_stage_path:
        return TTS.from_random(small=args.small, seed=args.seed, **common)
    return TTS.from_checkpoints(
        args.first_stage_path, args.second_stage_path, args.speaker_encoder_path,
        encodec_path=args.encodec_path, draft_checkpoint=args.draft_checkpoint,
        speculative_gamma=args.speculative_gamma, draft_use_cfg=not args.draft_no_cfg, seed=args.seed, **common,
    )


def cmd_synth(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="metavoice_tpu_torch synth")
    _add_model_args(ap)
    ap.add_argument("--text", action="append", required=True, help="repeatable")
    ap.add_argument("--spk_cond_path", required=True, help="speaker reference audio")
    ap.add_argument("--top_p", type=float, default=0.95)
    ap.add_argument("--guidance_scale", type=float, nargs="+", default=[3.0], metavar="SCALE",
                    help="one value: speaker CFG. Two values: (speaker, prompt) double guidance; a prompt "
                         "scale above 1 takes 3 cache rows")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--max_new_tokens", type=int, default=None,
                    help="cap on the first stage's tokens a chunk (default: to end-of-audio)")
    args = ap.parse_args(argv)
    if len(args.guidance_scale) > 2:
        ap.error("--guidance_scale takes one or two values")
    guidance = args.guidance_scale[0] if len(args.guidance_scale) == 1 else tuple(args.guidance_scale)

    if args.tensor_parallel > 1:
        from metavoice_tpu_torch.parallel import mesh as pmesh

        pmesh.spawn(_synth_rank, args.tensor_parallel, args=(args, guidance), devices=_tp_devices(args),
                    timeout=_TP_TIMEOUT_S)
    else:
        _synth_rank(0, args, guidance)
    return 0


def _synth_rank(rank: int, args, guidance) -> None:
    """One rank of ``synth`` (the whole of it without TP): each text's wav
    path printed (a TP rank other than the leader writes none)."""
    tts = _build_tts(args)
    for text in args.text:
        path = tts.synthesise(text, args.spk_cond_path, top_p=args.top_p, guidance_scale=guidance,
                              temperature=args.temperature, max_new_tokens=args.max_new_tokens)
        if path is not None:
            print(path, flush=True)


_TP_TIMEOUT_S = 1800.0  # a TP rank's collectives: a long rendering on the leader keeps the others waiting
_TP_IDLE = datetime.timedelta(days=365)  # a serving follower waits this long for the next request


def _tp_devices(args) -> list[str]:
    """One device a TP rank: the CPU with ``--device cpu``, else one card a
    rank (NCCL holds one rank a card)."""
    n = args.tensor_parallel
    if args.device == "cpu":
        return ["cpu"] * n
    import torch

    if n > torch.cuda.device_count():
        raise ValueError(f"--tensor_parallel {n} needs {n} cards, one a rank; this machine has "
                         f"{torch.cuda.device_count()}")
    return [f"cuda:{r}" for r in range(n)]


class _TPLeader:
    """The serving rank's TTS: each synthesis call first sends its name and
    arguments to the other ranks of the tensor group (``_tp_follow``), which
    run the same call; every other attribute is the TTS's own."""

    def __init__(self, tts, group, src: int):
        self._tts, self._group, self._src = tts, group, src

    def __getattr__(self, name):
        return getattr(self._tts, name)

    def _send(self, msg) -> None:
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=self._src, group=self._group)

    def synthesise(self, *a, **kw):
        self._send(("synthesise", a, kw))
        return self._tts.synthesise(*a, **kw)

    def synthesise_streaming(self, *a, **kw):
        self._send(("synthesise_streaming", a, kw))
        return self._tts.synthesise_streaming(*a, **kw)

    def stop(self) -> None:
        self._send(None)


def _tp_follow(tts, group, src: int) -> None:
    """A serving rank other than the leader: run each call the leader sends
    until it sends None. A call that fails fails on the leader too, which
    reports it; the loop goes on."""
    import traceback

    import torch.distributed as dist

    while True:
        box = [None]
        dist.broadcast_object_list(box, src=src, group=group)
        if box[0] is None:
            return
        name, a, kw = box[0]
        try:
            out = getattr(tts, name)(*a, **kw)
            if name == "synthesise_streaming":
                for _ in out:
                    pass
        except Exception:
            traceback.print_exc()


def cmd_serve(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="metavoice_tpu_torch serve")
    _add_model_args(ap)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=58003)
    ap.add_argument("--batching", type=str, default="0", metavar="MAX_BATCH",
                    help="serve through the continuous-batching engine with this many slots; 'auto' sizes "
                         "the pool from the card's memory (utils/capacity.py)")
    ap.add_argument("--no_warmup", action="store_true", help="skip the warmup")
    ap.add_argument("--max_new_tokens", type=int, default=None,
                    help="cap on a request's first-stage tokens a chunk (default: to end-of-audio)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replicas: one model + engine a device, requests routed to the "
                         "least loaded (runtime/replicas.py); implies batching")
    args = ap.parse_args(argv)
    if args.batching != "auto":
        try:
            args.batching = int(args.batching)
        except ValueError:
            ap.error("--batching must be an integer or 'auto'")
    if args.tensor_parallel > 1:
        return _serve_tp(args)

    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine

    if args.replicas > 1:
        from metavoice_tpu_torch.runtime.replicas import ReplicaPool

        print(f"building {args.replicas} data-parallel replicas...", flush=True)
        slots = "auto" if args.batching == "auto" else args.batching if args.batching > 0 else 8
        devices = [args.device] * args.replicas if args.device == "cpu" else None
        engine = ReplicaPool(lambda i: _build_tts(args), n_replicas=args.replicas, devices=devices,
                             warmup=not args.no_warmup, slots=slots)
        tts = engine.engines[0].tts
        print(f"replica engines: {[e.n_slots for e in engine.engines]} slots", flush=True)
    else:
        tts = _build_tts(args)
        if not args.no_warmup:
            print("warming up...", flush=True)
            tts.warmup()
        engine = None
        if args.batching == "auto" or args.batching > 0:
            engine = ContinuousBatchingEngine(tts, slots=args.batching)
            if args.batching == "auto":
                print(f"auto-sized batching engine: {engine.n_slots} slots", flush=True)
            if not args.no_warmup:
                print("warming up the batching engine...", flush=True)
                engine.warmup(warm_tts=False)  # tts.warmup() already ran
    return _serve_http(args, tts, engine)


def _serve_tp(args) -> int:
    """``serve --tensor_parallel N``: N ranks (``_serve_rank``); SIGTERM or
    SIGINT to this process reach them, and rank 0 stops the server."""
    import multiprocessing
    import signal

    from metavoice_tpu_torch.parallel import mesh as pmesh

    if args.replicas > 1 or args.batching != 0:
        raise ValueError("--tensor_parallel serves through the direct synthesise path: the batching engine and "
                         "replicas do not support tensor_parallel")
    devices = _tp_devices(args)

    def forward(signum, frame):
        for proc in multiprocessing.active_children():
            os.kill(proc.pid, signal.SIGTERM)

    before = {sig: signal.signal(sig, forward) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        pmesh.spawn(_serve_rank, args.tensor_parallel, args=(args,), devices=devices, timeout=_TP_TIMEOUT_S,
                    deadline=math.inf)  # a server runs until it is stopped
    finally:
        for sig, handler in before.items():
            signal.signal(sig, handler)
    return 0


def _serve_rank(rank: int, args) -> None:
    """One rank of ``serve --tensor_parallel``: every rank builds (and warms
    up) the TTS, then serves it (``serve_tp_rank``)."""
    tts = _build_tts(args)
    if not args.no_warmup:
        print("warming up...", flush=True)
        tts.warmup()
    serve_tp_rank(tts, args)


def serve_tp_rank(tts, args) -> None:
    """A rank of a TP TTS in ``serve``: the tensor group's leader serves
    HTTP (``args.host``, ``args.port``, ``args.output_dir``,
    ``args.max_new_tokens``) through a ``_TPLeader`` until SIGTERM or
    SIGINT, the other ranks follow it until it stops."""
    import signal

    import torch.distributed as dist

    src = tts.mesh.tensor_ranks[0]
    # the requests' channel: a follower waits on it for as long as the server is idle
    control = dist.new_group(list(tts.mesh.tensor_ranks), backend="gloo", timeout=_TP_IDLE)
    if not tts.mesh.leader:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, signal.SIG_IGN)  # the leader stops the followers
        _tp_follow(tts, control, src)
        return
    leader = _TPLeader(tts, control, src)
    try:
        _serve_http(args, leader, None)
    finally:
        leader.stop()


def _serve_http(args, tts, engine) -> int:
    """The HTTP server over ``tts`` (and ``engine``) until SIGTERM or SIGINT."""
    import signal
    import threading
    from http.server import ThreadingHTTPServer

    from metavoice_tpu_torch.runtime.server import ServingConfig, make_handler

    cfg = ServingConfig(host=args.host, port=args.port, output_dir=args.output_dir,
                        max_new_tokens=args.max_new_tokens)
    httpd = ThreadingHTTPServer((cfg.host, cfg.port), make_handler(tts, cfg, engine))
    print(f"serving on {cfg.host}:{httpd.server_address[1]}", flush=True)

    # SIGTERM / SIGINT: stop accepting, let the engine finish what it holds, exit 0
    def _stop(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        httpd.serve_forever()
    finally:
        if engine is not None:
            engine.shutdown()
        httpd.server_close()
        print("server stopped", flush=True)
    return 0


def quantize_first_stage(params, mode: str):
    """A dense first stage -> the serving tree of ``mode`` (the JAX
    ``cmd_quantize``'s: ``"int8_packed"`` is ``"int8"``, the int8-in-int32
    format)."""
    from metavoice_tpu_torch.ops import quantized as qz

    if mode == "int8":
        return qz.quantize_params_int8_i32(params)
    if mode == "int8_plain":
        return qz.quantize_params_int8(params)
    return qz.quantize_params_int4_i32(params)


def _sorted_keys(tree):
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted_keys(v) for v in tree]
    return tree


def cmd_quantize(argv: list[str]) -> int:
    """Quantize a first-stage checkpoint offline into a serving ``.npz``: the
    ``.pt`` read in f32 and rounded to bf16, quantized on ``--device``, and
    written as the JAX package's ``cmd_quantize`` writes it; the packed
    arrays load directly at serve time (``TTS.from_checkpoints``)."""
    ap = argparse.ArgumentParser(prog="metavoice_tpu_torch quantize")
    ap.add_argument("--first_stage_path", required=True, help="first-stage .pt")
    ap.add_argument("--mode", choices=QUANT_MODES, default="int4")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--device", default="cuda", help="where to quantize: cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import os

    import torch

    from metavoice_tpu_torch.utils import checkpoint as ck

    # np.savez appends ".npz" to a path without it: report the file it writes
    if not args.out.endswith(".npz"):
        args.out += ".npz"
    params, cfg, tok_info = ck.load_first_stage_pt(args.first_stage_path, dtype=torch.bfloat16,
                                                   device=args.device)
    mode = "int8" if args.mode == "int8_packed" else args.mode
    # the JAX package's bf16 cast (jax.tree.map) sorts every dict's keys, and its file keeps that order
    ck.save_first_stage_quantized(args.out, quantize_first_stage(_sorted_keys(params), mode), cfg, tok_info, mode)
    print(f"{args.out}: {os.path.getsize(args.out) / 1e9:.2f} GB ({mode})")
    return 0


def cmd_capacity(argv: list[str]) -> int:
    """Plan the device memory of a serving configuration: the exact weights
    and cache bytes (utils/capacity.py), the plan and the largest slot count
    that fits."""
    ap = argparse.ArgumentParser(prog="metavoice_tpu_torch capacity")
    ap.add_argument("--quantisation_mode", choices=QUANT_MODES, default="int4")
    ap.add_argument("--kv_cache_dtype", choices=["int8", "int8_packed"], default=None)
    ap.add_argument("--slots", type=int, default=8, help="engine slot count")
    ap.add_argument("--block_size", type=int, default=None)
    ap.add_argument("--cfg_rows", type=int, default=2, choices=[2, 3],
                    help="cache rows a slot (3 with prompt guidance)")
    ap.add_argument("--hbm_gib", type=float, default=None,
                    help="device memory to plan for, in GiB (default: the card's)")
    ap.add_argument("--device", default="cuda", help="the card whose memory is planned for")
    args = ap.parse_args(argv)

    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.utils import capacity as cap

    hbm = int(args.hbm_gib * 1024**3) if args.hbm_gib is not None else cap.device_memory_bytes(args.device)
    cfg = first_stage_config()
    kwargs = dict(quantisation_mode=args.quantisation_mode, kv_cache_dtype=args.kv_cache_dtype,
                  block_size=args.block_size, cfg_rows=args.cfg_rows, hbm_bytes=hbm)
    print(cap.memory_plan(cfg, slots=args.slots, **kwargs).describe())
    print(f"max slots at this config: {cap.max_slots(cfg, **kwargs)}")
    return 0


def cmd_finetune(argv: list[str]) -> int:
    from metavoice_tpu_torch.training import trainer

    return trainer.main(argv)


COMMANDS = {"synth": cmd_synth, "serve": cmd_serve, "finetune": cmd_finetune, "quantize": cmd_quantize,
            "capacity": cmd_capacity}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m metavoice_tpu_torch.cli {{{'|'.join(COMMANDS)}}} [args]")
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
