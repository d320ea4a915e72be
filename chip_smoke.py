#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (metavoice_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. device  - needs torch.cuda.is_available(); prints the card's name and
               power limit as nvidia-smi gives them;
  2. build   - builds every kernel from metavoice_tpu_torch/csrc with nvcc;
  3. K1      - the decode-attention kernel against its plain PyTorch version
               at the main-path shape (L=24, S=2048, B=2, H=16, Dh=128, bf16):
               y within atol/rtol 2e-2 of the plain version (f32 inside,
               rounded to bf16), caches bit-identical; CUDA-event times;
  4. small   - the first stage on the card (f32) against the CPU path on a
               small model with the same weights and Gumbel noise: same tokens;
  5. synth   - full-width TTS.synthesise on random weights (first stage
               24L/16H/2048d, default second stage and EnCodec): a finite
               24 kHz wav, and the K1 launch count equal to n_layer x decode
               steps of that run.

The two lines before the last are the kernels' JSON record and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}. TF32 is
off for matmuls and convolutions throughout, so every comparison is f32.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = dict(l=24, s=2048, b=2, h=16, dh=128)
K1_TOL = 2e-2
TIMED_POS = (256, 1000, 2047)  # the JSON line carries the last one


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from metavoice_tpu_torch.ops import _build

    lib = _build.kernels()
    regs = [ln.split(":", 1)[1].strip() for ln in lib.build_log.splitlines() if "registers" in ln]
    print(f"[2 build] {lib.build_seconds:.2f} s nvcc -> {lib.path.name}; ptxas: {regs}")


def _k1_inputs(torch, gen, dev, pos=None, garbage=None):
    l, s, b, h, dh = (MAIN_SHAPE[k] for k in ("l", "s", "b", "h", "dh"))

    def t(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    q, k_new, v_new = t(b, h, dh), t(b, h, dh), t(b, h, dh)
    k_cache, v_cache = t(l, s, b, h, dh), t(l, s, b, h, dh)
    if garbage is not None:
        k_cache[:, pos + 1 :] = garbage
        v_cache[:, pos + 1 :] = garbage
    return q, k_new, v_new, k_cache, v_cache


def _time_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of fn() from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _layers_ms(torch, fn, n_layer: int) -> tuple[float, float]:
    """(device ms, host-inclusive ms) per call of fn(layer), one call per
    layer in turn as a decode step makes them, so that a layer's cache
    window is not in the 50 MB L2 from the call before. Device time replays
    the n_layer calls captured in a CUDA graph; host-inclusive time issues
    them one by one from Python."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for li in range(n_layer):
            fn(li)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for li in range(n_layer):
            fn(li)
    device = _time_ms(torch, graph.replay, 20) / n_layer
    host = _time_ms(torch, lambda: [fn(li) for li in range(n_layer)], 10) / n_layer
    return device, host


def phase_k1(torch) -> dict:
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    layer = 5
    cases = [(p, None, None) for p in (0, 1, 255, 256, 1000, 2047)]
    cases += [(1000, (300, 700), None), (1000, None, float("nan"))]
    max_err = 0.0
    for pos, starts, garbage in cases:
        q, k_new, v_new, kc, vc = _k1_inputs(torch, gen, dev, pos, garbage)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        y_ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc_ref, vc_ref, layer, pos, st)
        y, _, _ = A.decode_attention(q, k_new, v_new, kc, vc, layer, pos, st)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            fail(f"K1 output not finite at pos {pos} starts {starts} garbage {garbage}")
        if not (torch.equal(kc.view(torch.int16), kc_ref.view(torch.int16))
                and torch.equal(vc.view(torch.int16), vc_ref.view(torch.int16))):
            fail(f"K1 caches differ from the plain version at pos {pos}")
        err = (y.float() - y_ref.float()).abs().max().item()
        max_err = max(max_err, err)
        try:
            torch.testing.assert_close(y.float(), y_ref.float(), atol=K1_TOL, rtol=K1_TOL)
        except AssertionError as e:
            fail(f"K1 disagrees with the plain version at pos {pos} starts {starts}: {e}")
    times = {}
    q, k_new, v_new, kc, vc = _k1_inputs(torch, gen, dev)
    n_layer = MAIN_SHAPE["l"]
    for pos in TIMED_POS:
        kernel = _layers_ms(torch, lambda li: A.decode_attention(q, k_new, v_new, kc, vc, li, pos), n_layer)
        plain = _layers_ms(
            torch, lambda li: A.decode_attention_reference(q, k_new, v_new, kc, vc, li, pos), n_layer
        )
        times[pos] = (kernel, plain)
    window_bytes = lambda p: 2 * (p + 1) * q.numel() * q.element_size()  # noqa: E731
    shown = "; ".join(
        f"pos {p}: kernel {k[0]:.4f} ms ({window_bytes(p) / k[0] / 1e6:.0f} GB/s), "
        f"plain {pl[0]:.4f} ms on the device; {k[1]:.4f} / {pl[1]:.4f} ms a call from Python"
        for p, (k, pl) in times.items()
    )
    print(f"[3 K1] {len(cases)} cases at {MAIN_SHAPE} bf16 agree (max |dy| {max_err:.3g}, "
          f"caches bit-identical); {shown}")
    (ms, _), (plain, _) = times[TIMED_POS[-1]]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain}


def phase_small(torch):
    """First stage on the card (f32) vs the CPU path, same weights and noise."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm

    cfg = first_stage_config(n_layer=2, n_head=4, dim=512, block_size=512)
    gen = torch.Generator().manual_seed(7)
    params = tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.float32)
    spk = torch.randn(256, generator=gen).numpy()
    prompt = list(range(2100, 2140))
    n = 48
    noise = S.gumbel_noise((n, 1, cfg.vocab_size), device="cpu", generator=gen)
    kw = dict(max_new_tokens=n, compute_dtype=torch.float32)
    tok_cpu = fs.generate(params, cfg, prompt, spk, noise=noise, **kw)

    def to_cuda(node):
        if isinstance(node, dict):
            return {k: to_cuda(v) for k, v in node.items()}
        if isinstance(node, list):
            return [to_cuda(v) for v in node]
        return node.cuda()

    tok_gpu = fs.generate(to_cuda(params), cfg, prompt, spk, noise=noise.cuda(), **kw)
    if not (tok_cpu.shape == tok_gpu.shape and (tok_cpu == tok_gpu).all()):
        fail(f"first stage on the card differs from the CPU path: {tok_gpu} vs {tok_cpu}")
    print(f"[4 small] first stage (2L/512d, f32) on the card == CPU path: "
          f"{len(tok_gpu) - len(prompt)} tokens identical")


def phase_synth(torch, workdir: str) -> int:
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.runtime.tts import TTS
    from metavoice_tpu_torch.utils import audio_io as aio
    import numpy as np

    sr = 24000
    t = np.arange(30 * sr) / sr
    ref = os.path.join(workdir, "ref.wav")
    aio.write_wav(ref, 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)), sr)
    t0 = time.perf_counter()
    tts = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg1 = tts.c.first_stage_cfg
    A.decode_attention.launches = 0
    t0 = time.perf_counter()
    path = tts.synthesise(
        "The quick brown fox jumps over the lazy dog, twice.", ref, max_new_tokens=192
    )
    total_s = time.perf_counter() - t0
    launches = A.decode_attention.launches
    steps = tts.stats["decode_steps"]
    if launches == 0 or launches != cfg1.n_layer * steps:
        fail(f"K1 launches {launches} != n_layer {cfg1.n_layer} x decode steps {steps}")
    wav, wav_sr = aio.read_wav(path)
    if wav_sr != sr or len(wav) == 0 or not np.isfinite(wav).all():
        fail(f"bad wav: sr {wav_sr}, {len(wav)} samples, finite {np.isfinite(wav).all()}")
    stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
    print(f"[5 synth] {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d: init {init_s:.2f} s; "
          f"synthesise {total_s:.2f} s ({stages} s); {steps} decode steps, "
          f"{launches} K1 launches; wav {len(wav)} samples ({len(wav) / sr:.2f} s) finite")
    return launches


def main() -> int:
    import torch

    smi = phase_device(torch)
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    phase_build()
    k1 = phase_k1(torch)
    phase_small(torch)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_synth(torch, workdir)
    record = {"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "metavoice_tpu_torch/csrc/decode_attention.cu",
        "replaces": "metavoice_tpu/ops/attention.py:292",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
