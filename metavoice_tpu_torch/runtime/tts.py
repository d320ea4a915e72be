"""End-to-end TTS — the user-facing ``TTS`` class of the PyTorch port.

Port of the default path of metavoice_tpu/runtime/tts.py:
``TTS(...).synthesise(text, spk_ref_path, top_p, guidance_scale, temperature)
-> path to a .wav``, bf16 weights and a bf16 KV cache. The stages:

  1. speaker encoder (models/speaker_encoder), cached per reference file;
  2. first-stage LLM (models/first_stage): prefill + decode loop, whose
     T=1 attention is the hand-written CUDA kernel on the card (a GQA first
     stage's, ``from_random(first_stage_overrides={"n_local_heads": 2})``,
     the multi-query kernel's); or, with a draft model, speculative decoding
     (models/spec_decode), whose T=gamma verify attends through the
     multi-query kernel;
  3. token split (core/tokens.split_flattened_interleaved);
  4. second-stage non-causal completion (models/second_stage) and the
     EnCodec decoder (models/encodec) as one function on device tensors
     (``stage2_vocode``, no host copy between the two, the codes padded to
     a vocoder bucket), then the spectral-gate enhancer and a
     loudness-normalized wav write.

``synthesise_streaming`` yields the wav segment by segment: the first stage
pauses at even segment boundaries (first_stage.generate_segments) and each
segment takes the same render as a whole utterance. ``warmup`` loads
the kernel library and runs every prompt bucket, guidance variant and
vocoder bucket once, so no request builds or first-runs anything;
``get_tokens`` EnCodec-encodes a wav and ``render_tokens`` renders a
first-stage stream to a file.

Everything runs on the ``device`` given (default "cuda"; asking for cuda
without a card raises). ``quantisation_mode="int4"`` packs the first stage's
layer weights and tied head into the int4-in-int32 serving format on the
device: prefill projections go through the int4 matmul kernel and each
decode step through the int4 decode-stack kernel (ops/quantized.py,
ops/decode_stack.py). ``quantisation_mode="int8"`` (alias "int8_packed")
packs the layer weights into the int8-in-int32 format: prefill projections
go through the int8 matmul kernel, each decode step through the int8
decode-stack kernel where its conditions hold (else per layer, through the
int8 matmul and decode-attention kernels), and the tied head stays bf16.
``quantisation_mode="int8_plain"`` quantizes the layer weights to plain int8
arrays with one f32 scale per column (the JAX package's
``quantize_params_int8``; or takes a tree that already holds such ``{"q",
"scales"}`` leaves): prefill projections go through the plain-int8 matmul
kernel, and each decode step of an MHA first stage runs every layer through
the plain-int8 attention-block and FFN kernels (ops/attention.py,
ops/quantized.py; a GQA one through the matmul kernel, the multi-query
attention kernel and the FFN kernel). ``guidance_scale=(speaker, prompt)``
with a prompt scale above 1 is the reference's double guidance on 3 cache
rows. A first stage that holds the JAX package's groupwise int4 leaves
(``quantize_params_int4`` or ``_packed``, or ``load_first_stage_npz`` of
such a file) runs as it is with ``quantisation_mode=None``, as in JAX: every
projection goes through the groupwise int4 matmul kernels (K12, K13; a
dense f32 route above 256 rows), a decode step through them and the
decode-attention kernel, layer by layer.

``kv_cache_dtype="int8"`` or ``"int8_packed"`` makes the persistent KV
caches quantized (models/transformer.KVCache: int8 values with per-(slot,
row, kv head) f32 scales, the packed form four slots to an int32 word),
half the bf16 cache's bytes. Prefill quantizes its rows on the plain path;
with int4 weights each decode step runs per layer through the int4
attention-block kernel (which quantizes the new row and attends over the
int8 window) and the int4 FFN kernel, then the bf16 tied head. With bf16,
int8 or plain-int8 weights a quantized cache decodes on the plain
dequantizing path, as in the JAX package, which warns on the card.

Speculative decoding: ``TTS(components, draft_params=..., draft_cfg=...,
speculative_gamma=4, draft_use_cfg=True)``. The draft shares the token
space, lives on the same device, and is dense or int4-packed
(``ops/quantized.quantize_params_int4_i32``; its T=1 steps then run
through the int4 decode-stack kernel). ``spec_stats`` accumulates the
acceptance ledger. As in the JAX package the speculative path refuses
tensor parallelism and keeps bf16 caches whatever ``kv_cache_dtype`` is.

Not ported yet: tensor parallelism, a draft checkpoint loader
(``from_checkpoints``), MBD and the DF enhancer.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os
import threading
import time
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from metavoice_tpu_torch.core import tokens as T
from metavoice_tpu_torch.core.config import (
    RuntimeConfig,
    TransformerConfig,
    first_stage_config,
    second_stage_config,
)
from metavoice_tpu_torch.core.device import resolve_device
from metavoice_tpu_torch.core.text import chunk_text, normalize_text
from metavoice_tpu_torch.models import encodec as ec
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.models import second_stage as ss
from metavoice_tpu_torch.models import spec_decode as sd
from metavoice_tpu_torch.models import speaker_encoder as se
from metavoice_tpu_torch.models import transformer as tfm
from metavoice_tpu_torch.models.enhancer import get_enhancer
from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.ops.attention import (
    decode_attention,
    decode_attention_block_int4,
    decode_attention_block_int8,
    decode_attention_multi,
)
from metavoice_tpu_torch.ops.decode_stack import decode_stack_int4
from metavoice_tpu_torch.ops.quantized import (
    decode_ffn_int4,
    ffn_int8,
    is_int4,
    is_int4_grouped,
    is_int8_i32,
    is_int8_plain,
    matmul_int4,
    matmul_int4_i32,
    matmul_int4_packed,
    matmul_int8,
    matmul_int8_i32,
    quantize_params_int4_i32,
    quantize_params_int8,
    quantize_params_int8_i32,
)
from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
from metavoice_tpu_torch.utils import audio_io as aio

MAX_CHARS_PER_CHUNK = 220  # reference truncation point (fam/llm/inference.py:537)
_INT8_PACKED_MODES = ("int8", "int8_packed")  # "int8_packed" is an alias of "int8"
# the kernels whose launches TTS.stats counts, by stats key: (wrapper, its counter)
KERNEL_COUNTERS = {
    "k1_launches": (decode_attention, "launches"),
    "k2_launches": (matmul_int4_i32, "launches"),
    "k3_launches": (decode_stack_int4, "launches"),
    "k4_launches": (decode_attention_multi, "launches"),
    "k5_launches": (decode_attention_block_int4, "launches"),
    "k6_launches": (decode_ffn_int4, "launches"),
    "k7_launches": (decode_stack_int4, "launches_i8"),
    "k8_launches": (matmul_int8_i32, "launches"),
    "k9_launches": (decode_attention_block_int8, "launches"),
    "k10_launches": (ffn_int8, "launches"),
    "k11_launches": (matmul_int8, "launches"),
    "k12_launches": (matmul_int4, "launches"),
    "k13_launches": (matmul_int4_packed, "launches"),
}
_QUANTIZERS = {"int4": quantize_params_int4_i32, "int8": quantize_params_int8_i32,
               "int8_plain": quantize_params_int8}


def _launches() -> dict[str, int]:
    return {k: getattr(fn, attr) for k, (fn, attr) in KERNEL_COUNTERS.items()}


def _vocoder_bucket(t_audio: int) -> int:
    """The code length the vocoder sees: 1/3 s granularity up to 1 s, 1 s
    above, as in the JAX package."""
    return max(25, -(-t_audio // 25) * 25) if t_audio <= 75 else -(-t_audio // 75) * 75


@torch.inference_mode()
def stage2_vocode(
    params2: tfm.Params,
    eparams: dict,
    cfg2: TransformerConfig,
    ecfg: ec.EncodecConfig,
    idx: torch.Tensor,  # (1, 2, ctx) second-stage input (text+h0 / pad+h1)
    spk: torch.Tensor,  # (1, spk_dim)
    n_text: int,
    n_audio: int,
    coarse_pad: torch.Tensor,  # (2, bucket) the true coarse rows
    *,
    bucket: int,
    top_k: int = 200,
    compute_dtype=torch.bfloat16,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """The second stage and the EnCodec vocoder in one function on device
    tensors (the JAX package's ``_stage2_vocode_jit``) -> (1, bucket * hop)
    wav: sample the 6 fine rows, stack [inputs; sampled], slice the audio
    region at ``n_text``, put back the true coarse rows, zero past
    ``n_audio``, clip to the codebook, decode. ``noise`` replaces the
    second stage's Gumbel draws."""
    sampled = ss.non_causal_sample(params2, cfg2, idx, spk, 1.0, top_k=top_k, compute_dtype=compute_dtype,
                                   generator=generator, noise=noise)  # (1, 6, ctx)
    full = torch.cat([idx[0], sampled[0]], dim=0)  # (8, ctx)
    full = torch.nn.functional.pad(full, (0, bucket))  # keep the slice whole
    region = full[:, n_text : n_text + bucket].clone()
    region[0:2] = coarse_pad
    region[:, n_audio:] = 0
    return ec.decode_codes(eparams, ecfg, region.clamp(0, T.CODEBOOK_SIZE - 1))


@dataclass
class TTSComponents:
    first_stage_params: tfm.Params
    first_stage_cfg: TransformerConfig
    second_stage_params: tfm.Params
    second_stage_cfg: TransformerConfig
    spk_params: se.Params
    encodec_params: dict
    encodec_cfg: ec.EncodecConfig
    tokenizer: TrainedBPETokeniser
    enhancer: object | None = None


class TTS:
    """Text-to-speech with zero-shot voice cloning (reference
    fam/llm/fast_inference.py:38, class TTS)."""

    END_OF_AUDIO_TOKEN = T.HIERARCHY_EOA  # 1024, per-hierarchy space

    def __init__(
        self,
        components: TTSComponents,
        *,
        device="cuda",
        seed: int = 1337,
        output_dir: str = "outputs",
        runtime: RuntimeConfig | None = None,
        enforce_min_ref_duration: bool = True,
        quantisation_mode: str | None = None,
        kv_cache_dtype: str | None = None,
        tensor_parallel: int = 1,
        draft_params=None,
        draft_cfg=None,
        speculative_gamma: int = 4,
        draft_use_cfg: bool = True,
    ):
        self.runtime = runtime or RuntimeConfig(seed=seed, output_dir=output_dir)
        if draft_params is not None and draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        if draft_params is not None and tensor_parallel > 1:
            raise ValueError("speculative decoding is not supported with tensor_parallel")
        mode = quantisation_mode or self.runtime.quantisation_mode
        if mode not in (None, "int4", *_INT8_PACKED_MODES, "int8_plain"):
            raise ValueError(
                f"Invalid quantisation mode {mode}! Must be None, 'int4', 'int8' ('int8_packed') or 'int8_plain'"
            )
        if tensor_parallel != 1:
            raise NotImplementedError("tensor_parallel is not ported to PyTorch yet")
        kv_cache_dtype = kv_cache_dtype or self.runtime.kv_cache_dtype
        if kv_cache_dtype not in (None, "int8", "int8_packed"):
            raise ValueError(f"Invalid kv_cache_dtype {kv_cache_dtype!r}; expected None, 'int8' or 'int8_packed'")
        self.kv_cache_dtype = kv_cache_dtype
        self._compute_dtype = (
            torch.bfloat16 if self.runtime.dtype == "bfloat16" else torch.float32
        )
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the card this thread builds on: an engine's threads enter it
            # (the current device is per thread)
            self.device = torch.device("cuda", torch.cuda.current_device())
        # A quantized mode arrives as the mode, or as first-stage params that
        # already hold quantized leaves, {"pw", "sc"} for int4, {"p8", "sc8"}
        # for int8 or {"q", "scales"} for int8_plain (a JAX-written .npz, or
        # a tree the JAX package quantized). The JAX package's groupwise int4
        # leaves, {"q" | "p", "scales", "zeros"}, run as they are with the
        # mode left None, as in JAX; a tree that mixes kinds is refused.
        # Quantizing runs on the params' device; an int4 first stage's T=1
        # route is named in decode_route (int8 layers that miss the int8
        # stack's conditions run per layer).
        params1 = components.first_stage_params
        found = set()
        for w in params1["layers"].values():
            kind = ("int4" if is_int4(w) else "int8" if is_int8_i32(w) else "int8_plain" if is_int8_plain(w)
                    else "groupwise int4" if is_int4_grouped(w) else None)
            if kind:
                found.add(kind)
        wanted = "int8" if mode in _INT8_PACKED_MODES else mode
        if len(found) > 1 or (found and wanted and found != {wanted}):
            raise ValueError(f"quantisation_mode={mode!r}, but the first stage holds {sorted(found)} leaves")
        self.quantisation_mode = wanted or next(iter(found - {"groupwise int4"}), None)
        self.decode_route = None
        if self.quantisation_mode is not None:
            if not found:
                params1 = _QUANTIZERS[wanted](params1)
            if self.quantisation_mode == "int4":
                self.decode_route = tfm.int4_decode_route(params1, components.first_stage_cfg, 3,
                                                          self._cache_format(draft_params is not None))
            components = dataclasses.replace(components, first_stage_params=params1)
        if kv_cache_dtype and self.quantisation_mode != "int4" and self.device.type == "cuda":
            warnings.warn(
                f"kv_cache_dtype={kv_cache_dtype!r} without quantisation_mode='int4' has no decode kernel: "
                "every step dequantizes the whole cache on the plain path. Pair it with "
                "quantisation_mode='int4' for the per-layer kernels."
            )
        self.c = components
        # speculative decoding (models/spec_decode.py): the draft proposes
        # `speculative_gamma` tokens a round and the first stage verifies
        # them in one T=gamma forward; B=1, bf16 caches. An int4 draft
        # decodes through an int4 route (named in draft_route).
        self.draft_route = None
        if draft_params is not None and any(is_int4(w) for w in draft_params["layers"].values()):
            self.draft_route = tfm.int4_decode_route(draft_params, draft_cfg, 3, self._compute_dtype)
        self._draft_params = draft_params
        self._draft_cfg = draft_cfg
        self._spec_gamma = int(speculative_gamma)
        self._draft_use_cfg = bool(draft_use_cfg)
        # cumulative acceptance ledger: accepted/proposed is the draft
        # acceptance rate, emitted/rounds the tokens a target forward yields
        self.spec_stats = {"accepted": 0, "proposed": 0, "rounds": 0, "emitted": 0}
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._emb_cache: "collections.OrderedDict[str, np.ndarray]" = collections.OrderedDict()
        self._emb_cache_max = 256
        self._emb_lock = threading.Lock()
        self._enforce_min_ref = enforce_min_ref_duration
        # persistent KV caches, reused across calls: the CFG pair's, and a
        # 3-row one for (speaker, prompt) guidance made at its first use
        self._kv_cache = self._create_kv_cache(2)
        self._kv_cache3: tfm.KVCache | None = None
        # seconds per stage of the last synthesise or stream (the second
        # stage + vocoder under "stage2_vocode_fused"); the first
        # stage's decode step count (speculative rounds with a draft) and the kernel
        # launches (K1 decode attention, K2 int4 matmul, K3 int4 decode
        # stack, K4 multi-query decode attention, K5 int4 attention block,
        # K6 int4 FFN, K7 int8 decode stack, K8 int8 matmul, K9 plain-int8
        # attention block, K10 plain-int8 FFN, K11 plain-int8 matmul, K12 and
        # K13 groupwise int4 matmuls) of the last synthesise
        self.timings: dict[str, float] = {}
        self.stats: dict[str, int] = {}
        self._timings_lock = threading.Lock()  # an engine's render threads add to timings at once

    def _cache_format(self, speculative: bool):
        """The persistent caches' format: ``kv_cache_dtype``, or the compute
        dtype when it is None or a draft is set (the speculative path keeps
        float caches, as in the JAX package)."""
        return self._compute_dtype if speculative or not self.kv_cache_dtype else self.kv_cache_dtype

    def _create_kv_cache(self, rows: int) -> tfm.KVCache:
        cfg1 = self.c.first_stage_cfg
        return tfm.KVCache.create(cfg1, rows, cfg1.block_size, device=self.device,
                                  dtype=self._cache_format(self._draft_params is not None))

    def _persistent_kv_cache(self, guidance_scale) -> tfm.KVCache:
        """The reusable cache with the guidance rows this request needs."""
        if fs._normalize_guidance(guidance_scale)[2] == 2:
            return self._kv_cache
        if self._kv_cache3 is None:
            self._kv_cache3 = self._create_kv_cache(3)
        return self._kv_cache3

    @classmethod
    def from_random(cls, *, small: bool = False, device="cuda", seed: int = 0,
                    first_stage_overrides: dict | None = None, **kwargs) -> "TTS":
        """Random-weight instance for development and smoke runs.

        ``small=False`` is the full-width model: first stage 24L/16H/2048d,
        the default second stage and EnCodec, the speaker encoder. Weights
        are drawn on ``device`` from a generator seeded with ``seed``.
        ``first_stage_overrides``: more first_stage_config keywords (e.g.
        ``{"n_local_heads": 2}`` for a GQA first stage).
        """
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        fs_kw = dict(n_layer=2, n_head=4, dim=128, block_size=512) if small else {}
        cfg1 = first_stage_config(**(fs_kw | dict(first_stage_overrides or {})))
        cfg2 = second_stage_config(n_layer=2, n_head=2, dim=64, block_size=256) if small else second_stage_config()
        ecfg = ec.EncodecConfig(n_filters=8, dimension=32) if small else ec.EncodecConfig()
        comps = TTSComponents(
            first_stage_params=tfm.init_params(cfg1, device=dev, generator=gen, dtype=torch.bfloat16),
            first_stage_cfg=cfg1,
            second_stage_params=tfm.init_params(cfg2, device=dev, generator=gen, dtype=torch.bfloat16),
            second_stage_cfg=cfg2,
            spk_params=se.init_params(device=dev, generator=gen),
            encodec_params=ec.init_params(ecfg, device=dev, generator=gen),
            encodec_cfg=ecfg,
            tokenizer=TrainedBPETokeniser(),
            enhancer=get_enhancer("spectral_gate"),
        )
        kwargs.setdefault("enforce_min_ref_duration", False)
        return cls(comps, device=dev, **kwargs)

    # ------------------------------------------------------------------ warmup
    @torch.inference_mode()
    def warmup(
        self,
        prompt_buckets: tuple[int, ...] = (128, 256),
        vocoder_frame_buckets: tuple[int, ...] = (25, 50, 75, 150, 225, 300),
        guidance_variants: tuple = (3.0, (2.0, 1.5)),
    ) -> None:
        """Run the serving envelope once, so that no request is the first to
        build or run anything (the JAX package's warmup, without MBD):

          * on the card, load the kernel library (``ops/_build.kernels()``:
            the nvcc build, when the sources have no build yet);
          * per prompt bucket and guidance variant, a prefill and 4 decode
            steps on the persistent cache (with a draft, a speculative round
            too): each route's kernels run once eagerly, which also makes
            their per-device merge counters;
          * the second stage + vocoder (``stage2_vocode``) at every
            vocoder bucket up to ``vocoder_frame_buckets[-1]`` frames.

        The draws come from a generator of its own: the TTS's stays as it
        was.
        """
        if self.device.type == "cuda":
            _build.kernels()
        gen = torch.Generator(device=self.device).manual_seed(0)
        cfg1 = self.c.first_stage_cfg
        spk = np.zeros((cfg1.speaker_emb_dim,), np.float32)
        eot = self.c.tokenizer.eot_token
        prompt = []
        for bucket in prompt_buckets:
            bucket = min(bucket, cfg1.block_size // 2)
            prompt = list(range(T.TEXT_OFFSET, T.TEXT_OFFSET + min(bucket, 16)))
            padded = prompt + [0] * (bucket - len(prompt))
            for g in guidance_variants:
                common = dict(generator=gen, guidance_scale=g, end_of_text_token=eot, prompt_pad_multiple=bucket,
                              kv_cache=self._persistent_kv_cache(g), compute_dtype=self._compute_dtype)
                fs.generate(self.c.first_stage_params, cfg1, padded, spk, max_new_tokens=4, **common)
                if self._draft_params is not None:
                    sd.generate_spec(
                        self.c.first_stage_params, cfg1, self._draft_params, self._draft_cfg, padded, spk,
                        gamma=self._spec_gamma, draft_use_cfg=self._draft_use_cfg,
                        max_new_tokens=self._spec_gamma + 1, **common,
                    )
        for n_audio in vocoder_frame_buckets:
            self._render(prompt, [list(range(n_audio))] * 2, spk, gen)

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Add the stage's wall seconds (its device work included) to
        timings. It waits for the calling thread's current stream only: an
        engine's render, on a stream of its own, does not wait for the
        decode queued on the device's default stream."""
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        with self._timings_lock:
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0

    # ------------------------------------------------------------------ speaker embedding
    def _get_speaker_embedding(self, spk_ref_path: str) -> np.ndarray:
        """md5-cached speaker embedding (reference fam/llm/inference.py:419-435)."""
        with open(spk_ref_path, "rb") as f:
            cache_key = hashlib.md5(f.read(1 << 20)).hexdigest() + f":{os.path.getsize(spk_ref_path)}"
        with self._emb_lock:  # an engine's submit runs on every client's thread
            if cache_key in self._emb_cache:
                self._emb_cache.move_to_end(cache_key)
                return self._emb_cache[cache_key]
        wav, _ = aio.load_audio(spk_ref_path, target_sr=se.SAMPLING_RATE)
        wav = se.trim_silence(wav, top_db=20.0)
        emb = se.embed_utterance(self.c.spk_params, wav)
        with self._emb_lock:
            self._emb_cache[cache_key] = emb
            while len(self._emb_cache) > self._emb_cache_max:
                self._emb_cache.popitem(last=False)
        return emb

    # ------------------------------------------------------------------ token utilities
    @torch.inference_mode()
    def get_tokens(self, audio_path: str) -> list[list[int]]:
        """EnCodec-encode an audio file (reference fam/llm/decoders.py:49-64)
        -> the (n_q, T) code grid as nested lists, codebook-major. The wav is
        loaded at the codec's rate and trimmed to whole frames."""
        ecfg = self.c.encodec_cfg
        wav, _ = aio.load_audio(audio_path, target_sr=ecfg.sample_rate)
        if len(wav) >= ecfg.hop_length:
            wav = wav[: len(wav) // ecfg.hop_length * ecfg.hop_length]
        codes = ec.encode_codes(self.c.encodec_params, ecfg, wav[None])
        return codes[0].cpu().numpy().tolist()

    # ------------------------------------------------------------------ synthesis
    @torch.inference_mode()
    def _tokens_to_wav(
        self,
        text: str,
        prompt_tokens: list,
        token_stream,
        spk_emb: np.ndarray,
        noise: torch.Tensor | None = None,
        *,
        generator: torch.Generator | None = None,
    ) -> np.ndarray:
        """First-stage token stream -> 24 kHz waveform: split, then
        ``_render``. ``noise`` replaces the second stage's Gumbel draws
        (tests); ``generator`` the TTS's own (an engine's render takes one
        of its own)."""
        _text_ids, coarse = T.split_flattened_interleaved(token_stream, self.END_OF_AUDIO_TOKEN)
        if len(coarse[0]) == 0:
            raise RuntimeError(f"first stage produced no audio tokens for: {text!r}")
        return self._render(prompt_tokens, coarse, spk_emb, generator or self._gen, noise)

    def _render(self, prompt_tokens: list, coarse: list, spk_emb, generator,
                noise: torch.Tensor | None = None) -> np.ndarray:
        """The two coarse rows -> 24 kHz float32 waveform: ``stage2_vocode``
        at the vocoder bucket of the frames (timed as
        ``"stage2_vocode_fused"``), the wav trimmed to the frames, then the
        enhancer."""
        ctx = self.c.second_stage_cfg.block_size
        n_text = len(prompt_tokens)
        n_audio = min(len(coarse[0]), ctx - n_text)
        bucket = _vocoder_bucket(n_audio)
        coarse_pad = np.zeros((2, bucket), np.int64)
        coarse_pad[0, :n_audio] = np.asarray(coarse[0][:n_audio])
        coarse_pad[1, :n_audio] = np.asarray(coarse[1][:n_audio])
        with self._stage("stage2_vocode_fused"):
            wav = stage2_vocode(
                self.c.second_stage_params, self.c.encodec_params, self.c.second_stage_cfg, self.c.encodec_cfg,
                torch.as_tensor(T.build_second_stage_input(prompt_tokens, coarse, ctx), dtype=torch.int64,
                                device=self.device)[None],
                torch.as_tensor(np.asarray(spk_emb, np.float32), device=self.device).reshape(1, -1),
                n_text, n_audio, torch.as_tensor(coarse_pad, device=self.device),
                bucket=bucket, compute_dtype=self._compute_dtype, generator=generator, noise=noise,
            )
            wav = wav[0].float().cpu().numpy()[: n_audio * self.c.encodec_cfg.hop_length]
        if self.c.enhancer is not None:
            with self._stage("enhancer"):
                wav = self.c.enhancer(wav, self.c.encodec_cfg.sample_rate)
        return wav.astype(np.float32)

    def render_tokens(self, text: str, prompt_tokens: list, generated, spk_emb: np.ndarray) -> str:
        """Render a generated first-stage stream to a wav file on disk."""
        return self.write_wav_output(text, self._tokens_to_wav(text, prompt_tokens, generated, spk_emb))

    def write_wav_output(self, text: str, wav: np.ndarray) -> str:
        """Loudness-normalized write to a unique path in output_dir."""
        digest = hashlib.md5(f"{text}{time.time()}".encode()).hexdigest()[:12]
        out_path = os.path.join(self.output_dir, f"synth_{digest}.wav")
        aio.write_wav_loudness_normalized(out_path, wav, self.c.encodec_cfg.sample_rate)
        return out_path

    def _synthesise_chunk(
        self,
        text: str,
        spk_emb: np.ndarray,
        top_p: float,
        guidance_scale: float | tuple[float, float],
        temperature: float,
        max_new_tokens: int | None = None,
    ) -> np.ndarray:
        """One <=220-char chunk -> 24 kHz waveform (float32)."""
        prompt = self.c.tokenizer.encode(text)
        stats = {"decode_steps": 0}
        launches = _launches()
        common = dict(
            generator=self._gen,
            temperature=temperature,
            top_p=top_p,
            guidance_scale=guidance_scale,
            max_new_tokens=max_new_tokens,
            end_of_text_token=self.c.tokenizer.eot_token,
            prompt_pad_multiple=self.runtime.prompt_pad_multiple,
            kv_cache=self._persistent_kv_cache(guidance_scale),
            compute_dtype=self._compute_dtype,
        )
        with self._stage("first_stage"):
            if self._draft_params is not None:
                seq, spec = sd.generate_spec(
                    self.c.first_stage_params, self.c.first_stage_cfg,
                    self._draft_params, self._draft_cfg, prompt, spk_emb,
                    gamma=self._spec_gamma, draft_use_cfg=self._draft_use_cfg,
                    return_stats=True, **common,
                )
                for k, n in spec.items():
                    self.spec_stats[k] += n
                stats["spec_rounds"] = spec["rounds"]
            else:
                seq = fs.generate(
                    self.c.first_stage_params, self.c.first_stage_cfg, prompt, spk_emb,
                    stats=stats, **common,
                )
        for k, n in stats.items():
            self.stats[k] = self.stats.get(k, 0) + n
        for k, n in _launches().items():
            self.stats[k] = self.stats.get(k, 0) + n - launches[k]
        return self._tokens_to_wav(text, prompt, seq, spk_emb)

    def synthesise_streaming(
        self,
        text: str,
        spk_ref_path: str,
        top_p: float = 0.95,
        guidance_scale: float | tuple[float, float] = 3.0,
        temperature: float = 1.0,
        segment_tokens: int = 150,
        first_segment_tokens: int = 40,
        max_new_tokens: int | None = None,
        noise: torch.Tensor | None = None,
        stage2_noise: torch.Tensor | None = None,
    ):
        """Yield 24 kHz float32 wav chunks as they are synthesised: each text
        chunk's first stage pauses at even segment boundaries
        (first_stage.generate_segments; the first segment
        ``first_segment_tokens`` long, about 1/4 s of audio by default, the
        later ones ``segment_tokens``) and each segment runs through the
        second stage + vocoder and the enhancer at once. A segment
        that holds only the end-of-audio token yields nothing. Everything
        runs in the caller's thread, between its reads of the stream.
        ``max_new_tokens`` caps the first stage per chunk, as in
        ``synthesise``. ``timings`` and ``stats`` describe the stream so far. ``noise`` (n,
        1, V) and ``stage2_noise`` replace each chunk's first-stage and each
        segment's second-stage Gumbel draws (tests)."""
        self.timings, self.stats = {}, {}
        launches = _launches()
        text = normalize_text(text)
        spk_ref_path = aio.get_cached_file(spk_ref_path)
        if self._enforce_min_ref:
            aio.check_audio_file(spk_ref_path)
        with self._stage("spk_emb"):
            spk_emb = self._get_speaker_embedding(spk_ref_path)
        for chunk in chunk_text(text, MAX_CHARS_PER_CHUNK) or [""]:
            prompt = self.c.tokenizer.encode(chunk)
            segments = fs.generate_segments(
                self.c.first_stage_params, self.c.first_stage_cfg, prompt, spk_emb,
                generator=self._gen, segment_tokens=segment_tokens,
                first_segment_tokens=min(first_segment_tokens, segment_tokens),
                temperature=temperature, top_p=top_p, guidance_scale=guidance_scale,
                max_new_tokens=max_new_tokens, end_of_text_token=self.c.tokenizer.eot_token,
                prompt_pad_multiple=self.runtime.prompt_pad_multiple,
                compute_dtype=self._compute_dtype, cache_dtype=self._cache_format(False),
                noise=noise, stats=self.stats,
            )
            while True:
                with self._stage("first_stage"):
                    segment = next(segments, None)
                for k, n in _launches().items():
                    self.stats[k] = n - launches[k]
                if segment is None:
                    break
                coarse = T.split_flattened_interleaved(segment, self.END_OF_AUDIO_TOKEN)[1]
                if len(coarse[0]) == 0:
                    continue  # the segment held only the end-of-audio token
                yield self._render(prompt, coarse, spk_emb, self._gen, stage2_noise)

    def synthesise(
        self,
        text: str,
        spk_ref_path: str,
        top_p: float = 0.95,
        guidance_scale: float | tuple[float, float] = 3.0,
        temperature: float = 1.0,
        max_new_tokens: int | None = None,
    ) -> str:
        """Synthesise ``text`` in the voice of ``spk_ref_path``; returns the
        path to a loudness-normalized 24 kHz wav. ``guidance_scale`` is the
        speaker CFG scale or a (speaker, prompt) tuple. ``max_new_tokens``
        caps the first stage per chunk (None: to end-of-audio or the context
        limit). ``timings`` and ``stats`` describe this call afterwards."""
        start = time.time()
        self.timings, self.stats = {}, {}
        text = normalize_text(text)
        spk_ref_path = aio.get_cached_file(spk_ref_path)
        if self._enforce_min_ref:
            aio.check_audio_file(spk_ref_path)
        with self._stage("spk_emb"):
            spk_emb = self._get_speaker_embedding(spk_ref_path)

        wavs = [
            self._synthesise_chunk(
                chunk, spk_emb, top_p, guidance_scale, temperature, max_new_tokens=max_new_tokens
            )
            for chunk in chunk_text(text, MAX_CHARS_PER_CHUNK) or [""]
        ]
        gap = np.zeros(int(0.1 * self.c.encodec_cfg.sample_rate), np.float32)
        wav = wavs[0] if len(wavs) == 1 else np.concatenate(
            [w for pair in zip(wavs, [gap] * len(wavs)) for w in pair][:-1]
        )
        digest = hashlib.md5(f"{text}{spk_ref_path}{time.time()}".encode()).hexdigest()[:12]
        out_path = os.path.join(self.output_dir, f"synth_{digest}.wav")
        with self._stage("write_wav"):
            aio.write_wav_loudness_normalized(out_path, wav, self.c.encodec_cfg.sample_rate)

        elapsed = time.time() - start
        duration = len(wav) / self.c.encodec_cfg.sample_rate
        print(f"Total time to synth (s): {elapsed:.2f}")
        print(f"Real-time factor: {elapsed / max(duration, 1e-6):.2f}")
        return out_path
