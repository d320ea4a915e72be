#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (metavoice_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

  1. device  - needs torch.cuda.is_available(); prints the card's name and
               power limit as nvidia-smi gives them;
  2. build   - builds every kernel from metavoice_tpu_torch/csrc with nvcc;
  3. K1      - the decode-attention kernel against its plain PyTorch version
               at the main-path shape (L=24, S=2048, B=2, H=16, Dh=128, bf16),
               pos 0 to 2047 and the edges of its plan (one split, windows
               ending on a split boundary, the most splits, starts, NaN past
               pos): y within atol/rtol 2e-2 of the plain version (f32
               inside, rounded to bf16), caches bit-identical, the new row
               written, one launch counted and one device kernel a call
               (from the graph of one call); each case's plan; per layer from a CUDA
               graph at pos 256, 1000 and 2047 beside SDPA on the same
               window, the plain version and the bound;
  4. small   - the first stage on the card (f32) against the CPU path on a
               small model with the same weights and Gumbel noise: same tokens;
  5. synth   - full-width TTS.synthesise on random weights (first stage
               24L/16H/2048d, default second stage and EnCodec): a finite
               24 kHz wav, and the K1 launch count equal to n_layer x decode
               steps of that run;
  6. K2      - the int4 prefill matmul against its plain version at the
               main-path shapes (M = 256; K x N of 2048 x 6144, 2048 x 2048,
               6144 x 2048) and at M = 1, 200: max |dy| <= 1e-3 max |ref|;
               CUDA-event times of one layer's five projections beside the
               plain version, torch._weight_int4pack_mm (replayed from a CUDA
               graph as the kernels are; eagerly, said so, where it cannot be
               captured) and the bound;
  7. K3      - the int4 decode stack against its plain version at the full
               main-path shape (24 layers, B = 2, cache 2048 slots, head
               Vp 3072) at pos 0, 255, 1000, 2047, with starts, with NaN
               beyond pos and with GQA (2 kv heads): one layer at a time
               within 1e-2 max |ref|, all layers' x_out and logits within
               5e-2 max |ref|, pad logits exactly 0, layer 0's new cache
               row within one bf16 ulp, every other slot unchanged; one
               whole step captured in a CUDA graph and replayed 3 times,
               each replay the eager step's bits (itself the same twice),
               the merge tickets back at 0, and the step's kernels counted
               from the graph's nodes (6 a layer and the head's, none named
               rmsnorm or gemv_reduce); the products' profiled device time
               a step and their weights' GB/s; times;
  8. small4  - a 2-layer 1024-wide int4 first stage on the card against the
               CPU path (plain versions) with the same weights: prefill
               logits and 8 teacher-forced decode steps within 5e-2 max |ref|;
  9. synth4  - full-width TTS(quantisation_mode="int4").synthesise: a finite
               wav; K3 launches == decode steps, K2 launches == 5 x n_layer x
               prefills, K1 launches == 0;
 10. profile4 - where a 64-token int4 first-stage generate spends its time:
               device kernel time by kernel (torch.profiler) against the same
               generate unprofiled (the device's busy share), by family (the
               products stack_gemv, the attention split and combine, the
               prefill matmul); a family with no device time fails;
 11. K8      - the int8 prefill matmul against its plain version at the
               main-path shapes (M = 256; K x N of 2048 x 6144, 2048 x 2048,
               6144 x 2048) and at M = 1, 2, 200: every row within 1e-3 max
               |ref|, or so once its bf16(sum x) moves one ulp (the c term's
               rounding flip); times of one layer's five projections beside
               the plain version, a library call and the bound;
 12. K7      - the int8 decode stack against its plain version at the full
               main-path shape (24 layers, B = 2, cache 2048 slots, no head)
               at pos 0, 255, 1000, 2047, with starts, with NaN beyond pos
               and with GQA (2 kv heads), held as K3 is, with phase 7's
               captured step (6 kernels a layer); times;
 13. small8  - int8 first stages on the card against the CPU path (plain
               versions) with the same weights: a 2-layer 1024-wide one
               (decode through K7) and a 2-layer 512-wide one (decode per
               layer through K8 at M = 2 and K1): prefill logits and 8
               teacher-forced steps within 5e-2 max |ref|, and the launches
               each route must make;
 14. synth8  - full-width TTS(quantisation_mode="int8").synthesise: a finite
               wav; K7 launches == decode steps, K8 launches == 5 x n_layer x
               prefills, K1 == K2 == K3 == 0;
 15. profile8 - phase 10 for a 64-token int8 generate;
 16. K4      - the multi-query decode-attention kernel against its plain
               version at the main-path shape (L=24, S=2048, B=2, Dh=128,
               bf16): the spec verify (H = H_kv = 16, T 4, 8, 16 at pos 0,
               255, 1000, 2032), GQA (H 16, H_kv 2, T 1 and 8), 3 rows
               (B 3, T 4), starts with one past pos, NaN past pos+T-1, and
               the edges of its plan (one split, windows ending on a split
               boundary, GQA's most splits, GQA starts with NaN): y within
               atol/rtol 2e-2, caches bit-identical (the T rows written,
               every other slot unchanged), one launch counted and one
               device kernel a call; each case's plan; CUDA-event times per
               layer beside the plain version, SDPA (at GQA T 1 also
               without its all-true mask) and the bound;
 17. small-spec - speculative decoding of a small f32 first stage and draft
               on the card against the CPU path, same weights and injected
               draws: same tokens and ledger; with draft == target under
               greedy sampling every proposal accepted and the tokens those
               of first_stage.generate;
 18. synth-spec - full-width TTS.synthesise with a draft: a bf16 target
               with a dense 4L/8H/1024d draft (gamma 4), and an int4 target
               with that draft int4-packed and CFG-free (gamma 8): a finite
               wav, K4 launches == n_layer x rounds, the target's T=1 kernels
               never (K1 == 4 x gamma x rounds from the dense draft, K3 ==
               gamma x rounds from the int4 one), a coherent ledger; ms per
               emitted token beside the ordinary synthesise of that mode;
 19. synth-gqa - full-width bf16 synthesise of a GQA first stage (2 kv
               heads): K4 launches == n_layer x decode steps, K1 == 0;
 20. synth-g3 - full-width bf16 synthesise with guidance (3.0, 1.5) on a
               3-row cache: K1 launches == n_layer x decode steps;
 21. K5      - the int4 attention-block kernel against its plain version at
               the main-path shape (24 stacked layers, D 2048, 16 heads, B 2,
               S 2048) for a bf16, an int8 and a packed cache, MHA and GQA (2
               kv heads), at pos 0, 77, 255, 2047, plus starts and NaN past
               pos in the bf16 cache: y within 2e-2 of max |y|, every cache
               byte and scale but the new row's unchanged, the new row within
               one int8 step (scales 1e-6 relative; bf16: one ulp); in each
               format at pos 1000 one call captured in a CUDA graph: 3
               kernels (stack_gemv, attn_row_kernel, stack_gemv; none of the
               split-K GEMV, split attention or row-write kernels), 3
               replays the eager call's bits, the merge counters at 0 after
               every call; per layer from a CUDA graph at pos 0, 255, 1000,
               2047 beside the plain version and the bound;
 22. K6      - the int4 FFN kernel against its plain version at the main-path
               shape (FFN packed to 6144) at rows 1, 2, 3, 8 and layers 0,
               11, 23: within 1e-2 of max |y|; a capture before any eager
               call raises; one call captured in a CUDA graph: 2 kernels
               (stack_gemv twice, none of BLOCK_RETIRED), 3 replays its
               bits, the merge counters at 0; per layer from a CUDA graph
               at B 1, 2, 8 beside the plain version and the bound;
 23. small-kv8 - a 2-layer 1024-wide int4 first stage on an int8 and a packed
               KV cache, on the card (K5/K6) and on the CPU (plain versions)
               under the same Gumbel draws: the same tokens, or, at the first
               step where they part, the CPU's top two scores closer than the
               largest score gap between the two (a rounding flip, printed);
 24. synth-kv8 - full-width TTS(quantisation_mode="int4", kv_cache_dtype=
               "int8" and "int8_packed").synthesise: a finite wav; K5 and K6
               launches == n_layer x decode steps, K2 == 5 x n_layer x
               prefills, K1 == K3 == K4 == K7 == K8 == 0; ms per token beside
               phase 9's and the cache bytes of each format;
 25. K11     - the plain-int8 matmul against its plain version at the
               main-path shapes (K x N of 2048 x 6144, 2048 x 2048, 2048 x
               5632, 5632 x 2048) at M = 2 (its tensor-core GEMV) and 256
               (its ring of tensor-core tiles), at every M of 1-8, M 9, 16,
               32, 64, 65, 200 and 600, N 16 and 2064, K 5632 and with f32
               x: every element within 1e-3 max |ref| plus one bf16 ulp of
               the element; every int8 value bit for bit on both routes
               (one-hot rows, f32 out); at M 2, 16 and 256 one kernel a
               call (the graph of one call), two calls the same bits, a
               graph of one call replayed 3 times each the eager bits, a
               capture before any eager call raising; times of one layer's
               five projections at M = 2, 16, 32 and 256 beside the plain
               version, torch._weight_int8pack_mm and torch.matmul on the
               bf16-dequantized weight (both replayed from a CUDA graph as
               the kernel is; eagerly, said so, where one cannot be
               captured) and the bound, with each shape's route and cut;
 26. K9      - the plain-int8 attention-block kernel against its plain
               version at the main-path shape (24 stacked layers, D 2048,
               16 heads, B 2, S 2048, bf16 cache) at pos 0, 77, 255, 2047,
               with one row's start past pos and with NaN past pos: y
               within 2e-2 of max |y|, the new row within one bf16 ulp,
               every other slot unchanged; phase 21's graph check at pos
               1000; per layer from a CUDA graph at pos 0, 255, 1000, 2047
               beside the plain version and the bound;
 27. K10     - the plain-int8 FFN kernel against its plain version at D
               2048, I 5632, as phase 22 (rows 1, 2, 3, 8, layers 0, 11,
               23, plus w3 = w1 with s3 = 2 s1, which a scale shared by w1
               and w3 would fail; the capture check and the graph check; B
               1, 2, 8 timed);
 28. small-int8p - 2-layer 512-wide plain-int8 first stages, MHA (T = 1
               through K9/K10) and GQA with 2 kv heads (K11 at M = 2, on its
               GEMV, K4, K10), on the card and on the CPU under the same
               Gumbel draws: the same tokens or phase 23's flip rule, and
               each route's launches;
 29. synth-int8p - full-width TTS(quantisation_mode="int8_plain").synthesise:
               a finite wav; K9 and K10 launches == n_layer x decode steps,
               K11 == 5 x n_layer x prefills, every other kernel 0; ms per
               token beside phases 9 and 14;
 30. K12     - the groupwise int4 matmul against its plain version at the
               main-path shapes (K x N of 2048 x 6144, 2048 x 2048, 2048 x
               5632, 5632 x 2048) at M = 2 (decode) and 256 (prefill), at
               every M of 1-8, M 200, N 16 and 2064, with f32 x, with
               groupsize 64, and at M = 2 with groupsizes 8 and 24: every element within 1e-3 max |ref| plus one
               bf16 ulp of the element; at M = 2 one kernel a call (the
               graph of one call), two calls the same bits and a graph of
               one call replayed 3 times, each replay equal to the eager
               result; times of one layer's five projections at M = 2 and
               256, each shape beside torch._weight_int4pack_mm (as in
               phase 6), the plain version and the bound;
 31. K13     - phase 30 for the nibble-packed matmul;
 32. small-int4g - 2-layer 512-wide groupwise int4 first stages, unpacked
               (K12) and packed (K13), on the card and on the CPU under the
               same Gumbel draws: the same tokens or phase 23's flip rule;
               K1 == n_layer and K12 (K13) == 5 x n_layer a step and a
               prefill of M <= 256, no launch for a 512-row forward;
 33. synth-int4g - full-width TTS.synthesise of a first stage quantized by
               quantize_params_int4 (quantisation_mode None): a finite wav;
               K12 == 5 x n_layer x (decode steps + prefills), K1 == n_layer
               x decode steps, every other kernel 0; ms per token beside
               phases 9 and 29;
 34. synth-int4p - phase 33 with quantize_params_int4_packed and K13, the
               tree written by save_first_stage_quantized and read back by
               load_first_stage_npz with every dtype kept; also the
               int4-in-int32 tree written and read back, its bf16 sc taken
               by one K2 call.
 35. unfused - run after phase 8: a 2-layer int4 first stage at the full
               width (2048d/16H, FFN 5632) at 16 rows, more than the fused
               int4 kernels hold, one T = 1 step through the unfused route
               on the card (K2 for every projection, K1) against the CPU
               path on the same weights and cache: logits within 5e-2 max
               |ref|, K2 == 5 x n_layer and K1 == n_layer launches.
 36. batch-bf16 - full-width bf16 first_stage.generate_batch of 4 ragged
               prompts (17, 53, 90, 128 tokens in one 128 bucket; 8 cache
               rows, per-row windows), 96 new tokens a row at temperature 1,
               top-p 1 on injected Gumbel noise, timed twice: K1 == n_layer
               x decode steps, every other kernel 0; ms a step and tokens/s
               of both runs. A third run keeps its logits and a copy of
               every kernel call's arguments at the prefill, the first
               decode step and the last; each kept call is held against its
               plain version at the kernel's own tolerance, the attention
               kernels' also moved to the cache's last slots (the same
               ragged starts over the longest window); each row's tokens
               are those of the same call on the plain path on the card
               (every kernel wrapper swapped for its plain version, no
               launch), or part at a step where the rounding reorders two
               close scores (the logits of both runs up to that step within
               the route's BATCH_LOGIT_TOL of max |ref|); each row those of
               its prompt generated alone (the same rule);
 37. batch-int4 - phase 36 with int4 weights at B 4 (K2 prefill at M 1024,
               K3 with ragged starts) and B 8 (16 rows: K2 at M 2048, then
               the unfused route, K2 at M 16 + K1 a step); B 4's rows also
               alone (B 8's alone take the stack, another head); K3 at 8
               rows with the ragged starts against its plain version (one
               layer at a time and the stack) and timed from a CUDA graph;
               K2 at M 1024 and 2048 against its plain version and timed;
 38. batch-routes - one 2-layer full-width first stage a route: int8 (K8,
               K7), int4 on the int8 and on the packed cache (K2, K5, K6),
               int8_plain (K11, K9, K10), groupwise int4 and packed (K12 /
               K13 + K1), GQA (K4), each generate_batch at B 4 and B 8 (32
               new tokens) as in phase 36; K7 at 8 rows with ragged starts,
               K8 and K11 at M 1024 and 2048, as in phase 37;
 39. streaming - full-width int4 TTS.synthesise_streaming (192 tokens a chunk
               at most): the seconds to the first yielded chunk and to the
               end; one finite float32 chunk for each segment that holds
               audio tokens, of its frames' samples; K3 == decode steps and
               K2 == 5 x n_layer; generate_segments joined equal to
               generate under the same noise; the port's one render (the
               second stage + vocoder on the device) and the two-call
               render (the codes on the host between them) on the same
               draws within TWO_CALL_TOL;
 40. get_tokens - TTS.get_tokens of a seeded 24 kHz wav on the card: (8,
               frames) codes in [0, 1024); the latent within
               ENCODE_LATENT_TOL of the port's on the CPU, the codes equal
               but where the CPU's two nearest codewords lie within
               ENCODE_GAP of each other;
 41. warmup  - a fresh process: a full-width int4 TTS, TTS.warmup timed with
               the kernel library's load apart, then two synthesises that
               build nothing (the same library, no new file in its build
               directory).
 42. engine-small - the serving engine's join and rebase on a 2-layer
               1024-wide int4 first stage, 2 slots, greedy sampling
               (temperature and top-p 0.01), 32-token buckets, on a bf16
               (K3), an int8 and a packed cache (K5, K6; K2 prefills): a
               request joined at 49 decodes the tokens of generate_batch of
               it alone, and a group rebased by 128 (after a join at 161)
               those of the group unmoved, or the two part where the
               rounding reorders the top two scores (the logits within the
               route's BATCH_LOGIT_TOL up to there); every landing and shift
               on the card equal to the CPU's bit for bit;
 43. engine-int4 - runtime/engine.ContinuousBatchingEngine on a full-width
               int4 TTS: 4 slots (8 rows, K3 with starts), segments of 64,
               rebasing from position 384; engine.warmup timed; seven
               requests of at most 192 tokens (two at once, the rest
               submitted after segments 1, 2 and 4 so that they join or
               wait, one streaming): every wav finite and of its render's
               samples (its frames' samples), the stream's chunks its
               renders in order, joins >= 2, rebases >= 1, truncations 0;
               K3 == decode steps, K2 == 5 x n_layer x (group prefills +
               joins), every other kernel 0; with the engine idle a speaker
               embedding and a render launch no kernel; tokens/s, each
               request's latency, the stream's first chunk and the phase
               timers (utils/phases) printed; then one join with no render
               beside it, timed;
 44. engine-bf16 - the engine on a full-width bf16 TTS, 8 slots (16 rows,
               K1 with starts), eight requests of at most 128 tokens (two
               joining): K1 == n_layer x decode steps, every other kernel 0;
 45. server  - runtime/server.make_handler on phase 43's engine at
               127.0.0.1, port 0: /health; three JSON /tts and one streaming
               /tts at once (wavs; the stream with live RIFF sizes and no
               Content-Length); /metrics counting 4 requests, 1 streaming, no
               error, and the engine's counters; K3 and K2 as in phase 43.

Phases 5, 9, 14, 18, 19, 20, 24, 29, 33, 34, 36-39 and 43-45 are the main paths: every kernel count is
set to 0 just before each and read just after. The two lines before the last are the
kernels' JSON record and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. TF32 is off for matmuls and convolutions
throughout, so every comparison is f32. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = dict(l=24, s=2048, b=2, h=16, dh=128)
K1_TOL = 2e-2
TIMED_POS = (256, 1000, 2047)  # the JSON line carries the last one
K2_TOL = 1e-3
# K3 over 24 layers: the two versions round at the same points, but their f32
# sums run in other orders, so a bf16 rounding can land one ulp apart; a layer
# spreads such a flip into every later value, and the gap grows with depth
# like a random walk (measured on the card: 0.4% of max |ref| after 1 layer,
# 2.2% after 24). So each layer alone, fed the plain version's residual
# stream, is held to K3_LAYER_TOL, and the whole stack to K3_TOL.
K3_TOL = 5e-2
K3_LAYER_TOL = 1e-2
# The small int4 model on the card against the CPU path: the kernels agree
# with their plain versions to ~1e-6 of max |ref| (K2) and one bf16 ulp a
# layer (K3), but the bf16 dense products outside them (speaker projection,
# prefill attention) run on cuBLAS on the card and on the CPU's own kernels,
# which round differently, and two layers spread those flips (measured: 2.25%
# of max |ref| at prefill on the card).
SMALL4_TOL = 5e-2
UNFUSED_ROWS = 16  # the engine's batch 16: more rows than the fused int4 kernels (K3, K5/K6) hold
K2_M = 256  # prefill rows: the CFG pair x a 128-token prompt bucket
# K2 and K8 are also timed at the rows of the unfused int4 route and the int8
# per-layer route (the CFG rows of batches 8 and 16); the JSON line carries M 256
PREFILL_TIMED_M = (K2_M, 16, 32)
# K8: the same bf16 products as its plain version, summed in another order,
# but also sum(x), which both round to bf16 for the c term (c = -128 s takes
# back about 128 s sum(x)); a row whose f32 sum lies on a bf16 rounding
# boundary may round one ulp apart in the two and move by |c| ulp, so each
# row is held at the best of its bf16(sum x) as is or one ulp either way.
K8_TOL = 1e-3
# K7 is held as K3 is: one layer at a time within K3_LAYER_TOL, the whole
# stack within K3_TOL.
K3_TIMED_POS = (0, 255, 1000, 2047)  # the JSON line carries pos 255
K4_TOL = 2e-2
K4_TIMED = ((4, 255), (8, 255), (4, 2032), (8, 2032))  # (T, pos); the JSON line carries T 4, pos 2032
# K5: the plain version takes the same roundings, but its softmax uses the
# window's maximum where the kernel's runs online per split, so the bf16
# roundings of the value weights (int8 caches) and the f32 sums land apart
K5_TOL = 2e-2
K5_POS = (0, 77, 255, 2047)
K5_TIMED = (0, 255, 1000, 2047)  # the JSON line carries the int8 cache at pos 255
K6_TOL = 1e-2
FFN_ROWS = (1, 2, 3, 8)  # K6 and K10 are held at each, on layers FFN_LAYERS
FFN_LAYERS = (0, 11, 23)
FFN_TIMED_ROWS = (1, 2, 8)  # the JSON line carries B 2
FFN_KERNELS = ("stack_gemv", "stack_gemv")  # a K6 / K10 call: w1/w3, then w2
# K11: the same bf16 products as its plain version summed in another order,
# rounded to x's dtype, so a bf16 output may land one ulp apart
K11_TOL = 1e-3
# K11 is timed at the rows of a GQA decode step of the CFG pair (the GEMV), the
# spec verify and batched CFG rows, and the prefill (the ring); the JSON line
# carries M 256, the main path's
K11_TIMED_M = (2, 16, 32, K2_M)
# its card cases beyond the main shapes: every GEMV row count, the ring's row
# tiles and more than 256 rows, N off the GEMV's 64-column grid (16, 2064), K
# 5632 and f32 x (M, K, N, x dtype or None for bf16)
K11_CASES = ([(m, 2048, 2048, None) for m in range(1, 9)]
             + [(m, 2048, 6144, None) for m in (9, 16, 32, 64, 65, 200, 600)]
             + [(2, 2048, 16, None), (2, 2048, 2064, None), (32, 2048, 2064, None), (8, 5632, 2048, None),
                (16, 5632, 2048, None), (600, 5632, 2048, None), (2, 2048, 6144, "f32"), (16, 5632, 2048, "f32"),
                (256, 5632, 2048, "f32")])
# K9: the same roundings as its plain version, but the softmax runs online
# per split and the f32 sums in other orders (as K5)
K9_TOL = 2e-2
K9_POS = (0, 77, 255, 2047)
K9_TIMED = (0, 255, 1000, 2047)  # the JSON line carries pos 255
BLOCK_KERNELS = ("stack_gemv", "attn_row_kernel", "stack_gemv")  # a K5 / K9 call, in order
BLOCK_RETIRED = ("gemv_partial", "gemv8_partial", "gemv_reduce", "decode_attn_split", "decode_attn_combine",
                 "kv_row_write")
K10_TOL = 1e-2
# K12/K13: the same bf16 weights and products as their plain version, summed
# in another order, rounded to x's dtype (as K11)
K12_TOL = 1e-3
K12_DECODE_M = 2  # decode rows: the CFG pair; the JSON line carries this M
K12_TIMED_M = (K12_DECODE_M, 16, 32, K2_M)  # decode, the spec verify and batched CFG rows, prefill
KV_FORMATS = ("bf16", "int8", "int8_packed")
SYNTH_TEXT = "The quick brown fox jumps over the lazy dog, twice."
# phases 36-38: ragged prompts in one 128 bucket (B 4 takes the first four),
# Gumbel draws at temperature 1 and top-p 1, speaker guidance 3
BATCH_PROMPT_LENS = (17, 53, 90, 128, 5, 33, 64, 111)
BATCH_NEW = 96  # new tokens a row in phases 36 and 37
ROUTE_NEW = 32  # and in phase 38
BATCH_GUIDANCE = 3.0
# two runs of a row on the same draws (kernels against the plain path, or in
# a batch against alone) see the same inputs up to the first step where
# their tokens part; until there their logits differ by the rounding drift
# of the route's layers, which grows over the steps through the cache rows
# each run writes. Each route's limit is 1.5 times the largest gap these
# phases measured on an NVIDIA H100 80GB HBM3 at a 700 W limit, at B 4 and
# B 8 and, where held, a row alone against in a batch:
# bf16 24 layers 0.0296, int4 24 layers 0.0968 (a row alone; 0.0776 against
# the plain path), int8 2 layers 0.0727, int4 on an int8 or packed cache
# 0.0364, int8_plain 0.0083, groupwise int4 0.0082 and packed 0.0093, GQA
# 0.0099. The int4-in-int32 and int8-in-int32 routes drift furthest: their
# c terms take back about 128 s bf16(sum x), so a sum that rounds one ulp
# apart moves a product by |c| ulp (k8_row_gap). Each kernel is also held
# alone on the run's own calls (captured_calls, hold_captured) at its own
# tolerance. A decode that ignores the padding moves a padded row's logits
# past the largest limit even on a 2-layer, 64-wide model
# (tests/test_torch_batched_generation.py
# test_chip_row_check_catches_a_window_fault).
BATCH_LOGIT_TOL = {"bf16": 0.045, "int4": 0.15, "int8": 0.11, "int4, int8 cache": 0.055,
                   "int4, packed cache": 0.055, "int8_plain": 0.015, "groupwise int4": 0.015,
                   "groupwise int4 packed": 0.015, "GQA bf16": 0.015}
BATCH_PREFILL_M = (1024, 2048)  # the prefill rows of B 4 and B 8: 2B x 128
STREAM_NEW = 192  # phase 39's first-stage tokens a chunk, as the synthesise phases
TWO_CALL_TOL = 2e-3  # the fused and the two-call wav (the JAX package's own test's tolerance)
# phase 40: the full-width encoder in f32 (TF32 off) on the card and the CPU
# sums in other orders; a frame's codes may part only where the CPU's two
# nearest codewords score within ENCODE_GAP of each other (relative)
ENCODE_LATENT_TOL = 1e-4
ENCODE_GAP = 1e-4
# phases 42-45: the serving layer (runtime/engine.py, runtime/server.py)
ENGINE_SLOTS = 2  # phase 42: 4 cache rows
ENGINE_BUCKET = 32  # phase 42's prompt buckets (the port refuses 16 tokens or fewer)
ENGINE_GREEDY = 0.01  # phases 42-44's temperature and top-p: the argmax, whatever the draws
# phase 42's cache formats -> their route's key in BATCH_LOGIT_TOL
ENGINE_ROUTES = {"bf16": "int4", "int8": "int4, int8 cache", "int8_packed": "int4, packed cache"}
ENGINE_INT4_SLOTS = 4  # phase 43: 8 rows, the int4 decode stack (K3) with starts
ENGINE_BF16_SLOTS = 8  # phase 44: 16 rows, K1 with starts
ENGINE_SEGMENT = 64  # decode steps a segment
ENGINE_NEW = 192  # first-stage tokens a request at most, phases 43 and 45
ENGINE_BF16_NEW = 128  # and phase 44
ENGINE_REBASE_AT = 384  # phase 43 rebases once the timeline reaches this (rebase_margin = block_size - it)
# (segments run before the request is submitted, does it stream): phase 43's two at once, two that join,
# a stream and one more that wait for a slot (deferred, then joined), a late joiner; phase 44's six at
# once and two that join
ENGINE_SCHEDULE = ((0, False), (0, False), (1, False), (1, False), (2, True), (2, False), (4, False))
ENGINE_BF16_SCHEDULE = ((0, False),) * 6 + ((1, False),) * 2
# phases 43 and 44 submit greedy requests, so each request's tokens can be held against the request alone
GREEDY_KNOBS = {"temperature": ENGINE_GREEDY, "top_p": ENGINE_GREEDY}
# H100 SXM data sheet: HBM bytes/s, dense bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
F32_FLOP_S = 67e12


def bound(n_bytes: float, n_flop: float, peak_flop_s: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_flop / peak_flop_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    n_src = len(list(_build.CSRC_DIR.glob("*.cu")))
    print(f"[2 build] {lib.build_seconds:.2f} s: {n_src} nvcc compiles at once + link -> "
          f"{lib.path.name}; ptxas: {regs}")
    return lib.build_seconds


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


def _graph_nodes(torch, fn) -> list[tuple[str, str]]:
    """The nodes of one call of fn() captured in a CUDA graph, as (type,
    name) from the graph's own description (cudaGraphDebugDotPrint)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # keep the cudaGraph_t for the dump
    graph.enable_debug_mode()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: the first call of a wrapper may allocate its counters
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "call.dot")
        graph.debug_dump(path)
        with open(path) as f:
            text = f.read()
    return re.findall(r'label="\{(\w+)\s*\|\s*\{ID \|[^|]*\|\s*([^\\|}]*)', text)


def _one_kernel(torch, fn, what: str) -> str:
    """Fail unless one call of fn(), captured in a CUDA graph, is one kernel
    node and nothing else; the kernel's name."""
    nodes = _graph_nodes(torch, fn)
    if len(nodes) != 1 or nodes[0][0] != "KERNEL":
        fail(f"{what}: one call is {len(nodes)} graph nodes, not one kernel: {nodes}")
    found = re.search(r"attn_\w+?_kernel|int4g_\w+?_gemv", nodes[0][1])
    return found.group(0) if found else nodes[0][1]


def phase_k1(torch) -> dict:
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    layer = 5
    rows = MAIN_SHAPE["b"] * MAIN_SHAPE["h"]
    cases = [(p, None, None) for p in (0, 1, 255, 256, 1000, 2047)]
    cases += [(1000, (300, 700), None), (1000, None, float("nan"))]
    # the edges of attention_plan at 32 rows (one split up to 384 slots, then
    # up to 4 of 128 or more): one split of 101 and of 384 slots, windows
    # ending on a split boundary (512 and 1024 in 4), starts on a boundary,
    # NaN past pos in a window of 4 splits
    cases += [(100, None, None), (383, None, None), (511, None, None), (1023, (256, 767), None),
              (1500, (1, 1499), float("nan"))]
    max_err = 0.0
    plans = {}
    for pos, starts, garbage in cases:
        q, k_new, v_new, kc, vc = _k1_inputs(torch, gen, dev, pos, garbage)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        y_ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc_ref, vc_ref, layer, pos, st)
        before = A.decode_attention.launches
        y, _, _ = A.decode_attention(q, k_new, v_new, kc, vc, layer, pos, st)
        torch.cuda.synchronize()
        what = f"pos {pos} starts {starts} garbage {garbage}"
        if A.decode_attention.launches != before + 1:
            fail(f"K1 counted {A.decode_attention.launches - before} launches for one call at {what}")
        plans[pos + 1] = A.attention_plan(pos + 1, rows, 1)
        if not torch.isfinite(y).all():
            fail(f"K1 output not finite at {what}")
        if not (torch.equal(kc.view(torch.int16), kc_ref.view(torch.int16))
                and torch.equal(vc.view(torch.int16), vc_ref.view(torch.int16))):
            fail(f"K1 caches differ from the plain version at {what}")
        if not torch.equal(kc[layer, pos].view(torch.int16), k_new.view(torch.int16)):
            fail(f"K1 did not write the new row at {what}")
        err = (y.float() - y_ref.float()).abs().max().item()
        max_err = max(max_err, err)
        try:
            torch.testing.assert_close(y.float(), y_ref.float(), atol=K1_TOL, rtol=K1_TOL)
        except AssertionError as e:
            fail(f"K1 disagrees with the plain version at {what}: {e}")
    times = {}
    q, k_new, v_new, kc, vc = _k1_inputs(torch, gen, dev)
    n_layer = MAIN_SHAPE["l"]
    kernel_name = _one_kernel(torch, lambda: A.decode_attention(q, k_new, v_new, kc, vc, 0, TIMED_POS[-1]), "K1")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q[:, :, None, :]
    for pos in TIMED_POS:
        # the library yardstick: SDPA on each layer's window, pre-transposed to (B, H, pos+1, Dh)
        kt = [kc[li, : pos + 1].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        vt = [vc[li, : pos + 1].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        library, _ = _layers_ms(torch, lambda li: sdpa(qt, kt[li], vt[li]), n_layer)
        del kt, vt
        kernel = _layers_ms(torch, lambda li: A.decode_attention(q, k_new, v_new, kc, vc, li, pos), n_layer)
        plain = _layers_ms(
            torch, lambda li: A.decode_attention_reference(q, k_new, v_new, kc, vc, li, pos), n_layer
        )
        times[pos] = (kernel, plain, library)
    window_bytes = lambda p: 2 * (p + 1) * q.numel() * q.element_size()  # noqa: E731
    row = q.numel() * q.element_size()  # one (B, H, Dh) bf16 row
    # read q, k_new, v_new and the window; write the cache row pair and y
    bounds = {p: bound(window_bytes(p) + 3 * row + 2 * row + row, 4.0 * (p + 1) * q.numel(), F32_FLOP_S)
              for p in TIMED_POS}
    shown = "; ".join(
        f"pos {p} (plan {plans.get(p + 1, A.attention_plan(p + 1, rows, 1))}): kernel {k[0]:.4f} ms "
        f"({window_bytes(p) / k[0] / 1e6:.0f} GB/s), SDPA {lib:.4f}, plain {pl[0]:.4f}, bound {bounds[p][0]:.4f} "
        f"on the device; {k[1]:.4f} / {pl[1]:.4f} ms a call from Python"
        for p, (k, pl, lib) in times.items()
    )
    print(f"[3 K1] {len(cases)} cases at {MAIN_SHAPE} bf16 agree (max |dy| {max_err:.3g}, tol {K1_TOL}; caches "
          f"bit-identical, new rows written); one kernel a call ({kernel_name}); plans (window: split_len, "
          f"splits): {plans}; per layer, device time from a CUDA graph (SDPA on the pre-transposed window): "
          f"{shown}")
    pos = TIMED_POS[-1]
    (ms, _), (plain, _), library = times[pos]
    bound_ms, bound_by = bounds[pos]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library}


def to_cuda(node):
    if isinstance(node, dict):
        return {k: to_cuda(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_cuda(v) for v in node]
    return node.cuda()


def to_cpu(node):
    if isinstance(node, dict):
        return {k: to_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_cpu(v) for v in node]
    return node.cpu()


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
    tok_gpu = fs.generate(to_cuda(params), cfg, prompt, spk, noise=noise.cuda(), **kw)
    if not (tok_cpu.shape == tok_gpu.shape and (tok_cpu == tok_gpu).all()):
        fail(f"first stage on the card differs from the CPU path: {tok_gpu} vs {tok_cpu}")
    print(f"[4 small] first stage (2L/512d, f32) on the card == CPU path: "
          f"{len(tok_gpu) - len(prompt)} tokens identical")


def counters() -> dict:
    """TTS.stats key -> (the kernel's wrapper, the wrapper's attribute that
    counts its launches): the table TTS.stats is kept from."""
    from metavoice_tpu_torch.runtime.tts import KERNEL_COUNTERS

    return KERNEL_COUNTERS


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def drive_main_path(tts, ref: str, **kw) -> tuple[str, float, dict]:
    """One synthesise through the user's entry point, every kernel count set
    to 0 just before and read just after -> (wav path, seconds, counts)."""
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    path = tts.synthesise(SYNTH_TEXT, ref, max_new_tokens=192, **kw)
    seconds = time.perf_counter() - t0
    return path, seconds, read_counts()


def write_ref(workdir: str) -> str:
    from metavoice_tpu_torch.utils import audio_io as aio
    import numpy as np

    sr = 24000
    t = np.arange(30 * sr) / sr
    ref = os.path.join(workdir, "ref.wav")
    aio.write_wav(ref, 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)), sr)
    return ref


def check_wav(path: str):
    from metavoice_tpu_torch.utils import audio_io as aio
    import numpy as np

    wav, wav_sr = aio.read_wav(path)
    if wav_sr != 24000 or len(wav) == 0 or not np.isfinite(wav).all():
        fail(f"bad wav: sr {wav_sr}, {len(wav)} samples, finite {np.isfinite(wav).all()}")
    return wav


def phase_synth(torch, workdir: str, ref: str) -> dict:
    from metavoice_tpu_torch.runtime.tts import TTS

    t0 = time.perf_counter()
    tts = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg1 = tts.c.first_stage_cfg
    path, total_s, counts = drive_main_path(tts, ref)
    launches = counts["k1_launches"]
    steps = tts.stats["decode_steps"]
    if launches == 0 or launches != cfg1.n_layer * steps:
        fail(f"K1 launches {launches} != n_layer {cfg1.n_layer} x decode steps {steps}")
    if any(n for name, n in counts.items() if name != "k1_launches"):
        fail(f"the bf16 path launched quantized-weight kernels: {counts}")
    wav = check_wav(path)
    stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
    ms_tok = 1e3 * tts.timings["first_stage"] / max(steps, 1)
    print(f"[5 synth] {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d: init {init_s:.2f} s; "
          f"synthesise {total_s:.2f} s ({stages} s); {steps} decode steps, "
          f"first stage {ms_tok:.2f} ms/token; {launches} K1 launches; "
          f"wav {len(wav)} samples ({len(wav) / 24000:.2f} s) finite")
    return {"counts": counts, "ms_per_token": ms_tok, "seconds": total_s, "timings": dict(tts.timings),
            "tts": tts}


def _int4_bytes(pw, sc) -> int:
    return pw.numel() * pw.element_size() + sc.numel() * sc.element_size()


def _int8_bytes(p8, sc8) -> int:
    """p8 and the two rows of sc8 the kernels read (s at row 0, c at row 8);
    the other 14 rows are zero padding and are never read."""
    return p8.numel() * p8.element_size() + 2 * (sc8.numel() // sc8.shape[-2]) * sc8.element_size()


def phase_k2(torch) -> dict:
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    d, ip = 2048, 6144
    cases = [(K2_M, d, 3 * d), (K2_M, d, d), (K2_M, ip, d), (1, d, d), (200, d, 3 * d), (16, d, 3 * d), (32, ip, d)]
    max_err = 0.0
    for m, k, n in cases:
        pw, sc = Q.quantize_int4_i32(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = Q.matmul_int4_i32(x, pw, sc)
        torch.cuda.synchronize()
        ref = Q.matmul_int4_i32_reference(x, pw, sc)
        if y.shape != (m, n) or not torch.isfinite(y).all():
            fail(f"K2 output bad at M {m}, K {k}, N {n}")
        err = (y - ref).abs().max().item()
        if err > K2_TOL * ref.abs().max().item():
            fail(f"K2 disagrees with the plain version at M {m}, K {k}, N {n}: max |dy| {err:.3g}")
        max_err = max(max_err, err)

    t = prefill_times(torch, "6 K2", "i4", gen)
    print(f"[6 K2] {len(cases)} cases agree (max |dy| {max_err:.3g}, tol {K2_TOL} max |ref|); {t['text']}")
    return {"max_abs_err": max_err, **t["record"]}


def _rotate_ms(torch, fn, n: int) -> float:
    """ms per call of fn(i), i = 0..n-1 in turn, called eagerly (CUDA events)."""
    return _time_ms(torch, lambda: [fn(i) for i in range(n)], 10) / n


def _graph_or_eager_ms(torch, fn, n: int, label: str) -> tuple[float, str]:
    """ms per call of fn(i), i = 0..n-1 in turn: device time replayed from a
    CUDA graph as _layers_ms takes it, or, where the call cannot be captured,
    called eagerly (the reason printed) -> (ms, how it was timed)."""
    try:
        return _layers_ms(torch, fn, n)[0], "CUDA graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[{label}] the library call cannot be captured in a CUDA graph ({str(e)[:160]}); "
              "timing it eagerly")
        return _rotate_ms(torch, fn, n), "eager"


def _int4pack_ms(torch, x, mats, ref, groupsize: int, lib_name: str, label: str) -> tuple[float, str]:
    """One PyTorch call for the groupwise product x @ w with mats [(nib (K,
    N) in 0..15, s (G, N), zero (G, N))], w = (nib - 8) * s + zero per group:
    torch._weight_int4pack_mm on the same nibbles, scales and zeros, or,
    where this torch lacks it or refuses the shape, torch.matmul on the
    bf16-dequantized weight (the dequantization untimed). Its answer is
    checked against ref first; timed as the kernels are, the weights in
    turn replayed from a CUDA graph (_graph_or_eager_ms). -> (ms, the call
    timed and how)."""
    k = x.shape[1]
    tol = 2e-2 * ref.float().abs().max().item()
    if lib_name.startswith("torch._weight_int4pack_mm"):
        try:
            libs = []
            for nib, s, zero in mats:
                q = nib.to(torch.int32).T.contiguous()  # (N, K) in 0..15
                w_lib = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 2)
                sz = torch.stack([s.float(), zero.float()], dim=2).to(torch.bfloat16).contiguous()  # (G, N, 2)
                libs.append((w_lib, sz))
            y = torch._weight_int4pack_mm(x, libs[0][0], groupsize, libs[0][1])
            if (y.float() - ref.float()).abs().max().item() > tol:
                raise RuntimeError("its result disagrees with the int4 product")
            ms, how = _graph_or_eager_ms(
                torch, lambda i: torch._weight_int4pack_mm(x, libs[i][0], groupsize, libs[i][1]), len(libs), label)
            return ms, f"torch._weight_int4pack_mm ({how})"
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            print(f"[{label}] torch._weight_int4pack_mm not usable here ({str(e)[:120]}); "
                  "timing torch.matmul on the bf16-dequantized weight instead")
    dense = []
    for nib, s, zero in mats:
        g = s.shape[0]
        w = (nib.float() - 8).reshape(g, k // g, -1) * s.float()[:, None] + zero.float()[:, None]
        dense.append(w.reshape(k, -1).to(torch.bfloat16))
    ms, how = _graph_or_eager_ms(torch, lambda i: torch.matmul(x, dense[i]), len(dense), label)
    return ms, f"torch.matmul(bf16 dequantized) ({how})"


def _random_int4_model(torch, cfg, seed: int, dev):
    """The first stage's params from a seed, packed to int4 on the device."""
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    lay = params["layers"]
    for key in ("attn_norm_w", "ffn_norm_w"):
        lay[key] = (1 + 0.1 * torch.randn(lay[key].shape, generator=gen, device=dev)).to(torch.bfloat16)
    return Q.quantize_params_int4_i32(params)


def _k3_args(qp):
    lay = qp["layers"]
    return (lay["attn_norm_w"], lay["ffn_norm_w"],
            *[t for k in ("wqkv", "wo", "w1", "w3", "w2") for t in (lay[k]["pw"], lay[k]["sc"])])


def stack_worst_layer(torch, x, args, kc, vc, pos, n_head, **kw) -> float:
    """Largest gap, as a share of max |ref|, between the decode stack (K3 or
    K7) and its plain version run one layer at a time, each fed the plain version's residual stream
    (copies of the caches: the originals stay as they are)."""
    from metavoice_tpu_torch.ops import decode_stack as DS

    worst = 0.0
    for li in range(kc.shape[0]):
        one = [a[li : li + 1] for a in args]
        got = DS.decode_stack_int4(x, *one, kc[li : li + 1].clone(), vc[li : li + 1].clone(),
                                   pos, n_head, **kw)[0].float()
        x = DS.decode_stack_int4_reference(x, *one, kc[li : li + 1].clone(), vc[li : li + 1].clone(),
                                           pos, n_head, **kw)[0]
        ref = x.float()
        worst = max(worst, (got - ref).abs().max().item() / ref.abs().max().item())
    return worst


STACK_KERNELS_A_LAYER = 6  # qkv, attention split and combine, o-proj, w1/w3, w2


def stack_graph_check(torch, fn, what: str) -> list[str]:
    """Capture one whole decode-stack step fn() in a CUDA graph and replay it
    3 times: every replay's outputs the same bits as an eager call's, which
    are the same bits twice, and the merge tickets back at 0. -> the
    kernel nodes of one captured step (their names)."""
    from metavoice_tpu_torch.ops import decode_stack as DS

    eager = [t.clone() for t in fn() if t.dim() == 2]
    again = [t for t in fn() if t.dim() == 2]
    if not all(torch.equal(a, b) for a, b in zip(eager, again)):
        fail(f"{what}: two eager steps differ")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [t for t in fn() if t.dim() == 2]
    for i in range(3):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(eager, outs)):
            fail(f"{what}: graph replay {i} differs from the eager step")
    tickets = DS._stack_tickets[torch.cuda.current_device()]
    if tickets.any():
        fail(f"{what}: the merge tickets are not back at 0 after the replays")
    del graph
    return [name for kind, name in _graph_nodes(torch, fn) if kind == "KERNEL"]


def stack_gemv_rate(torch, fn, weight_bytes: int) -> tuple[float, float]:
    """(ms, GB/s): the products' (stack_gemv) device time a step, from the
    profiler over 3 replays of a captured step, and the weight bytes over it.
    A product starts before the kernel before it has finished (programmatic
    dependent launch), so its time counts some waiting: the rate is a floor."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "stack_gemv" in e.name)
    if us <= 0:
        return float("nan"), float("nan")
    ms = us / 3 / 1e3
    return ms, weight_bytes / ms / 1e6


def phase_k3(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import decode_stack as DS

    dev = torch.device("cuda")
    b = MAIN_SHAPE["b"]
    models = {h_kv: (first_stage_config(n_local_heads=h_kv),) for h_kv in (16, 2)}
    models = {h: (cfg, _random_int4_model(torch, cfg, h, dev)) for h, (cfg,) in models.items()}
    cases = [(p, None, None, 16) for p in K3_TIMED_POS]
    cases += [(1000, (300, 700), None, 16), (1000, None, float("nan"), 16), (1000, None, None, 2)]
    gen = torch.Generator(device=dev).manual_seed(33)
    max_err = worst_layer = worst_rel = 0.0
    for pos, starts, garbage, h_kv in cases:
        cfg, qp = models[h_kv]
        shape = (cfg.n_layer, cfg.block_size, b, h_kv, cfg.head_dim)
        kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        if garbage is not None:
            kc[:, pos + 1 :] = garbage
            vc[:, pos + 1 :] = garbage
        x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kw = dict(n_kv_head=h_kv, starts=st, norm_eps=cfg.norm_eps, ln_f_w=qp["ln_f_w"],
                  head_pw=qp["lm_head_q"]["pw"], head_sc=qp["lm_head_q"]["sc"])
        kc0, vc0 = kc.clone(), vc.clone()
        kr, vr = kc.clone(), vc.clone()
        layer_kw = dict(n_kv_head=h_kv, starts=st, norm_eps=cfg.norm_eps)
        layer_gap = stack_worst_layer(torch, x, _k3_args(qp), kc, vc, pos, cfg.n_head, **layer_kw)
        xo, _, _, lg = DS.decode_stack_int4(x, *_k3_args(qp), kc, vc, pos, cfg.n_head, **kw)
        torch.cuda.synchronize()
        xr, _, _, lr = DS.decode_stack_int4_reference(x, *_k3_args(qp), kr, vr, pos, cfg.n_head, **kw)
        what = f"pos {pos} starts {starts} garbage {garbage} n_kv_head {h_kv}"
        if not layer_gap <= K3_LAYER_TOL:
            fail(f"K3 disagrees with the plain version one layer at a time at {what}: "
                 f"{layer_gap:.3g} of max |ref|")
        worst_layer = max(worst_layer, layer_gap)
        v = cfg.vocab_size
        if not (torch.isfinite(xo).all() and torch.isfinite(lg).all()):
            fail(f"K3 output not finite at {what}")
        for name, got, ref in (("x_out", xo.float(), xr.float()), ("logits", lg[:, :v], lr[:, :v])):
            err = (got - ref).abs().max().item()
            if not err <= K3_TOL * ref.abs().max().item():
                fail(f"K3 {name} disagrees with the plain version at {what}: max |d| {err:.3g}, "
                     f"max |ref| {ref.abs().max().item():.3g}")
            max_err = max(max_err, err)
            worst_rel = max(worst_rel, err / ref.abs().max().item())
        if lg[:, v:].any():
            fail(f"K3 vocab pad logits are not exactly 0 at {what}")
        others = torch.ones(cfg.block_size, dtype=torch.bool, device=dev)
        others[pos] = False
        for got, ref, orig in ((kc, kr, kc0), (vc, vr, vc0)):
            row, ref_row = got[0, pos].float(), ref[0, pos].float()
            excess = ((row - ref_row).abs() - ref_row.abs() * 2.0**-7).max().item()
            if excess > 1e-4 * ref_row.abs().max().item():
                fail(f"K3 layer 0's new cache row is more than one bf16 ulp off at {what}")
            if not torch.equal(got[:, others].view(torch.int16), orig[:, others].view(torch.int16)):
                fail(f"K3 changed cache slots other than pos at {what}")
        del kc, vc, kc0, vc0, kr, vr

    cfg, qp = models[16]
    del models[2]
    shape = (cfg.n_layer, cfg.block_size, b, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(norm_eps=cfg.norm_eps, ln_f_w=qp["ln_f_w"], head_pw=qp["lm_head_q"]["pw"],
              head_sc=qp["lm_head_q"]["sc"])
    lay = qp["layers"]
    weight_bytes = sum(_int4_bytes(lay[k]["pw"], lay[k]["sc"]) for k in ("wqkv", "wo", "w1", "w3", "w2"))
    head_bytes = _int4_bytes(qp["lm_head_q"]["pw"], qp["lm_head_q"]["sc"])
    pos_t = torch.tensor(255, dtype=torch.int32, device=dev)

    def one_step():
        return DS.decode_stack_int4(x, *_k3_args(qp), kc, vc, pos_t, cfg.n_head, **kw)

    names = stack_graph_check(torch, one_step, "K3")
    want = STACK_KERNELS_A_LAYER * cfg.n_layer + 1
    if len(names) != want or any(bad in n for n in names for bad in ("rmsnorm", "gemv_reduce", "gemv_partial")):
        fail(f"K3: a captured step is {len(names)} kernels, not {want} (6 a layer and the head's): "
             f"{sorted(set(names))}")
    gemv_ms, gemv_gbs = stack_gemv_rate(torch, one_step, weight_bytes + head_bytes)
    graph_note = (f"a captured step: {len(names)} kernels ({STACK_KERNELS_A_LAYER} a layer + the head), "
                  f"3 replays the eager step's bits, tickets back at 0; products {gemv_ms:.4f} ms a step of "
                  f"profiled device time, {gemv_gbs:.0f} GB/s of weights (a floor: PDL overlap counts)")
    macs = sum(lay[k]["pw"].numel() * 8 for k in ("wqkv", "wo", "w1", "w3", "w2"))
    macs += qp["lm_head_q"]["pw"].numel() * 8
    vp = qp["lm_head_q"]["pw"].shape[1]
    # norm weights, ln_f, x in and out, logits out
    small = 2 * cfg.n_layer * cfg.dim * 2 + cfg.dim * 2 + 2 * b * cfg.dim * 2 + b * vp * 4
    times, shown = {}, []
    for pos in K3_TIMED_POS:
        def step(_):
            return DS.decode_stack_int4(x, *_k3_args(qp), kc, vc, pos, cfg.n_head, **kw)

        device_ms, eager_ms = _layers_ms(torch, step, 20)  # 20 steps: 14 GB, far past the L2
        plain_ms = _time_ms(torch, lambda: DS.decode_stack_int4_reference(
            x, *_k3_args(qp), kc, vc, pos, cfg.n_head, **kw), 3)
        kv_bytes = 2 * cfg.n_layer * (pos + 1) * b * 16 * cfg.head_dim * 2  # window + row writes
        n_bytes = weight_bytes + head_bytes + small + kv_bytes + 2 * cfg.n_layer * b * cfg.dim * 2
        n_flop = 2.0 * b * macs + 4.0 * cfg.n_layer * b * cfg.n_head * (pos + 1) * cfg.head_dim
        bound_ms, bound_by = bound(n_bytes, n_flop, BF16_FLOP_S)
        times[pos] = (device_ms, plain_ms, bound_ms, bound_by)
        shown.append(f"pos {pos}: {device_ms:.4f} ms on the device ({n_bytes / device_ms / 1e6:.0f} GB/s), "
                     f"{eager_ms:.4f} ms a call from Python, plain {plain_ms:.3f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by})")
    print(f"[7 K3] {len(cases)} cases at 24L/16H/2048d, B {b}, S 2048, Vp 3072 agree: one layer at "
          f"a time within {worst_layer:.3g} of max |ref| (tol {K3_LAYER_TOL}); all 24 layers, "
          f"x_out and logits, within {worst_rel:.3g} (max |d| {max_err:.3g}; tol {K3_TOL}); pad "
          f"logits 0; layer 0's new row within one ulp; other slots unchanged; {graph_note}; "
          f"{'; '.join(shown)}")
    device_ms, plain_ms, bound_ms, bound_by = times[255]
    return {"max_abs_err": max_err, "ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_small4(torch):
    """int4 first stage on the card vs the CPU path (plain versions), same weights."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024, intermediate_size=2048, block_size=512)
    gen = torch.Generator().manual_seed(8)
    cpu = Q.quantize_params_int4_i32(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
    gpu = to_cuda(cpu)
    prompt = torch.randint(0, cfg.vocab_size, (40,), generator=gen)
    idx = torch.zeros((2, 128), dtype=torch.long)
    idx[:, :40] = prompt
    spk2 = torch.randn((1, 256), generator=gen).repeat(2, 1)
    steps = torch.randint(0, 1024, (8,), generator=gen)
    runs = {}
    for name, params in (("cpu", cpu), ("cuda", gpu)):
        dev = torch.device(name)
        kv = tfm.KVCache.create(cfg, 2, cfg.block_size, device=dev)
        mask = fs.make_spk_cond_mask(1, device=dev)
        logits, kv = tfm.forward(params, cfg, idx.to(dev), spk_emb=spk2.to(dev), spk_cond_mask=mask,
                                 kv_cache=kv, cache_pos=0)
        out = [logits[0][:, :40].float().cpu()]
        for i, tok in enumerate(steps.tolist()):
            x = tfm.embed_inputs(params, cfg, torch.full((2, 1), tok, device=dev),
                                 torch.tensor([40 + i], device=dev), spk2.to(dev), mask)
            lg, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, 40 + i, fused_head=True)
            if not head_done:
                fail("the int4 decode step did not fuse the head")
            out.append(lg.float().cpu())
        runs[name] = out
    gaps = [(got - ref).abs().max().item() / ref.abs().max().item()
            for ref, got in zip(runs["cpu"], runs["cuda"])]
    if not max(gaps) <= SMALL4_TOL:
        fail(f"int4 first stage on the card differs from the CPU path: prefill and steps "
             f"{[round(g, 4) for g in gaps]} of max |ref| (tol {SMALL4_TOL})")
    n = 48
    noise = S.gumbel_noise((n, 1, cfg.vocab_size), device="cpu", generator=gen)
    toks = [fs.generate(p, cfg, prompt.tolist(), spk2[0].numpy(), noise=nz, max_new_tokens=n)[40:]
            for p, nz in ((cpu, noise), (gpu, noise.cuda()))]
    same = next((i for i, (a, c) in enumerate(zip(*toks)) if a != c), min(map(len, toks)))
    print(f"[8 small4] int4 first stage (2L/8H/1024d, Ip 2048) on the card vs the CPU path: "
          f"prefill logits and 8 teacher-forced steps within {[round(g, 4) for g in gaps]} of "
          f"max |ref| (tol {SMALL4_TOL}); free-running under shared Gumbel noise: first {same} of "
          f"{len(toks[0])}/{len(toks[1])} tokens identical (printed, not required)")


def phase_unfused(torch):
    """The unfused int4 route on the card: a 2-layer first stage at the full
    width (2048d/16H, FFN 5632) at UNFUSED_ROWS rows, more than the fused
    kernels hold, one T = 1 step through K2 (every projection) and K1 on a
    bf16 cache, against the CPU path (plain versions) on the same weights
    and cache: logits within SMALL4_TOL of max |ref|, and the launches."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    cfg = first_stage_config(n_layer=2, block_size=256)
    gen = torch.Generator().manual_seed(35)
    cpu = Q.quantize_params_int4_i32(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
    gpu = to_cuda(cpu)
    rows, pos = UNFUSED_ROWS, 100
    route = tfm.int4_decode_route(cpu, cfg, rows, torch.bfloat16)
    if route != "unfused":
        fail(f"a {rows}-row int4 step takes the {route!r} route, not the unfused one")
    shape = (cfg.n_layer, pos, rows, cfg.n_local_heads, cfg.head_dim)
    window = [torch.randn(shape, generator=gen).to(torch.bfloat16) for _ in range(2)]
    tokens = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen)
    spk = torch.randn((rows, 256), generator=gen)
    runs = {}
    for name, params in (("cpu", cpu), ("cuda", gpu)):
        dev = torch.device(name)
        kv = tfm.KVCache.create(cfg, rows, cfg.block_size, device=dev)
        kv.k[:, :pos], kv.v[:, :pos] = window[0].to(dev), window[1].to(dev)
        for fn, attr in counters().values():
            setattr(fn, attr, 0)
        x = tfm.embed_inputs(params, cfg, tokens.to(dev), torch.tensor([pos], device=dev), spk.to(dev))
        out, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, pos, fused_head=True)
        if head_done:
            fail("the unfused int4 step fused a head")
        logits = tfm.output_logits(params, cfg, out)[0][:, 0].float().cpu()
        runs[name] = (logits, read_counts())
    want = dict.fromkeys(counters(), 0)
    want.update({"k2_launches": 5 * cfg.n_layer, "k1_launches": cfg.n_layer})
    if runs["cpu"][1] != dict.fromkeys(counters(), 0) or runs["cuda"][1] != want:
        fail(f"the unfused int4 step launched {runs['cuda'][1]} on the card (expected {want}) and "
             f"{runs['cpu'][1]} on the CPU")
    ref, got = runs["cpu"][0], runs["cuda"][0]
    gap = (got - ref).abs().max().item() / ref.abs().max().item()
    if not (torch.isfinite(got).all() and gap <= SMALL4_TOL):
        fail(f"the unfused int4 step on the card differs from the CPU path: {gap:.4g} of max |ref| "
             f"(tol {SMALL4_TOL})")
    print(f"[35 unfused] int4 {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d at {rows} rows, bf16 cache, pos {pos}: "
          f"route {route!r}; logits within {gap:.4g} of max |ref| of the CPU path (tol {SMALL4_TOL}); "
          f"launches {({k: v for k, v in want.items() if v})}")


def phase_synth_quantized(torch, workdir: str, ref: str, mode, label: str, per_step: dict,
                          matmul: str, compared: dict, tts=None, init_s=None) -> dict:
    """Full-width TTS(quantisation_mode=mode).synthesise, or that of ``tts``
    built by the caller in ``init_s`` seconds: a finite wav, each kernel of
    ``per_step`` launched that many times a decode step, the prefill matmul
    5 x n_layer more times a prefill, every other kernel never. -> counts,
    the TTS and ms per token."""
    from metavoice_tpu_torch.core.text import chunk_text, normalize_text
    from metavoice_tpu_torch.runtime.tts import MAX_CHARS_PER_CHUNK, TTS

    if tts is None:
        t0 = time.perf_counter()
        tts = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, f"out_{mode}"),
                              quantisation_mode=mode)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
    cfg1 = tts.c.first_stage_cfg
    path, total_s, counts = drive_main_path(tts, ref)
    steps = tts.stats["decode_steps"]
    prefills = len(chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK) or [""])
    want = dict.fromkeys(counts, 0)
    want.update({k: steps * n for k, n in per_step.items()})
    want[matmul] += 5 * cfg1.n_layer * prefills
    if steps == 0 or counts != want:
        fail(f"[{label}] synthesise launched {counts}, expected {want}")
    check_stats(tts, counts)
    wav = check_wav(path)
    stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
    ms_tok = 1e3 * tts.timings["first_stage"] / max(steps, 1)
    shown = "; ".join(f"{name}: {ms:.2f}" for name, ms in compared.items())
    print(f"[{label}] {mode or 'groupwise int4 leaves'} {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d: init + quantize "
          f"{init_s:.2f} s; synthesise {total_s:.2f} s ({stages} s); {steps} decode steps, first stage "
          f"{ms_tok:.2f} ms/token ({shown}); launches {({k: v for k, v in counts.items() if v})}; wav "
          f"{len(wav)} samples finite")
    return {"counts": counts, "tts": tts, "ms_per_token": ms_tok}


def k8_row_gap(torch, y, ref, x, sc8) -> float:
    """Largest row gap between y and ref as a share of max |ref|, each row
    taken at the best of its bf16(sum x) as is or one ulp either way."""
    xs = x.to(torch.bfloat16).float().sum(-1).to(torch.bfloat16)
    c = sc8[sc8.shape[0] // 2].float()
    flips = [torch.zeros_like(xs.float())] + [
        (xs.view(torch.int16) + d).view(torch.bfloat16).float() - xs.float() for d in (-1, 1)
    ]
    gap = torch.stack([(y - ref - f[:, None] * c[None, :]).abs().amax(-1) for f in flips]).amin(0)
    return gap.max().item() / ref.abs().max().item()


def phase_k8(torch) -> dict:
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(88)
    d, ip = 2048, 6144
    cases = [(K2_M, d, 3 * d), (K2_M, d, d), (K2_M, ip, d), (1, d, d), (2, d, 3 * d), (200, d, 3 * d),
             (16, d, 3 * d), (32, ip, d)]
    max_err = worst = 0.0
    rounding = []  # the TPU kernel's bf16(sum x) against an unrounded sum, at K = 2048
    for m, k, n in cases:
        p8, sc8 = Q.quantize_int8_i32(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        y = Q.matmul_int8_i32(x, p8, sc8)
        torch.cuda.synchronize()
        ref = Q.matmul_int8_i32_reference(x, p8, sc8)
        if y.shape != (m, n) or not torch.isfinite(y).all():
            fail(f"K8 output bad at M {m}, K {k}, N {n}")
        gap = k8_row_gap(torch, y, ref, x, sc8)
        if not gap <= K8_TOL:
            fail(f"K8 disagrees with the plain version at M {m}, K {k}, N {n}: {gap:.3g} of max |ref|")
        max_err = max(max_err, (y - ref).abs().max().item())
        worst = max(worst, gap)
        if k == d and m == K2_M:
            exact = ref + (x.float().sum(-1) - x.float().sum(-1).to(torch.bfloat16).float())[:, None] \
                * sc8[sc8.shape[0] // 2].float()[None, :]
            rounding.append((ref - exact).abs().max().item() / exact.abs().max().item())

    t = prefill_times(torch, "11 K8", "i8", gen)
    print(f"[11 K8] {len(cases)} cases agree (rows within {worst:.3g} of max |ref| after the sum "
          f"flip allowance, tol {K8_TOL}; raw max |dy| {max_err:.3g}); {t['text']}; the c term's bf16(sum x) "
          f"moves the product by up to {max(rounding):.3g} of max |y| against an unrounded sum (K {d}, "
          f"M {K2_M}, x ~ N(0, 1))")
    return {"max_abs_err": max_err, **t["record"]}


def _prefill_yardsticks(torch, wfmt: str, packed, ref, xk, label: str):
    """The two yardsticks of a K2 / K8 shape, each weight set made once: the
    library call (torch._weight_int4pack_mm on the same nibbles, scales and
    zeros, w = (nib - 8) * s + zero, so zero = c + 8 s; or
    torch._weight_int8pack_mm on the same int8 values and scales), checked
    against ref at M 256, or None where this torch lacks it or refuses the
    shape; and torch.matmul on the bf16-dequantized weight (cuBLAS, the
    dequantization untimed). -> (library fn(x, i) or None, its name, matmul fn(x, i))."""
    from metavoice_tpu_torch.ops import quantized as Q

    tol = 2e-2 * ref.float().abs().max().item()  # bf16 weights: a few bf16 ulps of the sum
    k = xk.shape[1]
    dense, lib, name = [], None, None
    if wfmt == "i4":
        g = k // Q.I32_GROUPSIZE
        mats = []
        for pw, sc in packed:
            s, c = sc[:g].float(), sc[sc.shape[0] // 2 : sc.shape[0] // 2 + g].float()
            nib = Q.unpack_int4_i32(pw).to(torch.int32) + 8
            mats.append((nib, s, c + 8 * s))
            w = (nib.float() - 8).reshape(g, k // g, -1) * s[:, None] + (c + 8 * s)[:, None]
            dense.append(w.reshape(k, -1).to(torch.bfloat16))
        name = "torch._weight_int4pack_mm"
        try:
            libs = []
            for nib, s, zero in mats:
                q = nib.T.contiguous()  # (N, K) in 0..15
                w_lib = torch._convert_weight_to_int4pack((q[:, ::2] << 4 | q[:, 1::2]).to(torch.uint8), 2)
                libs.append((w_lib, torch.stack([s, zero], dim=2).to(torch.bfloat16).contiguous()))
            if (torch._weight_int4pack_mm(xk, libs[0][0], Q.I32_GROUPSIZE, libs[0][1]).float()
                    - ref.float()).abs().max().item() > tol:
                raise RuntimeError("its result disagrees with the int4 product")
            lib = lambda x, i: torch._weight_int4pack_mm(x, libs[i][0], Q.I32_GROUPSIZE, libs[i][1])  # noqa: E731
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            print(f"[{label}] {name} not usable here ({str(e)[:120]}); the library column is torch.matmul's")
    else:
        name = "torch._weight_int8pack_mm"
        libs = []
        for p8, sc8 in packed:
            q = Q.unpack_int8_i32(p8)
            dense.append((q.float() * sc8[0].float()).to(torch.bfloat16))
            libs.append((q.T.contiguous(), sc8[0].to(torch.bfloat16).contiguous()))
        try:
            if (torch._weight_int8pack_mm(xk, *libs[0]).float() - ref.float()).abs().max().item() > tol:
                raise RuntimeError("its result disagrees with the int8 product")
            lib = lambda x, i: torch._weight_int8pack_mm(x, *libs[i])  # noqa: E731
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            print(f"[{label}] {name} not usable here ({str(e)[:120]}); the library column is torch.matmul's")
    if (torch.matmul(xk, dense[0]).float() - ref.float()).abs().max().item() > tol:
        fail(f"[{label}] torch.matmul on the dequantized weight disagrees with the product")
    return lib, name, lambda x, i: torch.matmul(x, dense[i])


def prefill_times(torch, label: str, wfmt: str, gen) -> dict:
    """Device times of one prefill layer's five projections (qkv, wo, w1, w3,
    w2 at D 2048, FFN padded to 6144), each on 8 weight sets in turn (50 MB
    and more a shape), so the weights come from HBM, at each M of
    PREFILL_TIMED_M: the kernel (K2 wfmt "i4", K8 "i8"), its plain version
    (M 256), the library call and torch.matmul on the bf16-dequantized
    weight, each replayed from a CUDA graph (a library call that cannot be
    captured is called eagerly, and says so), with the bounds. -> {"record":
    the JSON line's fields at M 256, "text": the phase's line}."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    d, ip = 2048, 6144
    layer_shapes = [(d, 3 * d), (d, d), (d, ip), (d, ip), (ip, d)]  # qkv, wo, w1, w3, w2
    quantize, call, plain, nbytes = (
        (Q.quantize_int4_i32, Q.matmul_int4_i32, Q.matmul_int4_i32_reference, _int4_bytes) if wfmt == "i4" else
        (Q.quantize_int8_i32, Q.matmul_int8_i32, Q.matmul_int8_i32_reference, _int8_bytes))
    xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for m in PREFILL_TIMED_M for k in (d, ip)}
    tot = {m: {"kernel": 0.0, "library": 0.0, "matmul": 0.0, "bytes": 0.0, "flop": 0.0, "per": []}
           for m in PREFILL_TIMED_M}
    plain_ms, lib_name, how = 0.0, None, set()
    for k, n in layer_shapes:
        packed = [quantize(torch.randn((k, n), generator=gen, device=dev) * 0.02) for _ in range(8)]
        ref = plain(xs[(K2_M, k)], *packed[0])
        lib, lib_name, mm = _prefill_yardsticks(torch, wfmt, packed, ref, xs[(K2_M, k)], label)
        for m in PREFILL_TIMED_M:
            xk, row = xs[(m, k)], tot[m]
            t_k, _ = _layers_ms(torch, lambda i: call(xk, *packed[i]), len(packed))
            t_m, _ = _layers_ms(torch, lambda i: mm(xk, i), len(packed))
            if lib is None:
                t_l = t_m
            else:
                t_l, h = _graph_or_eager_ms(torch, lambda i: lib(xk, i), len(packed), label)
                how.add(h)
            if m == K2_M:
                plain_ms += _layers_ms(torch, lambda i: plain(xk, *packed[i]), len(packed))[0]
            row["kernel"] += t_k
            row["library"] += t_l
            row["matmul"] += t_m
            row["bytes"] += xk.numel() * 2 + nbytes(*packed[0]) + m * n * 4
            row["flop"] += 2.0 * m * k * n
            row["per"].append(f"{t_k:.4f}")
        del packed
    parts, record = [], {}
    lib_label = f"{lib_name} ({'/'.join(sorted(how))})" if how else "torch.matmul (bf16 dequantized)"
    for m in PREFILL_TIMED_M:
        row = tot[m]
        b_ms, b_by = bound(row["bytes"], row["flop"], BF16_FLOP_S)
        parts.append(f"M {m}: kernel {row['kernel']:.4f} ms (qkv, wo, w1, w3, w2: {', '.join(row['per'])}), "
                     f"{lib_label} {row['library']:.4f}, torch.matmul on the bf16-dequantized weight "
                     f"{row['matmul']:.4f}, bound {b_ms:.4f} ms ({b_by}, {row['flop'] / 1e9:.2f} GFLOP, "
                     f"{row['bytes'] / 1e6:.1f} MB), kernel at {row['flop'] / row['kernel'] / 1e9:.1f} TFLOP/s, "
                     f"{row['bytes'] / row['kernel'] / 1e6:.1f} GB/s")
        if m == K2_M:
            record = {"ms": row["kernel"], "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": row["library"], "library_call": lib_label, "matmul_ms": row["matmul"]}
        else:
            record |= {f"m{m}_ms": row["kernel"], f"m{m}_bound_ms": b_ms, f"m{m}_library_ms": row["library"],
                       f"m{m}_matmul_ms": row["matmul"]}
    text = (f"one layer's five projections, device time from CUDA graphs of 8 weight sets in turn: "
            f"{'; '.join(parts)}; plain version at M {K2_M} {plain_ms:.4f} ms")
    return {"record": record, "text": text}


def _k7_args(qp):
    lay = qp["layers"]
    return (lay["attn_norm_w"], lay["ffn_norm_w"],
            *[t for k in ("wqkv", "wo", "w1", "w3", "w2") for t in (lay[k]["p8"], lay[k]["sc8"])])


def _random_int8_model(torch, cfg, seed: int, dev):
    """The first stage's params from a seed, packed to int8 on the device."""
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    lay = params["layers"]
    for key in ("attn_norm_w", "ffn_norm_w"):
        lay[key] = (1 + 0.1 * torch.randn(lay[key].shape, generator=gen, device=dev)).to(torch.bfloat16)
    return Q.quantize_params_int8_i32(params)


def phase_k7(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import decode_stack as DS

    dev = torch.device("cuda")
    b = MAIN_SHAPE["b"]
    models = {}
    for h_kv in (16, 2):
        cfg = first_stage_config(n_local_heads=h_kv)
        models[h_kv] = (cfg, _random_int8_model(torch, cfg, 70 + h_kv, dev))
    cases = [(p, None, None, 16) for p in K3_TIMED_POS]
    cases += [(1000, (300, 700), None, 16), (1000, None, float("nan"), 16), (1000, None, None, 2)]
    gen = torch.Generator(device=dev).manual_seed(77)
    max_err = worst_layer = worst_rel = 0.0
    for pos, starts, garbage, h_kv in cases:
        cfg, qp = models[h_kv]
        shape = (cfg.n_layer, cfg.block_size, b, h_kv, cfg.head_dim)
        kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        if garbage is not None:
            kc[:, pos + 1 :] = garbage
            vc[:, pos + 1 :] = garbage
        x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kw = dict(n_kv_head=h_kv, starts=st, norm_eps=cfg.norm_eps, wfmt="i8")
        kc0, vc0 = kc.clone(), vc.clone()
        kr, vr = kc.clone(), vc.clone()
        layer_gap = stack_worst_layer(torch, x, _k7_args(qp), kc, vc, pos, cfg.n_head, **kw)
        xo, _, _ = DS.decode_stack_int4(x, *_k7_args(qp), kc, vc, pos, cfg.n_head, **kw)
        torch.cuda.synchronize()
        xr, _, _ = DS.decode_stack_int4_reference(x, *_k7_args(qp), kr, vr, pos, cfg.n_head, **kw)
        what = f"pos {pos} starts {starts} garbage {garbage} n_kv_head {h_kv}"
        if not layer_gap <= K3_LAYER_TOL:
            fail(f"K7 disagrees with the plain version one layer at a time at {what}: "
                 f"{layer_gap:.3g} of max |ref|")
        worst_layer = max(worst_layer, layer_gap)
        if not torch.isfinite(xo).all():
            fail(f"K7 output not finite at {what}")
        err = (xo.float() - xr.float()).abs().max().item()
        if not err <= K3_TOL * xr.float().abs().max().item():
            fail(f"K7 x_out disagrees with the plain version at {what}: max |d| {err:.3g}")
        max_err = max(max_err, err)
        worst_rel = max(worst_rel, err / xr.float().abs().max().item())
        others = torch.ones(cfg.block_size, dtype=torch.bool, device=dev)
        others[pos] = False
        for got, ref, orig in ((kc, kr, kc0), (vc, vr, vc0)):
            row, ref_row = got[0, pos].float(), ref[0, pos].float()
            excess = ((row - ref_row).abs() - ref_row.abs() * 2.0**-7).max().item()
            if excess > 1e-4 * ref_row.abs().max().item():
                fail(f"K7 layer 0's new cache row is more than one bf16 ulp off at {what}")
            if not torch.equal(got[:, others].view(torch.int16), orig[:, others].view(torch.int16)):
                fail(f"K7 changed cache slots other than pos at {what}")
        del kc, vc, kc0, vc0, kr, vr

    cfg, qp = models[16]
    del models[2]
    shape = (cfg.n_layer, cfg.block_size, b, 16, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(norm_eps=cfg.norm_eps, wfmt="i8")
    lay = qp["layers"]
    keys = ("wqkv", "wo", "w1", "w3", "w2")
    weight_bytes = sum(_int8_bytes(lay[k]["p8"], lay[k]["sc8"]) for k in keys)
    pos_t = torch.tensor(255, dtype=torch.int32, device=dev)

    def one_step():
        return DS.decode_stack_int4(x, *_k7_args(qp), kc, vc, pos_t, cfg.n_head, **kw)

    names = stack_graph_check(torch, one_step, "K7")
    want = STACK_KERNELS_A_LAYER * cfg.n_layer
    if len(names) != want or any(bad in n for n in names for bad in ("rmsnorm", "gemv_reduce", "gemv_partial")):
        fail(f"K7: a captured step is {len(names)} kernels, not {want} (6 a layer): {sorted(set(names))}")
    gemv_ms, gemv_gbs = stack_gemv_rate(torch, one_step, weight_bytes)
    graph_note = (f"a captured step: {len(names)} kernels ({STACK_KERNELS_A_LAYER} a layer), 3 replays the "
                  f"eager step's bits, tickets back at 0; products {gemv_ms:.4f} ms a step of profiled device "
                  f"time, {gemv_gbs:.0f} GB/s of weights (a floor: PDL overlap counts)")
    macs = sum(lay[k]["p8"].numel() * 4 for k in keys)
    small = 2 * cfg.n_layer * cfg.dim * 2 + 2 * b * cfg.dim * 2  # norm weights, x in and out
    times, shown = {}, []
    for pos in K3_TIMED_POS:
        def step(_):
            return DS.decode_stack_int4(x, *_k7_args(qp), kc, vc, pos, cfg.n_head, **kw)

        device_ms, eager_ms = _layers_ms(torch, step, 12)  # 12 steps: 16 GB, far past the L2
        plain_ms = _time_ms(torch, lambda: DS.decode_stack_int4_reference(
            x, *_k7_args(qp), kc, vc, pos, cfg.n_head, **kw), 3)
        kv_bytes = 2 * cfg.n_layer * (pos + 1) * b * 16 * cfg.head_dim * 2  # window + row writes
        n_bytes = weight_bytes + small + kv_bytes + 2 * cfg.n_layer * b * cfg.dim * 2
        n_flop = 2.0 * b * macs + 4.0 * cfg.n_layer * b * cfg.n_head * (pos + 1) * cfg.head_dim
        bound_ms, bound_by = bound(n_bytes, n_flop, BF16_FLOP_S)
        times[pos] = (device_ms, plain_ms, bound_ms, bound_by)
        shown.append(f"pos {pos}: {device_ms:.4f} ms on the device ({n_bytes / device_ms / 1e6:.0f} GB/s), "
                     f"{eager_ms:.4f} ms a call from Python, plain {plain_ms:.3f} ms, "
                     f"bound {bound_ms:.4f} ms ({bound_by}, {n_bytes / 1e6:.1f} MB)")
    print(f"[12 K7] {len(cases)} cases at 24L/16H/2048d int8, B {b}, S 2048 agree: one layer at a "
          f"time within {worst_layer:.3g} of max |ref| (tol {K3_LAYER_TOL}); all 24 layers' x_out "
          f"within {worst_rel:.3g} (max |d| {max_err:.3g}; tol {K3_TOL}); layer 0's new row within "
          f"one ulp; other slots unchanged; {graph_note}; {'; '.join(shown)}")
    device_ms, plain_ms, bound_ms, bound_by = times[255]
    return {"max_abs_err": max_err, "ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_small8(torch):
    """int8 first stages on the card vs the CPU path (plain versions), same
    weights: one decodes through K7, a narrower one per layer (K8 + K1)."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    shown = []
    for name, cfg in (
        ("stack", first_stage_config(n_layer=2, n_head=8, dim=1024, intermediate_size=2048, block_size=512)),
        ("per-layer", first_stage_config(n_layer=2, n_head=4, dim=512, block_size=512)),
    ):
        gen = torch.Generator().manual_seed(18)
        cpu = Q.quantize_params_int8_i32(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
        gpu = to_cuda(cpu)
        stack = tfm.int8_stack_ok(cpu, cfg, 2, torch.bfloat16)
        if stack != (name == "stack"):
            fail(f"the {name} int8 model takes the {'stack' if stack else 'per-layer'} route")
        prompt = torch.randint(0, cfg.vocab_size, (40,), generator=gen)
        idx = torch.zeros((2, 128), dtype=torch.long)
        idx[:, :40] = prompt
        spk2 = torch.randn((1, 256), generator=gen).repeat(2, 1)
        steps = torch.randint(0, 1024, (8,), generator=gen)
        runs = {}
        for dev_name, params in (("cpu", cpu), ("cuda", gpu)):
            dev = torch.device(dev_name)
            for fn, attr in counters().values():
                setattr(fn, attr, 0)
            kv = tfm.KVCache.create(cfg, 2, cfg.block_size, device=dev)
            mask = fs.make_spk_cond_mask(1, device=dev)
            logits, kv = tfm.forward(params, cfg, idx.to(dev), spk_emb=spk2.to(dev), spk_cond_mask=mask,
                                     kv_cache=kv, cache_pos=0)
            out = [logits[0][:, :40].float().cpu()]
            for i, tok in enumerate(steps.tolist()):
                x = tfm.embed_inputs(params, cfg, torch.full((2, 1), tok, device=dev),
                                     torch.tensor([40 + i], device=dev), spk2.to(dev), mask)
                h, kv, head_done = tfm.apply_blocks(params, cfg, x, None, kv, 40 + i, fused_head=True)
                if head_done:
                    fail("an int8 decode step fused a head")
                out.append(tfm.output_logits(params, cfg, h)[0][:, 0, :].float().cpu())
            runs[dev_name] = (out, read_counts())
        n, n_steps = cfg.n_layer, len(steps)
        want = dict.fromkeys(counters(), 0)
        if name == "stack":
            want.update({"k8_launches": 5 * n, "k7_launches": n_steps})
        else:
            want.update({"k8_launches": 5 * n * (1 + n_steps), "k1_launches": n * n_steps})
        if runs["cpu"][1] != dict.fromkeys(counters(), 0) or runs["cuda"][1] != want:
            fail(f"the {name} int8 model launched {runs['cuda'][1]} on the card (expected {want}) "
                 f"and {runs['cpu'][1]} on the CPU")
        gaps = [(got - ref).abs().max().item() / ref.abs().max().item()
                for ref, got in zip(runs["cpu"][0], runs["cuda"][0])]
        if not max(gaps) <= SMALL4_TOL:
            fail(f"the {name} int8 first stage on the card differs from the CPU path: prefill and "
                 f"steps {[round(g, 4) for g in gaps]} of max |ref| (tol {SMALL4_TOL})")
        shown.append(f"{name} route ({cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d): prefill logits and "
                     f"{n_steps} teacher-forced steps within {[round(g, 4) for g in gaps]} of max |ref| "
                     f"(tol {SMALL4_TOL}), launches {({k: v for k, v in want.items() if v})}")
    print(f"[13 small8] int8 first stages on the card vs the CPU path: {'; '.join(shown)}")


def check_stats(tts, counts: dict):
    """TTS.stats' kNN_launches must agree with the kernel counts."""
    if {key: tts.stats[key] for key in counts} != counts:
        fail(f"TTS.stats {tts.stats} disagrees with the kernel counts {counts}")


def phase_profile(torch, tts, label: str, families: dict):
    """Where a 64-token first-stage generate spends its device time, by the
    kernel families given (name -> a substring of the kernel's name)."""
    import numpy as np
    from metavoice_tpu_torch.models import first_stage as fs

    params, cfg = tts.c.first_stage_params, tts.c.first_stage_cfg
    prompt = tts.c.tokenizer.encode(SYNTH_TEXT)
    spk = np.random.default_rng(0).normal(size=256).astype(np.float32) * 0.1
    stats: dict = {}

    def run():
        fs.generate(params, cfg, prompt, spk, max_new_tokens=64, kv_cache=tts._kv_cache, stats=stats)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{label}] the profiler saw no device time: busy share not measured")
        return
    by = {name: 0.0 for name in families}
    by["other (PyTorch: embedding, sampling, prefill attention, copies)"] = 0.0
    for e in kernels:
        fam = next((k for k, pat in families.items() if pat in e.name), None)
        by[fam or "other (PyTorch: embedding, sampling, prefill attention, copies)"] += \
            e.time_range.elapsed_us() / 1e3
    empty = [name for name, ms in by.items() if name in families and ms <= 0]
    if empty:
        fail(f"[{label}] kernel families with no device time (renamed kernels?): {empty}")
    total = sum(by.values())
    shown = ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    steps = stats["decode_steps"]
    print(f"[{label}] generate, prefill + {steps} decode steps: {wall_ms:.1f} ms unprofiled "
          f"({wall_ms / max(steps, 1):.2f} ms a step with the prefill spread over them); "
          f"{len(kernels)} device records, {total:.2f} ms of device time = "
          f"{100 * total / wall_ms:.1f}% of the unprofiled wall time; {shown}")


def _k4_inputs(torch, gen, dev, b, h, h_kv, t, pos=None, garbage=None):
    l, s, dh = MAIN_SHAPE["l"], MAIN_SHAPE["s"], MAIN_SHAPE["dh"]

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    q, k_new, v_new = r(b, h, t, dh), r(b, h_kv, t, dh), r(b, h_kv, t, dh)
    k_cache, v_cache = r(l, s, b, h_kv, dh), r(l, s, b, h_kv, dh)
    if garbage is not None:
        k_cache[:, pos + t :] = garbage
        v_cache[:, pos + t :] = garbage
    return q, k_new, v_new, k_cache, v_cache


def phase_k4(torch) -> dict:
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4444)
    layer = 7
    b, h = MAIN_SHAPE["b"], MAIN_SHAPE["h"]
    # (B, H_kv, T, pos, starts, garbage)
    cases = [(b, h, t, p, None, None) for t in (4, 8, 16) for p in (0, 255, 1000, 2032)]
    cases += [(b, 2, t, p, None, None) for t in (1, 8) for p in (255, 2032)]
    cases += [(3, h, 4, 500, None, None), (b, h, 4, 1000, (300, 1500), None),
              (b, h, 8, 1000, None, float("nan")), (b, 2, 8, 700, (100, 650), float("nan"))]
    # the edges of attention_plan (one split up to 384 slots, then splits of
    # 128 or more, about one block an SM): one split (104 slots), windows
    # ending on a split boundary (512 in 4 splits; GQA T 1: 2048 in 16, the
    # most; GQA T 8, 4 query groups: 1024 in 8), GQA starts with NaN past pos
    cases += [(b, h, 4, 100, None, None), (b, h, 4, 508, None, None), (b, 2, 1, 2047, None, None),
              (b, 2, 8, 1016, None, None), (b, 2, 1, 1500, (256, 1000), float("nan"))]
    max_err = 0.0
    plans = {}
    for bb, h_kv, t, pos, starts, garbage in cases:
        q, k_new, v_new, kc, vc = _k4_inputs(torch, gen, dev, bb, h, h_kv, t, pos, garbage)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        y_ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kc_ref, vc_ref, layer, pos, st)
        before = A.decode_attention_multi.launches
        y, _, _ = A.decode_attention_multi(q, k_new, v_new, kc, vc, layer, pos, st)
        torch.cuda.synchronize()
        what = f"B {bb}, H_kv {h_kv}, T {t}, pos {pos}, starts {starts}, garbage {garbage}"
        if A.decode_attention_multi.launches != before + 1:
            fail(f"K4 counted {A.decode_attention_multi.launches - before} launches for one call at {what}")
        plans[(bb, h_kv, t, pos + t)] = A.attention_plan(pos + t, bb * h_kv, t * h // h_kv)
        if not torch.isfinite(y).all():
            fail(f"K4 output not finite at {what}")
        if not (torch.equal(kc.view(torch.int16), kc_ref.view(torch.int16))
                and torch.equal(vc.view(torch.int16), vc_ref.view(torch.int16))):
            fail(f"K4 caches differ from the plain version at {what}")
        if not torch.equal(kc[layer, pos : pos + t].view(torch.int16),
                           k_new.permute(2, 0, 1, 3).contiguous().view(torch.int16)):
            fail(f"K4 did not write the new rows at {what}")
        max_err = max(max_err, (y.float() - y_ref.float()).abs().max().item())
        try:
            torch.testing.assert_close(y.float(), y_ref.float(), atol=K4_TOL, rtol=K4_TOL)
        except AssertionError as e:
            fail(f"K4 disagrees with the plain version at {what}: {e}")
        del q, k_new, v_new, kc, vc, kc_ref, vc_ref

    n_layer = MAIN_SHAPE["l"]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    times, shown, kernels = {}, [], set()
    for h_kv, t, pos in [(h, t, p) for t, p in K4_TIMED] + [(2, 1, 2032)]:
        q, k_new, v_new, kc, vc = _k4_inputs(torch, gen, dev, b, h, h_kv, t)
        n = pos + t
        kernels.add(_one_kernel(torch, lambda: A.decode_attention_multi(q, k_new, v_new, kc, vc, 0, pos), "K4"))
        y_ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kc, vc, 0, pos)  # rows into layer 0
        # the library yardstick: SDPA on each layer's window, pre-transposed
        # to (B, H_kv, pos+T, Dh), under the causal-offset mask
        mask = torch.arange(n, device=dev)[None, :] <= pos + torch.arange(t, device=dev)[:, None]
        kt = [kc[li, :n].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        vt = [vc[li, :n].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        gqa = dict(enable_gqa=True) if h_kv != h else {}
        y_lib = sdpa(q, kt[0], vt[0], attn_mask=mask, **gqa)
        if (y_lib.float() - y_ref.float()).abs().max().item() > K4_TOL * (1 + y_ref.float().abs().max().item()):
            fail(f"SDPA disagrees with K4's plain version at H_kv {h_kv}, T {t}, pos {pos}")
        library, _ = _layers_ms(torch, lambda li: sdpa(q, kt[li], vt[li], attn_mask=mask, **gqa), n_layer)
        # at T = 1 the causal-offset mask is all true: SDPA without it too
        nomask = _layers_ms(torch, lambda li: sdpa(q, kt[li], vt[li], **gqa), n_layer)[0] if t == 1 else None
        del kt, vt
        kernel = _layers_ms(torch, lambda li: A.decode_attention_multi(q, k_new, v_new, kc, vc, li, pos), n_layer)
        plain, _ = _layers_ms(
            torch, lambda li: A.decode_attention_multi_reference(q, k_new, v_new, kc, vc, li, pos), n_layer)
        rows = 2 * t * b * h_kv * 128 * 2  # the T new K and V rows, bf16
        n_bytes = 2 * n * b * h_kv * 128 * 2 + rows + 2 * q.numel() * 2  # window, rows, q and y
        bound_ms, bound_by = bound(n_bytes, 4.0 * b * h * t * n * 128, BF16_FLOP_S)
        times[(h_kv, t, pos)] = (kernel[0], plain, library, bound_ms, bound_by, nomask)
        plan = A.attention_plan(n, b * h_kv, t * h // h_kv)
        shown.append(f"H_kv {h_kv} T {t} pos {pos} (plan {plan}): kernel {kernel[0]:.4f} ms ({n_bytes / kernel[0] / 1e6:.0f} "
                     f"GB/s; {kernel[1]:.4f} a call from Python), plain {plain:.4f}, SDPA {library:.4f}"
                     + ("" if nomask is None else f" (without the mask {nomask:.4f})")
                     + f", bound {bound_ms:.4f} ({bound_by}, {n_bytes / 1e6:.2f} MB)")
        del q, k_new, v_new, kc, vc
    print(f"[16 K4] {len(cases)} cases at L 24, S 2048, Dh 128 bf16 agree (max |dy| {max_err:.3g}, tol "
          f"{K4_TOL}; caches bit-identical, new rows written); one kernel a call ({', '.join(sorted(kernels))}); "
          f"plans ((B, H_kv, T, window): split_len, splits): {plans}; per layer, device time from a CUDA graph: "
          f"{'; '.join(shown)}")
    ms, plain, library, bound_ms, bound_by, _ = times[(h, 4, 2032)]
    gqa_ms, _, gqa_library, gqa_bound_ms, _, gqa_nomask = times[(2, 1, 2032)]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library,
            "gqa_t1": {"ms": gqa_ms, "library_ms": gqa_library, "library_no_mask_ms": gqa_nomask,
                       "bound_ms": gqa_bound_ms}}


def phase_small_spec(torch):
    """Speculative decoding on the card vs the CPU path, same weights and draws."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import spec_decode as sd
    from metavoice_tpu_torch.models import transformer as tfm

    cfg = first_stage_config(n_layer=2, n_head=4, dim=512, block_size=512)
    dcfg = first_stage_config(n_layer=1, n_head=2, dim=256, block_size=512)
    gen = torch.Generator().manual_seed(17)
    params = tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.float32)
    draft = tfm.init_params(dcfg, device="cpu", generator=gen, dtype=torch.float32)
    spk = torch.randn(256, generator=gen).numpy()
    prompt = list(range(2100, 2140))
    gamma, n = 4, 48
    draws = sd.SpecDraws.sample(n, gamma, cfg.vocab_size, generator=gen)
    kw = dict(gamma=gamma, max_new_tokens=n, compute_dtype=torch.float32, return_stats=True, draws=draws)
    runs = {}
    for name, (p, d) in (("cpu", (params, draft)), ("cuda", (to_cuda(params), to_cuda(draft)))):
        for fn, attr in counters().values():
            setattr(fn, attr, 0)
        runs[name] = (*sd.generate_spec(p, cfg, d, dcfg, prompt, spk, **kw), read_counts())
    (tok_cpu, st_cpu, _), (tok_gpu, st_gpu, counts) = runs["cpu"], runs["cuda"]
    if not (tok_cpu.shape == tok_gpu.shape and (tok_cpu == tok_gpu).all() and st_cpu == st_gpu):
        fail(f"speculative decoding on the card differs from the CPU path: {tok_gpu} {st_gpu} vs "
             f"{tok_cpu} {st_cpu}")
    want = dict.fromkeys(counts, 0)
    want.update({"k4_launches": cfg.n_layer * st_gpu["rounds"],
                 "k1_launches": dcfg.n_layer * gamma * st_gpu["rounds"]})
    if counts != want:
        fail(f"the small speculative run launched {counts}, expected {want}")
    greedy = dict(temperature=1e-6, top_p=1.0, max_new_tokens=n, compute_dtype=torch.float32)
    gp = to_cuda(params)
    ref = fs.generate(gp, cfg, prompt, spk, **greedy)
    tok, st = sd.generate_spec(gp, cfg, gp, cfg, prompt, spk, gamma=gamma, return_stats=True, **greedy)
    if not (st["accepted"] == st["proposed"] and tok.shape == ref.shape and (tok == ref).all()):
        fail(f"greedy self-draft speculation on the card: {st}, tokens equal "
             f"{tok.shape == ref.shape and (tok == ref).all()}")
    print(f"[17 small-spec] target 2L/4H/512d, draft 1L/2H/256d (f32), gamma {gamma}, injected draws: "
          f"the card == the CPU path, {len(tok_gpu) - len(prompt)} tokens, ledger {st_gpu}, launches "
          f"{({k: v for k, v in counts.items() if v})}; greedy self-draft: {st} (all accepted), "
          f"{len(tok) - len(prompt)} tokens == first_stage.generate's")


def _spec_ledger_ok(st: dict, gamma: int) -> bool:
    return (st["rounds"] >= 1 and st["proposed"] == gamma * st["rounds"] and 0 <= st["accepted"] <= st["proposed"]
            and st["rounds"] <= st["emitted"] <= gamma * st["rounds"])


def phase_synth_spec(torch, workdir: str, ref: str, comps: dict, ordinary: dict) -> dict:
    """Full-width synthesise with a draft, bf16 and int4 -> {mode: result}."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.core.text import chunk_text, normalize_text
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.runtime.tts import MAX_CHARS_PER_CHUNK, TTS

    dcfg = first_stage_config(n_layer=4, n_head=8, dim=1024)  # scripts/make_bench_draft.py's default shape
    dgen = torch.Generator(device="cuda").manual_seed(18)
    draft = tfm.init_params(dcfg, device="cuda", generator=dgen, dtype=torch.bfloat16)
    prefills = len(chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK) or [""])
    results, shown = {}, []
    for mode, gamma, use_cfg in ((None, 4, True), ("int4", 8, False)):
        dparams = draft if mode is None else Q.quantize_params_int4_i32(draft)
        tts = TTS(comps[mode], device="cuda", output_dir=os.path.join(workdir, f"out_spec_{mode}"),
                  quantisation_mode=mode, draft_params=dparams, draft_cfg=dcfg,
                  speculative_gamma=gamma, draft_use_cfg=use_cfg, enforce_min_ref_duration=False)
        n_layer = tts.c.first_stage_cfg.n_layer
        path, total_s, counts = drive_main_path(tts, ref)
        st = tts.spec_stats
        rounds = st["rounds"]
        want = dict.fromkeys(counts, 0)
        want["k4_launches"] = n_layer * rounds
        if mode is None:
            want["k1_launches"] = dcfg.n_layer * gamma * rounds
        else:
            want["k3_launches"] = gamma * rounds
            want["k2_launches"] = 5 * n_layer * (prefills + rounds) + 5 * dcfg.n_layer * prefills
        if rounds == 0 or counts != want or tts.stats["spec_rounds"] != rounds:
            fail(f"{mode or 'bf16'} speculative synthesise launched {counts} in {rounds} rounds, expected {want}")
        if not _spec_ledger_ok(st, gamma):
            fail(f"{mode or 'bf16'} speculative ledger incoherent: {st}")
        check_stats(tts, counts)
        wav = check_wav(path)
        ms_tok = 1e3 * tts.timings["first_stage"] / (st["emitted"] + 1)
        name = mode or "bf16"
        results[name] = {"counts": counts, "ms_per_token": ms_tok, "stats": dict(st)}
        shown.append(f"{name} target + {'int4 CFG-free' if mode else 'dense bf16'} draft, gamma {gamma}: "
                     f"synthesise {total_s:.2f} s, {st['emitted'] + 1} tokens in {rounds} rounds "
                     f"({st['emitted'] / rounds:.2f} a round), acceptance {st['accepted'] / st['proposed']:.3f}, "
                     f"first stage {ms_tok:.2f} ms per emitted token (ordinary {name} "
                     f"{ordinary[name]:.2f} ms/token in this call); launches "
                     f"{({k: v for k, v in counts.items() if v})}; wav {len(wav)} samples finite")
        del tts
        torch.cuda.empty_cache()
    print(f"[18 synth-spec] draft 4L/8H/1024d on random weights (acceptance is not a speed claim): "
          f"{'; '.join(shown)}")
    return results


def phase_synth_route(torch, workdir: str, ref: str, label: str, tts, kernel: str, **kw) -> dict:
    """A full-width bf16 synthesise whose decode steps each launch ``kernel``
    once a layer, and no other kernel."""
    cfg1 = tts.c.first_stage_cfg
    path, total_s, counts = drive_main_path(tts, ref, **kw)
    steps = tts.stats["decode_steps"]
    want = dict.fromkeys(counts, 0)
    want[kernel] = cfg1.n_layer * steps
    if steps == 0 or counts != want:
        fail(f"[{label}] launched {counts} in {steps} decode steps, expected {want}")
    check_stats(tts, counts)
    wav = check_wav(path)
    ms_tok = 1e3 * tts.timings["first_stage"] / max(steps, 1)
    rows = tts._persistent_kv_cache(kw.get("guidance_scale", 3.0)).batch_size
    print(f"[{label}] {cfg1.n_layer}L/{cfg1.n_head}H ({cfg1.n_local_heads} kv heads)/{cfg1.dim}d bf16, "
          f"{kw or 'guidance 3.0'}, {rows} cache rows: synthesise {total_s:.2f} s; {steps} decode steps, "
          f"first stage {ms_tok:.2f} ms/token; {counts[kernel]} {kernel}; wav {len(wav)} samples finite")
    return {"counts": counts, "ms_per_token": ms_tok}


def _kv_cache(torch, cfg, fmt: str, gen, dev, b: int, pos: int = 0, garbage=None):
    """A filled (L, S, B, H_kv, 128) cache of ``fmt`` at the config's shape:
    random bf16 values, or random int8 values (words) with scales in
    [0.005, 0.03) and zero padding columns. ``garbage`` fills a bf16 cache
    past ``pos``."""
    from metavoice_tpu_torch.models import transformer as tfm

    kv = tfm.KVCache.create(cfg, b, cfg.block_size, dtype=torch.bfloat16 if fmt == "bf16" else fmt, device=dev)
    if fmt == "bf16":
        for t in (kv.k, kv.v):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
            if garbage is not None:
                t[:, pos + 1 :] = garbage
        return kv
    lo, hi = (-127, 128) if fmt == "int8" else (-(2**31), 2**31)
    for t in (kv.k, kv.v):
        t.copy_(torch.randint(lo, hi, t.shape, generator=gen, device=dev, dtype=t.dtype))
    bkv = b * cfg.n_local_heads
    for t in (kv.k_scale, kv.v_scale):
        t[..., :bkv] = 0.005 + 0.025 * torch.rand(t[..., :bkv].shape, generator=gen, device=dev)
    return kv


def _k5_args(qp):
    lay = qp["layers"]
    return lay["wqkv"]["pw"], lay["wqkv"]["sc"], lay["wo"]["pw"], lay["wo"]["sc"]


def _new_slots(torch, kv, layer: int, pos: int, bkv: int):
    """Boolean masks of the cache tensors' elements a K5 call at (layer,
    pos) may change: the new row (its word row, packed), its scales."""
    masks = []
    for t in (kv.k, kv.v, kv.k_scale, kv.v_scale):
        m = torch.zeros(t.shape, dtype=torch.bool, device=t.device) if t is not None else None
        masks.append(m)
    row = pos // 4 if kv.packed else pos
    for m in masks[:2]:
        m[layer, row] = True
    if kv.quantized:
        for m in masks[2:]:
            if kv.packed:
                m[layer, pos % 4, pos // 4, 0, :bkv] = True
            else:
                m[layer, pos, 0, :bkv] = True
    return masks


def _scales_before(torch, kv, layer: int, starts, h_kv: int):
    """Boolean masks of the k and v scale tables' entries at ``layer`` of
    each batch row's slots before its start (its h_kv columns)."""
    masks = []
    for t in (kv.k_scale, kv.v_scale):
        m = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
        for b, lo in enumerate(starts):
            cols = slice(b * h_kv, (b + 1) * h_kv)
            if kv.packed:
                for r in range(4):  # slot s at [layer, s % 4, s // 4]
                    m[layer, r, : (lo - r + 3) // 4, 0, cols] = True
            else:
                m[layer, :lo, 0, cols] = True
        masks.append(m)
    return masks


def k5_case(torch, qp, cfg, fmt: str, pos: int, gen, *, starts=None, garbage=None, layer: int = 5) -> float:
    """One K5 call against its plain version on copies of the same cache:
    y within K5_TOL of max |y|; nothing but the new row and its scales
    changed (bit for bit); the new row within one int8 step (its scales 1e-6
    relative) or, bf16, one ulp plus 1e-4 of its largest value -> max |dy| /
    max |y|. ``garbage`` fills a bf16 cache past pos, or the k and v scales
    of a quantized cache's slots before each row's start, in the kernel's
    cache only (the plain version reads them, weighted by 0).
    Raises AssertionError on a disagreement."""
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b, h_kv = MAIN_SHAPE["b"], cfg.n_local_heads
    kv = _kv_cache(torch, cfg, fmt, gen, dev, b, pos, garbage)
    ref = type(kv)(*[None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)])
    planted = [None, None, None, None]
    if garbage is not None and kv.quantized:
        planted[2:] = _scales_before(torch, kv, layer, starts, h_kv)
        for t, m in zip((kv.k_scale, kv.v_scale), planted[2:]):
            t[m] = garbage
    orig = type(kv)(*[None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)])
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    kw = dict(n_kv_head=h_kv, starts=st)
    y_ref = A.decode_attention_block_int4_reference(x, *_k5_args(qp), ref.k, ref.v, layer, pos, cfg.n_head,
                                                    k_scale=ref.k_scale, v_scale=ref.v_scale, **kw)[0].float()
    y = A.decode_attention_block_int4(x, *_k5_args(qp), kv.k, kv.v, layer, pos, cfg.n_head,
                                      k_scale=kv.k_scale, v_scale=kv.v_scale, **kw)[0].float()
    torch.cuda.synchronize()
    what = f"{fmt} cache, n_kv_head {h_kv}, pos {pos}, starts {starts}, garbage {garbage}"
    assert y.shape == (b, cfg.dim) and torch.isfinite(y).all(), f"K5 output bad at {what}"
    rel = (y - y_ref).abs().max().item() / y_ref.abs().max().item()
    assert rel <= K5_TOL, f"K5 disagrees with the plain version at {what}: {rel:.3g} of max |y|"
    bkv = b * h_kv
    masks = _new_slots(torch, kv, layer, pos, bkv)
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for got, want, before, m, g in zip((kv.k, kv.v, kv.k_scale, kv.v_scale), (ref.k, ref.v, ref.k_scale, ref.v_scale),
                                       (orig.k, orig.v, orig.k_scale, orig.v_scale), masks, planted):
        if got is None:
            continue
        got_b, want_b, before_b = (t.view(ints.get(t.dtype, t.dtype)) for t in (got, want, before))  # NaN == NaN
        keep = ~m if g is None else ~m & ~g
        assert torch.equal(got_b[keep], want_b[keep]) and torch.equal(got_b[~m], before_b[~m]), \
            f"K5 changed cache elements besides the new row at {what}"
    if kv.packed:  # the new row's word row: its other three bytes kept
        keep = A._packed_byte_mask(pos)
        for got, want, before in ((kv.k, ref.k, orig.k), (kv.v, ref.v, orig.v)):
            for other in (want, before):
                assert not ((got[layer, pos // 4] ^ other[layer, pos // 4]) & keep).any(), \
                    f"K5 changed the neighbours of the new row's byte at {what}"
    if fmt == "bf16":
        for got, want in ((kv.k, ref.k), (kv.v, ref.v)):
            row, ref_row = got[layer, pos].float(), want[layer, pos].float()
            excess = ((row - ref_row).abs() - ref_row.abs() * 2.0**-7).max().item()
            assert excess <= 1e-4 * ref_row.abs().max().item(), f"K5's new bf16 row is more than one ulp off at {what}"
        return rel
    for got, want in ((kv.k, ref.k), (kv.v, ref.v)):
        row, ref_row = got[layer, pos // 4 if kv.packed else pos], want[layer, pos // 4 if kv.packed else pos]
        if kv.packed:
            sh = 8 * (pos % 4)
            row, ref_row = (row >> sh).to(torch.int8), (ref_row >> sh).to(torch.int8)
        step = (row.int() - ref_row.int()).abs().max().item()
        assert step <= 1, f"K5's new int8 row is {step} steps off at {what}"
    for got, want in ((kv.k_scale, ref.k_scale), (kv.v_scale, ref.v_scale)):
        idx = (layer, pos % 4, pos // 4, 0) if kv.packed else (layer, pos, 0)
        s, s_ref = got[idx][:bkv], want[idx][:bkv]
        assert (s_ref > 0).all() and ((s - s_ref).abs() <= 1e-6 * s_ref).all(), f"K5's new scales differ at {what}"
    return rel


def _k5_bound(qp, cfg, fmt: str, pos: int, b: int) -> tuple[float, str]:
    """K5's least time at (fmt, pos): one layer's packed wqkv/wo and scales,
    the window's values and scales, x, y and the new row; its products."""
    lay = qp["layers"]
    h_kv, dh, d = cfg.n_local_heads, cfg.head_dim, cfg.dim
    w_bytes = sum(_int4_bytes(lay[k]["pw"][0], lay[k]["sc"][0]) for k in ("wqkv", "wo"))
    elem = 2 if fmt == "bf16" else 1
    row = b * h_kv * dh * elem + (0 if fmt == "bf16" else b * h_kv * 4)  # one slot of K or V, its scales
    n_bytes = w_bytes + 2 * (pos + 1) * row + 2 * row + 2 * b * d * 2
    qout = lay["wqkv"]["pw"].shape[-1]
    n_flop = 2.0 * b * d * (qout + d) + 4.0 * b * cfg.n_head * (pos + 1) * dh
    return bound(n_bytes, n_flop, BF16_FLOP_S)


def block_graph_check(torch, fn, what: str, kernels: tuple = BLOCK_KERNELS) -> list[str]:
    """One K5, K6, K9 or K10 call fn() -> (y, caches, scales...): two eager
    calls give the same bits; the call captured in a CUDA graph and replayed
    3 times gives the eager call's bits each time; the merge counters of the
    products (and of the attention, where the call attends) are back at 0
    after every call; the captured call is ``kernels`` (BLOCK_KERNELS, or
    FFN_KERNELS) and none of BLOCK_RETIRED. -> the kernel names of the
    captured call. Raises AssertionError on a disagreement."""
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import decode_stack as DS

    dev = torch.cuda.current_device()

    def bits(ts):
        return [t.reshape(-1).view(torch.uint8) for t in ts if t is not None]

    def tickets_at_0() -> bool:
        torch.cuda.synchronize()
        tables = [DS._stack_tickets] + ([A._tickets] if "attn_row_kernel" in kernels else [])
        return not any(t[dev].any() for t in tables)

    eager = [t.clone() for t in bits(fn())]
    assert tickets_at_0(), f"{what}: the merge counters are not back at 0 after an eager call"
    again = bits(fn())
    assert all(torch.equal(a, b) for a, b in zip(eager, again)), f"{what}: two eager calls differ"
    assert tickets_at_0(), f"{what}: the merge counters are not back at 0 after an eager call"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    for i in range(3):
        outs[0].zero_()
        graph.replay()
        assert tickets_at_0(), f"{what}: the merge counters are not back at 0 after graph replay {i}"
        assert all(torch.equal(a, b) for a, b in zip(eager, bits(outs))), f"{what}: graph replay {i} differs"
    del graph
    names = [name for kind, name in _graph_nodes(torch, fn) if kind == "KERNEL"]
    found = [next((k for k in kernels if k in n), n) for n in names]
    assert found == list(kernels) and not any(old in n for n in names for old in BLOCK_RETIRED), \
        f"{what}: one call is {len(names)} kernels, not {len(kernels)} {kernels}: {names}"
    return found


def capture_first_raises(torch, fn, what: str, tables=None):
    """With the device's merge counters not yet made (``tables``: (module,
    name) of each table fn() takes; the decode GEMV's by default), a
    CUDA-graph capture of fn() raises and makes none
    (ops/quantized.merge_tickets); the counters are put back after. Raises
    AssertionError otherwise."""
    from metavoice_tpu_torch.ops import decode_stack as DS

    tables = tables or ((DS, "_stack_tickets"),)
    saved = [getattr(mod, name) for mod, name in tables]
    for mod, name in tables:
        setattr(mod, name, {})
    try:
        try:
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                fn()
        except RuntimeError as e:
            assert "eager call" in str(e), f"{what}: a capture before any eager call raised another error: {e}"
        else:
            raise AssertionError(f"{what}: a capture before any eager call did not raise")
        assert not any(getattr(mod, name) for mod, name in tables), f"{what}: a refused capture made merge counters"
    finally:
        for (mod, name), table in zip(tables, saved):
            setattr(mod, name, table)


def phase_k5(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b = MAIN_SHAPE["b"]
    models = {h_kv: (first_stage_config(n_local_heads=h_kv),) for h_kv in (16, 2)}
    models = {h: (cfg, _random_int4_model(torch, cfg, 50 + h, dev)) for h, (cfg,) in models.items()}
    gen = torch.Generator(device=dev).manual_seed(55)
    cases = [(fmt, h, p, None, None) for fmt in KV_FORMATS for h in (16, 2) for p in K5_POS]
    cases += [("int8", 16, 1000, (300, 700), None), ("bf16", 16, 1000, None, float("nan"))]
    # NaN scales before the start; the packed tile starts on a word row, so 301 and 703 leave slots before it
    cases += [(fmt, 16, 1000, (301, 703), float("nan")) for fmt in ("int8", "int8_packed")]
    worst = 0.0
    for fmt, h_kv, pos, starts, garbage in cases:
        cfg, qp = models[h_kv]
        try:
            worst = max(worst, k5_case(torch, qp, cfg, fmt, pos, gen, starts=starts, garbage=garbage))
        except AssertionError as e:
            fail(str(e))
        torch.cuda.empty_cache()
    cfg, qp = models[16]
    del models[2]
    times, shown = {}, []
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kernels = None
    for fmt in KV_FORMATS:
        kv = _kv_cache(torch, cfg, fmt, gen, dev, b)
        try:
            kernels = block_graph_check(torch, lambda: A.decode_attention_block_int4(
                x, *_k5_args(qp), kv.k, kv.v, 5, 1000, cfg.n_head, k_scale=kv.k_scale, v_scale=kv.v_scale),
                f"K5 {fmt} cache")
        except AssertionError as e:
            fail(str(e))
        for pos in K5_TIMED:
            def run(fn):
                return lambda li: fn(x, *_k5_args(qp), kv.k, kv.v, li, pos, cfg.n_head,
                                     k_scale=kv.k_scale, v_scale=kv.v_scale)
            kernel, eager = _layers_ms(torch, run(A.decode_attention_block_int4), cfg.n_layer)
            plain, _ = _layers_ms(torch, run(A.decode_attention_block_int4_reference), cfg.n_layer)
            bound_ms, bound_by = _k5_bound(qp, cfg, fmt, pos, b)
            times[(fmt, pos)] = (kernel, plain, bound_ms, bound_by)
            shown.append(f"{fmt} pos {pos}: kernel {kernel:.4f} ms ({eager:.4f} a call from Python), plain "
                         f"{plain:.4f}, bound {bound_ms:.4f} ({bound_by})")
        del kv
        torch.cuda.empty_cache()
    print(f"[21 K5] {len(cases)} cases at 24L/16H/2048d, B {b}, S 2048 (bf16, int8, packed caches; MHA and "
          f"GQA 2 kv heads; starts; NaN past pos; NaN scales before the starts) agree: y within {worst:.3g} of "
          f"max |y| (tol {K5_TOL}), only the new row and its scales written, within one int8 step / 1e-6 / one bf16 ulp; a call is "
          f"{len(kernels)} kernels ({', '.join(kernels)}) in each format, 3 graph replays its bits, merge "
          f"counters at 0; per layer, device time from a CUDA graph: {'; '.join(shown)}")
    kernel, plain, bound_ms, bound_by = times[("int8", 255)]
    return {"max_abs_err": worst, "ms": kernel, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "kernels_a_call": len(kernels), "times": times}


def _k6_args(qp):
    lay = qp["layers"]
    return [t for k in ("w1", "w3", "w2") for t in (lay[k]["pw"], lay[k]["sc"])]


def k6_case(torch, qp, layer: int, x) -> float:
    """K6 against its plain version on one layer -> max |dy| / max |y|;
    raises AssertionError past K6_TOL."""
    from metavoice_tpu_torch.ops import quantized as Q

    y = Q.decode_ffn_int4(x, *_k6_args(qp), layer)
    torch.cuda.synchronize()
    ref = Q.decode_ffn_int4_reference(x, *_k6_args(qp), layer)
    what = f"{x.shape[0]} rows, layer {layer}"
    assert y.shape == ref.shape and y.dtype == torch.float32 and torch.isfinite(y).all(), f"K6 output bad at {what}"
    rel = (y - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= K6_TOL, f"K6 disagrees with the plain version at {what}: {rel:.3g} of max |y|"
    return rel


def ffn_phase(torch, label: str, call, plain, case, bytes_flop, gen, dim: int, n_layer: int,
              extra: tuple = ()) -> dict:
    """Phases 22 (K6) and 27 (K10): call(x, layer) and plain(x, layer) of one
    FFN. case(x, layer) holds the kernel to its plain version at FFN_ROWS x
    FFN_LAYERS (and ``extra``: (what, fn() -> rel)); a capture before any
    eager call raises; one call at B 2 is FFN_KERNELS (block_graph_check);
    each of FFN_TIMED_ROWS is timed per layer from a CUDA graph beside the
    plain version and the bound from bytes_flop(b) -> (bytes, flop)."""
    dev = torch.device("cuda")
    worst = 0.0
    try:
        for rows in FFN_ROWS:
            for layer in FFN_LAYERS:
                x = torch.randn((rows, dim), generator=gen, device=dev).to(torch.bfloat16)
                worst = max(worst, case(x, layer))
        for _, fn in extra:
            worst = max(worst, fn())
        b = MAIN_SHAPE["b"]
        x = torch.randn((b, dim), generator=gen, device=dev).to(torch.bfloat16)
        capture_first_raises(torch, lambda: call(x, 5), label)
        kernels = block_graph_check(torch, lambda: (call(x, 5),), label, FFN_KERNELS)
    except AssertionError as e:
        fail(str(e))
    times, shown = {}, []
    for b in FFN_TIMED_ROWS:
        x = torch.randn((b, dim), generator=gen, device=dev).to(torch.bfloat16)
        kernel, eager = _layers_ms(torch, lambda li: call(x, li), n_layer)
        plain_ms, _ = _layers_ms(torch, lambda li: plain(x, li), n_layer)
        n_bytes, n_flop = bytes_flop(b)
        bound_ms, bound_by = bound(n_bytes, n_flop, BF16_FLOP_S)
        times[b] = (kernel, plain_ms, bound_ms, bound_by)
        shown.append(f"B {b}: kernel {kernel:.4f} ms ({eager:.4f} a call from Python, {n_bytes / kernel / 1e6:.0f} "
                     f"GB/s), plain {plain_ms:.4f}, bound {bound_ms:.4f} ({bound_by}, {n_bytes / 1e6:.1f} MB)")
    more = "".join(f", {what}" for what, _ in extra)
    print(f"[{label}] rows {FFN_ROWS} x layers {FFN_LAYERS}{more} agree (within {worst:.3g} of max |y|, tol 1e-2); "
          f"a capture before any eager call raises; a call is {len(kernels)} kernels ({', '.join(kernels)}), 3 "
          f"graph replays its bits, merge counters at 0; per layer, device time from a CUDA graph: {'; '.join(shown)}")
    kernel, plain_ms, bound_ms, bound_by = times[MAIN_SHAPE["b"]]
    return {"max_abs_err": worst, "ms": kernel, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "kernels_a_call": len(kernels), "times": times}


def phase_k6(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config()
    qp = _random_int4_model(torch, cfg, 66, dev)
    gen = torch.Generator(device=dev).manual_seed(66)
    lay = qp["layers"]
    ip = lay["w1"]["pw"].shape[-1]
    w_bytes = sum(_int4_bytes(lay[k]["pw"][0], lay[k]["sc"][0]) for k in ("w1", "w3", "w2"))

    def bytes_flop(b):  # one layer's words and scales, x in, y out; the products
        return w_bytes + b * cfg.dim * 2 + b * cfg.dim * 4, 2.0 * b * 3 * cfg.dim * ip

    return ffn_phase(torch, "22 K6", lambda x, li: Q.decode_ffn_int4(x, *_k6_args(qp), li),
                     lambda x, li: Q.decode_ffn_int4_reference(x, *_k6_args(qp), li),
                     lambda x, li: k6_case(torch, qp, li, x), bytes_flop, gen, cfg.dim, cfg.n_layer)


def _guided_scores(torch, params, cfg, prompt, spk, tokens, noise, dev, fmt: str):
    """The sampler's scores (CFG-merged logits + Gumbel noise, temperature 1,
    no top-p) for the token after ``tokens``, with ``tokens`` forced."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm

    kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=fmt, device=dev)
    padded, t_true = fs.pad_to_bucket(prompt, 128, max_len=cfg.block_size)
    spk1 = spk.reshape(1, -1).to(dev)
    x = fs.fill_cache(params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev)[None], spk1, kv)
    logits = tfm.output_logits(params, cfg, x[:, t_true - 1 : t_true])[0][:, 0, :]
    mask = fs.make_spk_cond_mask(1, device=dev)
    for i, tok in enumerate(tokens):
        x = tfm.embed_inputs(params, cfg, torch.full((2, 1), int(tok), device=dev),
                             torch.tensor([t_true + i], device=dev), spk1.repeat(2, 1), mask)
        out, kv, _ = tfm.apply_blocks(params, cfg, x, None, kv, t_true + i, fused_head=True)
        logits = tfm.output_logits(params, cfg, out)[0][:, 0, :]
    return (S.cfg_merge(logits.float(), 3.0) + noise[len(tokens)].to(dev)).cpu()[0]


def _tokens_agree(torch, label: str, toks: dict, params: tuple, cfg, prompt, spk, noise, fmt) -> str:
    """The CPU's and the card's tokens under the same Gumbel draws are the
    same, or, at the first step where they part, the two tokens are the
    CPU's top two scores, closer than the largest score gap between the two
    runs (a rounding flip). -> what was seen; fails otherwise."""
    a, c = toks["cpu"], toks["cuda"]
    same = next((i for i, (u, v) in enumerate(zip(a, c)) if u != v), None)
    if same is None and len(a) == len(c):
        return f"{len(a)} tokens identical"
    i = same if same is not None else min(len(a), len(c))
    if i == min(len(a), len(c)):
        fail(f"{label}: one run ended (EOA) before the other: {len(c)} vs {len(a)} tokens")
    scores = {name: _guided_scores(torch, p, cfg, prompt, spk, a[:i], noise, torch.device(name), fmt)
              for name, p in zip(("cpu", "cuda"), params)}
    top2 = torch.topk(scores["cpu"], 2)
    margin = (top2.values[0] - top2.values[1]).item()
    gap = (scores["cuda"] - scores["cpu"]).abs().max().item()
    if {int(a[i]), int(c[i])} != set(top2.indices.tolist()) or margin > 2 * gap:
        fail(f"{label}: tokens part at step {i} ({a[i]} on the CPU, {c[i]} on the card), and that is "
             f"no rounding flip: the CPU's top two {top2.indices.tolist()} are {margin:.4g} apart, the "
             f"largest score gap between the two runs is {gap:.4g}")
    return (f"the first {i} of {len(a)} tokens identical; step {i} is a rounding flip between tokens {a[i]} "
            f"and {c[i]}, the CPU's top two, {margin:.4g} apart against a largest score gap of {gap:.4g} "
            f"between the card and the CPU")


def phase_small_kv8(torch):
    """An int4 first stage on a quantized cache, card (K5/K6) vs CPU (plain)."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024, intermediate_size=2048, block_size=512)
    gen = torch.Generator().manual_seed(23)
    cpu = Q.quantize_params_int4_i32(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
    gpu = to_cuda(cpu)
    prompt = torch.randint(0, cfg.vocab_size, (40,), generator=gen).tolist()
    spk = torch.randn(256, generator=gen)
    n = 48
    noise = S.gumbel_noise((n, 1, cfg.vocab_size), device="cpu", generator=gen)
    shown = []
    for fmt in ("int8", "int8_packed"):
        toks = {}
        for name, params in (("cpu", cpu), ("cuda", gpu)):
            for fn, attr in counters().values():
                setattr(fn, attr, 0)
            stats = {}
            kw = dict(noise=noise.to(name), max_new_tokens=n, top_p=1.0, cache_dtype=fmt, stats=stats)
            toks[name] = fs.generate(params, cfg, prompt, spk.numpy(), **kw)[len(prompt):]
            counts = read_counts()
            want = dict.fromkeys(counts, 0)
            if name == "cuda":
                want.update(k2_launches=5 * cfg.n_layer, k5_launches=cfg.n_layer * stats["decode_steps"],
                            k6_launches=cfg.n_layer * stats["decode_steps"])
            if counts != want:
                fail(f"small-kv8 {fmt} on {name} launched {counts}, expected {want}")
        shown.append(f"{fmt}: " + _tokens_agree(torch, f"small-kv8 {fmt}", toks, (cpu, gpu), cfg, prompt, spk,
                                                noise, fmt))
    print(f"[23 small-kv8] int4 first stage (2L/8H/1024d, Ip 2048) on quantized KV caches, the card (K5/K6) vs "
          f"the CPU (plain versions), same Gumbel draws: {'; '.join(shown)}")


def phase_synth_kv8(torch, workdir: str, ref: str, comps4, compared: dict) -> dict:
    """Full-width int4 synthesise on an int8 and a packed KV cache -> {fmt: result}."""
    from metavoice_tpu_torch.core.text import chunk_text, normalize_text
    from metavoice_tpu_torch.runtime.tts import MAX_CHARS_PER_CHUNK, TTS

    prefills = len(chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK) or [""])
    cfg1 = comps4.first_stage_cfg
    bf16_bytes = 2 * cfg1.n_layer * cfg1.block_size * 2 * cfg1.n_local_heads * cfg1.head_dim * 2
    results, shown = {}, []
    for fmt in ("int8", "int8_packed"):
        tts = TTS(comps4, device="cuda", output_dir=os.path.join(workdir, f"out_kv_{fmt}"), kv_cache_dtype=fmt,
                  enforce_min_ref_duration=False)
        path, total_s, counts = drive_main_path(tts, ref)
        steps = tts.stats["decode_steps"]
        want = dict.fromkeys(counts, 0)
        want.update(k5_launches=cfg1.n_layer * steps, k6_launches=cfg1.n_layer * steps,
                    k2_launches=5 * cfg1.n_layer * prefills)
        if steps == 0 or counts != want:
            fail(f"int4 synthesise on a {fmt} cache launched {counts}, expected {want}")
        check_stats(tts, counts)
        wav = check_wav(path)
        kv = tts._kv_cache
        cache_bytes = sum(t.numel() * t.element_size() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale))
        ms_tok = 1e3 * tts.timings["first_stage"] / max(steps, 1)
        results[fmt] = {"counts": counts, "ms_per_token": ms_tok, "cache_bytes": cache_bytes}
        stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
        shown.append(f"{fmt}: synthesise {total_s:.2f} s ({stages} s), {steps} decode steps, first stage "
                     f"{ms_tok:.2f} ms/token; cache {cache_bytes} bytes; launches "
                     f"{({k: v for k, v in counts.items() if v})}; wav {len(wav)} samples finite")
        del tts, kv
        torch.cuda.empty_cache()
    others = "; ".join(f"{name}: {ms:.2f}" for name, ms in compared.items())
    print(f"[24 synth-kv8] int4 {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d on quantized KV caches (the bf16 cache: "
          f"{bf16_bytes} bytes; ms/token in this call: {others}): {'; '.join(shown)}")
    return results


def _bf16_ulp(torch, t):
    """One bf16 ulp of each element of t (2^(e - 8) for |t| = m 2^e, m in
    [0.5, 1)); 2^-133 at 0."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def k11_case(torch, m: int, k: int, n: int, gen, dtype=None) -> float:
    """K11 against its plain version on seeded inputs: every element within
    K11_TOL of max |ref| plus one bf16 ulp of the element (both round the
    same f32 value to x's dtype, summed in other orders) -> the largest gap
    as a share of max |ref|. Raises AssertionError on a disagreement."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    q, s = Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype or torch.bfloat16)
    y = Q.matmul_int8(x, q, s)
    torch.cuda.synchronize()
    ref = Q.matmul_int8_reference(x, q, s)
    what = f"M {m}, K {k}, N {n}, x {x.dtype} ({Q.int8_route(m, k, n)[0]} route)"
    assert y.shape == (m, n) and y.dtype == x.dtype and torch.isfinite(y).all(), f"K11 output bad at {what}"
    top = ref.float().abs().max().item()
    gap = (y.float() - ref.float()).abs()
    ulp = _bf16_ulp(torch, ref) if x.dtype == torch.bfloat16 else torch.zeros_like(gap)
    assert (gap <= K11_TOL * top + ulp).all(), f"K11 disagrees with the plain version at {what}"
    return gap.max().item() / top


def k11_exact_case(torch, rows: int, k: int = 2048, n: int = 256):
    """Every int8 value through K11 bit for bit: q covers all 256 values
    (byte (r, c) = (7 r + 11 c) mod 256 - 128), the scales are 1 and x is
    one-hot rows (``rows`` at a time, f32 out), so each call's y is rows of
    q exactly, on the route that ``rows`` takes. Raises AssertionError."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    kk, nn = torch.meshgrid(torch.arange(k, device=dev), torch.arange(n, device=dev), indexing="ij")
    q = ((kk * 7 + nn * 11) % 256 - 128).to(torch.int8)
    s = torch.ones(n, device=dev)
    eye = torch.eye(k, device=dev)
    for r0 in range(0, k, rows):
        y = Q.matmul_int8(eye[r0:r0 + rows], q, s)
        assert torch.equal(y, q[r0:r0 + rows].float()), \
            f"K11 ({Q.int8_route(rows, k, n)[0]} route) does not give rows {r0}.. of q bit for bit"


def k11_call(torch, m: int, k: int, n: int, seed: int):
    """A K11 call on seeded inputs, as a function of no arguments."""
    from metavoice_tpu_torch.ops import quantized as Q

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, s = Q.quantize_int8(torch.randn((k, n), generator=gen, device="cuda") * 0.02)
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    return lambda: Q.matmul_int8(x, q, s)


def k11_graph_check(torch, call, what: str) -> str:
    """One K11 call(): one kernel node in the graph of one call, two eager
    calls the same bits, the call captured in a CUDA graph and replayed 3
    times each the eager call's bits, both merge-counter tables of K11 back
    at 0 -> the kernel's name. Raises AssertionError."""
    from metavoice_tpu_torch.ops import decode_stack as DS
    from metavoice_tpu_torch.ops import quantized as Q

    nodes = _graph_nodes(torch, call)
    assert len(nodes) == 1 and nodes[0][0] == "KERNEL", f"{what}: one call is {len(nodes)} graph nodes: {nodes}"
    first, second = call(), call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    bits = first.view(torch.int16)
    assert torch.equal(second.view(torch.int16), bits), f"{what}: two calls differ"
    dev = torch.cuda.current_device()
    for i in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.view(torch.int16), bits), f"{what}: graph replay {i} differs from the eager call"
        assert not any(t[dev].any() for t in (DS._stack_tickets, Q._int4g_tickets) if dev in t), \
            f"{what}: the merge counters are not back at 0 after replay {i}"
    found = re.search(r"int4g_ring_kernel|stack_gemv", nodes[0][1])
    return found.group(0) if found else nodes[0][1]


def _int8pack_ms(torch, x, mats, ref, lib_name: str, label: str) -> tuple[float, str, float]:
    """The two yardsticks of the product x @ (q * s) with mats [(q (K, N)
    int8, s (N,))], each timed as the kernels are (the weights in turn,
    replayed from a CUDA graph, or eagerly where the call cannot be
    captured, said so: _graph_or_eager_ms): torch._weight_int8pack_mm on the
    same int8 values and scales, where this torch has a CUDA kernel for it,
    and torch.matmul on the bf16-dequantized weight (cuBLAS, the
    dequantization untimed); each answer checked against ref first. ->
    (library ms, the library call timed and how, torch.matmul ms)."""
    tol = 2e-2 * ref.float().abs().max().item()  # bf16 output and weights: a few bf16 ulps of the sum
    dense = [(q.float() * s.float()).to(torch.bfloat16) for q, s in mats]
    if (torch.matmul(x, dense[0]).float() - ref.float()).abs().max().item() > tol:
        fail(f"[{label}] torch.matmul on the dequantized int8 weight disagrees with the int8 product")
    t_m, how_m = _graph_or_eager_ms(torch, lambda i: torch.matmul(x, dense[i]), len(dense), label)
    if lib_name.startswith("torch._weight_int8pack_mm"):
        try:
            libs = [(q.T.contiguous(), s.to(x.dtype).contiguous()) for q, s in mats]
            y = torch._weight_int8pack_mm(x, *libs[0])
            if (y.float() - ref.float()).abs().max().item() > tol:
                raise RuntimeError("its result disagrees with the int8 product")
            t_l, how = _graph_or_eager_ms(torch, lambda i: torch._weight_int8pack_mm(x, *libs[i]), len(libs), label)
            return t_l, f"torch._weight_int8pack_mm ({how})", t_m
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            print(f"[{label}] torch._weight_int8pack_mm not usable here ({str(e)[:120]}); "
                  "the library column is torch.matmul's")
    return t_m, f"torch.matmul(bf16 dequantized) ({how_m})", t_m


def phase_k11(torch) -> dict:
    """K11 at the main-path shapes (M 2 on the GEMV, M 256 on the ring) and
    at K11_CASES; every int8 value bit for bit on both routes; one kernel a
    call, the same bits twice and over 3 graph replays, and a capture before
    any eager call raising, on both routes; then one layer's five
    projections timed at each M of K11_TIMED_M beside the plain version,
    both library calls and the bound, with each shape's route and cut."""
    from metavoice_tpu_torch.ops import decode_stack as DS
    from metavoice_tpu_torch.ops import quantized as Q

    label = "25 K11"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(111)
    d, i_sz = 2048, 5632
    layer_shapes = [(d, 3 * d), (d, d), (d, i_sz), (d, i_sz), (i_sz, d)]  # qkv, wo, w1, w3, w2
    distinct = layer_shapes[:3] + layer_shapes[4:]
    cases = [(m, k, n, None) for m in (K11_TIMED_M[0], K2_M) for k, n in distinct] + K11_CASES
    worst = 0.0
    for m, k, n, dtype in cases:
        try:
            worst = max(worst, k11_case(torch, m, k, n, gen, torch.float32 if dtype == "f32" else dtype))
        except AssertionError as e:
            fail(str(e))
    names = {}
    try:
        for rows in (8, K2_M):
            k11_exact_case(torch, rows)
        for m, (k, n) in ((2, layer_shapes[0]), (16, layer_shapes[1]), (K2_M, layer_shapes[1])):
            route, cut = Q.int8_route(m, k, n)
            assert cut[1 if route == "gemv" else 2] > 1, f"M {m} {k}x{n} plans one split: no merge checked"
            call = k11_call(torch, m, k, n, 250 + m)
            names[f"M {m} {route}"] = k11_graph_check(torch, call, f"K11 at M {m}, {k}x{n}")
            capture_first_raises(torch, call, f"K11 at M {m}", tables=((DS, "_stack_tickets"), (Q, "_int4g_tickets")))
    except AssertionError as e:
        fail(str(e))

    # one layer's five projections at each M, each on 8 weight sets in turn
    # (50 MB and more a shape), so the weights come from HBM
    n_sets = 8
    xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for m in K11_TIMED_M for k in (d, i_sz)}
    tot = {m: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "matmul": 0.0, "bytes": 0.0, "flop": 0.0, "per": [],
               "cuts": []} for m in K11_TIMED_M}
    lib_name = "torch._weight_int8pack_mm"
    for k, n in layer_shapes:
        mats = [Q.quantize_int8(torch.randn((k, n), generator=gen, device=dev) * 0.02) for _ in range(n_sets)]
        for m in K11_TIMED_M:
            xk, row = xs[(m, k)], tot[m]
            t_k, t_ke = _layers_ms(torch, lambda i: Q.matmul_int8(xk, *mats[i]), n_sets)
            t_p = _layers_ms(torch, lambda i: Q.matmul_int8_reference(xk, *mats[i]), n_sets)[0]
            ref = Q.matmul_int8_reference(xk, *mats[0])
            t_l, lib_name, t_m = _int8pack_ms(torch, xk, mats, ref, lib_name, label)
            row["kernel"] += t_k
            row["plain"] += t_p
            row["library"] += t_l
            row["matmul"] += t_m
            row["bytes"] += xk.numel() * 2 + k * n + n * 4 + m * n * 2
            row["flop"] += 2.0 * m * k * n
            row["per"].append(f"{t_k:.4f} (eager {t_ke:.4f}; library {t_l:.4f})")
            route, cut = Q.int8_route(m, k, n)
            row["cuts"].append(f"{route} {'x'.join(map(str, cut))}")
        del mats
    record, shown = {}, []
    for m in K11_TIMED_M:
        row = tot[m]
        bound_ms, bound_by = bound(row["bytes"], row["flop"], BF16_FLOP_S)
        shown.append(f"M {m}: kernel {row['kernel']:.4f} ms (qkv, wo, w1, w3, w2: {'; '.join(row['per'])}; cuts "
                     f"{', '.join(row['cuts'])}), plain {row['plain']:.4f} ms, {lib_name} {row['library']:.4f} ms, "
                     f"torch.matmul on the bf16-dequantized weight {row['matmul']:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({bound_by}, {row['flop'] / 1e9:.2f} GFLOP, {row['bytes'] / 1e6:.1f} MB)")
        stats = {"ms": row["kernel"], "plain_ms": row["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": row["library"], "matmul_ms": row["matmul"]}
        if m == K2_M:
            record |= stats | {"library_call": lib_name}
        else:
            record |= {f"m{m}_{key}": v for key, v in stats.items()}
    print(f"[{label}] {len(cases)} cases agree (within {worst:.3g} of max |ref| at most, tol {K11_TOL} of max |ref| "
          f"plus one bf16 ulp of each element; routes and cuts of the main shapes: "
          + "; ".join(f"M {m} {', '.join(tot[m]['cuts'])}" for m in K11_TIMED_M)
          + f"); every int8 value bit for bit at 8 rows (GEMV) and 256 (ring); one kernel a call ("
          f"{', '.join(f'{k}: {v}' for k, v in names.items())}), the same bits twice and over 3 graph replays, a "
          f"capture before any eager call raising; one layer's five projections, device time from a CUDA graph: "
          f"{'; '.join(shown)}")
    return {"max_abs_err": worst, **record}


def _random_int8_plain_model(torch, cfg, seed: int, dev):
    """The first stage's params from a seed, quantized to plain int8 on the device."""
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    gen = torch.Generator(device=dev).manual_seed(seed)
    return Q.quantize_params_int8(tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16))


def _k9_args(qp, layer: int):
    lay = qp["layers"]
    return lay["wqkv"]["q"][layer], lay["wqkv"]["scales"][layer], lay["wo"]["q"][layer], lay["wo"]["scales"][layer]


def k9_case(torch, qp, cfg, pos: int, gen, *, starts=None, garbage=None, layer: int = 5) -> float:
    """One K9 call against its plain version on copies of the same bf16
    cache: y within K9_TOL of max |y|; the new K/V row within one bf16 ulp
    (plus 1e-4 of its largest value, where a value near 0 cancels); every
    other slot bit-identical -> max |dy| / max |y|. Raises AssertionError on
    a disagreement."""
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b = MAIN_SHAPE["b"]
    kv = _kv_cache(torch, cfg, "bf16", gen, dev, b, pos, garbage)
    ref_k, ref_v, orig_k, orig_v = kv.k.clone(), kv.v.clone(), kv.k.clone(), kv.v.clone()
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
    args = _k9_args(qp, layer)
    y_ref = A.decode_attention_block_int8_reference(x, *args, ref_k, ref_v, layer, pos, cfg.n_head,
                                                    starts=st)[0].float()
    y = A.decode_attention_block_int8(x, *args, kv.k, kv.v, layer, pos, cfg.n_head, starts=st)[0].float()
    torch.cuda.synchronize()
    what = f"pos {pos}, starts {starts}, garbage {garbage}"
    assert y.shape == (b, cfg.dim) and torch.isfinite(y).all(), f"K9 output bad at {what}"
    rel = (y - y_ref).abs().max().item() / y_ref.abs().max().item()
    assert rel <= K9_TOL, f"K9 disagrees with the plain version at {what}: {rel:.3g} of max |y|"
    other = torch.ones(kv.k.shape[:2], dtype=torch.bool, device=dev)
    other[layer, pos] = False
    for got, want, before in ((kv.k, ref_k, orig_k), (kv.v, ref_v, orig_v)):
        for t in (want, before):
            assert torch.equal(got[other].view(torch.int16), t[other].view(torch.int16)), \
                f"K9 changed cache slots besides the new row at {what}"
        row, ref_row = got[layer, pos].float(), want[layer, pos].float()
        excess = ((row - ref_row).abs() - _bf16_ulp(torch, ref_row)).max().item()
        assert excess <= 1e-4 * ref_row.abs().max().item(), f"K9's new row is more than one bf16 ulp off at {what}"
    return rel


def _k9_bound(cfg, pos: int, b: int) -> tuple[float, str]:
    """K9's least time at pos: one layer's int8 wqkv and wo with their f32
    scales, the window's bf16 K and V, x, y and the new rows; its products."""
    d, dh = cfg.dim, cfg.head_dim
    slot = 2 * b * cfg.n_head * dh * 2  # one slot's K and V, bf16
    n_bytes = 4 * d * d + 4 * 4 * d + (pos + 1) * slot + slot + 2 * b * d * 2
    n_flop = 2.0 * b * d * 4 * d + 4.0 * b * cfg.n_head * (pos + 1) * dh
    return bound(n_bytes, n_flop, BF16_FLOP_S)


def phase_k9(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import attention as A

    dev = torch.device("cuda")
    b = MAIN_SHAPE["b"]
    cfg = first_stage_config()
    qp = _random_int8_plain_model(torch, cfg, 99, dev)
    gen = torch.Generator(device=dev).manual_seed(99)
    cases = [(p, None, None) for p in K9_POS] + [(255, (100, 300), None), (1000, None, float("nan"))]
    worst = 0.0
    for pos, starts, garbage in cases:
        try:
            worst = max(worst, k9_case(torch, qp, cfg, pos, gen, starts=starts, garbage=garbage))
        except AssertionError as e:
            fail(str(e))
    x = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kv = _kv_cache(torch, cfg, "bf16", gen, dev, b)
    try:
        kernels = block_graph_check(torch, lambda: A.decode_attention_block_int8(
            x, *_k9_args(qp, 5), kv.k, kv.v, 5, 1000, cfg.n_head), "K9")
    except AssertionError as e:
        fail(str(e))
    times, shown = {}, []
    for pos in K9_TIMED:
        def run(fn):
            return lambda li: fn(x, *_k9_args(qp, li), kv.k, kv.v, li, pos, cfg.n_head)
        kernel, eager = _layers_ms(torch, run(A.decode_attention_block_int8), cfg.n_layer)
        plain, _ = _layers_ms(torch, run(A.decode_attention_block_int8_reference), cfg.n_layer)
        bound_ms, bound_by = _k9_bound(cfg, pos, b)
        times[pos] = (kernel, plain, bound_ms, bound_by)
        shown.append(f"pos {pos}: kernel {kernel:.4f} ms ({eager:.4f} a call from Python), plain {plain:.4f}, "
                     f"bound {bound_ms:.4f} ({bound_by})")
    print(f"[26 K9] {len(cases)} cases at 24L/16H/2048d, B {b}, S 2048, bf16 cache (pos {K9_POS}; starts with "
          f"one past pos; NaN past pos) agree: y within {worst:.3g} of max |y| (tol {K9_TOL}), the new row "
          f"within one bf16 ulp, every other slot unchanged; a call is {len(kernels)} kernels "
          f"({', '.join(kernels)}), 3 graph replays its bits, merge counters at 0; per layer, device time from a "
          f"CUDA graph: {'; '.join(shown)}")
    kernel, plain, bound_ms, bound_by = times[255]
    return {"max_abs_err": worst, "ms": kernel, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "kernels_a_call": len(kernels), "times": times}


def _k10_args(qp, layer: int):
    lay = qp["layers"]
    return [lay[k][f][layer] for k in ("w1", "w3", "w2") for f in ("q", "scales")]


def k10_case(torch, x, args, what: str) -> float:
    """K10 on x and one layer's args (w1, s1, w3, s3, w2, s2) against its
    plain version -> max |dy| / max |y|; raises AssertionError past K10_TOL."""
    from metavoice_tpu_torch.ops import quantized as Q

    y = Q.ffn_int8(x, *args)
    torch.cuda.synchronize()
    ref = Q.ffn_int8_reference(x, *args)
    what = f"{x.shape[0]} rows, {what}"
    assert y.shape == ref.shape and y.dtype == torch.float32 and torch.isfinite(y).all(), f"K10 output bad at {what}"
    rel = (y - ref).abs().max().item() / ref.abs().max().item()
    assert rel <= K10_TOL, f"K10 disagrees with the plain version at {what}: {rel:.3g} of max |y|"
    return rel


def k10_own_scales_case(torch, qp, gen) -> float:
    """K10 with w3 = w1 and s3 = 2 s1, so h3 = 2 h1 exactly: a kernel that
    scaled both of w1's and w3's sums by one matrix's scales would be off by
    half of y."""
    q1, s1, _, _, q2, s2 = _k10_args(qp, 3)
    x = torch.randn((MAIN_SHAPE["b"], q1.shape[0]), generator=gen, device=q1.device).to(torch.bfloat16)
    return k10_case(torch, x, (q1, s1, q1, 2 * s1, q2, s2), "layer 3 with w3 = w1, s3 = 2 s1")


def phase_k10(torch) -> dict:
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config()
    qp = _random_int8_plain_model(torch, cfg, 100, dev)
    gen = torch.Generator(device=dev).manual_seed(100)
    i_sz = cfg.intermediate_size

    def bytes_flop(b):  # one layer's bytes and f32 scales, x in, y out; the products
        return (3 * cfg.dim * i_sz + 4 * (2 * i_sz + cfg.dim) + b * cfg.dim * 2 + b * cfg.dim * 4,
                2.0 * b * 3 * cfg.dim * i_sz)

    return ffn_phase(torch, "27 K10", lambda x, li: Q.ffn_int8(x, *_k10_args(qp, li)),
                     lambda x, li: Q.ffn_int8_reference(x, *_k10_args(qp, li)),
                     lambda x, li: k10_case(torch, x, _k10_args(qp, li), f"layer {li}"), bytes_flop, gen,
                     cfg.dim, cfg.n_layer, extra=(("w3 = w1 with s3 = 2 s1", lambda: k10_own_scales_case(
                         torch, qp, gen)),))


def phase_small_int8p(torch):
    """Plain-int8 first stages on the card vs the CPU path, same weights and
    Gumbel draws: an MHA one (K9/K10 at T = 1) and a GQA one (K11, K4, K10)."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    shown = []
    for h_kv in (4, 2):
        cfg = first_stage_config(n_layer=2, n_head=4, n_local_heads=h_kv, dim=512, intermediate_size=1536,
                                 block_size=512)
        gen = torch.Generator().manual_seed(28 + h_kv)
        cpu = Q.quantize_params_int8(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
        gpu = to_cuda(cpu)
        if tfm.int8_block_ok(cpu, cfg, 2, torch.bfloat16) != (h_kv == 4):
            fail(f"small-int8p: int8_block_ok is wrong for {h_kv} kv heads")
        prompt = torch.randint(0, cfg.vocab_size, (40,), generator=gen).tolist()
        spk = torch.randn(256, generator=gen)
        n = 48
        noise = S.gumbel_noise((n, 1, cfg.vocab_size), device="cpu", generator=gen)
        toks = {}
        for name, params in (("cpu", cpu), ("cuda", gpu)):
            for fn, attr in counters().values():
                setattr(fn, attr, 0)
            Q.matmul_int8.gemv_launches = 0
            stats = {}
            kw = dict(noise=noise.to(name), max_new_tokens=n, top_p=1.0, stats=stats)
            toks[name] = fs.generate(params, cfg, prompt, spk.numpy(), **kw)[len(prompt):]
            counts = read_counts()
            want = dict.fromkeys(counts, 0)
            steps = stats["decode_steps"]
            gemv = 0  # K11 calls on its GEMV: the GQA steps' qkv and wo at M 2 (the prefill's M 80 take the ring)
            if name == "cuda":
                want.update(k11_launches=5 * cfg.n_layer, k10_launches=cfg.n_layer * steps)
                if h_kv == 4:
                    want["k9_launches"] = cfg.n_layer * steps
                else:
                    want["k11_launches"] += 2 * cfg.n_layer * steps
                    want["k4_launches"] = cfg.n_layer * steps
                    gemv = 2 * cfg.n_layer * steps
            if counts != want or Q.matmul_int8.gemv_launches != gemv:
                fail(f"small-int8p ({h_kv} kv heads) on {name} launched {counts} ({Q.matmul_int8.gemv_launches} K11 "
                     f"calls on its GEMV), expected {want} ({gemv} on its GEMV)")
        route = "K9/K10" if h_kv == 4 else "K11 (GEMV at M 2) + K4 + K10"
        shown.append(f"{h_kv} kv heads ({route}, launches {({k: v for k, v in counts.items() if v})}): "
                     + _tokens_agree(torch, f"small-int8p ({h_kv} kv heads)", toks, (cpu, gpu), cfg, prompt, spk,
                                     noise, torch.bfloat16))
    print(f"[28 small-int8p] plain-int8 first stages (2L/4H/512d, I 1536), the card vs the CPU (plain versions), "
          f"same Gumbel draws: {'; '.join(shown)}")


def k12_case(torch, m: int, k: int, n: int, gen, *, packed: bool, dtype=None, groupsize: int = 128) -> float:
    """K12 (or K13, ``packed``) against its plain version on seeded inputs:
    every element within K12_TOL of max |ref| plus one bf16 ulp of the
    element -> the largest gap as a share of max |ref|. Raises
    AssertionError on a disagreement."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device=dev) * 0.02, groupsize)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype or torch.bfloat16)
    name = "K13" if packed else "K12"
    if packed:
        p = Q.pack_int4(q)
        y = Q.matmul_int4_packed(x, p, s, z, groupsize)
        torch.cuda.synchronize()
        ref = Q.matmul_int4_packed_reference(x, p, s, z, groupsize)
    else:
        y = Q.matmul_int4(x, q, s, z, groupsize)
        torch.cuda.synchronize()
        ref = Q.matmul_int4_reference(x, q, s, z, groupsize)
    what = f"M {m}, K {k}, N {n}, x {x.dtype}, groupsize {groupsize}"
    assert y.shape == (m, n) and y.dtype == x.dtype and torch.isfinite(y).all(), f"{name} output bad at {what}"
    top = ref.float().abs().max().item()
    gap = (y.float() - ref.float()).abs()
    ulp = _bf16_ulp(torch, ref) if x.dtype == torch.bfloat16 else torch.zeros_like(gap)
    assert (gap <= K12_TOL * top + ulp).all(), f"{name} disagrees with the plain version at {what}"
    return gap.max().item() / top


def _int4g_one_launch(torch, fn, packed: bool, gen, label: str) -> str:
    """K12's (K13's) GEMV at M = 2 on the qkv shape: one kernel a call in
    the graph of one call, two eager calls the same bits, and that call
    captured in a CUDA graph and replayed 3 times, each replay the eager
    result's bits (the merge tickets are left at 0) -> the kernel's name."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    d = 2048
    q, s, z = Q.quantize_int4_grouped(torch.randn((d, 3 * d), generator=gen, device=dev) * 0.02)
    w = Q.pack_int4(q) if packed else q
    x = torch.randn((K12_DECODE_M, d), generator=gen, device=dev).to(torch.bfloat16)
    if Q.int4g_plan(K12_DECODE_M, d, 3 * d, packed)[1] < 2:
        fail(f"{label}: the qkv shape at M {K12_DECODE_M} plans one split, so no merge would be checked")
    name = _one_kernel(torch, lambda: fn(x, w, s, z), label)
    first, second = fn(x, w, s, z), fn(x, w, s, z)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(x, w, s, z)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, w, s, z)
    replays = []
    for _ in range(3):
        out.zero_()
        graph.replay()
        replays.append(out.clone())
    torch.cuda.synchronize()
    bits = first.view(torch.int16)
    if not torch.equal(second.view(torch.int16), bits):
        fail(f"{label}: two calls at M {K12_DECODE_M} differ")
    if not all(torch.equal(r.view(torch.int16), bits) for r in replays):
        fail(f"{label}: a CUDA-graph replay differs from the eager call")
    return name


def phase_k12(torch, packed: bool) -> dict:
    """K12 (phase 30) or K13 (phase 31) at the main-path shapes, then one
    layer's five projections timed at each M of K12_TIMED_M: the kernel, its
    plain version (M 2 and 256), torch._weight_int4pack_mm and, from 16 rows
    up, torch.matmul on the bf16-dequantized weight (cuBLAS, the
    dequantization untimed), each with the bound."""
    from metavoice_tpu_torch.ops import quantized as Q

    label = "31 K13" if packed else "30 K12"
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31 if packed else 30)
    d, i_sz = 2048, 5632
    layer_shapes = [(d, 3 * d), (d, d), (d, i_sz), (d, i_sz), (i_sz, d)]  # qkv, wo, w1, w3, w2
    distinct = layer_shapes[:3] + layer_shapes[4:]
    cases = [(m, k, n, None, 128) for m in (K12_DECODE_M, K2_M) for k, n in distinct]
    cases += [(1, d, 3 * d, None, 128), (8, d, i_sz, None, 128), (200, d, 3 * d, None, 128),
              (K12_DECODE_M, d, 3 * d, torch.float32, 128), (K2_M, i_sz, d, torch.float32, 128),
              (K12_DECODE_M, i_sz, d, None, 64), (K2_M, d, i_sz, None, 64)]
    # every GEMV row count, N off the column tiles, more splits at groupsize 64
    cases += [(m, d, d, None, 128) for m in range(1, Q.DECODE_MAX_ROWS + 1)]
    cases += [(K12_DECODE_M, d, 16, None, 128), (K12_DECODE_M, d, 2064, None, 128), (5, d, 2064, None, 64)]
    # groupsizes that are no multiple of the GEMV's k-step: up to 8 rows take the ring
    cases += [(K12_DECODE_M, d, d, None, 8), (K12_DECODE_M, 1152, d, None, 24)]
    # the ring's row tiles and splits, f32 x, groupsizes 8, 24 and 12 (no multiple of 8: scales read per row)
    cases += [(m, d, 3 * d, None, 128) for m in (9, 16, 32, 64, 65)]
    cases += [(16, i_sz, d, torch.float32, 128), (K2_M, d, 3 * d, None, 8), (32, 1152, i_sz, None, 24),
              (16, 1152, d, None, 12), (300, d, d, None, 128)]
    worst = 0.0
    for m, k, n, dtype, gs in cases:
        try:
            worst = max(worst, k12_case(torch, m, k, n, gen, packed=packed, dtype=dtype, groupsize=gs))
        except AssertionError as e:
            fail(str(e))

    kernel_fn = Q.matmul_int4_packed if packed else Q.matmul_int4
    plain_fn = Q.matmul_int4_packed_reference if packed else Q.matmul_int4_reference
    kernel_name = _int4g_one_launch(torch, kernel_fn, packed, gen, label)

    # one layer's five projections, each on 8 weight sets in turn (more than
    # 50 MB a shape), so the weights come from HBM
    n_sets = 8
    times, shown = {}, []
    lib_name = "torch._weight_int4pack_mm"
    xs = {(m, k): torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
          for m in K12_TIMED_M for k in (d, i_sz)}
    tot = {m: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "matmul": 0.0, "bytes": 0.0, "flop": 0.0, "per": []}
           for m in K12_TIMED_M}
    for k, n in layer_shapes:
        mats = []
        for _ in range(n_sets):
            q, s, z = Q.quantize_int4_grouped(torch.randn((k, n), generator=gen, device=dev) * 0.02)
            mats.append((Q.pack_int4(q) if packed else q, s, z, q))
        lib = [(q.to(torch.int32) + 8, s, z + 0.5 * s) for _, s, z, q in mats]
        dense = [Q.dequantize_int4_grouped(q, s, z).to(torch.bfloat16) for _, s, z, q in mats]
        for m in K12_TIMED_M:
            xk, row = xs[(m, k)], tot[m]
            t_k, t_ke = _layers_ms(torch, lambda i: kernel_fn(xk, *mats[i][:3]), n_sets)
            ref = plain_fn(xk, *mats[0][:3])
            t_l, lib_name = _int4pack_ms(torch, xk, lib, ref, 128, lib_name, label)
            t_p = t_m = 0.0
            if m in (K12_DECODE_M, K2_M):
                t_p = _layers_ms(torch, lambda i: plain_fn(xk, *mats[i][:3]), n_sets)[0]
            if m >= 16:
                if (torch.matmul(xk, dense[0]).float() - ref.float()).abs().max().item() > \
                        2e-2 * ref.float().abs().max().item():
                    fail(f"[{label}] torch.matmul on the dequantized weight disagrees with the product")
                t_m = _layers_ms(torch, lambda i: torch.matmul(xk, dense[i]), n_sets)[0]
            w, s = mats[0][0], mats[0][1]
            row["kernel"] += t_k
            row["plain"] += t_p
            row["library"] += t_l
            row["matmul"] += t_m
            row["bytes"] += xk.numel() * 2 + w.numel() * w.element_size() + 2 * s.numel() * 4 + m * n * 2
            row["flop"] += 2.0 * m * k * n
            row["per"].append(f"{t_k:.4f} (eager {t_ke:.4f}; library {t_l:.4f})")
        del mats, lib, dense
    for m in K12_TIMED_M:
        row = tot[m]
        bound_ms, bound_by = bound(row["bytes"], row["flop"], BF16_FLOP_S)
        times[m] = (row["kernel"], row["plain"], row["library"], bound_ms, bound_by, row["matmul"])
        shown.append(f"M {m}: kernel {row['kernel']:.4f} ms (qkv, wo, w1, w3, w2: {'; '.join(row['per'])})"
                     + (f", plain {row['plain']:.4f} ms" if m in (K12_DECODE_M, K2_M) else "")
                     + f", {lib_name} {row['library']:.4f} ms"
                     + (f", torch.matmul on the bf16-dequantized weight {row['matmul']:.4f} ms" if m >= 16 else "")
                     + f", bound {bound_ms:.4f} ms ({bound_by}, {row['flop'] / 1e9:.2f} GFLOP, "
                       f"{row['bytes'] / 1e6:.1f} MB)")
    print(f"[{label}] {len(cases)} cases agree (within {worst:.3g} of max |ref| at most, tol {K12_TOL} of max |ref| "
          f"plus one bf16 ulp of each element); at M {K12_DECODE_M} one kernel a call ({kernel_name}), the same "
          f"bits on every call and graph replay; one layer's five projections, device time from a CUDA graph: "
          f"{'; '.join(shown)}")
    kernel, plain, library, bound_ms, bound_by, _ = times[K12_DECODE_M]
    record = {"max_abs_err": worst, "ms": kernel, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": library, "library_call": lib_name}
    for m in K12_TIMED_M[1:]:
        kernel, plain, library, bound_ms, _, matmul = times[m]
        record |= {f"m{m}_ms": kernel, f"m{m}_bound_ms": bound_ms, f"m{m}_library_ms": library,
                   f"m{m}_matmul_ms": matmul}
        if m == K2_M:
            record[f"m{m}_plain_ms"] = plain
    return record


def phase_small_int4g(torch):
    """Groupwise int4 first stages, unpacked (K12) and packed (K13), on the
    card vs the CPU path, same weights and Gumbel draws."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    cfg = first_stage_config(n_layer=2, n_head=4, dim=512, intermediate_size=1536, block_size=512)
    shown = []
    for packed in (False, True):
        key = "k13_launches" if packed else "k12_launches"
        gen = torch.Generator().manual_seed(32 + packed)
        quantize = Q.quantize_params_int4_packed if packed else Q.quantize_params_int4
        cpu = quantize(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
        gpu = to_cuda(cpu)
        prompt = torch.randint(0, cfg.vocab_size, (40,), generator=gen).tolist()  # a 128 bucket: M = 256
        spk = torch.randn(256, generator=gen)
        n = 48
        noise = S.gumbel_noise((n, 1, cfg.vocab_size), device="cpu", generator=gen)
        toks = {}
        for name, params in (("cpu", cpu), ("cuda", gpu)):
            for fn, attr in counters().values():
                setattr(fn, attr, 0)
            stats = {}
            kw = dict(noise=noise.to(name), max_new_tokens=n, top_p=1.0, stats=stats)
            toks[name] = fs.generate(params, cfg, prompt, spk.numpy(), **kw)[len(prompt):]
            counts = read_counts()
            want = dict.fromkeys(counts, 0)
            steps = stats["decode_steps"]
            if name == "cuda":
                want.update({key: 5 * cfg.n_layer * (steps + 1), "k1_launches": cfg.n_layer * steps})
            if counts != want:
                fail(f"small-int4g ({key}) on {name} launched {counts}, expected {want}")
        for fn, attr in counters().values():
            setattr(fn, attr, 0)
        long = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda")  # M = 512: the dense route
        tfm.forward(gpu, cfg, long, spk_emb=spk.cuda().repeat(2, 1))
        if any(read_counts().values()):
            fail(f"small-int4g: a 512-row forward launched {read_counts()}, expected no kernel")
        shown.append(f"{'packed (K13)' if packed else 'unpacked (K12)'}, launches "
                     f"{({k: v for k, v in counts.items() if v})}, none for M = 512: "
                     + _tokens_agree(torch, f"small-int4g ({key})", toks, (cpu, gpu), cfg, prompt, spk, noise,
                                     torch.bfloat16))
    print(f"[32 small-int4g] groupwise int4 first stages (2L/4H/512d, I 1536, groupsize 128), the card vs the CPU "
          f"(plain versions), same Gumbel draws: {'; '.join(shown)}")


def _leaf_dtypes(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _leaf_dtypes(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _leaf_dtypes(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree.dtype}


def _npz_round_trip(workdir: str, params, cfg, mode):
    """params through save_first_stage_quantized and load_first_stage_npz
    -> (the loaded tree on the card, the file's bytes); every leaf's dtype,
    the config and the mode must come back as written."""
    from metavoice_tpu_torch.utils import checkpoint as ckpt

    path = os.path.join(workdir, "first_stage_quantized.npz")
    ckpt.save_first_stage_quantized(path, params, cfg, None, mode)
    size = os.path.getsize(path)
    loaded, cfg2, _, mode2 = ckpt.load_first_stage_npz(path)
    os.remove(path)
    if _leaf_dtypes(loaded) != _leaf_dtypes(params) or cfg2 != cfg or mode2 != mode:
        fail(f"a {mode} first stage does not load as it was written: {_leaf_dtypes(loaded)} against "
             f"{_leaf_dtypes(params)}, {cfg2} against {cfg}, mode {mode2}")
    return ckpt.params_from_numpy(loaded, device="cuda"), size


def phase_synth_int4g(torch, workdir: str, ref: str, packed: bool, compared: dict) -> dict:
    """Full-width synthesise of a first stage quantized by the port's
    quantize_params_int4 (phase 33) or _packed (phase 34, through the
    quantized .npz writer and loader): every projection through K12 (K13),
    5 x n_layer a decode step and a prefill, K1 n_layer a step. Phase 34
    also writes and reads the int4-in-int32 tree and runs one K2 call on
    the loaded sc."""
    import dataclasses

    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.runtime.tts import TTS

    label = "34 synth-int4p" if packed else "33 synth-int4g"
    t0 = time.perf_counter()
    comps = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out_int4g")).c
    cfg1 = comps.first_stage_cfg
    params = (Q.quantize_params_int4_packed if packed else Q.quantize_params_int4)(comps.first_stage_params)
    extra = ""
    if packed:
        params, size = _npz_round_trip(workdir, params, cfg1, None)
        i32, size32 = _npz_round_trip(workdir, Q.quantize_params_int4_i32(comps.first_stage_params), cfg1, "int4")
        leaf = i32["layers"]["wqkv"]
        if leaf["sc"].dtype != torch.bfloat16:
            fail(f"a loaded int4-in-int32 sc is {leaf['sc'].dtype}, not bf16")
        x = torch.randn((K2_M, cfg1.dim), device="cuda").to(torch.bfloat16)
        y = Q.matmul_int4_i32(x, leaf["pw"][0], leaf["sc"][0])
        y_ref = Q.matmul_int4_i32_reference(x, leaf["pw"][0], leaf["sc"][0])
        if (y - y_ref).abs().max().item() > K2_TOL * y_ref.abs().max().item():
            fail("K2 on a loaded int4-in-int32 layer disagrees with its plain version")
        extra = (f"; the packed tree through save_first_stage_quantized/load_first_stage_npz ({size} bytes) with "
                 f"every dtype kept; an int4-in-int32 file ({size32} bytes) loads with bf16 sc, which K2 takes")
        del i32, leaf
    tts = TTS(dataclasses.replace(comps, first_stage_params=params), device="cuda",
              output_dir=os.path.join(workdir, f"out_{label.split()[1]}"), enforce_min_ref_duration=False)
    del comps, params
    if tts.quantisation_mode is not None:
        fail(f"a groupwise int4 first stage was taken as {tts.quantisation_mode!r}")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    key = "k13_launches" if packed else "k12_launches"
    run = phase_synth_quantized(torch, workdir, ref, None, label, {"k1_launches": cfg1.n_layer,
                                key: 5 * cfg1.n_layer}, key, compared, tts=tts, init_s=init_s)
    if extra:
        print(f"[{label}]{extra}")
    return run

# ---------------------------------------------------------------- phases 36-41: ragged batches and streaming


# the kernel wrappers models/transformer calls, each with its kernel (K1 on
# a GQA model is K4, the decode stack on int8 words K7)
KERNEL_OF = {"decode_attention": "K1", "matmul_int4_i32": "K2", "decode_stack_int4": "K3",
             "decode_attention_multi": "K4", "decode_attention_block_int4": "K5", "decode_ffn_int4": "K6",
             "matmul_int8_i32": "K8", "decode_attention_block_int8": "K9", "ffn_int8": "K10", "matmul_int8": "K11",
             "matmul_int4": "K12", "matmul_int4_packed": "K13"}
# each kernel's tolerance as a share of max |ref| (K3/K7 and K8 have rules of their own)
KERNEL_TOL = {"K1": K1_TOL, "K2": K2_TOL, "K4": K4_TOL, "K5": K5_TOL, "K6": K6_TOL, "K9": K9_TOL,
              "K10": K10_TOL, "K11": K11_TOL, "K12": K12_TOL, "K13": K12_TOL}
# the attention wrappers: the index of pos in their arguments (the caches sit 3 before it)
POS_ARG = {"decode_attention": 6, "decode_attention_multi": 6, "decode_attention_block_int4": 8,
           "decode_attention_block_int8": 8}


def plain_versions() -> dict:
    """Each wrapper of KERNEL_OF -> its plain version, which takes the
    card's tensors as it takes the CPU's."""
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import decode_stack as DS
    from metavoice_tpu_torch.ops import quantized as Q

    def decode_attention(q, k_new, v_new, kc, vc, layer, pos, starts=None):
        if k_new.shape[1] != q.shape[1]:  # GQA: K4's plain version at T = 1, as the wrapper routes it
            y, kc, vc = A.decode_attention_multi_reference(q[:, :, None], k_new[:, :, None], v_new[:, :, None],
                                                           kc, vc, layer, pos, starts)
            return y[:, :, 0], kc, vc
        return A.decode_attention_reference(q, k_new, v_new, kc, vc, layer, pos, starts)

    mods = {name: mod for mod, names in ((A, ("decode_attention_multi", "decode_attention_block_int4",
                                              "decode_attention_block_int8")),
                                         (DS, ("decode_stack_int4",)),
                                         (Q, ("decode_ffn_int4", "ffn_int8", "matmul_int4", "matmul_int4_i32",
                                              "matmul_int4_packed", "matmul_int8", "matmul_int8_i32")))
            for name in names}
    return {"decode_attention": decode_attention} | {name: getattr(mod, f"{name}_reference")
                                                     for name, mod in mods.items()}


@contextlib.contextmanager
def plain_path():
    """Every kernel wrapper the block stack calls swapped for its plain
    version: the CPU path's math on the card, no kernel launched."""
    from metavoice_tpu_torch.models import transformer as tfm

    plain = plain_versions()
    saved = {name: getattr(tfm, name) for name in plain}
    for name, fn in plain.items():
        setattr(tfm, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(tfm, name, fn)


@contextlib.contextmanager
def captured_calls(torch, steps, step):
    """Every kernel wrapper the block stack calls, wrapped to keep a copy of
    the arguments of its first call of each shape at the decode steps
    ``steps`` (``step()`` gives the current one; 0 is the prefill) -> a list
    of (name, the wrapper, args, kwargs, step). The calls themselves run as
    they would."""
    from metavoice_tpu_torch.models import transformer as tfm

    kept, seen = [], set()

    def copy(a):
        return a.clone() if torch.is_tensor(a) else a

    def wrap(name, fn):
        def call(*args, **kw):
            s = step()
            key = (name, s, tuple(tuple(a.shape) for a in args if torch.is_tensor(a)))
            if s in steps and key not in seen:
                seen.add(key)
                kept.append((name, fn, [copy(a) for a in args], {k: copy(v) for k, v in kw.items()}, s))
            return fn(*args, **kw)
        return call

    saved = {name: getattr(tfm, name) for name in KERNEL_OF}
    for name, fn in saved.items():
        setattr(tfm, name, wrap(name, fn))
    try:
        yield kept
    finally:
        for name, fn in saved.items():
            setattr(tfm, name, fn)


def held_call(torch, name: str, fn, args: list, kw: dict, what: str) -> tuple[str, float]:
    """One call of wrapper ``name`` (``fn``) and its plain version on the
    same arguments -> (the kernel, its gap as a share of max |ref|); fails
    past the kernel's own rule: K3/K7 one layer at a time within
    K3_LAYER_TOL (each layer fed the plain version's residual stream; the
    fused head left out) and the whole stack, head included, within K3_TOL;
    K8 by k8_row_gap within K8_TOL; K11-K13 every element within their
    tolerance of max |ref| plus one bf16 ulp of a bf16 element; any other
    within KERNEL_TOL. Each call writes its new cache row before it reads
    it, so the kernel and the plain version see the same window."""
    plain = plain_versions()[name]
    kernel = KERNEL_OF[name]
    if name == "decode_attention" and args[1].shape[1] != args[0].shape[1]:
        kernel = "K4"
    if name == "decode_stack_int4":
        kernel = "K7" if kw.get("wfmt") == "i8" else "K3"
        layer_kw = {k: v for k, v in kw.items() if k not in ("ln_f_w", "head_pw", "head_sc")}
        kc, vc = args[13], args[14]
        worst = stack_worst_layer(torch, args[0], args[1:13], kc, vc, *args[15:], **layer_kw)
        got = fn(*args[:13], kc.clone(), vc.clone(), *args[15:], **kw)
        ref = plain(*args[:13], kc.clone(), vc.clone(), *args[15:], **kw)
        outs = [0, 3] if len(got) > 3 else [0]
        whole = max((got[i].float() - ref[i].float()).abs().max().item() / ref[i].float().abs().max().item()
                    for i in outs)
        if not (worst <= K3_LAYER_TOL and whole <= K3_TOL and all(torch.isfinite(got[i]).all() for i in outs)):
            fail(f"{what}: {kernel} at {args[0].shape[0]} rows: {worst:.3g} one layer at a time (tol "
                 f"{K3_LAYER_TOL}), {whole:.3g} over the stack (tol {K3_TOL}) of max |ref|")
        return kernel, worst
    got, ref = fn(*args, **kw), plain(*args, **kw)
    y, r = (got[0], ref[0]) if isinstance(got, tuple) else (got, ref)
    y, top = y.float(), r.float().abs().max().item()
    if kernel == "K8":
        gap = k8_row_gap(torch, y, r.float(), args[0], args[2])
        ok = gap <= K8_TOL
    elif kernel in ("K11", "K12", "K13"):
        d = (y - r.float()).abs()
        ulp = _bf16_ulp(torch, r) if r.dtype == torch.bfloat16 else torch.zeros_like(d)
        ok, gap = bool((d <= KERNEL_TOL[kernel] * top + ulp).all()), d.max().item() / top
    else:
        gap = (y - r.float()).abs().max().item() / top
        ok = gap <= KERNEL_TOL[kernel]
    if not (ok and torch.isfinite(y).all()):
        fail(f"{what}: {kernel} ({name}) at {tuple(y.shape)} disagrees with its plain version: {gap:.3g} of max "
             f"|ref| (tol {KERNEL_TOL.get(kernel, K8_TOL)})")
    return kernel, gap


def hold_captured(torch, label: str, kept: list, counts: dict) -> str:
    """Each call captured_calls kept, held by held_call; the attention
    kernels' calls also moved to the cache's last slots (the same rows,
    ragged starts and inputs over the longest window, which takes the most
    splits). Fails unless every kernel the run launched (``counts``) was
    held. -> what was seen."""
    worst, moved, calls = {}, {}, {}
    with torch.inference_mode():
        for name, fn, args, kw, step in kept:
            what = f"{label}, step {step}"
            kernel, gap = held_call(torch, name, fn, args, kw, what)
            worst[kernel] = max(worst.get(kernel, 0.0), gap)
            calls[kernel] = calls.get(kernel, 0) + 1
            i = POS_ARG.get(name)
            if i is None:
                continue
            kc, t = args[i - 3], (args[0].shape[2] if name == "decode_attention_multi" else 1)
            last = kc.shape[1] * (4 if kc.dtype == torch.int32 else 1) - t  # a packed cache: 4 slots a word
            if last > args[i]:
                _, gap = held_call(torch, name, fn, args[:i] + [last] + args[i + 1 :], kw,
                                   f"{what} moved to pos {last}")
                moved[kernel] = max(moved.get(kernel, 0.0), gap)
    launched = {"K" + key[1:].split("_")[0] for key, n in counts.items() if n}
    if launched - set(worst):
        fail(f"{label}: no call of {sorted(launched - set(worst))} was held against its plain version")
    return ", ".join(f"{k} {calls[k]} calls within {worst[k]:.3g}" + (f" (at the last slots {moved[k]:.3g})"
                                                                        if k in moved else "")
                     for k in sorted(worst, key=lambda k: int(k[1:])))


@contextlib.contextmanager
def recorded_logits():
    """first_stage.sample_guided wrapped to keep the f32 logits of each of
    its calls, in call order (call i draws every row's i-th token)."""
    from metavoice_tpu_torch.models import first_stage as fs

    seen, sample = [], fs.sample_guided

    def record(logits, *args, **kw):
        seen.append(logits.float().clone())
        return sample(logits, *args, **kw)

    fs.sample_guided = record
    try:
        yield seen
    finally:
        fs.sample_guided = sample


def _row_logits(logits, row: int, b: int):
    """The (2, V) logits of batch row ``row``'s CFG pair (rows row and b + row)."""
    return logits[[row, b + row]]


def rows_agree(torch, label: str, a, c, logits_a, logits_c, tol: float) -> tuple[str, float]:
    """Two runs' tokens of one row (a: the reference run) under the same
    Gumbel draws. Up to the first step where the tokens part, both runs saw
    the same inputs, so their logits may differ only by rounding: at every
    step up to and including it, the row's two cache rows' logits
    (logits_x(i), (2, V)) must agree within ``tol`` of max |ref| (the
    route's BATCH_LOGIT_TOL);
    the tokens may then part where the rounding reorders two close scores.
    -> (what was seen, the largest gap); fails otherwise."""
    n = min(len(a), len(c))
    part = next((i for i in range(n) if a[i] != c[i]), None)
    if part is None and len(a) != len(c):
        fail(f"{label}: one run ended (EOA) before the other: {len(c)} vs {len(a)} tokens")
    worst = 0.0
    for i in range(n if part is None else part + 1):
        ref = logits_a(i)
        gap = (logits_c(i) - ref).abs().max().item() / ref.abs().max().item()
        if not gap <= tol:
            fail(f"{label}: at step {i}, before the tokens part, the logits differ by {gap:.4g} of max |ref| "
                 f"(tol {tol})")
        worst = max(worst, gap)
    return ("same" if part is None else f"parts at step {part} ({a[part]} vs {c[part]})"), worst


def _zero_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def batch_case(torch, label: str, route: str, params, cfg, b: int, n_new: int, want, *, cache_dtype=None,
               isolation: bool = False, seed: int = 0) -> dict:
    """``generate_batch`` of the first b prompts of BATCH_PROMPT_LENS (one
    128 bucket) on the card, timed twice; every count set to 0 just before
    the first and read just after: the counts equal want(decode steps)
    (every other kernel 0; want None: not checked). A third run on the same
    Gumbel noise keeps each step's logits and a copy of the arguments of
    every kernel call at the prefill, the first decode step and the last
    (captured_calls); the same call on the plain path (no launch) agrees
    with it row by row within the route's BATCH_LOGIT_TOL (rows_agree);
    with ``isolation``, so does each row's prompt generated alone
    (``generate``); each kept call is held against its plain version
    (hold_captured). -> {"ms_step" (the two timed runs), "tok_s",
    "prefill_ms", "steps", "counts", "text"}."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.models import first_stage as fs

    dev = params["wpe"].device
    tol = BATCH_LOGIT_TOL[route]
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist() for n in BATCH_PROMPT_LENS[:b]]
    spk = torch.randn((b, 256), generator=gen).numpy()
    noise = S.gumbel_noise((n_new, b, cfg.vocab_size), device="cpu", generator=gen).to(dev)
    kw = dict(temperature=1.0, top_p=1.0, guidance_scale=BATCH_GUIDANCE, cache_dtype=cache_dtype)
    fs.generate_batch(params, cfg, prompts, spk, max_new_tokens=1, noise=noise, **kw)  # the prefill alone
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fs.generate_batch(params, cfg, prompts, spk, max_new_tokens=1, noise=noise, **kw)
    prefill_s = time.perf_counter() - t0
    _zero_counts()
    totals = []
    for run in range(2):
        stats = {}
        t0 = time.perf_counter()
        timed = fs.generate_batch(params, cfg, prompts, spk, max_new_tokens=n_new, noise=noise, stats=stats, **kw)
        totals.append(time.perf_counter() - t0)
        if run == 0:
            counts = read_counts()
    steps = stats["decode_steps"]
    if want is not None:
        expected = dict.fromkeys(counts, 0) | want(steps)
        if steps == 0 or counts != expected:
            fail(f"{label}: B {b} launched {counts}, expected {expected} ({steps} decode steps)")
    with recorded_logits() as seen_k, captured_calls(torch, {0, 1, n_new - 1}, lambda: len(seen_k)) as kept:
        toks = fs.generate_batch(params, cfg, prompts, spk, max_new_tokens=n_new, noise=noise, **kw)
    before = read_counts()
    with recorded_logits() as seen_p, plain_path():
        plain = fs.generate_batch(params, cfg, prompts, spk, max_new_tokens=n_new, noise=noise, **kw)
    if read_counts() != before:
        fail(f"{label}: the plain path launched a kernel: {read_counts()} after {before}")
    parted, gaps = [], []
    for r in range(b):
        seen, gap = rows_agree(torch, f"{label} B {b} row {r} (plain path vs kernels)", plain[r], toks[r],
                               lambda i: _row_logits(seen_p[i], r, b), lambda i: _row_logits(seen_k[i], r, b), tol)
        gaps.append(gap)
        if seen != "same":
            parted.append(f"row {r} {seen}")
    alone, alone_gaps = [], []
    if isolation:
        for r in range(b):
            with recorded_logits() as seen_1:
                one = fs.generate(params, cfg, prompts[r], spk[r], max_new_tokens=n_new, noise=noise[:, r : r + 1],
                                  **kw)[len(prompts[r]):]
            seen, gap = rows_agree(torch, f"{label} B {b} row {r} (alone vs in the batch)", one, toks[r],
                                   lambda i: seen_1[i], lambda i: _row_logits(seen_k[i], r, b), tol)
            alone_gaps.append(gap)
            if seen != "same":
                alone.append(f"row {r} {seen}")
    held = hold_captured(torch, f"{label} B {b}", kept, counts)
    del kept
    n_tok = sum(len(t) for t in timed)
    ms_step = [1e3 * (t - prefill_s) / max(steps, 1) for t in totals]
    tok_s = [n_tok / t for t in totals]
    text = (f"B {b} ({2 * b} cache rows, prompts {list(BATCH_PROMPT_LENS[:b])}): {n_tok} tokens, {steps} decode "
            f"steps in {totals[0]:.3f} s and {totals[1]:.3f} s (prefill {1e3 * prefill_s:.1f} ms, "
            f"{ms_step[0]:.2f} and {ms_step[1]:.2f} ms a step, {tok_s[0]:.0f} and {tok_s[1]:.0f} tokens/s); "
            f"launches {({k: v for k, v in counts.items() if v})}; held alone at the run's own calls: {held}; "
            f"against the plain path: logits within {max(gaps):.3g} of max |ref| (tol {tol}) up to any parting, "
            f"{'every row the same tokens' if not parted else ', '.join(parted)}")
    if isolation:
        text += (f"; each row alone: logits within {max(alone_gaps):.3g}, "
                 f"{'the same tokens' if not alone else ', '.join(alone)}")
    return {"ms_step": ms_step, "tok_s": tok_s, "prefill_ms": 1e3 * prefill_s, "steps": steps,
            "counts": counts, "text": text}


def phase_batch_bf16(torch) -> dict:
    """36: full-width bf16 generate_batch of 4 ragged prompts, K1 with starts."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm

    cfg = first_stage_config()
    gen = torch.Generator(device="cuda").manual_seed(36)
    params = tfm.init_params(cfg, device="cuda", generator=gen, dtype=torch.bfloat16)
    run = batch_case(torch, "36 batch-bf16", "bf16", params, cfg, 4, BATCH_NEW,
                     lambda s: {"k1_launches": cfg.n_layer * s}, isolation=True, seed=36)
    print(f"[36 batch-bf16] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d, {BATCH_NEW} new tokens a row: {run['text']}")
    return run


def stack_batch_case(torch, label: str, qp, cfg, wfmt: str, args, rows: int = 8, pos: int = 255) -> str:
    """K3 (wfmt "i4") or K7 ("i8") at the ragged batch's rows: starts = the
    left pads of BATCH_PROMPT_LENS (both CFG groups), one layer at a time
    within K3_LAYER_TOL of its plain version and the whole stack within
    K3_TOL; a step's device time from a CUDA graph of 20 steps beside the
    plain version's and the bound."""
    from metavoice_tpu_torch.ops import decode_stack as DS

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(rows)
    pads = [128 - n for n in BATCH_PROMPT_LENS[: rows // 2]] * 2
    st = torch.tensor(pads, dtype=torch.int32, device=dev)
    shape = (cfg.n_layer, cfg.block_size, rows, cfg.n_local_heads, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((rows, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(n_kv_head=cfg.n_local_heads, starts=st, norm_eps=cfg.norm_eps, wfmt=wfmt)
    worst = stack_worst_layer(torch, x, args, kc, vc, pos, cfg.n_head, **kw)
    xo = DS.decode_stack_int4(x, *args, kc.clone(), vc.clone(), pos, cfg.n_head, **kw)[0]
    xr = DS.decode_stack_int4_reference(x, *args, kc.clone(), vc.clone(), pos, cfg.n_head, **kw)[0]
    whole = (xo.float() - xr.float()).abs().max().item() / xr.float().abs().max().item()
    if not (worst <= K3_LAYER_TOL and whole <= K3_TOL and torch.isfinite(xo).all()):
        fail(f"{label}: {rows} rows with starts {pads}: {worst:.3g} one layer at a time (tol {K3_LAYER_TOL}), "
             f"{whole:.3g} over the stack (tol {K3_TOL}) of max |ref|")
    device_ms, _ = _layers_ms(torch, lambda _: DS.decode_stack_int4(x, *args, kc, vc, pos, cfg.n_head, **kw), 20)
    plain_ms = _time_ms(torch, lambda: DS.decode_stack_int4_reference(x, *args, kc, vc, pos, cfg.n_head, **kw), 3)
    lay = qp["layers"]
    nbytes = _int4_bytes if wfmt == "i4" else _int8_bytes
    weight = sum(nbytes(*[lay[k][n] for n in (("pw", "sc") if wfmt == "i4" else ("p8", "sc8"))])
                 for k in ("wqkv", "wo", "w1", "w3", "w2"))
    window = sum(pos + 1 - p for p in pads)  # the slots the rows attend
    n_bytes = weight + 2 * cfg.n_layer * window * cfg.n_local_heads * cfg.head_dim * 2 + 4 * rows * cfg.dim * 2
    vals = 8 if wfmt == "i4" else 4
    macs = sum(lay[k]["pw" if wfmt == "i4" else "p8"].numel() * vals for k in ("wqkv", "wo", "w1", "w3", "w2"))
    n_flop = 2.0 * rows * macs + 4.0 * cfg.n_layer * window * cfg.n_head * cfg.head_dim
    b_ms, b_by = bound(n_bytes, n_flop, BF16_FLOP_S)
    return (f"{'K3' if wfmt == 'i4' else 'K7'} at {rows} rows, pos {pos}, starts {pads}: within {worst:.3g} of max "
            f"|ref| one layer at a time, {whole:.3g} over 24 layers; {device_ms:.4f} ms a step on the device "
            f"(CUDA graph of 20), plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")


def batch_prefill_times(torch, label: str, kind: str) -> str:
    """K2 (kind "i4"), K8 ("i8") or K11 ("q8") at the ragged batch's prefill
    rows, M = 2B x 128 = 1024 and 2048: each of one layer's five projections
    (D 2048, FFN 6144; K11 5632) against its plain version (K2 within
    K2_TOL of max |ref|, K8 by k8_row_gap within K8_TOL, K11 within K11_TOL
    plus one bf16 ulp), and the five's device time from CUDA graphs of 2
    weight sets in turn beside the plain version's, torch.matmul on the
    bf16-dequantized weight and the bound."""
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(len(kind))
    d, ip = 2048, (5632 if kind == "q8" else 6144)
    parts = []
    for m in BATCH_PREFILL_M:
        tot = dict(kernel=0.0, plain=0.0, matmul=0.0, bytes=0.0, flop=0.0)
        worst = 0.0
        for k, n in ((d, 3 * d), (d, d), (d, ip), (d, ip), (ip, d)):
            w = [torch.randn((k, n), generator=gen, device=dev) * 0.02 for _ in range(2)]
            x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            if kind == "q8":
                mats = [Q.quantize_int8(wi) for wi in w]
                call, plain = Q.matmul_int8, Q.matmul_int8_reference
                dense = [(q.float() * s.float()).to(torch.bfloat16) for q, s in mats]
                wbytes = k * n + 4 * n
            else:
                quantize, call, plain = ((Q.quantize_int4_i32, Q.matmul_int4_i32, Q.matmul_int4_i32_reference)
                                         if kind == "i4" else
                                         (Q.quantize_int8_i32, Q.matmul_int8_i32, Q.matmul_int8_i32_reference))
                mats = [quantize(wi) for wi in w]
                dense = [wi.to(torch.bfloat16) for wi in w]  # cuBLAS on a bf16 weight of the shape
                wbytes = (_int4_bytes if kind == "i4" else _int8_bytes)(*mats[0])
            y, ref = call(x, *mats[0]), plain(x, *mats[0])
            top = ref.float().abs().max().item()
            if kind == "i8":
                gap = k8_row_gap(torch, y.float(), ref.float(), x, mats[0][1])
                ok = gap <= K8_TOL
            elif kind == "q8":
                gap = (y.float() - ref.float()).abs()
                ok = bool((gap <= K11_TOL * top + _bf16_ulp(torch, ref)).all())
                gap = gap.max().item() / top
            else:
                gap = (y.float() - ref.float()).abs().max().item() / top
                ok = gap <= K2_TOL
            if not (ok and torch.isfinite(y).all()):
                fail(f"{label}: {kind} at M {m}, K {k}, N {n} disagrees with its plain version: {gap:.3g} of max |ref|")
            worst = max(worst, gap)
            tot["kernel"] += _layers_ms(torch, lambda i: call(x, *mats[i]), 2)[0]
            tot["plain"] += _layers_ms(torch, lambda i: plain(x, *mats[i]), 2)[0]
            tot["matmul"] += _layers_ms(torch, lambda i: torch.matmul(x, dense[i]), 2)[0]
            tot["bytes"] += m * k * 2 + wbytes + m * n * (2 if kind == "q8" else 4)
            tot["flop"] += 2.0 * m * k * n
        b_ms, b_by = bound(tot["bytes"], tot["flop"], BF16_FLOP_S)
        parts.append(f"M {m}: within {worst:.3g} of max |ref|, {tot['kernel']:.4f} ms for one layer's five "
                     f"projections, plain {tot['plain']:.4f}, torch.matmul on a bf16 weight of each shape "
                     f"{tot['matmul']:.4f}, bound {b_ms:.4f} ({b_by}, {tot['flop'] / 1e9:.1f} GFLOP)")
    name = {"i4": "K2", "i8": "K8", "q8": "K11"}[kind]
    return f"{name} at the batch prefill: {'; '.join(parts)}"


def phase_batch_int4(torch) -> dict:
    """37: full-width int4 generate_batch at B 4 (K2 at M 1024, K3 with
    ragged starts) and B 8 (K2 at M 2048, then the unfused route)."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm

    cfg = first_stage_config()
    qp = _random_int4_model(torch, cfg, 37, torch.device("cuda"))
    n_layer, shown, out = cfg.n_layer, [], {}
    # B 8's rows alone take the stack (2 rows) with its int4 head, the batch
    # the unfused route with the bf16 head: only B 4 is held to its rows alone
    for b, route, want in (
        (4, "stack", lambda s: {"k3_launches": s, "k2_launches": 5 * n_layer}),
        (8, "unfused", lambda s: {"k2_launches": 5 * n_layer * (1 + s), "k1_launches": n_layer * s}),
    ):
        got = tfm.int4_decode_route(qp, cfg, 2 * b, torch.bfloat16)
        if got != route:
            fail(f"37 batch-int4: B {b} takes the {got!r} route, not {route!r}")
        out[b] = batch_case(torch, "37 batch-int4", "int4", qp, cfg, b, BATCH_NEW, want, isolation=b == 4,
                            seed=37 + b)
        shown.append(f"route {route!r}, {out[b]['text']}")
    shown.append(stack_batch_case(torch, "37 batch-int4", qp, cfg, "i4", _k3_args(qp)))
    shown.append(batch_prefill_times(torch, "37 batch-int4", "i4"))
    print(f"[37 batch-int4] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d int4, {BATCH_NEW} new tokens a row: "
          f"{'; '.join(shown)}")
    return out


def phase_batch_routes(torch) -> dict:
    """38: one 2-layer full-width first stage a decode route, generate_batch
    at B 4 and B 8 against the plain path, each route's kernels counted."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    dev = torch.device("cuda")
    cfg = first_stage_config(n_layer=2, block_size=512)
    gqa = first_stage_config(n_layer=2, block_size=512, n_local_heads=2)
    gen = torch.Generator(device=dev).manual_seed(38)
    bf16 = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    L = cfg.n_layer
    routes = [
        ("int8", cfg, Q.quantize_params_int8_i32(bf16), None,
         {4: lambda s: {"k7_launches": s, "k8_launches": 5 * L},
          8: lambda s: {"k8_launches": 5 * L * (1 + s), "k1_launches": L * s}}),
        ("int4, int8 cache", cfg, Q.quantize_params_int4_i32(bf16), "int8",
         {4: lambda s: {"k2_launches": 5 * L, "k5_launches": L * s, "k6_launches": L * s},
          8: lambda s: {"k2_launches": 5 * L * (1 + s)}}),
        ("int4, packed cache", cfg, Q.quantize_params_int4_i32(bf16), "int8_packed",
         {4: lambda s: {"k2_launches": 5 * L, "k5_launches": L * s, "k6_launches": L * s},
          8: lambda s: {"k2_launches": 5 * L * (1 + s)}}),
        ("int8_plain", cfg, Q.quantize_params_int8(bf16), None,
         {4: lambda s: {"k11_launches": 5 * L, "k9_launches": L * s, "k10_launches": L * s},
          8: lambda s: {"k11_launches": 5 * L * (1 + s), "k1_launches": L * s}}),
        ("groupwise int4", cfg, Q.quantize_params_int4(bf16), None,
         {b: lambda s: {"k12_launches": 5 * L * s, "k1_launches": L * s} for b in (4, 8)}),
        ("groupwise int4 packed", cfg, Q.quantize_params_int4_packed(bf16), None,
         {b: lambda s: {"k13_launches": 5 * L * s, "k1_launches": L * s} for b in (4, 8)}),
        ("GQA bf16", gqa, tfm.init_params(gqa, device=dev, generator=gen, dtype=torch.bfloat16), None,
         {b: lambda s: {"k4_launches": L * s} for b in (4, 8)}),
    ]
    shown, out = [], {}
    for name, c, params, cache, wants in routes:
        for b, want in wants.items():
            run = batch_case(torch, f"38 batch-routes {name}", name, params, c, b, ROUTE_NEW, want,
                             cache_dtype=cache, seed=38 + b)
            out[(name, b)] = run
            shown.append(f"{name}: {run['text']}")
        del params
    del routes
    torch.cuda.empty_cache()
    full = first_stage_config()
    q8 = _random_int8_model(torch, full, 38, dev)
    shown.append(stack_batch_case(torch, "38 batch-routes", q8, full, "i8", _k7_args(q8)))
    del q8
    torch.cuda.empty_cache()
    shown.append(batch_prefill_times(torch, "38 batch-routes", "i8"))
    shown.append(batch_prefill_times(torch, "38 batch-routes", "q8"))
    print(f"[38 batch-routes] 2-layer {cfg.n_head}H/{cfg.dim}d first stages, {ROUTE_NEW} new tokens a row: "
          f"{'; '.join(shown)}")
    return out


def two_call_wav(torch, tts, prompt: list, segment, spk):
    """The JAX package's two-call render of a first-stage stream, kept here
    as the yardstick of the port's one device-side render: the second stage
    with its codes to the host, then the vocoder on them padded to the
    bucket, the wav trimmed, the enhancer; on the TTS's weights and
    generator."""
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.models import second_stage as ss
    from metavoice_tpu_torch.runtime.tts import _vocoder_bucket
    import numpy as np

    c, ctx = tts.c, tts.c.second_stage_cfg.block_size
    _, coarse = T.split_flattened_interleaved(segment, tts.END_OF_AUDIO_TOKEN)
    x = T.build_second_stage_input(prompt, coarse, ctx)
    with torch.inference_mode():
        sampled = ss.non_causal_sample(c.second_stage_params, c.second_stage_cfg,
                                       torch.as_tensor(x, dtype=torch.int64, device=tts.device)[None],
                                       torch.as_tensor(np.asarray(spk, np.float32), device=tts.device)[None],
                                       1.0, top_k=200, compute_dtype=tts._compute_dtype, generator=tts._gen)
        full = np.concatenate([x[None], sampled.cpu().numpy()], axis=1)[0]
        n_text, n_audio = len(prompt), min(len(coarse[0]), ctx - len(prompt))
        codes = full[:, n_text : n_text + n_audio].copy()
        codes[0], codes[1] = coarse[0][:n_audio], coarse[1][:n_audio]
        codes = np.pad(np.clip(codes, 0, 1023), ((0, 0), (0, _vocoder_bucket(n_audio) - n_audio)))
        wav = ec.decode_codes(c.encodec_params, c.encodec_cfg, codes)[0].float().cpu().numpy()
    wav = wav[: n_audio * c.encodec_cfg.hop_length]
    return c.enhancer(wav, c.encodec_cfg.sample_rate) if c.enhancer is not None else wav


def phase_streaming(torch, workdir: str, ref: str):
    """39: full-width int4 synthesise_streaming; returns the TTS for phase 40."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.text import chunk_text, normalize_text
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.runtime.tts import MAX_CHARS_PER_CHUNK, TTS
    import numpy as np

    tts = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out_stream"),
                          quantisation_mode="int4")
    cfg1 = tts.c.first_stage_cfg
    chunks_of_text = chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK)
    if len(chunks_of_text) != 1:
        fail(f"39 streaming: the text takes {len(chunks_of_text)} chunks, not one")
    prompt = tts.c.tokenizer.encode(chunks_of_text[0])
    hop, ctx2 = tts.c.encodec_cfg.hop_length, tts.c.second_stage_cfg.block_size

    def frames(seg) -> int:
        return min(len(T.split_flattened_interleaved(seg, tts.END_OF_AUDIO_TOKEN)[1][0]), ctx2 - len(prompt))

    list(tts.synthesise_streaming(SYNTH_TEXT, ref, max_new_tokens=8))  # the speaker embedding cached
    segs_seen, segments = [], fs.generate_segments

    def recorded_segments(*args, **kw):  # the stream's own segments, as synthesise_streaming reads them
        for seg in segments(*args, **kw):
            segs_seen.append(seg)
            yield seg

    fs.generate_segments = recorded_segments
    _zero_counts()
    try:
        t0 = time.perf_counter()
        first_s, chunks = None, []
        for wav in tts.synthesise_streaming(SYNTH_TEXT, ref, max_new_tokens=STREAM_NEW):
            if first_s is None:
                first_s = time.perf_counter() - t0
            chunks.append(wav)
        total_s = time.perf_counter() - t0
        counts, steps = read_counts(), tts.stats["decode_steps"]
    finally:
        fs.generate_segments = segments
    want = dict.fromkeys(counts, 0) | {"k3_launches": steps, "k2_launches": 5 * cfg1.n_layer}
    if steps == 0 or counts != want:
        fail(f"39 streaming launched {counts}, expected {want}")
    # one chunk for each segment with audio tokens, of its frames' samples
    want_len = [frames(seg) * hop for seg in segs_seen if frames(seg) > 0]
    if [len(c) for c in chunks] != want_len:
        fail(f"39 streaming: chunks of {[len(c) for c in chunks]} samples for segments of "
             f"{[len(s) for s in segs_seen]} tokens (expected {want_len})")
    if not all(np.isfinite(c).all() and c.dtype == np.float32 for c in chunks):
        fail(f"39 streaming: chunks not finite float32: {[c.dtype for c in chunks]}")
    audio_s = sum(len(c) for c in chunks) / 24000
    stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
    # the segments joined against generate on the same Gumbel noise
    spk = tts._get_speaker_embedding(ref)
    noise = S.gumbel_noise((STREAM_NEW, 1, cfg1.vocab_size), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(39))
    kw = dict(max_new_tokens=STREAM_NEW, end_of_text_token=tts.c.tokenizer.eot_token, noise=noise)
    segs = list(fs.generate_segments(tts.c.first_stage_params, cfg1, prompt, spk, segment_tokens=150,
                                     first_segment_tokens=40, **kw))
    whole = fs.generate(tts.c.first_stage_params, cfg1, prompt, spk, **kw)[len(prompt):]
    joined = np.concatenate(segs)
    if not np.array_equal(joined, whole):
        fail(f"39 streaming: the segments joined ({len(joined)} tokens) are not generate's ({len(whole)})")
    # the one device-side render against the two-call render, on the same draws
    gaps = []
    for seg in [s for s in segs_seen if frames(s) > 0][:2]:
        wavs = []
        for render in (tts._tokens_to_wav, None):
            tts._gen.manual_seed(391)
            wavs.append(render("x", prompt, seg, spk) if render else two_call_wav(torch, tts, prompt, seg, spk))
        if wavs[0].shape != wavs[1].shape or not np.abs(wavs[0] - wavs[1]).max() <= TWO_CALL_TOL:
            fail(f"39 streaming: the render and the two-call wav differ: shapes {wavs[0].shape} {wavs[1].shape}")
        gaps.append(float(np.abs(wavs[0] - wavs[1]).max()))
    print(f"[39 streaming] int4 {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d synthesise_streaming, "
          f"{STREAM_NEW} tokens a chunk at most: first chunk after {first_s:.3f} s, {len(chunks)} chunks "
          f"({[len(c) for c in chunks]} samples, one for each of the segments {[len(s) for s in segs_seen]} tokens "
          f"long that holds audio tokens; {audio_s:.2f} s of audio) in {total_s:.3f} s ({stages} s); "
          f"{steps} decode steps; launches {({k: v for k, v in counts.items() if v})}; segments "
          f"{[len(s) for s in segs]} joined == generate's {len(whole)} tokens under the same noise; the render "
          f"vs the two-call render max |d| {max(gaps):.3g} (tol {TWO_CALL_TOL}) on {len(gaps)} segments")
    return {"ttfa_s": first_s, "total_s": total_s, "audio_s": audio_s, "timings": dict(tts.timings),
            "tts": tts}


def phase_get_tokens(torch, workdir: str, tts):
    """40: get_tokens on the card against the port on the CPU for a seeded wav."""
    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.utils import audio_io as aio
    import numpy as np

    ecfg = tts.c.encodec_cfg
    rng = np.random.default_rng(40)
    t = np.arange(2 * ecfg.sample_rate + 123) / ecfg.sample_rate
    wav = (0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
           + 0.05 * rng.normal(size=len(t))).astype(np.float32)
    path = os.path.join(workdir, "tokens.wav")
    aio.write_wav(path, wav, ecfg.sample_rate)
    t0 = time.perf_counter()
    codes = tts.get_tokens(path)
    card_s = time.perf_counter() - t0
    frames = len(wav) // ecfg.hop_length
    if np.shape(codes) != (ecfg.n_q, frames) or min(map(min, codes)) < 0 or max(map(max, codes)) >= 1024:
        fail(f"40 get_tokens: codes of shape {np.shape(codes)}, expected ({ecfg.n_q}, {frames}) in [0, 1024)")
    cpu = to_cpu(tts.c.encodec_params)
    x = torch.from_numpy(aio.load_audio(path, target_sr=ecfg.sample_rate)[0][: frames * ecfg.hop_length])[None]
    lat_c = ec.encode_latent(cpu, ecfg, x)
    lat_g = ec.encode_latent(tts.c.encodec_params, ecfg, x.cuda()).cpu()
    lat_gap = (lat_g - lat_c).abs().max().item() / lat_c.abs().max().item()
    if not lat_gap <= ENCODE_LATENT_TOL:
        fail(f"40 get_tokens: the card's latent is {lat_gap:.3g} of max |latent| from the CPU's "
             f"(tol {ENCODE_LATENT_TOL})")
    codes_c = ec.rvq_encode(cpu["codebooks"], lat_c, ecfg.n_q)[0]  # (n_q, T)
    codes_g = torch.tensor(codes, dtype=torch.int32)
    if not torch.equal(codes_g, ec.rvq_encode(cpu["codebooks"], lat_g, ecfg.n_q)[0]):
        fail("40 get_tokens: the card's codes are not the nearest codewords of the card's latent")
    flips = []
    for f in range(frames):
        diff = (codes_g[:, f] != codes_c[:, f]).nonzero()
        if len(diff) == 0:
            continue
        q = int(diff[0])  # the first stage that parts; later stages follow other residuals
        residual = lat_c[0, f] - sum(cpu["codebooks"][s][codes_c[s, f]] for s in range(q)) if q else lat_c[0, f]
        cb = cpu["codebooks"][q]
        score = 2 * cb @ residual - (cb * cb).sum(-1)
        top2 = torch.topk(score, 2)
        rel = (top2.values[0] - top2.values[1]).item() / top2.values[0].abs().item()
        if set(top2.indices.tolist()) != {int(codes_c[q, f]), int(codes_g[q, f])} or rel > ENCODE_GAP:
            fail(f"40 get_tokens: frame {f} stage {q}: the card picks {int(codes_g[q, f])}, the CPU "
                 f"{int(codes_c[q, f])}, and they are not the CPU's two nearest within {ENCODE_GAP} "
                 f"({top2.indices.tolist()}, {rel:.3g} apart)")
        flips.append(f"frame {f} stage {q} ({rel:.2g})")
    print(f"[40 get_tokens] {len(wav)} samples -> ({ecfg.n_q}, {frames}) codes in {card_s:.3f} s on the card; "
          f"latent within {lat_gap:.3g} of max |latent| of the CPU's (tol {ENCODE_LATENT_TOL}); codes equal"
          + (f" but at {len(flips)} frames parted by near ties: {', '.join(flips[:5])}" if flips else ""))


def batch_launches(runs: list) -> dict:
    """Every kernel's launches over the batch runs of phases 36-38; fails
    unless each of K1-K13 launched in some of them."""
    total = {k: sum(run["counts"][k] for run in runs) for k in counters()}
    missing = [k for k, n in total.items() if n == 0]
    if missing:
        fail(f"phases 36-38 launched no {missing} on a batch route")
    print(f"[36-38 batch launches] every kernel ran in a ragged batch: {total}")
    return total


WARMUP_SCRIPT = r"""
import json, os, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import torch
from metavoice_tpu_torch.ops import _build
from metavoice_tpu_torch.runtime.tts import TTS
tts = TTS.from_random(small=False, device="cuda", quantisation_mode="int4", output_dir=sys.argv[2])
torch.cuda.synchronize()
t1 = time.perf_counter()
loaded_before = _build._loaded is not None
tts.warmup()
torch.cuda.synchronize()
t2 = time.perf_counter()
lib = _build.kernels()
files = sorted(os.listdir(_build.BUILD_DIR))
synth = []
for _ in range(2):
    t = time.perf_counter()
    tts.synthesise(sys.argv[4], sys.argv[3], max_new_tokens=192)
    synth.append(time.perf_counter() - t)
print(json.dumps({"start_s": t1 - t0, "warmup_s": t2 - t1, "build_s": lib.build_seconds,
                  "compiled": bool(lib.build_log), "loaded_before": loaded_before,
                  "same_library": _build.kernels() is lib, "same_files": files == sorted(os.listdir(_build.BUILD_DIR)),
                  "synth_s": synth, "first_stage_s": tts.timings.get("first_stage"),
                  "decode_steps": tts.stats.get("decode_steps")}))
"""


def phase_warmup(torch, workdir: str, ref: str, build_s: float):
    """41: TTS.warmup from a fresh process, then synthesises that build nothing."""
    out = subprocess.run([sys.executable, "-c", WARMUP_SCRIPT, os.path.dirname(os.path.abspath(__file__)),
                          os.path.join(workdir, "out_warm"), ref, SYNTH_TEXT],
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"41 warmup: the fresh process failed ({out.returncode}): {out.stderr[-2000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    if r["loaded_before"] or not (r["same_library"] and r["same_files"]) or r["decode_steps"] in (None, 0):
        fail(f"41 warmup: {r}")
    print(f"[41 warmup] a fresh process: import and a full-width int4 TTS in {r['start_s']:.2f} s; "
          f"TTS.warmup {r['warmup_s']:.2f} s, of which the kernel library {r['build_s']:.2f} s "
          f"({'compiled' if r['compiled'] else 'loaded from its build in phase 2, which took ' + f'{build_s:.2f} s'}); "
          f"then two synthesises of {r['decode_steps']} decode steps in {r['synth_s'][0]:.2f} s and "
          f"{r['synth_s'][1]:.2f} s with no new build (the same library, no new file in the build directory)")


# ------------------------------------------------------------------ phases 42-45: the serving layer


def _greedy_knobs(torch, b: int, dev):
    """(B, 1) temperature, top-p and guidance of phase 42's greedy rows."""
    return [torch.full((b, 1), v, device=dev) for v in (ENGINE_GREEDY, ENGINE_GREEDY, BATCH_GUIDANCE)]


def _engine_prefill(torch, params, cfg, prompts: list, spk, kv):
    """A ragged prefill of ``prompts`` in one ENGINE_BUCKET -> (first tokens, pads)."""
    from metavoice_tpu_torch.models import first_stage as fs

    dev = params["wpe"].device
    padded, pads = fs.left_pad_prompts(prompts, ENGINE_BUCKET)
    first = fs.prefill_batch(params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev),
                             torch.as_tensor(pads, device=dev), torch.as_tensor(spk, device=dev), kv,
                             *_greedy_knobs(torch, len(prompts), dev))
    return first.cpu().numpy(), pads


def _engine_decode(torch, params, cfg, cur, pos: int, pads, spk, kv, steps: int):
    """One greedy segment of the group -> (tokens (B, steps), lengths (B,)) on the host."""
    from metavoice_tpu_torch.models import first_stage as fs

    dev = params["wpe"].device
    t, p, g = _greedy_knobs(torch, len(cur), dev)
    buf, lens = fs.decode(params, cfg, torch.as_tensor(cur, dtype=torch.int64, device=dev), pos, kv,
                          torch.as_tensor(spk, device=dev), steps, pad_lens=torch.as_tensor(pads, device=dev),
                          temperature=t, top_p=p, guidance_scale=g)
    return buf.cpu().numpy(), lens.cpu().numpy()


def _same_bits(torch, a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _cache_fields(kv) -> list:
    return [kv.k, kv.v, kv.k_scale, kv.v_scale]


def move_matches_cpu(torch, label: str, move, kv, *more) -> int:
    """Run a cache move, ``move(kv, *more)`` (caches among ``more`` too), on
    the card and on CPU copies of the same tensors -> the bytes compared;
    fails unless every tensor of ``kv`` comes out with the CPU's bits."""
    from metavoice_tpu_torch.models import transformer as tfm

    def on_cpu(x):
        return tfm.KVCache(*[None if t is None else t.cpu() for t in _cache_fields(x)]) if isinstance(
            x, tfm.KVCache) else x

    cpu_kv = on_cpu(kv)
    move(kv, *more)
    move(cpu_kv, *[on_cpu(m) for m in more])
    n = 0
    for name, a, b in zip(("k", "v", "k_scale", "v_scale"), _cache_fields(kv), _cache_fields(cpu_kv)):
        if a is None:
            continue
        if not _same_bits(torch, a.cpu(), b):
            fail(f"{label}: the card's {name} after the move is not the CPU's, bit for bit")
        n += a.numel() * a.element_size()
    return n


def greedy_rows_agree(torch, label: str, a, c, logits_a, logits_c, tol: float) -> str:
    """Two greedy runs of one row (a: the reference): the logits of both
    within ``tol`` of max |ref| up to where the tokens part (rows_agree), and
    at that step the two tokens the reference's top two guided scores,
    closer than twice the largest score gap between the runs (phase 23's
    rounding flip). -> what was seen; fails otherwise."""
    from metavoice_tpu_torch.core import sampling as S

    seen, worst = rows_agree(torch, label, a, c, logits_a, logits_c, tol)
    if seen == "same":
        return f"{len(a)} tokens the same (logits within {worst:.3g} of max |ref|)"
    i = next(i for i in range(min(len(a), len(c))) if a[i] != c[i])
    ref, other = (S.cfg_merge(f(i).float(), BATCH_GUIDANCE)[0].cpu() for f in (logits_a, logits_c))
    top2 = torch.topk(ref, 2)
    margin = (top2.values[0] - top2.values[1]).item()
    gap = (other - ref).abs().max().item()
    if {int(a[i]), int(c[i])} != set(top2.indices.tolist()) or margin > 2 * gap:
        fail(f"{label}: the tokens part at step {i} ({a[i]} vs {c[i]}) and that is no rounding flip: the "
             f"reference's top two {top2.indices.tolist()} are {margin:.4g} apart, the largest score gap "
             f"{gap:.4g}")
    return (f"the first {i} of {len(a)} tokens the same, then a rounding flip ({a[i]} vs {c[i]}, the top two "
            f"{margin:.3g} apart against a score gap of {gap:.3g}; logits within {worst:.3g} of max |ref| up to it)")


def _join_group(torch, params, cfg, cache, prompts, spk_ab, steps_before: int, seen: list):
    """Phase 42's schedule: A alone in slot 0 of ENGINE_SLOTS, ``steps_before``
    greedy steps, then B joins slot 1 at that position P (a temp prefill
    landed at P - ENGINE_BUCKET, held against the CPU's landing bit for bit)
    -> (kv, pos, pads, spk, cur, B's first token's logits index in ``seen``,
    the bytes compared)."""
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.runtime.engine import land_rows
    import numpy as np

    dev = params["wpe"].device
    kv = tfm.KVCache.create(cfg, 2 * ENGINE_SLOTS, cfg.block_size, dtype=cache, device=dev)
    spk = np.stack([spk_ab[0], np.zeros_like(spk_ab[0])])
    first, pads = _engine_prefill(torch, params, cfg, [prompts[0], [0]], spk, kv)
    buf, _ = _engine_decode(torch, params, cfg, [int(first[0]), 0], ENGINE_BUCKET, pads, spk, kv, steps_before)
    pos = ENGINE_BUCKET + steps_before
    temp = tfm.KVCache.create(cfg, 2, ENGINE_BUCKET, dtype=cache, device=dev)
    k_first = len(seen)
    first_b, _ = _engine_prefill(torch, params, cfg, [prompts[1]], spk_ab[1:], temp)
    n = move_matches_cpu(torch, f"42 engine-small landing at {pos - ENGINE_BUCKET}", lambda kv_, t_: land_rows(
        kv_, t_, pos - ENGINE_BUCKET, 1, ENGINE_SLOTS + 1, cfg.n_local_heads), kv, temp)
    spk[1] = spk_ab[1]
    pads = pads.copy()
    pads[1] = pos - len(prompts[1])
    return kv, pos, pads, spk, [int(buf[0, -1]), int(first_b[0])], k_first, n


def _continue_b(torch, params, cfg, kv, pos: int, pads, spk, cur, steps: int, seen: list) -> tuple[list, list]:
    """Decode the group ``steps`` more greedy steps in segments of 16 -> (B's
    tokens, the indices in ``seen`` of their logits)."""
    toks, idx = [], []
    for _ in range(steps // 16):
        k0 = len(seen)
        buf, lens = _engine_decode(torch, params, cfg, cur, pos, pads, spk, kv, 16)
        toks += buf[1, : lens[1]].tolist()
        idx += list(range(k0, k0 + int(lens[1])))
        cur = [int(buf[0, -1]), int(buf[1, -1])]
        pos += 16
    return toks, idx


def phase_engine_small(torch, dev: str = "cuda"):
    """42: the engine's join and rebase on a 2-layer 1024-wide int4 first stage."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.runtime.engine import shift_rows

    cfg = first_stage_config(n_layer=2, n_head=8, dim=1024, intermediate_size=2048, block_size=512)
    gen = torch.Generator().manual_seed(42)
    params = Q.quantize_params_int4_i32(tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.bfloat16))
    params = to_cuda(params) if dev == "cuda" else params
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist() for n in (4, 5)]
    spk_ab = torch.randn((2, 256), generator=gen).numpy()
    n_new = 48
    shown, moved = [], 0
    for fmt, cache in (("bf16", torch.bfloat16), ("int8", "int8"), ("int8_packed", "int8_packed")):
        route = ENGINE_ROUTES[fmt]
        tol = BATCH_LOGIT_TOL[route]
        _zero_counts()
        with recorded_logits() as seen_f:
            fresh = fs.generate_batch(params, cfg, [prompts[1]], spk_ab[1:], temperature=ENGINE_GREEDY,
                                      top_p=ENGINE_GREEDY, guidance_scale=BATCH_GUIDANCE, max_new_tokens=n_new,
                                      prompt_pad_multiple=ENGINE_BUCKET, cache_dtype=cache)[0].tolist()
        # a join: at P = 49, the packed landing one byte past a word boundary
        with recorded_logits() as seen_j:
            kv, pos, pads, spk, cur, k_first, n = _join_group(torch, params, cfg, cache, prompts, spk_ab, 17, seen_j)
            toks, idx = _continue_b(torch, params, cfg, kv, pos, pads, spk, cur, n_new, seen_j)
        moved += n
        joined = ([cur[1]] + toks)[: len(fresh)]
        lj = [lambda i: _row_logits(seen_j[k_first], 0, 1)] + [
            (lambda k: lambda i: _row_logits(seen_j[k], 1, ENGINE_SLOTS))(k) for k in idx]
        join_seen = greedy_rows_agree(torch, f"42 engine-small {fmt} join", fresh, joined,
                                      lambda i: _row_logits(seen_f[i], 0, 1), lambda i: lj[i](i), tol)
        # a rebase: B joins at 161 (its landing at 129, off the word grid), A retires, the group
        # slides left by 128 (<= B's start) and decodes on; against the same group unmoved
        with recorded_logits() as seen_r:
            kv, pos, pads, spk, cur, _, n = _join_group(torch, params, cfg, cache, prompts, spk_ab, 129, seen_r)
            moved += n
            pads[0] = pos  # A retires: an empty window
            snap = tfm.KVCache(*[None if t is None else t.clone() for t in _cache_fields(kv)])
            plain, idx_p = _continue_b(torch, params, cfg, kv, pos, pads, spk, cur, 32, seen_r)
            s = fs.REBASE_ALIGN
            moved += move_matches_cpu(torch, f"42 engine-small {fmt} shift by {s}",
                                      lambda kv_: shift_rows(kv_, s, pos), snap)
            moved_toks, idx_m = _continue_b(torch, params, cfg, snap, pos - s, pads - s, spk, cur, 32, seen_r)
        rebase_seen = greedy_rows_agree(
            torch, f"42 engine-small {fmt} rebase", plain, moved_toks,
            lambda i: _row_logits(seen_r[idx_p[i]], 1, ENGINE_SLOTS),
            lambda i: _row_logits(seen_r[idx_m[i]], 1, ENGINE_SLOTS), tol)
        counts = read_counts()
        decode_kernels = ("k3_launches",) if fmt == "bf16" else ("k5_launches", "k6_launches")
        if dev == "cuda" and not (counts["k2_launches"] > 0 and all(counts[k] > 0 for k in decode_kernels)
                                  and not any(v for k, v in counts.items()
                                              if k not in decode_kernels + ("k2_launches",))):
            fail(f"42 engine-small {fmt}: launched {counts}, expected K2 and {decode_kernels} alone")
        shown.append(f"{fmt} cache ({route}, tol {tol}): join at 49 == B alone: {join_seen}; rebase by 128 == "
                     f"unmoved: {rebase_seen}; launches {({k: v for k, v in counts.items() if v})}")
    print(f"[42 engine-small] int4 first stage (2L/8H/1024d, Ip 2048), {ENGINE_SLOTS} slots, greedy, "
          f"{ENGINE_BUCKET}-token buckets, on {dev}: {'; '.join(shown)}; every landing and shift equal to the "
          f"CPU's bit for bit ({moved} bytes)")


def _wait_for(pred, what: str, timeout: float = 300.0):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            fail(f"waited {timeout:.0f} s for {what}")
        time.sleep(0.002)


def _recording_renders(tts) -> list:
    """Wrap the TTS's render to keep (text, frames, samples) of each render
    that returned a wav, in the order they ran; fails at the end of the
    phase if a wav is not its frames' samples."""
    from metavoice_tpu_torch.core import tokens as T

    real, kept = tts._tokens_to_wav, []
    ctx2, hop = tts.c.second_stage_cfg.block_size, tts.c.encodec_cfg.hop_length

    def recording(text, prompt, toks, spk, noise=None, *, generator=None):
        wav = real(text, prompt, toks, spk, noise, generator=generator)
        frames = min(len(T.split_flattened_interleaved(toks, tts.END_OF_AUDIO_TOKEN)[1][0]), ctx2 - len(prompt))
        kept.append((text, frames, len(wav), frames * hop))
        return wav

    tts._tokens_to_wav = recording
    return kept


@contextlib.contextmanager
def tracked_engine(eng):
    """Follow each request through the engine's slot pool: the first stage's
    logits recorded (recorded_logits) and the engine's group starts, joins,
    segments, rebases and completions wrapped. Yields (kept, seen): kept
    {text: {"req", "tokens" (what the request completed with, no EOA), "at"
    [(index in seen, row, rows of that call's batch) of each token it drew,
    in order], "joined", "rebased"}}."""
    names = ("_start_group", "_join_inner", "_step_segment", "_maybe_rebase", "_complete")
    real = {n: getattr(eng, n) for n in names}
    kept = {}

    def rec(req):
        return kept.setdefault(req.text, {"req": req, "tokens": None, "at": [], "joined": False,
                                          "rebased": False})

    def active():
        return {i: s.req for i, s in enumerate(eng._slots) if not s.free}

    with recorded_logits() as seen:

        def start_group(reqs):
            for i, r in enumerate(reqs[: eng.n_slots]):
                rec(r)["at"].append((len(seen), i, eng.n_slots))
            real["_start_group"](reqs)

        def join(slot, req, bucket):
            rec(req)["at"].append((len(seen), 0, 1))
            rec(req)["joined"] = True
            real["_join_inner"](slot, req, bucket)

        def segment():
            held, k0 = active(), len(seen)
            real["_step_segment"]()
            for i, r in held.items():
                rec(r)["at"].extend((k, i, eng.n_slots) for k in range(k0, len(seen)))

        def rebase():
            held, n = active(), eng.stats["rebases"]
            real["_maybe_rebase"]()
            if eng.stats["rebases"] > n:
                for r in held.values():
                    rec(r)["rebased"] = True

        def complete(slot):
            if not eng._slots[slot].free:
                rec(eng._slots[slot].req)["tokens"] = list(eng._slots[slot].tokens)
            real["_complete"](slot)

        for n, f in zip(names, (start_group, join, segment, rebase, complete)):
            setattr(eng, n, f)
        try:
            yield kept, seen
        finally:
            for n in names:
                delattr(eng, n)


def engine_tokens_agree(torch, label: str, eng, kept: dict, seen: list, tol: float) -> tuple[str, list]:
    """Hold every request of a tracked_engine run (greedy knobs) against that
    request alone: ``prefill_batch`` and then ``decode`` on 2 cache rows, as
    ``generate_batch`` runs them, fed the engine's own tokens one step at a
    time, so that every step is compared, also after the two runs would
    part. At every step the request's two cache rows' logits in the engine
    must lie within ``tol`` of max |alone| (the route's BATCH_LOGIT_TOL; a
    join landed at the wrong place, a wrong window start or a rebase that
    breaks a window moves them by far more), and its token must be the
    argmax of its own guided scores (the tracking read the right row). Where
    that token is not the alone run's argmax, rounding reordered two scores
    closer than the runs' gap: counted as a flip. -> (what was seen, per
    request {"tokens", "worst", "flips", "joined", "rebased"}); fails
    otherwise."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm

    tts, dev, cfg, shown, out = eng.tts, eng.device, eng._cfg, [], []
    params, cdt = tts.c.first_stage_params, tts._compute_dtype
    for n, (text, r) in enumerate(kept.items()):
        req, got, at = r["req"], r["tokens"], r["at"]
        if got is None or (req.temperature, req.top_p) != (ENGINE_GREEDY, ENGINE_GREEDY):
            fail(f"{label}: request {n} ({text!r}) did not complete, or not under greedy knobs")
        # fewer tokens than its budget: it ended at an EOA, drawn at the next step
        got = got + ([T.END_OF_AUDIO_TOKEN] if len(got) < req.max_new_tokens else [])
        if len(at) < len(got):
            fail(f"{label}: request {n} drew {len(got)} tokens, the tracking saw {len(at)}")
        t, p, g = (torch.full((1, 1), v, device=dev) for v in (req.temperature, req.top_p, req.guidance_scale))
        spk = torch.as_tensor(req.spk_emb[None], device=dev)
        bucket = eng._bucket(len(req.prompt_tokens))
        padded, pads = fs.left_pad_prompts([req.prompt_tokens[-bucket:]], bucket)
        pads = torch.as_tensor(pads, device=dev)
        kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=eng._cache_dtype, device=dev)
        with recorded_logits() as alone:
            fs.prefill_batch(params, cfg, torch.as_tensor(padded, dtype=torch.int64, device=dev), pads, spk, kv,
                             t, p, g, cdt)
            for k, tok in enumerate(got[:-1]):
                fs.decode(params, cfg, torch.tensor([tok], device=dev), bucket + k, kv, spk, 1, temperature=t,
                          top_p=p, guidance_scale=g, pad_lens=pads, compute_dtype=cdt)
        worst, flips = 0.0, []
        for i, tok in enumerate(got):
            ref, mine = alone[i], _row_logits(seen[at[i][0]], at[i][1], at[i][2])
            gap = (mine - ref).abs().max().item() / ref.abs().max().item()
            if not gap <= tol:
                fail(f"{label}: request {n} ({text[:24]!r}...), step {i}: the engine's logits differ from the "
                     f"request alone by {gap:.4g} of max |alone| (tol {tol}; tokens the same up to here: "
                     f"{i - len(flips)} of {i})")
            worst = max(worst, gap)
            own = S.cfg_merge(mine, req.guidance_scale)[0]
            if own[tok] < own.max() - 1e-6 * own.abs().max():
                fail(f"{label}: request {n}, step {i}: token {tok} is not the argmax of the logits the tracking "
                     f"gave it ({int(own.argmax())})")
            if int(S.cfg_merge(ref, req.guidance_scale)[0].argmax()) != tok:
                flips.append(i)
        out.append({"tokens": len(got), "worst": worst, "flips": len(flips), "joined": r["joined"],
                    "rebased": r["rebased"]})
        how = "joined" if r["joined"] else "group prefill"
        shown.append(f"request {n} ({how}{', across a rebase' if r['rebased'] else ''}): {len(got)} tokens, "
                     f"logits within {worst:.3g} of max |alone|, "
                     + (f"{len(flips)} rounding flips (first at step {flips[0]})" if flips else "no flip"))
    return "; ".join(shown), out


def _drive_engine(torch, label: str, eng, ref: str, schedule: list, max_new: int, knobs: dict | None = None) -> dict:
    """Submit the requests of ``schedule`` [(after n segments, stream?)] to the
    engine at their segment counts, with the sampling ``knobs``, every kernel
    count set to 0 just before the first and read after the last is done ->
    {"latency_s", "counts", "wall_s", "ttfc_s", "chunks", "paths", "texts",
    "stats" (the run's deltas), "report" (the phase timers)}."""
    import threading

    from metavoice_tpu_torch.utils import phases

    phases.reset()
    phases.enable()
    before = dict(eng.stats)
    _zero_counts()
    t0 = time.perf_counter()
    done, outs, texts, chunks, first_chunk, consumers = {}, {}, {}, [], [], []
    for i, (after, stream) in enumerate(schedule):
        _wait_for(lambda: eng.stats["segments"] - before["segments"] >= after, f"{label}: segment {after}")
        text = texts[i] = f"Request {i}. {SYNTH_TEXT}"
        if stream:
            handle = eng.submit(text, ref, stream=True, max_new_tokens=max_new, **(knobs or {}))

            def consume(handle=handle, i=i):
                for c in handle:
                    if not chunks:
                        first_chunk.append(time.perf_counter() - t0)
                    chunks.append(c)
                done[i] = time.perf_counter() - t0

            consumers.append(threading.Thread(target=consume, daemon=True))
            consumers[-1].start()
        else:
            fut = eng.submit(text, ref, max_new_tokens=max_new, **(knobs or {}))
            fut.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter() - t0))
            outs[i] = fut
    paths = {i: fut.result(timeout=600) for i, fut in outs.items()}
    for th in consumers:
        th.join(timeout=600)
        if th.is_alive():
            fail(f"{label}: the stream did not end")
    wall = time.perf_counter() - t0
    counts = read_counts()
    phases.enable(False)
    return {"latency_s": done, "counts": counts, "wall_s": wall, "ttfc_s": first_chunk[0] if first_chunk else None,
            "chunks": chunks, "paths": paths, "texts": texts,
            "stats": {k: v - before.get(k, 0) for k, v in eng.stats.items()}, "report": phases.format_report(wall)}


def phase_engine_int4(torch, workdir: str, ref: str, dev: str = "cuda", small: bool = False) -> dict:
    """43: the engine on a full-width int4 TTS, 4 slots -> {"eng", "tts", ...}."""
    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
    from metavoice_tpu_torch.runtime.tts import TTS
    from metavoice_tpu_torch.utils import audio_io as aio
    from metavoice_tpu_torch.utils import phases
    import numpy as np

    tts = TTS.from_random(small=small, device=dev, output_dir=os.path.join(workdir, "out_engine"),
                          quantisation_mode="int4")
    cfg1 = tts.c.first_stage_cfg
    eng = ContinuousBatchingEngine(tts, slots=ENGINE_INT4_SLOTS, segment_tokens=ENGINE_SEGMENT,
                                   rebase_margin=cfg1.block_size - ENGINE_REBASE_AT)
    t0 = time.perf_counter()
    eng.warmup()
    warm_s = time.perf_counter() - t0
    renders = _recording_renders(tts)
    with tracked_engine(eng) as (kept, seen):
        run = _drive_engine(torch, "43 engine-int4", eng, ref, ENGINE_SCHEDULE, ENGINE_NEW, GREEDY_KNOBS)
    st, counts = run["stats"], run["counts"]
    if not (st["joins"] >= 2 and st["rebases"] >= 1 and st["truncations"] == 0):
        fail(f"43 engine-int4: scheduling {st}, expected joins >= 2, rebases >= 1, truncations 0")
    want = dict.fromkeys(counts, 0)
    if dev == "cuda":
        want |= {"k3_launches": st["decode_steps"], "k2_launches": 5 * cfg1.n_layer * (st["groups"] + st["joins"])}
    if st["decode_steps"] == 0 or counts != want:
        fail(f"43 engine-int4 launched {counts}, expected {want} ({st})")
    bad = [r for r in renders if r[2] != r[3]]
    if bad:
        fail(f"43 engine-int4: renders whose wav is not their frames' samples (text, frames, samples, want): {bad}")
    for i, path in run["paths"].items():
        wav = check_wav(path)
        want_len = [r[2] for r in renders if r[0] == run["texts"][i]]
        if [len(wav)] != want_len:
            fail(f"43 engine-int4: request {i}'s wav holds {len(wav)} samples, its render {want_len}")
    stream_text = next(run["texts"][i] for i, (_, s) in enumerate(ENGINE_SCHEDULE) if s)
    stream_renders = [r[2] for r in renders if r[0] == stream_text]
    if not run["chunks"] or [len(c) for c in run["chunks"]] != stream_renders or not all(
            np.isfinite(c).all() and c.dtype == np.float32 for c in run["chunks"]):
        fail(f"43 engine-int4: the stream's chunks {[len(c) for c in run['chunks']]} are not its renders "
             f"{stream_renders} in order, or not finite float32")
    # each request's tokens, joined or across the rebase, against the request alone
    if not (any(r["joined"] for r in kept.values()) and any(r["rebased"] for r in kept.values())):
        fail("43 engine-int4: no request whose tokens are held joined the group or spanned a rebase")
    agree, _ = engine_tokens_agree(torch, "43 engine-int4", eng, kept, seen, BATCH_LOGIT_TOL["int4"])
    del seen
    # with the engine idle, a speaker embedding and a render launch none of the kernels
    fresh_ref = os.path.join(workdir, "ref_idle.wav")
    aio.write_wav(fresh_ref, aio.read_wav(ref)[0][::-1].copy(), 24000)
    _zero_counts()
    spk = tts._get_speaker_embedding(fresh_ref)
    tts._tokens_to_wav("idle", tts.c.tokenizer.encode("idle"), np.tile(np.asarray([5, 1031], np.int32), 32), spk)
    if any(read_counts().values()):
        fail(f"43 engine-int4: a speaker embedding and a render launched kernels: {read_counts()}")
    # one join with no render beside it: two requests, the second submitted after the first segment
    lone = _drive_engine(torch, "43 engine-int4 (a lone join)", eng, ref, ((0, False), (1, False)), ENGINE_NEW)
    join_s = phases.report().get("eng.join", {}).get("total_s")
    if lone["stats"]["joins"] != 1 or join_s is None:
        fail(f"43 engine-int4: the lone join's run scheduled {lone['stats']}")
    tokens = st["row_tokens"] + len(ENGINE_SCHEDULE)
    lat = ", ".join(f"{run['latency_s'][i]:.2f}" for i in sorted(run["latency_s"]))
    print(f"[43 engine-int4] {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d int4, {ENGINE_INT4_SLOTS} slots "
          f"({2 * ENGINE_INT4_SLOTS} rows), segments of {ENGINE_SEGMENT}, rebase from {ENGINE_REBASE_AT}: "
          f"engine.warmup {warm_s:.2f} s; {len(ENGINE_SCHEDULE)} requests of at most {ENGINE_NEW} tokens "
          f"(submitted after segments {[a for a, _ in ENGINE_SCHEDULE]}, one streaming) in {run['wall_s']:.2f} s: "
          f"{tokens} tokens, {tokens / run['wall_s']:.1f} tokens/s; latency per request {lat} s; the stream's first "
          f"chunk after {run['ttfc_s']:.3f} s, {len(run['chunks'])} chunks in order; scheduling {st}; launches "
          f"{({k: v for k, v in counts.items() if v})} (K3 == decode steps, K2 == 5 x {cfg1.n_layer} x "
          f"(groups + joins)); a speaker embedding and a render with the engine idle launch no kernel; a join "
          f"with no render beside it {1e3 * join_s:.1f} ms")
    print(f"[43 engine-int4] greedy, each request against itself alone (2 rows, fed its tokens), tol "
          f"{BATCH_LOGIT_TOL['int4']}: {agree}")
    print("[43 engine-int4] phases:\n" + run["report"])
    return {"eng": eng, "tts": tts, "tokens_s": tokens / run["wall_s"], "wall_s": run["wall_s"],
            "warmup_s": warm_s, "ttfc_s": run["ttfc_s"]}


def phase_engine_bf16(torch, workdir: str, ref: str, dev: str = "cuda", small: bool = False) -> dict:
    """44: the engine on a full-width bf16 TTS, 8 slots (16 rows, K1 with starts)."""
    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
    from metavoice_tpu_torch.runtime.tts import TTS

    tts = TTS.from_random(small=small, device=dev, output_dir=os.path.join(workdir, "out_engine16"))
    cfg1 = tts.c.first_stage_cfg
    eng = ContinuousBatchingEngine(tts, slots=ENGINE_BF16_SLOTS, segment_tokens=ENGINE_SEGMENT)
    try:
        t0 = time.perf_counter()
        eng.warmup(warm_tts=False)
        warm_s = time.perf_counter() - t0
        with tracked_engine(eng) as (kept, seen):
            run = _drive_engine(torch, "44 engine-bf16", eng, ref, ENGINE_BF16_SCHEDULE, ENGINE_BF16_NEW,
                                GREEDY_KNOBS)
        st, counts = run["stats"], run["counts"]
        want = dict.fromkeys(counts, 0) | (
            {"k1_launches": cfg1.n_layer * st["decode_steps"]} if dev == "cuda" else {})
        if st["decode_steps"] == 0 or counts != want or st["joins"] < 1 or st["truncations"]:
            fail(f"44 engine-bf16 launched {counts}, expected {want} ({st})")
        for path in run["paths"].values():
            check_wav(path)
        agree, _ = engine_tokens_agree(torch, "44 engine-bf16", eng, kept, seen, BATCH_LOGIT_TOL["bf16"])
        del seen
    finally:
        eng.shutdown()
    tokens = st["row_tokens"] + len(ENGINE_BF16_SCHEDULE)
    lat = ", ".join(f"{run['latency_s'][i]:.2f}" for i in sorted(run["latency_s"]))
    print(f"[44 engine-bf16] {cfg1.n_layer}L/{cfg1.n_head}H/{cfg1.dim}d bf16, {ENGINE_BF16_SLOTS} slots "
          f"({2 * ENGINE_BF16_SLOTS} rows), segments of {ENGINE_SEGMENT}: engine.warmup (no render buckets) "
          f"{warm_s:.2f} s; {len(ENGINE_BF16_SCHEDULE)} requests of at most {ENGINE_BF16_NEW} tokens in "
          f"{run['wall_s']:.2f} s: {tokens} tokens, {tokens / run['wall_s']:.1f} tokens/s; latency per request "
          f"{lat} s; scheduling {st}; launches {({k: v for k, v in counts.items() if v})} (K1 == {cfg1.n_layer} "
          f"x decode steps)")
    print(f"[44 engine-bf16] greedy, each request against itself alone (2 rows, fed its tokens), tol "
          f"{BATCH_LOGIT_TOL['bf16']}: {agree}")
    print("[44 engine-bf16] phases:\n" + run["report"])
    return {"tokens_s": tokens / run["wall_s"], "wall_s": run["wall_s"]}


def phase_server(torch, eng, ref: str, dev: str = "cuda"):
    """45: the port's HTTP server on phase 43's engine, 127.0.0.1 port 0."""
    from http.server import ThreadingHTTPServer
    import functools
    import threading
    import urllib.request
    import numpy as np
    from metavoice_tpu_torch.runtime import server as srv
    from metavoice_tpu_torch.utils import audio_io as aio

    cfg1 = eng.tts.c.first_stage_cfg
    eng.submit = functools.partial(eng.submit, max_new_tokens=ENGINE_NEW)  # a bounded first stage a request
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.make_handler(eng.tts, srv.ServingConfig(),
                                                                  batching_engine=eng))
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("45 server: /health is not ok")
        before = dict(eng.stats)
        _zero_counts()
        bodies, errors = {}, []

        def post(i, stream):
            body = {"text": f"Server request {i}. {SYNTH_TEXT}", "speaker_ref_path": ref}
            if stream:
                body["stream"] = "true"
            req = urllib.request.Request(url + "/tts", data=json.dumps(body).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    first = r.read(44)
                    ttfb = time.perf_counter() - t
                    bodies[i] = (r.headers.get("Content-Length"), first + r.read(), ttfb, time.perf_counter() - t)
            except Exception as e:  # reported below
                errors.append(f"request {i}: {e!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=post, args=(i, i == 3)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = read_counts()
        if errors or len(bodies) != 4:
            fail(f"45 server: {errors or 'a request did not finish'}")
        for i, (length, body, _, _) in bodies.items():
            if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
                fail(f"45 server: request {i} is not a wav")
            stream = i == 3
            if stream != (length is None) or stream != (body[4:8] == b"\xff\xff\xff\xff"):
                fail(f"45 server: request {i}: Content-Length {length}, RIFF size {body[4:8]!r}")
            pcm = np.frombuffer(body[44 : 44 + (len(body) - 44) // 2 * 2], dtype="<i2")
            if len(pcm) == 0 or (stream and body[:44] != aio.wav_streaming_header(24000)):
                fail(f"45 server: request {i} holds no audio or a bad stream header")
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            metrics = {line.split()[0]: float(line.split()[1]) for line in r.read().decode().splitlines()
                       if line and line[0] != "#"}
        st = {k: v - before.get(k, 0) for k, v in eng.stats.items()}
        if (metrics["tts_requests_total"] != 4 or metrics["tts_streaming_requests_total"] != 1
                or metrics["tts_errors_total"] != 0 or metrics["engine_joins_total"] != eng.stats["joins"]):
            fail(f"45 server: /metrics {metrics}")
        want = dict.fromkeys(counts, 0)
        if dev == "cuda":
            want |= {"k3_launches": st["decode_steps"],
                     "k2_launches": 5 * cfg1.n_layer * (st["groups"] + st["joins"])}
        if counts != want:
            fail(f"45 server: launched {counts}, expected {want} ({st})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.shutdown()
    times = ", ".join(f"{bodies[i][3]:.2f}" for i in range(3))
    print(f"[45 server] the port's server on phase 43's engine at 127.0.0.1: /health ok; three JSON /tts and one "
          f"streaming /tts at once ({ENGINE_NEW} tokens a request at most) in {wall:.2f} s: wavs in {times} s, the "
          f"stream's first bytes after {bodies[3][2]:.3f} s and its end after {bodies[3][3]:.2f} s "
          f"({(len(bodies[3][1]) - 44) // 2} samples, live RIFF sizes); /metrics: requests "
          f"{metrics['tts_requests_total']:.0f} (streaming {metrics['tts_streaming_requests_total']:.0f}), errors "
          f"{metrics['tts_errors_total']:.0f}, engine counters {({k: metrics['engine_' + k + '_total'] for k in ('joins', 'rebases', 'segments', 'decode_steps')})}; "
          f"scheduling {st}; launches {({k: v for k, v in counts.items() if v})}")


def main() -> int:
    import torch

    smi = phase_device(torch)
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.runtime.tts import TTS

    build_s = phase_build()
    k1 = phase_k1(torch)
    phase_small(torch)
    with tempfile.TemporaryDirectory() as workdir:
        ref = write_ref(workdir)
        bf16 = phase_synth(torch, workdir, ref)
        comps = {None: bf16.pop("tts").c}
        torch.cuda.empty_cache()
        k2 = phase_k2(torch)
        k3 = phase_k3(torch)
        torch.cuda.empty_cache()
        phase_small4(torch)
        phase_unfused(torch)
        int4 = phase_synth_quantized(torch, workdir, ref, "int4", "9 synth4",
                                     {"k3_launches": 1}, "k2_launches",
                                     {"bf16 phase 5": bf16["ms_per_token"]})
        comps["int4"] = int4["tts"].c
        phase_profile(torch, int4.pop("tts"), "10 profile4", {
            "K3 stack_gemv (products, norms, merges)": "stack_gemv", "K3 attention split": "decode_attn_split",
            "K3 attention combine": "decode_attn_combine", "K2 matmul_int4_i32": "prefill_kernel"})
        torch.cuda.empty_cache()
        k8 = phase_k8(torch)
        k7 = phase_k7(torch)
        torch.cuda.empty_cache()
        phase_small8(torch)
        int8 = phase_synth_quantized(torch, workdir, ref, "int8", "14 synth8",
                                     {"k7_launches": 1}, "k8_launches",
                                     {"bf16 phase 5": bf16["ms_per_token"],
                                      "int4 phase 9": int4["ms_per_token"]})
        phase_profile(torch, int8.pop("tts"), "15 profile8", {
            "K7 stack_gemv (products, norms, merges)": "stack_gemv", "K7 attention split": "decode_attn_split",
            "K7 attention combine": "decode_attn_combine", "K8 matmul_int8_i32": "prefill_kernel"})
        torch.cuda.empty_cache()
        k4 = phase_k4(torch)
        torch.cuda.empty_cache()
        phase_small_spec(torch)
        spec = phase_synth_spec(torch, workdir, ref, comps, {
            "bf16": bf16["ms_per_token"], "int4": int4["ms_per_token"]})
        comps4 = comps["int4"]
        del comps
        torch.cuda.empty_cache()
        gqa = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out_gqa"),
                              first_stage_overrides={"n_local_heads": 2})
        phase_synth_route(torch, workdir, ref, "19 synth-gqa", gqa, "k4_launches")
        del gqa
        torch.cuda.empty_cache()
        g3 = TTS.from_random(small=False, device="cuda", output_dir=os.path.join(workdir, "out_g3"))
        phase_synth_route(torch, workdir, ref, "20 synth-g3", g3, "k1_launches", guidance_scale=(3.0, 1.5))
        del g3
        torch.cuda.empty_cache()
        k5 = phase_k5(torch)
        k6 = phase_k6(torch)
        torch.cuda.empty_cache()
        phase_small_kv8(torch)
        kv8 = phase_synth_kv8(torch, workdir, ref, comps4, {"int4 phase 9": int4["ms_per_token"]})
        del comps4
        torch.cuda.empty_cache()
        k11 = phase_k11(torch)
        k9 = phase_k9(torch)
        torch.cuda.empty_cache()
        k10 = phase_k10(torch)
        torch.cuda.empty_cache()
        phase_small_int8p(torch)
        n_layer = first_stage_config().n_layer
        int8p = phase_synth_quantized(torch, workdir, ref, "int8_plain", "29 synth-int8p",
                                      {"k9_launches": n_layer, "k10_launches": n_layer}, "k11_launches",
                                      {"int4 phase 9": int4["ms_per_token"], "int8 phase 14": int8["ms_per_token"]})
        del int8p["tts"]
        torch.cuda.empty_cache()
        k12 = phase_k12(torch, packed=False)
        k13 = phase_k12(torch, packed=True)
        torch.cuda.empty_cache()
        phase_small_int4g(torch)
        compared = {"int4 phase 9": int4["ms_per_token"], "int8_plain phase 29": int8p["ms_per_token"]}
        int4g = phase_synth_int4g(torch, workdir, ref, False, compared)
        del int4g["tts"]
        torch.cuda.empty_cache()
        int4p = phase_synth_int4g(torch, workdir, ref, True,
                                  compared | {"groupwise int4 phase 33": int4g["ms_per_token"]})
        del int4p["tts"]
        torch.cuda.empty_cache()
        runs = [phase_batch_bf16(torch)]
        torch.cuda.empty_cache()
        runs += phase_batch_int4(torch).values()
        torch.cuda.empty_cache()
        runs += phase_batch_routes(torch).values()
        torch.cuda.empty_cache()
        batch_launches(runs)
        stream = phase_streaming(torch, workdir, ref)
        phase_get_tokens(torch, workdir, stream.pop("tts"))
        del stream
        torch.cuda.empty_cache()
        phase_warmup(torch, workdir, ref, build_s)
        phase_engine_small(torch)
        torch.cuda.empty_cache()
        served = phase_engine_int4(torch, workdir, ref)
        phase_engine_bf16(torch, workdir, ref)
        torch.cuda.empty_cache()
        phase_server(torch, served.pop("eng"), ref)
        del served
        torch.cuda.empty_cache()
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # and, where a phase read it from the graph of one call, the kernels a call
    counted = ("kernels_a_call",)
    # each kernel's launches are those of the main path that runs it
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"metavoice_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": run["counts"][key], **{k: stats[k] for k in keys},
         **{k: stats[k] for k in counted if k in stats}}
        for name, key, run, src, replaces, stats in (
            ("decode_attention", "k1_launches", bf16, "decode_attention.cu",
             "metavoice_tpu/ops/attention.py:292", k1),
            ("matmul_int4_i32", "k2_launches", int4, "matmul_int4_i32.cu",
             "metavoice_tpu/ops/quantized.py:927", k2),
            ("decode_stack_int4", "k3_launches", int4, "decode_stack_int4.cu",
             "metavoice_tpu/ops/decode_stack.py:688", k3),
            ("matmul_int8_i32", "k8_launches", int8, "matmul_int4_i32.cu",
             "metavoice_tpu/ops/quantized.py:1098", k8),
            ("decode_stack_int4[i8]", "k7_launches", int8, "decode_stack_int4.cu",
             'metavoice_tpu/ops/decode_stack.py:688 (wfmt="i8")', k7),
            ("decode_attention_multi", "k4_launches", spec["bf16"], "decode_attention_multi.cu",
             "metavoice_tpu/ops/attention.py:545", k4),
            ("decode_attention_block_int4", "k5_launches", kv8["int8"], "decode_block_int4.cu",
             "metavoice_tpu/ops/attention.py:1644", k5),
            ("decode_ffn_int4", "k6_launches", kv8["int8"], "decode_block_int4.cu",
             "metavoice_tpu/ops/quantized.py:866", k6),
            ("decode_attention_block_int8", "k9_launches", int8p, "decode_block_int8.cu",
             "metavoice_tpu/ops/attention.py:1750", k9),
            ("ffn_int8", "k10_launches", int8p, "decode_block_int8.cu",
             "metavoice_tpu/ops/quantized.py:407", k10),
            ("matmul_int8", "k11_launches", int8p, "matmul_int8.cu",
             "metavoice_tpu/ops/quantized.py:153", k11),
            ("matmul_int4", "k12_launches", int4g, "matmul_int4_grouped.cu",
             "metavoice_tpu/ops/quantized.py:204", k12),
            ("matmul_int4_packed", "k13_launches", int4p, "matmul_int4_grouped.cu",
             "metavoice_tpu/ops/quantized.py:328", k13),
        )
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
