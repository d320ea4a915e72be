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
               (from the graph of one call); each case's window bucket's
               plan; the slot read on the device (a 0-d int32 tensor, as a
               replayed decode step reads it) gives the host-int call's bits
               in every case; per layer from a CUDA graph at pos 255, 256,
               1000 and 2047, host int and device pos, beside SDPA on the
               same window, the plain version and the bound;
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
               directory); then a TTS of the same weights on the int8 cache
               (K5/K6), its TTS.warmup timed and the decode graphs it
               captured counted (every window bucket of both variants).
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

 46. checkpoint-files - reference-format .pt files of seeded random f32
               weights at full width, in a temporary directory removed after
               phase 49: the first stage (24L/16H/2048d, vocab 2562, about
               4.9 GB, with the _orig_mod. prefix and the tokenizer in its
               meta), the default second stage, the speaker encoder, EnCodec
               24 kHz in the encodec package's names with weight norm; each
               loaded onto the card by the port's loaders with every leaf
               bit-equal to the array written (the weight norm folded in
               float64 apart from the port); sizes, write and load seconds;
 47. from-checkpoints - `cli quantize --mode int4` of the .pt in a process of
               its own (seconds, size); TTS.from_checkpoints on the card from
               the bf16 .pt (K1), the int4 .npz (K2, K3) and the .npz on the
               int8 cache (K5, K6): each first stage bit-equal to the tree
               built in process from the same weights, its first-stage tokens
               under injected Gumbel draws identical to that TTS's, and a
               synthesise launching as phases 5, 9 and 24 require; then the
               int4 .npz with a small int4 draft .npz (2L/8H/1024d, gamma 8,
               CFG-free): K4 == n_layer x rounds, K3 == gamma x rounds;
 48. cli     - python -m metavoice_tpu_torch.cli in processes of their own:
               synth from the .npz (a wav), capacity on the card (the plan and
               capacity.max_slots), serve --batching auto (the slot count it
               prints equal to capacity.max_slots capped at 32; /health, one
               /tts, one streamed /tts with its first bytes timed and live
               RIFF sizes; SIGTERM -> "server stopped", exit 0); the
               checkpoint tokenizer on the native BPE engine;
 49. capacity-plan - ContinuousBatchingEngine(slots="auto") from the int4
               .npz on the bf16 and the int8 cache: every slot given a request
               in the 256 prompt bucket, two segments each; the plan's bytes,
               torch.cuda.max_memory_reserved and the card's total printed,
               and the pool's own peak (over what the process held before its
               TTS) within the plan's budget.

 50. finetune-parity - a small first stage (2L/8H/1024d, vocab 2562) takes
               3 train steps (dropout 0, f32 params and compute, lr 1e-3,
               warmup 2, weight decay 0.1) on the card and on the CPU route
               from the same weights and batches: the losses within 1e-4,
               the grad-mask path's params as the CPU tests hold the port to
               JAX (every element within 2 x the rates summed, all but 1e-3
               of each leaf within 1e-3 lr), its frozen leaves bit for bit,
               the split path's tail the mask path's;
 51. finetune-full-width - first_stage_config() with bf16 params, dropout
               0.1 and spkemb_dropout 0.1, batches of 2 x 2048 tokens: 6 steps
               of the split tail (last_n_blocks 1), 3 of the whole tree with
               accumulation 2; for each the median ms a step after the first,
               tokens/s, torch.cuda.max_memory_allocated and MFU against 989
               TFLOP/s with the FLOP count stated (train_flops); losses
               finite, the frozen layers bit for bit, the tail moved; then
               final.npz through trainer.save_checkpoint, loaded by
               TTS.from_checkpoints(quantisation_mode="int4"), and a 64-token
               synthesise: K3 == decode steps, K2 == 5 x n_layer x prefills;
 52. finetune-e2e - `cli finetune --small` in a process of its own on a CSV
               of generated wavs; the JAX package's trained-system recipe
               (tests/test_trained_system_e2e.py) on the card, with a 2-head
               64-dim-head GQA first stage: a first stage (trainer.train, 600
               steps, every leaf) and a second stage (500 steps) overfit to
               two utterances below a teacher-forced loss of 0.15, loaded by
               TTS.from_checkpoints; each synthesis spectrally closer to its
               own utterance's codec reconstruction than to the other's.
 53. small-mbd - a small MBD (2 UNets, 8-32 channels, 3 steps) and the
               default DF-style enhancer network on the card against the same
               functions on the CPU, same weights and injected draws:
               unet_forward (zeroed and passthrough bottlenecks, per-example
               steps), re_eq, generate, tokens_to_wav (a small EnCodec) and
               df_enhance_spec, each max |err| within its printed bound
               (MBD_TOL, DF_TOL of max |ref|);
 54. synth-mbd - full-width TTS.from_random(vocoder="mbd") (bf16 first
               stage, the default MBD: 4 UNets of 48-3072 channels, 582 M
               f32 parameters, 20 steps): one synthesise and one
               synthesise_streaming, K1 launched on each; MBD ms per second
               of audio, RTF and peak memory; one 1 s MBD render profiled
               (device time by kernel name);
 55. train-mbd/df - three steps of one full-width MBD band (clip + Adam, 4
               x 1 s clips) and train_df of the default DF network: ms a
               step, finite losses, the stamped enhancer on a wav.
 56. tp-small - tensor parallelism (metavoice_tpu_torch/parallel) on two
               ranks, processes of parallel/mesh.spawn sharing cuda:0 over
               gloo (NCCL takes one card a rank), the kernels built first
               in this process: a 2L/4H/512d first stage in f32 and bf16
               with None, int4 and int8 weights and on the int8 cache, a
               32-token prefill and 8 teacher-forced steps on each rank
               against a CPU tp = 1 run of the plain path (TP_SMALL_TOL of
               max |ref|), the two ranks' logits bit-identical, every kernel
               call of the prefill and of the first and last step held
               against its plain version at the local shapes (K1, K2, K8),
               each rank's launches as the route requires and none of
               K3/K5/K6/K7/K9, and 48 tokens under the same Gumbel draws
               identical on both ranks;
 57. tp-synth - full-width TTS(tensor_parallel=2) on the two ranks for
               bf16, int4 and int8 weights: a 192-token synthesise through
               the user's entry point (the leader's wav; each rank's K1 =
               n_layer x steps and K2 or K8 = 5 x n_layer x (steps + 1) at
               the local shapes, nothing else launched), 64 tokens under
               Gumbel draws held to tp = 1's on the same weights up to the
               first near-tie (the step and the score gap printed; the
               logits within TP_SYNTH_TOL until then), identical on both
               ranks, their kernel calls held against the plain versions;
               one gloo all_reduce of a decode step timed, and each rank's
               ms a token, which is two ranks sharing one card over gloo,
               not a TP latency.
 58. sharded-small - sharded training (training/finetune.py under mesh=,
               parallel/sharding.py) on four ranks sharing cuda:0 over gloo
               at DP 2 x TP 2: parallel/dryrun's rank body (JAX's
               dryrun_multichip: one finetune step of its tiny 2L/4H/64d
               model and one TP decode step), two whole-tree train steps
               and one finetune step, f32, against the one-process step on
               the card (SHARD_SMALL_RTOL; the gathered params as phase 50
               holds two trees), every leaf bit-identical across a data
               group and the replicated ones across a tensor group, no
               kernel launched (sharded training runs none);
 59. sharded-full-width - make_train_step on the whole full-width tree in
               bf16 (a global batch of 4 x 2048, JAX's
               compile_sharded_train_step shape), two steps and one
               make_finetune_step, on the four ranks against tp = 1 run
               first in this process on the same weights: losses, grad
               norms, per leaf the cosine and norm ratio of the gathered
               step-1 grads (SHARD_FULL_TOL), the bits across the groups,
               no kernel launched; ms a step a rank, the reductions' share,
               peak memory a rank beside aot.abstract_train_state's bytes
               (four ranks sharing one card: no DP or TP time).
 60. graph-decode - first_stage.decode's CUDA-graph step (the K1, K3 and
               K7 routes) against its eager loop, decode_eager, at full
               width in bf16, int4 and int8: 64 tokens in four segments
               whose pos crosses every K1 window bucket (384, 512, 1024)
               and reaches the cache's end, a ragged batch of 4 with
               per-row starts and knobs, 3-row guidance, two calls at
               other temperature and top-p, and engine-shaped segments
               (2 slots, a generator's draws): tokens, lengths and caches
               bit for bit, the launch counts equal; a capture before any
               eager call raises; ms a token of both loops over three
               calls each (96 steps from pos 128, the CFG pair).
 61. graph-decode-routes - the graph step of every other single-card
               route against decode_eager at full width on seeded random
               weights (ROUTES_61): int4 on the int8 and on the packed
               cache (K5/K6), int8_plain (K9/K10), GQA with 2 kv heads in
               bf16 (K4) and in int8_plain (K11 + K4 + K10), groupwise int4
               g 128 unpacked and packed (K12/K13 + K1), int8 and int4 words
               at 16 rows (K8 + K1, K2 + K1), bf16 weights on the int8 cache
               (the dequantizing path): 192 tokens over every window bucket
               to the cache's end, a ragged batch of 4 with per-row knobs
               (the 16-row routes: ragged at 8), 3-row guidance (9 rows on
               the 16-row routes): tokens, lengths, every cache field and
               the launch counts bit for bit, each route's launches a step
               (on the K5 and K9 routes the ragged batch runs 160 steps
               from pos 370 with a row starting at 300, across pos 512);
               a capture before any eager call raises; ms a token of both
               loops (24 steps from pos 128) and one profiled graph step;
               then K4 (GQA, T 1), K5 (MHA; bf16, int8, packed) and K9 with pos
               on the device at pos 0, 255, 512, 1000, 2047 with starts and
               NaN past pos (the host-int bits, the plain version), each
               timed per layer from a CUDA graph host int and device pos;
               and K11 at a GQA int8_plain step's qkv and wo shapes, M 2,
               beside torch._weight_int8pack_mm and torch.matmul.

Phases 5, 9, 14, 18, 19, 20, 24, 29, 33, 34, 36-39, 43-45, 47, 51, 54, 57, 60 and 61 are the main paths: every
kernel count is set to 0 just before each and read just after; in 58-59 each rank sets them to 0 before its steps and
reads them 0 after. The two lines before the last are the
kernels' JSON record and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}. TF32 is off for matmuls and convolutions
throughout, so every comparison is f32. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

MAIN_SHAPE = dict(l=24, s=2048, b=2, h=16, dh=128)
K1_TOL = 2e-2
TIMED_POS = (255, 256, 1000, 2047)  # the JSON line carries the last one
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
# K4 at T = gamma with pos on the device, planned at the window bucket (the speculative round's verify in a CUDA
# graph): (T, pos), each timed against the host int in the same bucket; at 380 and 1020 a split boundary of the
# bucket's plan (512 in 4 splits of 128, 2048 in 4 of 512) falls inside [pos, pos + T)
K4_DEVICE_POS = tuple((t, p) for t in (4, 8, 16) for p in (255, 1000, 2032)) + ((8, 380), (8, 1020))
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
    # the window buckets' edges: the last slot of one bucket and the first of the next
    cases += [(p, None, None) for p in (384, 512, 1024)]
    max_err = 0.0
    plans = {}
    for pos, starts, garbage in cases:
        q, k_new, v_new, kc, vc = _k1_inputs(torch, gen, dev, pos, garbage)
        st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
        kc_ref, vc_ref = kc.clone(), vc.clone()
        kc_dev, vc_dev = kc.clone(), vc.clone()
        y_ref, _, _ = A.decode_attention_reference(q, k_new, v_new, kc_ref, vc_ref, layer, pos, st)
        before = A.decode_attention.launches
        y, _, _ = A.decode_attention(q, k_new, v_new, kc, vc, layer, pos, st)
        # the slot read on the device, as a replayed step reads it, in the same window bucket
        window = A.attention_window(pos + 1, kc.shape[1])
        y_dev, _, _ = A.decode_attention(q, k_new, v_new, kc_dev, vc_dev, layer,
                                         torch.tensor(pos, dtype=torch.int32, device=dev), st, window=window)
        torch.cuda.synchronize()
        what = f"pos {pos} starts {starts} garbage {garbage}"
        if A.decode_attention.launches != before + 2:
            fail(f"K1 counted {A.decode_attention.launches - before} launches for two calls at {what}")
        if not all(torch.equal(a.view(torch.int16), c.view(torch.int16))
                   for a, c in ((y, y_dev), (kc, kc_dev), (vc, vc_dev))):
            fail(f"K1 with pos on the device differs from the host-int call at {what}")
        plans[pos + 1] = A.attention_plan(window, rows, 1)
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
    pos_t = torch.zeros((), dtype=torch.int32, device=dev)
    _one_kernel(torch, lambda: A.decode_attention(q, k_new, v_new, kc, vc, 0, pos_t, window=kc.shape[1]),
                "K1 with pos on the device")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q[:, :, None, :]
    for pos in TIMED_POS:
        # the library yardstick: SDPA on each layer's window, pre-transposed to (B, H, pos+1, Dh)
        kt = [kc[li, : pos + 1].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        vt = [vc[li, : pos + 1].permute(1, 2, 0, 3).contiguous() for li in range(n_layer)]
        library, _ = _layers_ms(torch, lambda li: sdpa(qt, kt[li], vt[li]), n_layer)
        del kt, vt
        kernel = _layers_ms(torch, lambda li: A.decode_attention(q, k_new, v_new, kc, vc, li, pos), n_layer)
        pos_t.fill_(pos)
        window = A.attention_window(pos + 1, kc.shape[1])
        on_device, _ = _layers_ms(torch, lambda li: A.decode_attention(q, k_new, v_new, kc, vc, li, pos_t,
                                                                       window=window), n_layer)
        plain = _layers_ms(
            torch, lambda li: A.decode_attention_reference(q, k_new, v_new, kc, vc, li, pos), n_layer
        )
        times[pos] = (kernel, plain, library, on_device)
    window_bytes = lambda p: 2 * (p + 1) * q.numel() * q.element_size()  # noqa: E731
    row = q.numel() * q.element_size()  # one (B, H, Dh) bf16 row
    # read q, k_new, v_new and the window; write the cache row pair and y
    bounds = {p: bound(window_bytes(p) + 3 * row + 2 * row + row, 4.0 * (p + 1) * q.numel(), F32_FLOP_S)
              for p in TIMED_POS}
    shown = "; ".join(
        f"pos {p} (bucket {A.attention_window(p + 1, kc.shape[1])}, plan "
        f"{A.attention_plan(A.attention_window(p + 1, kc.shape[1]), rows, 1)}): kernel {k[0]:.4f} ms "
        f"({window_bytes(p) / k[0] / 1e6:.0f} GB/s), pos on the device {dv:.4f}, SDPA {lib:.4f}, plain {pl[0]:.4f}, "
        f"bound {bounds[p][0]:.4f} on the device; {k[1]:.4f} / {pl[1]:.4f} ms a call from Python"
        for p, (k, pl, lib, dv) in times.items()
    )
    print(f"[3 K1] {len(cases)} cases at {MAIN_SHAPE} bf16 agree (max |dy| {max_err:.3g}, tol {K1_TOL}; caches "
          f"bit-identical, new rows written; pos read on the device in its window bucket: the host-int call's "
          f"bits); one kernel a call ({kernel_name}); bucket plans (window: split_len, splits): {plans}; per "
          f"layer, device time from a CUDA graph (SDPA on the pre-transposed window): {shown}")
    pos = TIMED_POS[-1]
    (ms, _), (plain, _), library, _ = times[pos]
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
    from metavoice_tpu_torch.ops.counters import KERNEL_COUNTERS

    return KERNEL_COUNTERS


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def drive_main_path(tts, ref: str, max_new_tokens: int = 192, **kw) -> tuple[str, float, dict]:
    """One synthesise through the user's entry point, every kernel count set
    to 0 just before and read just after -> (wav path, seconds, counts)."""
    for fn, attr in counters().values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    path = tts.synthesise(SYNTH_TEXT, ref, max_new_tokens=max_new_tokens, **kw)
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
    check_stats(tts, counts, ("k1_launches",))
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
                          matmul: str, compared: dict, tts=None, init_s=None, max_new_tokens: int = 192) -> dict:
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
    path, total_s, counts = drive_main_path(tts, ref, max_new_tokens)
    steps = tts.stats["decode_steps"]
    prefills = len(chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK) or [""])
    want = dict.fromkeys(counts, 0)
    want.update({k: steps * n for k, n in per_step.items()})
    if matmul:
        want[matmul] += 5 * cfg1.n_layer * prefills
    if steps == 0 or counts != want:
        fail(f"[{label}] synthesise launched {counts}, expected {want}")
    check_stats(tts, counts, per_step)
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


def check_stats(tts, counts: dict, step_kernels=None):
    """TTS.stats' kNN_launches must agree with the kernel counts, and with
    ``step_kernels`` (the kernels a decode step launches) its decode route
    must be "graph": every single-card route's step is captured in a CUDA
    graph (first_stage.DECODE_ROUTES; TP stays eager; the speculative
    round's route, "spec", is checked by phase 18)."""
    if {key: tts.stats[key] for key in counts} != counts:
        fail(f"TTS.stats {tts.stats} disagrees with the kernel counts {counts}")
    if step_kernels is not None and tts.stats.get("decode_route") != "graph":
        fail(f"a decode step of {sorted(step_kernels)} ran on the {tts.stats.get('decode_route')!r} route, not "
             "'graph'")


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
    k4_device_pos(torch, A, gen, dev, {k[1:]: v for k, v in times.items() if k[0] == h})
    ms, plain, library, bound_ms, bound_by, _ = times[(h, 4, 2032)]
    gqa_ms, _, gqa_library, gqa_bound_ms, _, gqa_nomask = times[(2, 1, 2032)]
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library,
            "gqa_t1": {"ms": gqa_ms, "library_ms": gqa_library, "library_no_mask_ms": gqa_nomask,
                       "bound_ms": gqa_bound_ms}}


def k4_device_pos(torch, A, gen, dev, exact: dict) -> None:
    """Phase 16, K4 at T = gamma with ``pos`` read on the device
    (K4_DEVICE_POS): against the host int in the same window bucket bit for
    bit (y and both caches, NaN past pos + T never read), against the plain
    version within K4_TOL, both timed per layer from a CUDA graph; ``exact``
    (T, pos) -> phase 16's times of the host int over [0, pos + T)."""
    b, h, s, n_layer, layer = MAIN_SHAPE["b"], MAIN_SHAPE["h"], MAIN_SHAPE["s"], MAIN_SHAPE["l"], 7
    max_err, shown = 0.0, []
    for t, pos in K4_DEVICE_POS:
        window = A.attention_window(pos + t, s)
        dpos = torch.tensor(pos, dtype=torch.int32, device=dev)
        q, k_new, v_new, kc, vc = _k4_inputs(torch, gen, dev, b, h, h, t, pos, float("nan"))
        kd, vd, kr, vr = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        before = A.decode_attention_multi.launches
        y, _, _ = A.decode_attention_multi(q, k_new, v_new, kc, vc, layer, pos, window=window)
        yd, _, _ = A.decode_attention_multi(q, k_new, v_new, kd, vd, layer, dpos, window=window)
        ref, _, _ = A.decode_attention_multi_reference(q, k_new, v_new, kr, vr, layer, dpos, window=window)
        torch.cuda.synchronize()
        what = f"T {t}, pos {pos}, window {window}, plan {A.attention_plan(window, b * h, t)}"
        if A.decode_attention_multi.launches != before + 2:
            fail(f"16 K4 device pos: {A.decode_attention_multi.launches - before} launches for two calls at {what}")
        if not (_same_bits(torch, y, yd) and _same_bits(torch, kc, kd) and _same_bits(torch, vc, vd)):
            fail(f"16 K4 with pos on the device differs from the host int at {what}")
        if not (torch.isfinite(yd.float()).all() and _same_bits(torch, kd, kr) and _same_bits(torch, vd, vr)):
            fail(f"16 K4 with pos on the device: NaN in y, or caches other than the plain version's, at {what}")
        max_err = max(max_err, (yd.float() - ref.float()).abs().max().item())
        try:
            torch.testing.assert_close(yd.float(), ref.float(), atol=K4_TOL, rtol=K4_TOL)
        except AssertionError as e:
            fail(f"16 K4 with pos on the device disagrees with the plain version at {what}: {e}")
        del kd, vd, kr, vr
        q, k_new, v_new, kc, vc = _k4_inputs(torch, gen, dev, b, h, h, t)
        host = _layers_ms(torch, lambda li: A.decode_attention_multi(q, k_new, v_new, kc, vc, li, pos, window=window),
                          n_layer)[0]
        device = _layers_ms(torch, lambda li: A.decode_attention_multi(q, k_new, v_new, kc, vc, li, dpos,
                                                                       window=window), n_layer)[0]
        n_bytes = 2 * (pos + t) * b * h * 128 * 2 + 2 * t * b * h * 128 * 2 + 2 * q.numel() * 2
        bound_ms, bound_by = bound(n_bytes, 4.0 * b * h * t * (pos + t) * 128, BF16_FLOP_S)
        old = exact.get((t, pos))
        shown.append(f"T {t} pos {pos} (window {window}): host int {host:.4f} / device {device:.4f} ms"
                     + ("" if old is None else f" (exact window {old[0]:.4f}, SDPA {old[2]:.4f})")
                     + f", bound {bound_ms:.4f} ({bound_by})")
        del q, k_new, v_new, kc, vc
    print(f"[16 K4 device pos] T = gamma at B {b}, H {h}, bf16, planned at the window bucket: {len(K4_DEVICE_POS)} "
          f"cases bit for bit against the host int (y, caches; NaN past pos + T unread), the plain version within "
          f"{K4_TOL} (max |dy| {max_err:.3g}); per layer from a CUDA graph: {'; '.join(shown)}")


def spec_draws(torch, sd, rounds: int, gamma: int, vocab: int, seed: int, dev, forced=()):
    """SpecDraws (made on the CPU from ``seed``, moved to ``dev``) that never
    draw end-of-audio, but in ``forced``'s (round, k) rounds: accept the
    first k proposals (uniform 0), reject the next (uniform 1) and replace
    it by end-of-audio (its residual noise), so the generation ends there."""
    from metavoice_tpu_torch.core import tokens as T

    d = sd.SpecDraws.sample(rounds, gamma, vocab, generator=torch.Generator().manual_seed(seed))
    for t in (d.prefill, d.draft, d.residual):
        t[..., T.END_OF_AUDIO_TOKEN] = -1e4
    for r, k in forced:
        d.uniform[r, :k] = 0.0
        d.uniform[r, k:] = 1.0
        d.residual[r, T.END_OF_AUDIO_TOKEN] = 1e4
    return d.to(dev)


def spec_loops_agree(torch, sd, label: str, models: tuple, prompt, spk, *, caches=None, **kw) -> dict:
    """One generation by the host loop (generate_spec_eager) and the device
    loop (generate_spec: each round a CUDA-graph replay on the card), the
    kernel counts set to 0 before each: tokens, ledger and (with ``caches``,
    a function making a fresh (target, draft) pair) both caches below pos
    bit for bit; the launches, a round's times the rounds each loop ran ->
    {"tokens", "stats", "loop" (generate_spec's stats dict), "counts" (the
    device loop's), "eager_counts"}."""
    from metavoice_tpu_torch.core import tokens as T

    runs = []
    for fn in (sd.generate_spec_eager, sd.generate_spec):
        kv = caches() if caches else None
        for f, attr in counters().values():
            setattr(f, attr, 0)
        loop = {}
        extra = dict(stats=loop) if fn is sd.generate_spec else {}
        extra.update({} if kv is None else dict(kv_cache=kv[0], draft_kv_cache=kv[1]))
        tokens, stats = fn(*models, prompt, spk, return_stats=True, **kw, **extra)
        torch.cuda.synchronize()
        runs.append((tokens, stats, read_counts(), loop, kv))
    (te, se, ce, _, kve), (tg, sg, cg, loop, kvg) = runs
    if not (te.shape == tg.shape and (te == tg).all() and se == sg):
        part = next((i for i in range(min(len(te), len(tg))) if te[i] != tg[i]), min(len(te), len(tg)))
        fail(f"17-18 {label}: the device loop's tokens part from the host loop's at {part} ({len(tg)} / {len(te)} "
             f"tokens), ledger {sg} / {se}")
    if loop.get("spec_loop") != "graph":
        fail(f"17-18 {label}: the device loop ran {loop.get('spec_loop')!r}, not 'graph'")
    if kve is not None:
        pos = len(te) - 1
        for a, b in zip((kvg[0], kvg[1]), (kve[0], kve[1])):
            if not (_same_bits(torch, a.k[:, :pos], b.k[:, :pos]) and _same_bits(torch, a.v[:, :pos], b.v[:, :pos])):
                fail(f"17-18 {label}: the device loop's caches below pos {pos} differ from the host loop's")
    # a round runs idle only after end-of-audio inside an interval between host reads; K4 runs once a target
    # layer a round (the prefills take no K4), so the device loop's K4 count is the host loop's a round times
    # the rounds it ran, idle ones too; with none idle every count is the host loop's
    run, rounds = loop["spec_rounds_run"], se["rounds"]
    if run < rounds or (te[-1] != T.END_OF_AUDIO_TOKEN and run != rounds):
        fail(f"17-18 {label}: {run} rounds run for {rounds} that emitted, the generation not ended by end-of-audio")
    if (run == rounds and cg != ce) or cg["k4_launches"] * max(rounds, 1) != ce["k4_launches"] * run:
        fail(f"17-18 {label}: the device loop credited {cg} in {run} rounds, the host loop launched {ce} in {rounds}")
    return {"tokens": tg, "stats": sg, "loop": loop, "counts": cg, "eager_counts": ce}


def phase_small_spec(torch):
    """17: speculative decoding on the card vs the CPU path, same weights and
    draws; the device loop against the host loop on the card bit for bit
    where a generation ends (end-of-audio inside a round, max_new_tokens,
    the block limit); a greedy self-draft."""
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
        loop = {}
        runs[name] = (*sd.generate_spec(p, cfg, d, dcfg, prompt, spk, stats=loop, **kw), read_counts(), loop)
    (tok_cpu, st_cpu, _, _), (tok_gpu, st_gpu, counts, loop) = runs["cpu"], runs["cuda"]
    if not (tok_cpu.shape == tok_gpu.shape and (tok_cpu == tok_gpu).all() and st_cpu == st_gpu):
        fail(f"speculative decoding on the card differs from the CPU path: {tok_gpu} {st_gpu} vs "
             f"{tok_cpu} {st_cpu}")
    want = dict.fromkeys(counts, 0)
    want.update({"k4_launches": cfg.n_layer * loop["spec_rounds_run"],
                 "k1_launches": dcfg.n_layer * gamma * loop["spec_rounds_run"]})
    if counts != want or loop["spec_loop"] != "graph":
        fail(f"the small speculative run launched {counts} on the {loop['spec_loop']} loop, expected {want}")
    # the device loop against the host loop where a generation ends
    cuda_models = (to_cuda(params), cfg, to_cuda(draft), dcfg)

    def caches():
        return tuple(tfm.KVCache.create(c, 2, c.block_size, dtype=torch.float32, device="cuda") for c in (cfg, dcfg))

    ends = []
    for label, n_prompt, max_new, forced in (("end-of-audio in round 5", 40, None, ((5, 2),)),
                                             ("max_new_tokens 23", 40, 23, ()),
                                             ("the block limit", 400, None, ())):
        d = spec_draws(torch, sd, 512, gamma, cfg.vocab_size, 170 + len(ends), "cuda", forced)
        got = spec_loops_agree(torch, sd, f"small {label}", cuda_models, list(range(2100, 2100 + n_prompt)), spk,
                               caches=caches, gamma=gamma, max_new_tokens=max_new, compute_dtype=torch.float32,
                               prompt_pad_multiple=8, draws=d)
        ends.append(f"{label}: {len(got['tokens']) - n_prompt} tokens in {got['stats']['rounds']} rounds "
                    f"({got['loop']['spec_rounds_run']} run, {got['loop']['spec_reads']} host reads)")
    greedy = dict(temperature=1e-6, top_p=1.0, max_new_tokens=n, compute_dtype=torch.float32)
    gp = to_cuda(params)
    ref = fs.generate(gp, cfg, prompt, spk, **greedy)
    tok, st = sd.generate_spec(gp, cfg, gp, cfg, prompt, spk, gamma=gamma, return_stats=True, **greedy)
    if not (st["accepted"] == st["proposed"] and tok.shape == ref.shape and (tok == ref).all()):
        fail(f"greedy self-draft speculation on the card: {st}, tokens equal "
             f"{tok.shape == ref.shape and (tok == ref).all()}")
    print(f"[17 small-spec] target 2L/4H/512d, draft 1L/2H/256d (f32), gamma {gamma}, injected draws: "
          f"the card's device loop == the CPU path, {len(tok_gpu) - len(prompt)} tokens, ledger {st_gpu}, launches "
          f"{({k: v for k, v in counts.items() if v})} in {loop['spec_rounds_run']} rounds run; device loop == host "
          f"loop bit for bit (tokens, ledger, caches below pos, launches a round) at {'; '.join(ends)}; greedy "
          f"self-draft: {st} (all accepted), {len(tok) - len(prompt)} tokens == first_stage.generate's")


def _spec_ledger_ok(st: dict, gamma: int) -> bool:
    return (st["rounds"] >= 1 and st["proposed"] == gamma * st["rounds"] and 0 <= st["accepted"] <= st["proposed"]
            and st["rounds"] <= st["emitted"] <= gamma * st["rounds"])


SPEC_FORCED_NEW = 96  # phase 18: tokens of the forced generations (end-of-audio never drawn)
SPEC_TIMED_RUNS = 3  # calls of each loop timed, in turns host, device, device, host, ...
SPEC_PROFILED = 16  # rounds of phase 18's profiled graph loop, from pos 128
SPEC_GREEDY_NEW = 32  # tokens of phase 18's greedy self-draft
# a greedy self-draft may part from first_stage.generate only where the two tokens' guidance-merged target logits
# lie within this of each other (of max |logit|): the verify's T = gamma products round apart from the T = 1 step's
SPEC_FLIP_TOL = {"bf16": 2e-2, "int4": 5e-2}


def spec_greedy_self_draft(torch, fs, sd, label: str, params, cfg, prompt, spk, gamma: int, eot: int) -> str:
    """Phase 18's greedy self-draft at full width: the target as its own
    draft against first_stage.generate: acceptance 100% and the same tokens,
    or a parting shown to be a rounding flip (the two tokens' guidance-merged
    logits of a fresh prefill of the common prefix within SPEC_FLIP_TOL)."""
    greedy = dict(temperature=1e-6, top_p=1.0, max_new_tokens=SPEC_GREEDY_NEW, end_of_text_token=eot,
                  prompt_pad_multiple=128)
    ref = fs.generate(params, cfg, prompt, spk, **greedy)
    tok, st = sd.generate_spec(params, cfg, params, cfg, prompt, spk, gamma=gamma, return_stats=True, **greedy)
    if tok.shape == ref.shape and (tok == ref).all() and st["accepted"] == st["proposed"]:
        return f"greedy self-draft: {st}, all accepted, {len(tok) - len(prompt)} tokens == first_stage.generate's"
    part = next((i for i in range(min(len(tok), len(ref))) if tok[i] != ref[i]), None)
    if part is None:
        fail(f"18 {label}: greedy self-draft {st} not all accepted, yet its tokens are generate's")
    head = [int(t) for t in ref[:part]]
    kv = fs.tfm.KVCache.create(cfg, 2, cfg.block_size, device="cuda")
    x = fs.fill_cache(params, cfg, torch.tensor([head], device="cuda"), torch.as_tensor(spk).reshape(1, -1).cuda(),
                      kv)
    logits = fs.S.cfg_merge(fs.tfm.output_logits(params, cfg, x[:, -1:])[0][:, 0, :], 3.0)[0]
    gap = abs(float(logits[int(tok[part])] - logits[int(ref[part])])) / float(logits.abs().max())
    if gap > SPEC_FLIP_TOL[label]:
        fail(f"18 {label}: greedy self-draft parts from generate at token {part - len(prompt)} by {gap:.3g} of max "
             f"|logit|, past SPEC_FLIP_TOL {SPEC_FLIP_TOL[label]}")
    return (f"greedy self-draft: {st}, the same {part - len(prompt)} tokens as first_stage.generate, then a rounding "
            f"flip ({gap:.3g} of max |logit| between the two choices, tol {SPEC_FLIP_TOL[label]})")


def spec_round_profile(torch, sd, tts, gamma: int, use_cfg: bool, draws) -> str:
    """Phase 18: SPEC_PROFILED rounds replayed from the round's graphs on the
    TTS's caches from pos 128 (window 384), under graph_step_profile: the
    device's busy ms a round, its share of the wall, the kernels a round."""
    from metavoice_tpu_torch.core import tokens as T

    p, cfg, dp, dcfg = tts.c.first_stage_params, tts.c.first_stage_cfg, tts._draft_params, tts._draft_cfg
    kv_t, kv_d = tts._persistent_kv_cache(3.0), tts._draft_kv_cache(3.0)
    spec = sd.RoundSpec(gamma, 2, 2 if use_cfg else 1, min(cfg.block_size, dcfg.block_size), T.END_OF_AUDIO_TOKEN,
                        tts.c.tokenizer.eot_token, torch.bfloat16)
    with torch.inference_mode():
        st = sd.init_spec_state(torch.zeros((1,), dtype=torch.int64, device="cuda"), 128,
                                torch.ones((1, cfg.speaker_emb_dim), device="cuda"), cfg.block_size, spec,
                                temperature=1.0, top_p=0.95, draft_temperature=1.0, draft_top_p=0.95, guidance=3.0,
                                prompt_guidance=1.0, draws=draws)
    graphs = sd.round_graphs(p, cfg, dp, dcfg, kv_t, kv_d, spec, st, None)

    def run():
        with torch.inference_mode():  # the TTS's caches are inference tensors
            graphs.load(st, None)
            for _ in range(SPEC_PROFILED):
                graphs.round(p, cfg, dp, dcfg, kv_t, kv_d, 384)
        torch.cuda.synchronize()

    return graph_step_profile(torch, run, SPEC_PROFILED).replace("a step", "a round")


def phase_synth_spec(torch, workdir: str, ref: str, comps: dict, ordinary: dict) -> dict:
    """18: full-width synthesise with a draft through the device loop, bf16
    and int4 -> {mode: result}; in each mode the device loop against the
    host loop over the same forced rounds, both loops timed, the graph
    round profiled, and a greedy self-draft."""
    import numpy as np

    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.core.text import chunk_text, normalize_text
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import spec_decode as sd
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.runtime.tts import MAX_CHARS_PER_CHUNK, TTS

    t_phase = time.perf_counter()
    dcfg = first_stage_config(n_layer=4, n_head=8, dim=1024)  # scripts/make_bench_draft.py's default shape
    dgen = torch.Generator(device="cuda").manual_seed(18)
    draft = tfm.init_params(dcfg, device="cuda", generator=dgen, dtype=torch.bfloat16)
    chunks = chunk_text(normalize_text(SYNTH_TEXT), MAX_CHARS_PER_CHUNK) or [""]
    prefills = len(chunks)
    results, shown = {}, []
    for mode, gamma, use_cfg in ((None, 4, True), ("int4", 8, False)):
        name = mode or "bf16"
        dparams = draft if mode is None else Q.quantize_params_int4_i32(draft)
        tts = TTS(comps[mode], device="cuda", output_dir=os.path.join(workdir, f"out_spec_{mode}"),
                  quantisation_mode=mode, draft_params=dparams, draft_cfg=dcfg,
                  speculative_gamma=gamma, draft_use_cfg=use_cfg, enforce_min_ref_duration=False)
        n_layer = tts.c.first_stage_cfg.n_layer
        path, total_s, counts = drive_main_path(tts, ref)
        st = tts.spec_stats
        rounds, run = st["rounds"], tts.stats.get("spec_rounds_run", 0)
        want = dict.fromkeys(counts, 0)
        want["k4_launches"] = n_layer * run
        if mode is None:
            want["k1_launches"] = dcfg.n_layer * gamma * run
        else:
            want["k3_launches"] = gamma * run
            want["k2_launches"] = 5 * n_layer * (prefills + run) + 5 * dcfg.n_layer * prefills
        if rounds == 0 or counts != want or tts.stats["spec_rounds"] != rounds:
            fail(f"{name} speculative synthesise launched {counts} in {rounds} rounds ({run} run), expected {want}")
        if (tts.stats.get("decode_route"), tts.stats.get("spec_loop")) != ("spec", "graph"):
            fail(f"18 {name}: synthesise ran the {tts.stats.get('spec_loop')!r} loop, not the graph round")
        if not _spec_ledger_ok(st, gamma):
            fail(f"{name} speculative ledger incoherent: {st}")
        check_stats(tts, counts)
        wav = check_wav(path)
        ms_tok = 1e3 * tts.timings["first_stage"] / (st["emitted"] + 1)
        results[name] = {"counts": counts, "ms_per_token": ms_tok, "stats": dict(st)}
        synth = (f"synthesise {total_s:.2f} s, {st['emitted'] + 1} tokens in {rounds} rounds ({run} run, "
                 f"{tts.stats['spec_reads']} host reads; {st['emitted'] / rounds:.2f} a round), acceptance "
                 f"{st['accepted'] / st['proposed']:.3f}, first stage {ms_tok:.2f} ms per emitted token (ordinary "
                 f"{name} {ordinary[name]:.2f} ms/token in this call); launches "
                 f"{({k: v for k, v in counts.items() if v})}; wav {len(wav)} samples finite")
        # the host loop and the device loop over the same forced rounds, on the TTS's weights and caches
        p, cfg = tts.c.first_stage_params, tts.c.first_stage_cfg
        models = (p, cfg, dparams, dcfg)
        prompt = tts.c.tokenizer.encode(chunks[0])
        spk = torch.randn(cfg.speaker_emb_dim, generator=torch.Generator().manual_seed(180)).numpy()
        eot = tts.c.tokenizer.eot_token
        draws = spec_draws(torch, sd, SPEC_FORCED_NEW, gamma, cfg.vocab_sizes[0], 181, "cuda")
        kw = dict(gamma=gamma, draft_use_cfg=use_cfg, end_of_text_token=eot, max_new_tokens=SPEC_FORCED_NEW,
                  kv_cache=tts._persistent_kv_cache(3.0), draft_kv_cache=tts._draft_kv_cache(3.0), draws=draws)
        forced = spec_loops_agree(torch, sd, f"{name} forced", models, prompt, spk, **kw)
        fst = forced["stats"]
        # ms a round and per emitted token of both loops, SPEC_TIMED_RUNS calls each in turns
        ms = {"host": [], "device": []}
        for i in range(2 * SPEC_TIMED_RUNS):
            loop = ("host", "device", "device", "host")[i % 4]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (sd.generate_spec_eager if loop == "host" else sd.generate_spec)(*models, prompt, spk, **kw)
            torch.cuda.synchronize()
            ms[loop].append(1e3 * (time.perf_counter() - t0))
        timed = "; ".join(
            f"{loop} loop {np.mean(v) / fst['rounds']:.3f} ms a round (min {min(v) / fst['rounds']:.3f}, max "
            f"{max(v) / fst['rounds']:.3f}), {np.mean(v) / fst['emitted']:.3f} ms per emitted token"
            for loop, v in ms.items())
        profile = spec_round_profile(torch, sd, tts, gamma, use_cfg, draws)
        # the self-draft keeps to the bf16 tied head the verify takes: int4's fused head left off generate too
        greedy = spec_greedy_self_draft(torch, fs, sd, name, {k: v for k, v in p.items() if k != "lm_head_q"}, cfg,
                                        prompt, spk, gamma, eot)
        results[name].update(forced_ms=ms, forced=fst)
        shown.append(f"{name} target + {'int4 CFG-free' if mode else 'dense bf16'} draft, gamma {gamma}: {synth}; "
                     f"forced rounds ({SPEC_FORCED_NEW} tokens, end-of-audio never drawn): device loop == host loop "
                     f"bit for bit, {fst['emitted'] + 1} tokens in {fst['rounds']} rounds, "
                     f"{forced['loop']['spec_reads']} host reads, launches {forced['counts']} both; "
                     f"a call's wall (the two prefills included) over {SPEC_TIMED_RUNS} calls each in turns: {timed}; "
                     f"graph round profile ({SPEC_PROFILED} rounds from pos 128): {profile}; {greedy}")
        del tts
        fs.release_graphs()
        torch.cuda.empty_cache()
    print(f"[18 synth-spec] draft 4L/8H/1024d on random weights (acceptance is not a speed claim): "
          f"{' || '.join(shown)}; {time.perf_counter() - t_phase:.1f} s")
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
    check_stats(tts, counts, (kernel,))
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
        check_stats(tts, counts, ("k5_launches", "k6_launches"))
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

    def decode_attention(q, k_new, v_new, kc, vc, layer, pos, starts=None, window=None):
        if k_new.shape[1] != q.shape[1]:  # GQA: K4's plain version at T = 1, as the wrapper routes it
            y, kc, vc = A.decode_attention_multi_reference(q[:, :, None], k_new[:, :, None], v_new[:, :, None],
                                                           kc, vc, layer, pos, starts)
            return y[:, :, 0], kc, vc
        return A.decode_attention_reference(q, k_new, v_new, kc, vc, layer, pos, starts, window)

    mods = {name: mod for mod, names in ((A, ("decode_attention_multi", "decode_attention_block_int4",
                                              "decode_attention_block_int8")),
                                         (DS, ("decode_stack_int4",)),
                                         (Q, ("decode_ffn_int4", "ffn_int8", "matmul_int4", "matmul_int4_i32",
                                              "matmul_int4_packed", "matmul_int8", "matmul_int8_i32")))
            for name in names}
    return {"decode_attention": decode_attention} | {name: getattr(mod, f"{name}_reference")
                                                     for name, mod in mods.items()}


@contextlib.contextmanager
def eager_loop():
    """first_stage.decode swapped for its plain version, decode_eager (the
    same loop, every step run eagerly from Python), so that what wraps a
    step's Python calls (the wrappers, the sampler) sees every step; the
    CUDA graphs of the K1, K3 and K7 routes replay none of them."""
    from metavoice_tpu_torch.models import first_stage as fs

    saved = fs.decode
    fs.decode = fs.decode_eager
    try:
        yield
    finally:
        fs.decode = saved


@contextlib.contextmanager
def plain_path():
    """Every kernel wrapper the block stack calls swapped for its plain
    version: the CPU path's math on the card, no kernel launched (in the
    eager loop: a graph captured before would replay its kernels)."""
    from metavoice_tpu_torch.models import transformer as tfm

    plain = plain_versions()
    saved = {name: getattr(tfm, name) for name in plain}
    for name, fn in plain.items():
        setattr(tfm, name, fn)
    try:
        with eager_loop():
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
        with eager_loop():  # every step's calls, none replayed from a graph
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
    its calls, in call order (call i draws every row's i-th token), in the
    eager loop (a step replayed from a CUDA graph calls no sampler)."""
    from metavoice_tpu_torch.models import first_stage as fs

    seen, sample = [], fs.sample_guided

    def record(logits, *args, **kw):
        seen.append(logits.float().clone())
        return sample(logits, *args, **kw)

    fs.sample_guided = record
    try:
        with eager_loop():
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
# the same weights on the int8 cache (K5/K6): its warmup captures every window bucket of its route
from metavoice_tpu_torch.models import first_stage as fs
graphs_before = sum(len(g.graphs) for g in fs._graph_sets.values())
kv8 = TTS(tts.c, device="cuda", kv_cache_dtype="int8", output_dir=sys.argv[2])
t = time.perf_counter()
kv8.warmup()
torch.cuda.synchronize()
kv8_s = time.perf_counter() - t
kv8_graphs = sum(len(g.graphs) for g in fs._graph_sets.values()) - graphs_before
print(json.dumps({"start_s": t1 - t0, "warmup_s": t2 - t1, "build_s": lib.build_seconds,
                  "kv8_warmup_s": kv8_s, "kv8_graphs": kv8_graphs, "kv8_route": kv8.decode_route,
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
    if r["kv8_route"] != "layers" or r["kv8_graphs"] < 2:
        fail(f"41 warmup: the int8-cache TTS's warmup captured {r['kv8_graphs']} graphs on route {r['kv8_route']}")
    print(f"[41 warmup] a fresh process: import and a full-width int4 TTS in {r['start_s']:.2f} s; "
          f"TTS.warmup {r['warmup_s']:.2f} s, of which the kernel library {r['build_s']:.2f} s "
          f"({'compiled' if r['compiled'] else 'loaded from its build in phase 2, which took ' + f'{build_s:.2f} s'}); "
          f"then two synthesises of {r['decode_steps']} decode steps in {r['synth_s'][0]:.2f} s and "
          f"{r['synth_s'][1]:.2f} s with no new build (the same library, no new file in the build directory); "
          f"the same weights on the int8 cache (K5/K6): TTS.warmup {r['kv8_warmup_s']:.2f} s, capturing "
          f"{r['kv8_graphs']} decode graphs (every window bucket of both guidance variants)")


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

    def recording(text, prompt, toks, spk, noise=None, *, generator=None, streaming_segment=False):
        wav = real(text, prompt, toks, spk, noise, generator=generator, streaming_segment=streaming_segment)
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


# ------------------------------------------------------------------ phases 46-49: checkpoints, the CLI, capacity

# the reference trainer's names of a stacked layer leaf: (name under transformer.h.{i}., stored transposed)
GPT_LAYER_NAMES = {
    "attn_norm_w": ("ln_1.weight", False), "attn_norm_b": ("ln_1.bias", False),
    "ffn_norm_w": ("ln_2.weight", False), "ffn_norm_b": ("ln_2.bias", False),
    "wqkv": ("attn.c_attn.weight", True), "wqkv_b": ("attn.c_attn.bias", False),
    "wo": ("attn.c_proj.weight", True), "wo_b": ("attn.c_proj.bias", False),
    "w1": ("mlp.swiglu.w1.weight", True), "w3": ("mlp.swiglu.w3.weight", True), "w2": ("mlp.c_proj.weight", True),
    "w_fc": ("mlp.c_fc.weight", True), "w_fc_b": ("mlp.c_fc.bias", False),
    "w_proj": ("mlp.c_proj.weight", True), "w_proj_b": ("mlp.c_proj.bias", False),
}
# a checkpoint's tokenizer: the byte vocabulary and its end-of-text id, in the reference's meta["tokenizer"] keys
CKPT_TOKENIZER = {"name": "metavoice-bpe", "special_tokens": {"<|endoftext|>": 256},
                  "mergeable_ranks": {bytes([i]): i for i in range(256)}}
CKPT_NEW = 64  # phase 47: first-stage tokens held against the in-process trees
DRAFT_CFG = dict(n_layer=2, n_head=8, dim=1024)  # phase 47's small int4 draft
PLAN_NEW = 128  # phase 49: first-stage tokens a request (two segments)
PLAN_PROMPT = ("A long request fills the largest prompt bucket of the engine, so that every slot holds as many "
               "prompt rows as serving allows, and the peak memory of the card is read against the capacity "
               "plan while each slot decodes.")  # 250 bytes, 251 tokens: the 256 bucket


def gpt_checkpoint(params: dict, cfg, tokenizer: dict | None = None, prefix: str = "") -> dict:
    """A reference-format first- or second-stage checkpoint of the port's
    tree: the trainer's names (torch's (out, in) linears; a tied head written
    as lm_heads.0 = wtes.0), the config as model_args, CPU tensors."""
    sd = {}
    for key, stacked in params["layers"].items():
        name, transposed = GPT_LAYER_NAMES[key]
        for i in range(stacked.shape[0]):
            sd[f"transformer.h.{i}.{name}"] = (stacked[i].T if transposed else stacked[i]).contiguous().cpu()
    for i, w in enumerate(params["wtes"]):
        sd[f"transformer.wtes.{i}.weight"] = w.cpu()
    sd["transformer.wpe.weight"] = params["wpe"].cpu()
    sd["transformer.ln_f.weight"] = params["ln_f_w"].cpu()
    if "ln_f_b" in params:
        sd["transformer.ln_f.bias"] = params["ln_f_b"].cpu()
    if "speaker_cond" in params:
        sd["speaker_cond_pos.weight"] = params["speaker_cond"].T.contiguous().cpu()
    for i, w in enumerate(params.get("lm_heads") or [params["wtes"][0].T]):
        sd[f"lm_heads.{i}.weight"] = w.T.contiguous().cpu()
    args = {"block_size": cfg.block_size, "n_layer": cfg.n_layer, "n_head": cfg.n_head, "n_embd": cfg.dim,
            "vocab_sizes": list(cfg.vocab_sizes), "causal": cfg.causal, "norm_type": cfg.norm_type,
            "nonlinearity_type": cfg.nonlinearity_type, "bias": cfg.bias, "rmsnorm_eps": cfg.norm_eps}
    if cfg.n_local_heads != cfg.n_head:
        args["n_local_heads"] = cfg.n_local_heads
    if cfg.target_vocab_sizes is not None:
        args["target_vocab_sizes"] = list(cfg.target_vocab_sizes)
    return {"model": {prefix + k: v for k, v in sd.items()}, "model_args": args, "iter_num": 0,
            "best_val_loss": 0.0, "config": {}, "optimizer": None,
            "meta": {"speaker_cond": True, "speaker_emb_size": cfg.speaker_emb_dim, "tokenizer": tokenizer or {}}}


def speaker_checkpoint(torch, draw) -> tuple[dict, dict]:
    """A speaker_encoder.pt of torch.nn.LSTM(40, 256, 3) + Linear(256, 256)
    names (``draw(*shape)`` -> a CPU f32 tensor), and the tree the loader
    must make of it (weights transposed, biases summed in f32, layer 0's
    input rows zero-padded to 256)."""
    from metavoice_tpu_torch.models import speaker_encoder as se

    h, sd, tree = se.MODEL_HIDDEN_SIZE, {}, {"w_ih": [], "w_hh": [], "b": []}
    for k in range(se.MODEL_NUM_LAYERS):
        w_ih, w_hh = draw(4 * h, se.MEL_N_CHANNELS if k == 0 else h), draw(4 * h, h)
        b_ih, b_hh = draw(4 * h), draw(4 * h)
        sd |= {f"lstm.weight_ih_l{k}": w_ih, f"lstm.weight_hh_l{k}": w_hh, f"lstm.bias_ih_l{k}": b_ih,
               f"lstm.bias_hh_l{k}": b_hh}
        tree["w_ih"].append(torch.nn.functional.pad(w_ih.T, (0, 0, 0, h - w_ih.shape[1])))
        tree["w_hh"].append(w_hh.T)
        tree["b"].append(b_ih + b_hh)
    sd["linear.weight"], sd["linear.bias"] = draw(se.MODEL_EMBEDDING_SIZE, h), draw(se.MODEL_EMBEDDING_SIZE)
    tree = {k: torch.stack(v) for k, v in tree.items()}
    tree |= {"linear_w": sd["linear.weight"].T.contiguous(), "linear_b": sd["linear.bias"]}
    return {"model_state": sd}, tree


def fold_weight_norm_f64(torch, g, v):
    """w = g v / ||v|| over every dim but the first, in float64, rounded to
    f32: the value a converter must give, written out apart from the port's."""
    import numpy as np

    g64, v64 = g.double().numpy(), v.double().numpy()
    norm = np.sqrt((v64 ** 2).sum(axis=tuple(range(1, v64.ndim)), keepdims=True))
    return torch.from_numpy((g64 * v64 / np.maximum(norm, 1e-12)).astype(np.float32))


def encodec_checkpoint(torch, ecfg, draw) -> tuple[dict, dict]:
    """An encodec-package state dict of the 24 kHz model's topology at
    ``ecfg``, every conv weight-normed (``draw(*shape)`` -> a CPU f32
    tensor), and the port's tree the converter must make of it."""
    from metavoice_tpu_torch.models import encodec as ec

    shapes, sd = ec.init_params(ecfg, device="meta"), {}

    def conv(prefix, w, transposed=False):
        k, c_in, c_out = w.shape
        base = f"{prefix}.convtr.convtr" if transposed else f"{prefix}.conv.conv"
        shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
        g, v, b = draw(shape[0], 1, 1).abs() + 0.5, draw(*shape), draw(c_out)
        sd.update({f"{base}.weight_g": g, f"{base}.weight_v": v, f"{base}.bias": b})
        folded = fold_weight_norm_f64(torch, g, v)
        return (folded.flip(2).permute(2, 0, 1) if transposed else folded.permute(2, 1, 0)).contiguous(), b

    def res(prefix, r):
        w1, b1 = conv(f"{prefix}.block.1", r["conv1_w"])
        w2, b2 = conv(f"{prefix}.block.3", r["conv2_w"])
        return {"conv1_w": w1, "conv1_b": b1, "conv2_w": w2, "conv2_b": b2}

    def lstm(prefix, p):
        out = {"w_ih": [], "w_hh": [], "b": []}
        for i in range(p["w_ih"].shape[0]):
            w_ih, w_hh = draw(*p["w_ih"][i].shape[::-1]), draw(*p["w_hh"][i].shape[::-1])
            b_ih, b_hh = draw(p["b"].shape[1]), draw(p["b"].shape[1])
            sd.update({f"{prefix}.weight_ih_l{i}": w_ih, f"{prefix}.weight_hh_l{i}": w_hh,
                       f"{prefix}.bias_ih_l{i}": b_ih, f"{prefix}.bias_hh_l{i}": b_hh})
            out["w_ih"].append(w_ih.T)
            out["w_hh"].append(w_hh.T)
            out["b"].append(b_ih + b_hh)
        return {k: torch.stack(v) for k, v in out.items()}

    enc, dec, n = shapes["encoder"], shapes["decoder"], len(ecfg.ratios)
    e, d = {}, {}
    e["conv_in_w"], e["conv_in_b"] = conv("encoder.model.0", enc["conv_in_w"])
    e["blocks"] = []
    for i, blk in enumerate(enc["blocks"]):
        r = res(f"encoder.model.{1 + 3 * i}", blk["res"])
        w, b = conv(f"encoder.model.{3 + 3 * i}", blk["conv_w"])
        e["blocks"].append({"res": r, "conv_w": w, "conv_b": b})
    e["lstm"] = lstm(f"encoder.model.{1 + 3 * n}.lstm", enc["lstm"])
    e["conv_out_w"], e["conv_out_b"] = conv(f"encoder.model.{3 + 3 * n}", enc["conv_out_w"])
    d["conv_in_w"], d["conv_in_b"] = conv("decoder.model.0", dec["conv_in_w"])
    d["lstm"] = lstm("decoder.model.1.lstm", dec["lstm"])
    d["blocks"] = []
    for i, blk in enumerate(dec["blocks"]):
        w, b = conv(f"decoder.model.{3 + 3 * i}", blk["convtr_w"], transposed=True)
        d["blocks"].append({"convtr_w": w, "convtr_b": b, "res": res(f"decoder.model.{4 + 3 * i}", blk["res"])})
    d["conv_out_w"], d["conv_out_b"] = conv(f"decoder.model.{3 + 3 * n}", dec["conv_out_w"])
    books = [draw(ecfg.codebook_size, ecfg.dimension) for _ in range(ecfg.n_q)]
    sd.update({f"quantizer.vq.layers.{i}._codebook.embed": cb for i, cb in enumerate(books)})
    return sd, {"encoder": e, "decoder": d, "codebooks": torch.stack(books)}


def leaves(tree, prefix: str = "") -> dict:
    """Flat ``path -> leaf`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix.rstrip("/"): tree}
    return {k: v for key, sub in items for k, v in leaves(sub, f"{prefix}{key}/").items()}


def trees_bit_equal(torch, got, want, what: str) -> int:
    """Fail unless ``got`` has ``want``'s leaves, each of its dtype and shape
    with the same bits (compared on ``got``'s device); -> the leaf count."""
    g, w = leaves(got), leaves(want)
    if g.keys() != w.keys():
        fail(f"{what}: leaves {sorted(g.keys() ^ w.keys())} are not in both trees")
    for k, a in g.items():
        b = w[k]
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.contiguous().view(-1).view(torch.uint8), b.to(a.device).contiguous().view(-1).view(torch.uint8)):
            fail(f"{what}: leaf {k} ({a.dtype} {tuple(a.shape)}) is not the array written "
                 f"({b.dtype} {tuple(b.shape)})")
    return len(g)


def seeded_model(torch, seed: int = 46, dev: str = "cuda", small: bool = False) -> dict:
    """Seeded random f32 weights of the full-width model on the card (the
    first stage 24L/16H/2048d, vocab 2562; the default second stage; norms
    and biases moved off their init so that a misplaced leaf cannot pass) and,
    on the CPU, the speaker encoder's and EnCodec's state dicts with the trees
    they must load as."""
    from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config
    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.models import transformer as tfm

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cfg1, cfg2, ecfg = first_stage_config(), second_stage_config(), ec.EncodecConfig()
    if small:  # TTS.from_random(small=True)'s shapes, for a CPU rehearsal
        cfg1 = first_stage_config(n_layer=2, n_head=4, dim=128, block_size=512)
        cfg2 = second_stage_config(n_layer=2, n_head=2, dim=64, block_size=256)
        ecfg = ec.EncodecConfig(n_filters=8, dimension=32)
    p1, p2 = (tfm.init_params(c, device=dev, generator=gen) for c in (cfg1, cfg2))
    for tree in (p1, p2):
        for k, v in leaves(tree).items():
            if k.endswith(("_b", "norm_w", "ln_f_w")):
                v.add_(0.1 * torch.randn(v.shape, generator=gen, device=dev))
    cpu_gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=cpu_gen) * 0.1

    spk_sd, spk = speaker_checkpoint(torch, draw)
    enc_sd, enc = encodec_checkpoint(torch, ecfg, draw)
    return {"cfg1": cfg1, "cfg2": cfg2, "ecfg": ecfg, "p1": p1, "p2": p2, "spk_sd": spk_sd, "spk": spk,
            "encodec_sd": enc_sd, "encodec": enc}


def phase_checkpoint_files(torch, workdir: str, dev: str = "cuda", small: bool = False) -> dict:
    """46: the full-width reference-format files from seeded random weights,
    read back onto the card by the port's loaders, every leaf bit-equal to
    the array written."""
    from metavoice_tpu_torch.utils import checkpoint as ck
    from metavoice_tpu_torch.utils.convert_external import load_encodec_pt

    m = seeded_model(torch, dev=dev, small=small)
    paths = {k: os.path.join(workdir, f"{k}.pt") for k in ("first_stage", "second_stage", "speaker_encoder",
                                                             "encodec")}
    writes, loads, counts = {}, {}, {}
    for key, make in (("first_stage", lambda: gpt_checkpoint(m["p1"], m["cfg1"], CKPT_TOKENIZER, "_orig_mod.")),
                      ("second_stage", lambda: gpt_checkpoint(m["p2"], m["cfg2"])),
                      ("speaker_encoder", lambda: m["spk_sd"]), ("encodec", lambda: m["encodec_sd"])):
        obj = make()
        t0 = time.perf_counter()
        torch.save(obj, paths[key])
        writes[key] = time.perf_counter() - t0
        del obj
    dev = torch.device(dev)
    for key, load, want in (
        ("first_stage", lambda p: ck.load_first_stage_pt(p, device=dev), m["p1"]),
        ("second_stage", lambda p: ck.load_second_stage_pt(p, device=dev), m["p2"]),
        ("speaker_encoder", lambda p: (ck.load_speaker_encoder_pt(p, device=dev),), m["spk"]),
        ("encodec", lambda p: (load_encodec_pt(p, m["ecfg"], device=dev),), m["encodec"]),
    ):
        sync(torch, dev)
        t0 = time.perf_counter()
        got = load(paths[key])
        sync(torch, dev)
        loads[key] = time.perf_counter() - t0
        if any(t.device.type != dev.type for t in leaves(got[0]).values()):
            fail(f"46 checkpoint files: the {key} loader left leaves off the card")
        counts[key] = trees_bit_equal(torch, got[0], want, f"46 checkpoint files: {key}")
        if len(got) > 1 and got[1] != m["cfg1" if key == "first_stage" else "cfg2"]:
            fail(f"46 checkpoint files: {key}'s config {got[1]} is not the one written")
        if key == "first_stage" and got[2] != CKPT_TOKENIZER:
            fail("46 checkpoint files: the first stage's tokenizer info is not the one written")
        del got
        empty_cache(torch, dev)
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    shown = "; ".join(f"{k} {sizes[k] / 1e9:.4f} GB ({counts[k]} leaves) written in {writes[k]:.2f} s, "
                      f"loaded onto the card in {loads[k]:.2f} s" for k in paths)
    print(f"[46 checkpoint files] reference-format .pt files of seeded random f32 weights at full width "
          f"(first stage 24L/16H/2048d, vocab 2562, with the _orig_mod. prefix; the default second stage; the "
          f"speaker encoder; EnCodec 24 kHz in the encodec package's names, weight-normed), every leaf loaded "
          f"by the port's loaders bit-equal to the array written, the configs and tokenizer info as written "
          f"(reads from a warm page cache): {shown}")
    return {"paths": paths, "model": m, "ecfg": m["ecfg"], "sizes": sizes, "loads": loads}


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def empty_cache(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def start_cli(args: list):
    """``python -m metavoice_tpu_torch.cli ARGS`` started in a process of its
    own -> (the process, its start time)."""
    return subprocess.Popen([sys.executable, "-m", "metavoice_tpu_torch.cli", *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=os.path.dirname(os.path.abspath(__file__))), \
        time.perf_counter()


def finish_cli(started, what: str, timeout: float = 600) -> tuple[str, float]:
    """Wait for a ``start_cli`` process -> (its standard output, seconds);
    fails on a non-zero exit (a process past ``timeout`` is killed)."""
    proc, t0 = started
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"{what}: cli {proc.args[3]} exited {proc.returncode}: {err[-3000:]}")
    return out, time.perf_counter() - t0


def run_cli(args: list, what: str, timeout: float = 600) -> tuple[str, float]:
    return finish_cli(start_cli(args), what, timeout)


def _first_stage_tokens(torch, tts, noise):
    """The first stage's tokens of SYNTH_TEXT on tts's trees and a zero
    speaker embedding, under ``noise`` (the Gumbel draws)."""
    import numpy as np
    from metavoice_tpu_torch.core.text import normalize_text
    from metavoice_tpu_torch.models import first_stage as fs

    cfg1 = tts.c.first_stage_cfg
    prompt = tts.c.tokenizer.encode(normalize_text(SYNTH_TEXT))
    spk = np.zeros((cfg1.speaker_emb_dim,), np.float32)
    with torch.inference_mode():
        return fs.generate(tts.c.first_stage_params, cfg1, prompt, spk, max_new_tokens=CKPT_NEW, noise=noise,
                           guidance_scale=3.0, end_of_text_token=tts.c.tokenizer.eot_token,
                           kv_cache=tts._persistent_kv_cache(3.0), compute_dtype=tts._compute_dtype)


def phase_from_checkpoints(torch, workdir: str, ref: str, files: dict, dev: str = "cuda") -> dict:
    """47: TTS.from_checkpoints on the card from phase 46's files: the bf16
    .pt (K1), the `cli quantize --mode int4` .npz (K2, K3) and on the int8
    cache (K5, K6), each one's first-stage tokens those of a TTS built in
    process from the same trees under the same draws; an int4 draft .npz
    (K4 == n_layer x rounds)."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.runtime.tts import TTS, TTSComponents
    from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
    from metavoice_tpu_torch.utils import checkpoint as ck

    paths, m = files["paths"], files["model"]
    npz = os.path.join(workdir, "first_stage_int4.npz")
    out, quantize_s = run_cli(["quantize", "--first_stage_path", paths["first_stage"], "--mode", "int4",
                               "--out", npz, "--device", dev], "47 from-checkpoints")
    dev = torch.device(dev)
    p1_bf16 = ck.params_from_numpy(m["p1"], device=dev, dtype=torch.bfloat16)
    inproc = {"bf16": p1_bf16, "int4": Q.quantize_params_int4_i32(p1_bf16)}
    comps = dict(first_stage_cfg=m["cfg1"], second_stage_params=ck.params_from_numpy(m["p2"], device=dev,
                                                                                   dtype=torch.bfloat16),
                 second_stage_cfg=m["cfg2"], spk_params=ck.params_from_numpy(m["spk"], device=dev),
                 encodec_params=ck.params_from_numpy(m["encodec"], device=dev), encodec_cfg=m["ecfg"],
                 tokenizer=TrainedBPETokeniser(**CKPT_TOKENIZER))
    gen = torch.Generator(device=dev).manual_seed(47)
    noise = -torch.log(-torch.log(torch.rand((CKPT_NEW, 1, m["cfg1"].vocab_size), generator=gen, device=dev)
                                  .clamp_min(1e-20)))
    results, shown = {}, []
    common = dict(encodec_path=paths["encodec"], encodec_cfg=m["ecfg"], device=dev)
    for label, path, per_step, kw in (
        ("bf16 .pt", paths["first_stage"], {"k1_launches": m["cfg1"].n_layer}, {}),
        ("int4 .npz", npz, {"k3_launches": 1}, {}),
        ("int4 .npz, int8 cache", npz, {"k5_launches": m["cfg1"].n_layer, "k6_launches": m["cfg1"].n_layer},
         {"kv_cache_dtype": "int8"}),
    ):
        sync(torch, dev)
        t0 = time.perf_counter()
        tts = TTS.from_checkpoints(path, paths["second_stage"], paths["speaker_encoder"],
                                   output_dir=os.path.join(workdir, "out_ckpt"), **common, **kw)
        sync(torch, dev)
        load_s = time.perf_counter() - t0
        mode = "bf16" if path.endswith(".pt") else "int4"
        ref_tts = TTS(TTSComponents(first_stage_params=inproc[mode], **comps), device=dev,
                      output_dir=os.path.join(workdir, "out_inproc"), **kw)
        trees_bit_equal(torch, tts.c.first_stage_params, inproc[mode], f"47 {label}: the first stage")
        got, want = _first_stage_tokens(torch, tts, noise), _first_stage_tokens(torch, ref_tts, noise)
        if not (got.shape == want.shape and (got == want).all()):
            fail(f"47 {label}: the first stage's tokens are not those of the in-process trees")
        del ref_tts
        r = phase_synth_quantized(torch, workdir, ref, mode, f"47 {label}", per_step,
                                  None if mode == "bf16" else "k2_launches", {}, tts=tts, init_s=load_s)
        results[label] = {"counts": r["counts"], "ms_per_token": r["ms_per_token"], "load_s": load_s}
        shown.append(f"{label}: loaded in {load_s:.2f} s, {got.shape[-1]} tokens equal, {r['ms_per_token']:.2f} "
                     f"ms/token")
        del tts, r
        empty_cache(torch, dev)
    # a small int4 draft .npz (cli quantize's writer) for speculative decoding
    dcfg = first_stage_config(**DRAFT_CFG)
    draft = tfm.init_params(dcfg, device=dev, generator=torch.Generator(device=dev).manual_seed(147),
                            dtype=torch.bfloat16)
    dpath = os.path.join(workdir, "draft_int4.npz")
    ck.save_first_stage_quantized(dpath, Q.quantize_params_int4_i32(draft), dcfg, None, "int4")
    tts = TTS.from_checkpoints(npz, paths["second_stage"], paths["speaker_encoder"], draft_checkpoint=dpath,
                               speculative_gamma=8, draft_use_cfg=False,
                               output_dir=os.path.join(workdir, "out_ckpt_spec"), **common)
    path_wav, total_s, counts = drive_main_path(tts, ref)
    rounds, n_layer = tts.spec_stats["rounds"], m["cfg1"].n_layer
    if rounds == 0 or counts["k4_launches"] != n_layer * rounds or counts["k3_launches"] != 8 * rounds:
        fail(f"47 draft .npz: launches {counts} in {rounds} rounds; K4 must be n_layer x rounds, K3 8 x rounds")
    check_wav(path_wav)
    results["draft"] = {"counts": counts}
    shown.append(f"int4 .npz + int4 draft .npz ({dcfg.n_layer}L/{dcfg.n_head}H/{dcfg.dim}d, gamma 8, CFG-free): "
                 f"synthesise {total_s:.2f} s, {rounds} rounds, launches {({k: v for k, v in counts.items() if v})}")
    del tts
    empty_cache(torch, dev)
    print(f"[47 from-checkpoints] cli quantize --mode int4 of the 46 .pt in a process of its own: {quantize_s:.2f} s "
          f"-> {os.path.getsize(npz) / 1e9:.4f} GB ({out.strip()}); TTS.from_checkpoints on the card, each first "
          f"stage bit-equal to the in-process tree and its {CKPT_NEW} first-stage tokens under injected Gumbel draws "
          f"identical to a TTS built in process: {'; '.join(shown)}")
    return {"npz": npz, "quantize_s": quantize_s, "npz_bytes": os.path.getsize(npz), "runs": results}


SERVE_TEXT = "A request to the server started from the command line."
SERVE_NEW = 128  # phase 48: the server's cap on a request's first-stage tokens


def phase_cli(torch, workdir: str, ref: str, files: dict, ckpt: dict, dev: str = "cuda"):
    """48: the CLI in processes of its own: synth from the int4 .npz (a
    wav), capacity on the card, serve --batching auto (/health, a /tts, a
    streamed /tts, SIGTERM: "server stopped", exit 0) with the slot count
    capacity.max_slots gives for the card; the tokenizer on the native BPE."""
    import signal
    import urllib.request
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
    from metavoice_tpu_torch.utils import capacity as cap

    paths = files["paths"]
    model = ["--first_stage_path", ckpt["npz"], "--second_stage_path", paths["second_stage"],
             "--speaker_encoder_path", paths["speaker_encoder"], "--device", dev]
    if dev == "cuda":  # the full-width vocoder (a CPU rehearsal's small one does not load as the default config)
        model += ["--encodec_path", paths["encodec"]]
    # on a CPU rehearsal: a memory size to plan for, and a slot count (slots="auto" needs a card)
    hbm = cap.device_memory_bytes() if dev == "cuda" else 80 * 1024**3
    # the three at once on the card: the server starting while synth and capacity run
    serving = start_cli(["serve", *model, "--batching", "auto" if dev == "cuda" else "2", "--no_warmup",
                         "--max_new_tokens", str(SERVE_NEW), "--host", "127.0.0.1", "--port", "0",
                         "--output_dir", os.path.join(workdir, "out_serve")])
    proc, t0 = serving
    lines = []
    try:
        synth = start_cli(["synth", *model, "--text", SYNTH_TEXT, "--spk_cond_path", ref, "--max_new_tokens", "192",
                           "--output_dir", os.path.join(workdir, "out_cli")])
        planned = start_cli(["capacity", "--quantisation_mode", "int4"] + (["--hbm_gib", "80"] if dev == "cpu" else []))
        out, synth_s = finish_cli(synth, "48 cli")
        wav = check_wav(out.strip().splitlines()[-1])
        plan, cap_s = finish_cli(planned, "48 cli")
        fits = cap.max_slots(first_stage_config(), quantisation_mode="int4", hbm_bytes=hbm)
        if f"max slots at this config: {fits}" not in plan:
            fail(f"48 cli: capacity printed another plan than capacity.max_slots' {fits} slots: {plan}")
        want_slots = min(fits, cap.MAX_AUTO_SLOTS) if dev == "cuda" else 2
        port = None
        while port is None:
            line = proc.stdout.readline()
            if not line:
                fail(f"48 cli serve ended before serving ({proc.wait()}): {proc.stderr.read()[-3000:]}")
            lines.append(line.strip())
            found = re.match(r"serving on 127\.0\.0\.1:(\d+)", line)
            port = int(found.group(1)) if found else None
        start_s = time.perf_counter() - t0
        slots = [int(s) for ln in lines for s in re.findall(r"auto-sized batching engine: (\d+) slots", ln)]
        if slots != [want_slots] and dev == "cuda":
            fail(f"48 cli serve sized {slots} slots; capacity.max_slots gives {want_slots} on this card: {lines}")
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if json.loads(r.read()) != {"status": "ok"}:
                fail("48 cli serve: /health is not ok")
        timed = {}
        for stream in (False, True):
            body = {"text": SERVE_TEXT, "speaker_ref_path": ref} | ({"stream": "true"} if stream else {})
            req = urllib.request.Request(url + "/tts", data=json.dumps(body).encode(), method="POST",
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as r:
                first = r.read(44)
                first_s = time.perf_counter() - t
                data = first + r.read()
            if data[:4] != b"RIFF" or data[8:12] != b"WAVE" or len(data) <= 44:
                fail(f"48 cli serve: the {'streamed ' if stream else ''}/tts is not a wav with audio")
            if stream and data[4:8] != b"\xff\xff\xff\xff":
                fail("48 cli serve: the stream has no live RIFF size")
            timed["stream" if stream else "tts"] = (first_s, time.perf_counter() - t, (len(data) - 44) // 2)
        proc.send_signal(signal.SIGTERM)
        rest, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0 or "server stopped" not in rest:
        fail(f"48 cli serve: SIGTERM gave exit {proc.returncode}, output {rest[-500:]!r}: {err[-2000:]}")
    engine = TrainedBPETokeniser(**CKPT_TOKENIZER).engine
    if engine.path != "native":
        fail(f"48 cli: the tokenizer took the Python merge, not the native BPE engine: {engine.native_error}")
    print(f"[48 cli] python -m metavoice_tpu_torch.cli in processes of their own, from the 47 int4 .npz: synth "
          f"{synth_s:.2f} s (a wav of {len(wav)} samples); capacity {cap_s:.2f} s: "
          f"{' | '.join(plan.strip().splitlines())}; serve --batching auto --no_warmup (started beside the two): serving "
          f"after {start_s:.2f} s "
          f"with {want_slots} slots (capacity.max_slots for the card, at most {cap.MAX_AUTO_SLOTS}), /health ok, /tts "
          f"{timed['tts'][1]:.2f} s (first bytes {timed['tts'][0]:.3f} s, {timed['tts'][2]} samples), streamed /tts "
          f"first bytes {timed['stream'][0]:.3f} s, end {timed['stream'][1]:.2f} s ({timed['stream'][2]} samples), "
          f"SIGTERM -> 'server stopped', exit 0; quantize (phase 47) {ckpt['quantize_s']:.2f} s -> "
          f"{ckpt['npz_bytes'] / 1e9:.4f} GB; the tokenizer on the native BPE engine")


def phase_capacity_plan(torch, workdir: str, ref: str, files: dict, ckpt: dict, dev: str = "cuda"):
    """49: ContinuousBatchingEngine(slots="auto") at full width from the int4
    .npz, on the bf16 and the int8 cache: every slot given a request in the
    largest prompt bucket, two segments each; the plan's bytes, the memory
    reserved before, with the engine built and at its peak, and the card's
    total; the peak within the plan's budget."""
    from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
    from metavoice_tpu_torch.runtime.tts import TTS
    from metavoice_tpu_torch.utils import capacity as cap

    paths = files["paths"]
    total = cap.device_memory_bytes()
    gib = 1024**3
    shown = []
    for kv in (None, "int8"):
        gc_collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_reserved()
        tts = TTS.from_checkpoints(ckpt["npz"], paths["second_stage"], paths["speaker_encoder"],
                                   encodec_path=paths["encodec"], encodec_cfg=files["ecfg"], kv_cache_dtype=kv,
                                   device=dev, output_dir=os.path.join(workdir, "out_plan"))
        eng = ContinuousBatchingEngine(tts, slots="auto", segment_tokens=ENGINE_SEGMENT, pad_multiple=128)
        built = torch.cuda.memory_reserved()
        try:
            plan = cap.memory_plan(tts.c.first_stage_cfg, hbm_bytes=total, quantisation_mode="int4",
                                   kv_cache_dtype=kv, slots=eng.n_slots)
            t0 = time.perf_counter()
            futs = [eng.submit(f"{i:02d} {PLAN_PROMPT}", ref, max_new_tokens=PLAN_NEW) for i in range(eng.n_slots)]
            n_wavs = len([check_wav(f.result(timeout=900)) for f in futs])
            wall = time.perf_counter() - t0
            st = dict(eng.stats)
        finally:
            eng.shutdown()
        peak = torch.cuda.max_memory_reserved()
        # the pool's own peak: what this process held before the TTS (earlier phases' tensors) is not its
        if peak - base > plan.budget_bytes:
            fail(f"49 capacity plan: the pool's peak reserved {peak - base} bytes (peak {peak}, {base} before the "
                 f"TTS) exceeds the plan's budget {plan.budget_bytes}")
        if st["groups"] < 1 or st["segments"] < 2:
            fail(f"49 capacity plan: {st}")
        shown.append(f"int4 weights, {kv or 'bf16'} cache: {eng.n_slots} slots; plan weights "
                     f"{plan.weights_bytes / gib:.3f} + cache {plan.cache_bytes / gib:.3f} = {plan.total_bytes / gib:.3f} "
                     f"GiB, budget {plan.budget_bytes / gib:.3f} GiB; reserved {base / gib:.3f} GiB before the TTS, "
                     f"{built / gib:.3f} GiB with the TTS and engine built, peak {peak / gib:.3f} GiB; the pool's own peak "
                     f"{(peak - base) / gib:.3f} GiB ({(peak - base) / total:.3f} of the card, "
                     f"{(peak - base) / max(plan.total_bytes, 1):.2f}x the plan); "
                     f"{n_wavs} requests of 251 prompt tokens and {PLAN_NEW} new in {wall:.2f} s ({st['segments']} "
                     f"segments, {st['groups']} groups, {st['joins']} joins)")
        del tts, eng, futs
    print(f"[49 capacity plan] slots='auto' against the card's {total / gib:.2f} GiB at utilization "
          f"{cap.DEFAULT_UTILIZATION}: {'; '.join(shown)}")


# phases 50-52: training (metavoice_tpu_torch/training)
FT_PARITY_CFG = dict(n_layer=2, n_head=8, dim=1024, block_size=256)  # phase 50: vocab 2562, head_dim 128
FT_PARITY_T = 128  # tokens a row, 2 rows a batch
FT_PARITY = dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=2, lr_decay_iters=20, weight_decay=0.1)
FT_ROWS = 2  # phase 51: batch 2 x block_size tokens, as the CLI's default batch
FT_SPLIT_STEPS, FT_FULL_STEPS = 6, 3
FT_SAMPLE_NEW = 64  # phase 51: first-stage tokens of the finetuned int4 synthesise
# phase 52: JAX's tests/test_trained_system_e2e.py recipe, with the first stage's head_dim 64 (the
# decode kernels take 64 or 128; JAX's 64-wide, 4-head model has 16): GQA, 2 heads on 1 kv head
E2E_FIRST = dict(n_layer=2, n_head=2, n_local_heads=1, dim=128, block_size=128)
E2E_SECOND = dict(n_layer=2, n_head=4, dim=64, block_size=64)
E2E_ECFG = dict(n_filters=4, dimension=16, codebook_size=1024, n_q=8)
E2E_TEXTS = ("alpha says one.", "bravo says two.")
E2E_MEMORIZED = 0.15  # the teacher-forced loss each stage must reach (JAX's test's bound)


def _ft_modes(torch, params, cfg, ftc, batches, dev, mode: str):
    """``len(batches)`` steps of the grad-mask path (last block + ln_f) or of
    the split tail on ``dev``, f32 compute, from a copy of ``params`` ->
    (the whole tree after, the losses)."""
    from metavoice_tpu_torch.training import finetune as ft

    p = ft.tree_map(lambda t: t.detach().to(dev, copy=True), params)
    if mode == "split":
        frozen, train = ft.split_trainable(p, 1)
        state, opt = ft.init_train_state(train, ftc)
        step = ft.make_finetune_step(cfg, ftc, opt, frozen, compute_dtype=torch.float32)
    else:
        state, opt = ft.init_train_state(p, ftc)
        step = ft.make_train_step(cfg, ftc, opt, grad_mask=ft.trainable_mask(p, cfg, 1), compute_dtype=torch.float32)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return (ft.merge_trainable(frozen, state.params) if mode == "split" else state.params), losses


def params_apart(torch, got, want, lr_sum: float, lr: float, what: str) -> str:
    """Hold two trees of trained params to one another as the CPU tests hold
    the port to JAX: Adam moves an element by about +-lr a step, so a grad
    near zero whose sign the two runs' f32 sums disagree on moves its element
    by up to 2 lr in all; every element within 2 x (the rates summed), and
    all but 1e-3 of the elements within 1e-3 lr. -> the largest gap shown."""
    g, w = leaves(got), leaves(want)
    worst, worst_share = 0.0, 0.0
    for k, a in g.items():
        d = (a.detach().float().cpu() - w[k].detach().float().cpu()).abs()
        share = float((d > 1e-3 * lr).float().mean())
        if float(d.max()) > 2 * lr_sum or share > 1e-3:
            fail(f"{what}: leaf {k} apart by {float(d.max()):.3g} (bound {2 * lr_sum:.3g}), {share:.2e} of it past "
                 f"1e-3 lr")
        worst, worst_share = max(worst, float(d.max())), max(worst_share, share)
    return f"max |dp| {worst:.3g}, at most {worst_share:.1e} of a leaf past 1e-3 lr"


def phase_finetune_parity(torch, dev: str = "cuda"):
    """50: a small first stage (2L/8H/1024d, vocab 2562) takes 3 train steps
    on the card and on the CPU route from the same weights and batches
    (dropout 0, f32 params and compute): the grad-mask path's params agree,
    its frozen leaves stay bit for bit, and the split path's tail is the
    mask path's."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.training import finetune as ft

    cfg = first_stage_config(**FT_PARITY_CFG)
    gen = torch.Generator().manual_seed(50)
    params = tfm.init_params(cfg, device="cpu", generator=gen)
    for k, v in leaves(params).items():  # norms off their init, so a misplaced norm grad shows
        if k.endswith(("norm_w", "ln_f_w")):
            v.add_(0.1 * torch.randn(v.shape, generator=gen))
    batches = [{"x": torch.randint(0, cfg.vocab_size, (2, FT_PARITY_T), generator=gen),
                "y": torch.randint(0, cfg.vocab_size, (2, FT_PARITY_T), generator=gen),
                "spk_emb": torch.randn(2, 256, generator=gen)} for _ in range(3)]
    ftc = ft.FinetuneConfig(**FT_PARITY)
    sched = ft.lr_schedule(ftc)
    lr_sum = sum(sched(i) for i in range(len(batches)))
    t0 = time.perf_counter()
    cpu, cpu_losses = _ft_modes(torch, params, cfg, ftc, batches, "cpu", "mask")
    card, card_losses = _ft_modes(torch, params, cfg, ftc, batches, dev, "mask")
    split, split_losses = _ft_modes(torch, params, cfg, ftc, batches, dev, "split")
    seconds = time.perf_counter() - t0
    for what, losses in (("the card's mask path", card_losses), ("the card's split path", split_losses)):
        if not all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(losses, cpu_losses)):
            fail(f"50 finetune-parity: {what} losses {losses} are not the CPU route's {cpu_losses}")
    shown = [params_apart(torch, card, cpu, lr_sum, ftc.learning_rate, "50 the card's mask path against the CPU's")]
    init, got = leaves(params), {k: v.cpu() for k, v in leaves(card).items()}
    frozen = [k for k in init if not k.startswith("ln_f")]
    for k in frozen:  # the head layers, embeddings and speaker projection, bit for bit
        head = slice(0, -1) if k.startswith("layers/") else slice(None)
        if not torch.equal(got[k][head].view(torch.int32), init[k][head].view(torch.int32)):
            fail(f"50 finetune-parity: the frozen leaf {k} moved on the card's mask path")
    if all(torch.equal(got[k][-1:], init[k][-1:]) for k in init if k.startswith(("layers/", "ln_f"))):
        fail("50 finetune-parity: the trainable tail did not move")
    shown.append(params_apart(torch, split, card, lr_sum, ftc.learning_rate,
                              "50 the card's split path against its mask path"))
    print(f"[50 finetune-parity] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d vocab {cfg.vocab_size}, {len(batches)} steps "
          f"of 2 x {FT_PARITY_T} tokens, f32, lr {ftc.learning_rate} (warmup {ftc.warmup_iters}): losses card "
          f"{['%.6f' % x for x in card_losses]}, CPU {['%.6f' % x for x in cpu_losses]}, split "
          f"{['%.6f' % x for x in split_losses]}; card vs CPU: {shown[0]}; {len(frozen)} frozen leaves bit for bit; "
          f"split tail vs mask tail: {shown[1]} ({seconds:.1f} s)")


def train_flops(cfg, rows: int, t: int, n_tail: int | None = None) -> float:
    """Operations of one train step on ``rows`` x ``t`` tokens, the recompute
    not counted. The whole tree (``n_tail`` None): 6 N tokens, N the layer
    weights and the tied head (V x D), plus the attention's products as the
    forward computes them, the whole T x T square (4 B T^2 D a layer forward),
    three times. The split tail: the forward of every layer and the head
    (2 N tokens + 4 B T^2 D L), the head's input gradient (2 V D tokens) and
    the tail layers' backward (4 N_layer tokens + 8 B T^2 D each)."""
    d, i = cfg.dim, cfg.intermediate_size
    per_layer = d * (cfg.n_head + 2 * cfg.n_local_heads) * cfg.head_dim + d * d + 3 * d * i
    head = cfg.vocab_size * d
    tokens = rows * t
    attn = 4 * rows * t * t * d
    if n_tail is None:
        return 6 * (cfg.n_layer * per_layer + head) * tokens + 3 * attn * cfg.n_layer
    fwd = 2 * (cfg.n_layer * per_layer + head) * tokens + attn * cfg.n_layer
    return fwd + 2 * head * tokens + n_tail * (4 * per_layer * tokens + 2 * attn)


def _step_times(torch, step, state, batches, dev):
    """Run ``step`` over ``batches`` -> (state, seconds a step, losses)."""
    times, losses = [], []
    for b in batches:
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))  # waits for the step
        times.append(time.perf_counter() - t0)
    return state, times, losses


def phase_finetune_full_width(torch, workdir: str, ref: str, dev: str = "cuda", small: bool = False) -> dict:
    """51: the full-width first stage (24L/16H/2048d, block 2048) with bf16
    params, dropout 0.1 and speaker-embedding dropout 0.1, on batches of 2 x
    2048 tokens: 6 steps of the split tail (last_n_blocks 1), 3 of the whole
    tree with accumulation 2; ms a step, tokens/s, peak memory and MFU; the
    frozen leaves bit for bit, the tail moved; then final.npz through
    trainer.save_checkpoint, loaded by TTS.from_checkpoints(int4), and a
    64-token synthesise through K2 and K3."""
    import dataclasses
    import statistics

    import numpy as np
    from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.runtime.tts import TTS
    from metavoice_tpu_torch.training import finetune as ft
    from metavoice_tpu_torch.training import second_stage as ss
    from metavoice_tpu_torch.training import trainer

    dev = torch.device(dev)
    cfg = first_stage_config(**(dict(n_layer=2, n_head=4, dim=128, block_size=256) if small else {}))
    cfg = dataclasses.replace(cfg, dropout=0.1, spkemb_dropout=0.1)
    gen = torch.Generator(device=dev).manual_seed(51)
    params = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    t = cfg.block_size

    def batch(lead=()):
        shape = (*lead, FT_ROWS, t)
        return {"x": torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev),
                "y": torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev),
                "spk_emb": torch.randn((*lead, FT_ROWS, 256), generator=gen, device=dev)}

    # the CLI's finetune config, with one warmup step so that every step after the first moves
    split_cfg = ft.FinetuneConfig(warmup_iters=1, last_n_blocks_to_finetune=1)
    full_cfg = dataclasses.replace(split_cfg, last_n_blocks_to_finetune=-1, gradient_accumulation_steps=2)
    cuda = dev.type == "cuda"
    runs, shown = {}, []

    def start_peak() -> int:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() if cuda else 0

    def peak(start: int) -> tuple[int, int]:
        """(max_memory_allocated, the run's own: over what it started with)."""
        top = torch.cuda.max_memory_allocated() if cuda else 0
        return top, top - start

    head_before = {k: v[:-1].clone() for k, v in params["layers"].items()}
    tail_before = {k: v[-1:].clone() for k, v in params["layers"].items()}
    start = start_peak()
    frozen, train = ft.split_trainable(params, 1)
    state, opt = ft.init_train_state(train, split_cfg)
    step = ft.make_finetune_step(cfg, split_cfg, opt, frozen)
    state, times, losses = _step_times(torch, step, state, [batch() for _ in range(FT_SPLIT_STEPS)], dev)
    runs["split"] = (times, losses, peak(start), train_flops(cfg, FT_ROWS, t, n_tail=1), FT_ROWS * t)
    for k, v in head_before.items():
        if not torch.equal(frozen["layers_head"][k].view(torch.int16), v.view(torch.int16)):
            fail(f"51 finetune-full-width: the frozen layers of {k} moved on the split path")
    moved = {k: float((state.params["layers_tail"][k] != v).float().mean()) for k, v in tail_before.items()}
    if not any(moved.values()):
        fail("51 finetune-full-width: the split path's tail did not move")
    del head_before, tail_before
    final = ft.TrainState(ft.merge_trainable(frozen, state.params), state.opt_state, state.step)
    del frozen, train, state, opt, step
    empty_cache(torch, dev)
    sync(torch, dev)
    t0 = time.perf_counter()
    ckdir = os.path.join(workdir, "finetune51")
    final_npz = trainer.save_checkpoint(ckdir, "final", final, cfg, split_cfg, float("inf"))
    save_s = time.perf_counter() - t0
    del final
    empty_cache(torch, dev)

    before = {k: v.clone() for k, v in leaves(params).items()}
    start = start_peak()
    state, opt = ft.init_train_state(params, full_cfg)
    step = ft.make_train_step(cfg, full_cfg, opt)
    state, times, losses = _step_times(torch, step, state, [batch((2,)) for _ in range(FT_FULL_STEPS)], dev)
    runs["full"] = (times, losses, peak(start), 2 * train_flops(cfg, FT_ROWS, t), 2 * FT_ROWS * t)
    if not any(not torch.equal(v, before[k]) for k, v in leaves(params).items()):
        fail("51 finetune-full-width: the whole-tree path moved no leaf")
    del before, state, opt, step, params
    empty_cache(torch, dev)

    for name, (times, losses, (top, own), flops, tokens) in runs.items():
        if not all(np.isfinite(losses)):
            fail(f"51 finetune-full-width: {name} losses {losses}")
        ms = 1e3 * statistics.median(times[1:])
        mfu = flops / (ms / 1e3) / BF16_FLOP_S
        shown.append(f"{name}: {ms:.2f} ms a step (median of {len(times) - 1} after the first {1e3 * times[0]:.0f} "
                     f"ms), {tokens / ms * 1e3:.0f} tokens/s, max_memory_allocated {top / 2**30:.2f} GiB (the run's "
                     f"own {own / 2**30:.2f} over what it started with), {flops / 1e12:.2f} TFLOP a step, MFU "
                     f"{100 * mfu:.2f}% of {BF16_FLOP_S / 1e12:.0f} TFLOP/s; losses {['%.4f' % x for x in losses]}")
    # serve the finetuned checkpoint in int4
    cfg2 = second_stage_config(**(dict(n_layer=2, n_head=2, dim=64, block_size=256) if small else {}))
    second = ss.save_second_stage(os.path.join(ckdir, "second_stage.npz"),
                                  tfm.init_params(cfg2, device=dev, generator=gen, dtype=torch.bfloat16), cfg2)
    cpu_gen = torch.Generator().manual_seed(51)
    spk_sd, _ = speaker_checkpoint(torch, lambda *shape: torch.randn(shape, generator=cpu_gen) * 0.1)
    spk_pt = os.path.join(ckdir, "speaker_encoder.pt")
    torch.save(spk_sd, spk_pt)
    sync(torch, dev)
    t0 = time.perf_counter()
    tts = TTS.from_checkpoints(final_npz, second, spk_pt, device=dev, quantisation_mode="int4",
                               output_dir=os.path.join(workdir, "out51"))  # warns: a random vocoder
    sync(torch, dev)
    load_s = time.perf_counter() - t0
    if dev.type == "cuda":
        counts = phase_synth_quantized(torch, workdir, ref, "int4", "51 finetune-full-width", {"k3_launches": 1},
                                       "k2_launches", {}, tts=tts, init_s=load_s,
                                       max_new_tokens=FT_SAMPLE_NEW)["counts"]
    else:  # a CPU rehearsal: the plain versions count nothing
        check_wav(tts.synthesise(SYNTH_TEXT, ref, max_new_tokens=FT_SAMPLE_NEW))
        counts = {}
    print(f"[51 finetune-full-width] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d bf16 params, dropout {cfg.dropout}, "
          f"spkemb_dropout {cfg.spkemb_dropout}, batches of {FT_ROWS} x {t} tokens: {'; '.join(shown)}; the split "
          f"path's frozen layers bit for bit, its tail's share of elements moved "
          f"{min(moved.values()):.3f}-{max(moved.values()):.3f} by leaf; final.npz "
          f"{os.path.getsize(final_npz) / 1e9:.2f} GB written in {save_s:.2f} s; TTS.from_checkpoints(int4) "
          f"{load_s:.2f} s; launches {({k: v for k, v in counts.items() if v})}")
    del tts
    empty_cache(torch, dev)
    return {"runs": runs, "counts": counts}


def _spec_dist(x, y) -> float:
    """RMS-normalized log-magnitude STFT distance (JAX's
    tests/test_trained_system_e2e.py)."""
    import numpy as np
    from metavoice_tpu_torch.ops.audio import stft_np

    n = max(len(x), len(y))
    x, y = np.pad(x, (0, n - len(x))), np.pad(y, (0, n - len(y)))
    x = x / (np.sqrt(np.mean(x**2)) + 1e-8)
    y = y / (np.sqrt(np.mean(y**2)) + 1e-8)
    sx, sy = np.log1p(np.abs(stft_np(x, 512, 128))), np.log1p(np.abs(stft_np(y, 512, 128)))
    return float(np.sqrt(np.mean((sx - sy) ** 2)))


def phase_finetune_e2e(torch, workdir: str, dev: str = "cuda"):
    """52: ``cli finetune --small`` as a process on a CSV of generated wavs;
    then JAX's trained-system recipe on the card: a first stage (trainer.train,
    every leaf) and a second stage (train_second_stage) overfit to two
    utterances, both loaded by TTS.from_checkpoints, each synthesis
    spectrally closer to its own utterance's codec reconstruction than to
    the other's."""
    import numpy as np
    from metavoice_tpu_torch.core.config import first_stage_config, second_stage_config
    from metavoice_tpu_torch.core.text import normalize_text
    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.runtime.tts import TTS
    from metavoice_tpu_torch.tokenizer import TrainedBPETokeniser
    from metavoice_tpu_torch.training import finetune as ft
    from metavoice_tpu_torch.training import second_stage as ss
    from metavoice_tpu_torch.training import trainer
    from metavoice_tpu_torch.training.data import DynamicComputeDataset, training_batches
    from metavoice_tpu_torch.utils import audio_io as aio
    from metavoice_tpu_torch.utils import checkpoint as ck

    root = os.path.join(workdir, "finetune52")
    os.makedirs(root, exist_ok=True)
    sr, n = 24000, 12000  # 0.5 s: 37 EnCodec frames
    t = np.arange(n) / sr
    clips = [(0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
             (0.25 * np.random.default_rng(7).standard_normal(n)).astype(np.float32)]
    rows, refs = ["audio_files|captions"], []
    for i, (clip, text) in enumerate(zip(clips, E2E_TEXTS)):
        refs.append(os.path.join(root, f"utt{i}.wav"))
        aio.write_wav(refs[-1], clip, sr)
        rows.append(f"utt{i}.wav|{text}")
    csv = os.path.join(root, "ds.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows))

    out, cli_s = run_cli(["finetune", "--train", csv, "--val", csv, "--small", "--max_iters", "4", "--out_dir",
                          os.path.join(root, "cli"), "--device", str(dev)], "52 finetune-e2e")
    cli_losses = re.findall(r"iter \d+: loss ([0-9.]+)", out)
    _, cli_cfg, _, _ = ck.load_first_stage_npz(os.path.join(root, "cli", "final.npz"))
    if not cli_losses or not all(np.isfinite(float(x)) for x in cli_losses) or cli_cfg.dim != 128:
        fail(f"52 finetune-e2e: cli finetune printed {out[-2000:]!r}")

    dev = torch.device(dev)
    t0 = time.perf_counter()
    first, second = first_stage_config(**E2E_FIRST), second_stage_config(**E2E_SECOND)
    ecfg = ec.EncodecConfig(**E2E_ECFG)
    eparams = ec.init_params(ecfg, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    cpu_gen = torch.Generator().manual_seed(52)
    spk_sd, _ = speaker_checkpoint(torch, lambda *shape: torch.randn(shape, generator=cpu_gen) * 0.1)
    spk_pt = os.path.join(root, "speaker_encoder.pt")
    torch.save(spk_sd, spk_pt)
    spk_params = ck.load_speaker_encoder_pt(spk_pt, device=dev)
    tokenizer = TrainedBPETokeniser()
    dataset = DynamicComputeDataset.from_csv(csv, eparams, ecfg, tokenizer, spk_params,
                                             num_max_audio_tokens_timesteps=first.block_size // 2)
    items = [dataset[i] for i in range(len(dataset))]  # each epoch's items are the same: encode them once
    codes = [ec.encode_codes(eparams, ecfg, c[None]).cpu().numpy()[0] for c in clips]
    if np.array_equal(codes[0], codes[1]):
        fail("52 finetune-e2e: the two clips tokenize alike")

    cfg1 = ft.FinetuneConfig(learning_rate=2e-3, min_lr=2e-4, warmup_iters=20, lr_decay_iters=600, batch_size=2,
                             max_iters=600, eval_interval=10_000, eval_iters=1, last_n_blocks_to_finetune=-1,
                             weight_decay=0.0)
    p1 = tfm.init_params(first, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's log lines
        state = trainer.train(p1, first, cfg1, training_batches(items, 2, seed=0), None,
                              out_dir=os.path.join(root, "ft1"), log_every=100, tokenizer_info={})
    first_s = time.perf_counter() - t1
    eval_loss = float(ft.make_eval_step(first)(state.params, next(training_batches(items, 2, shuffle=False,
                                                                                    epochs=1))))
    if not eval_loss < E2E_MEMORIZED:
        fail(f"52 finetune-e2e: the first stage did not memorize: loss {eval_loss}")

    xs, ys, ms = zip(*(ss.build_example(tokenizer.encode(normalize_text(text)), codes[i], second)
                       for i, text in enumerate(E2E_TEXTS)))
    batch2 = {"x": np.stack(xs), "y": np.stack(ys), "mask": np.stack(ms),
              "spk_emb": np.stack([it["spkemb"][0] for it in items]).astype(np.float32)}
    p2 = tfm.init_params(second, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    t1 = time.perf_counter()
    p2, loss2 = ss.train_second_stage(p2, second, batch2, ss.SecondStageTrainConfig(max_iters=500,
                                                                                     learning_rate=2e-3))
    second_s = time.perf_counter() - t1
    if not loss2 < E2E_MEMORIZED:
        fail(f"52 finetune-e2e: the second stage did not memorize: loss {loss2}")
    second_npz = ss.save_second_stage(os.path.join(root, "second_stage.npz"), p2, second, tokenizer_info={})
    enc_npz = os.path.join(root, "encodec.npz")
    ck.save_npz(enc_npz, eparams)
    tts = TTS.from_checkpoints(os.path.join(root, "ft1", "final.npz"), second_npz, spk_pt, encodec_path=enc_npz,
                               encodec_cfg=ecfg, output_dir=os.path.join(root, "out"), enforce_min_ref_duration=False,
                               device=dev)
    targets = [ec.decode_codes(eparams, ecfg, torch.from_numpy(c)).cpu().numpy()[0] for c in codes]
    dists = np.zeros((2, 2))
    for i, text in enumerate(E2E_TEXTS):
        # guidance 1 = the conditional branch alone (the tiny model never trained the uncond one); a low
        # temperature sharpens the memorized distribution
        wav, wav_sr = aio.read_wav(tts.synthesise(text, refs[i], guidance_scale=1.0, temperature=0.3))
        if wav_sr != ecfg.sample_rate or not np.isfinite(wav).all():
            fail(f"52 finetune-e2e: synthesis {i}: sr {wav_sr}, finite {np.isfinite(wav).all()}")
        dists[i] = [_spec_dist(wav, targets[j]) for j in range(2)]
    if not (dists[0, 0] < dists[0, 1] and dists[1, 1] < dists[1, 0]):
        fail(f"52 finetune-e2e: a synthesis is not closest to its own utterance: distances {dists.tolist()}")
    del tts
    empty_cache(torch, dev)
    print(f"[52 finetune-e2e] cli finetune --small in a process of its own: {cli_s:.2f} s, losses {cli_losses}; "
          f"the trained-system recipe on the card ({first.n_layer}L/{first.n_head}H/{first.n_local_heads}kv/"
          f"{first.dim}d first stage, 600 steps in {first_s:.2f} s, teacher-forced loss {eval_loss:.4f}; second "
          f"stage 500 steps in {second_s:.2f} s, loss {loss2:.4f}): spectral distances to [own, other] "
          f"{[round(float(d), 4) for d in dists[0]]} and {[round(float(d), 4) for d in dists[1][::-1]]} "
          f"({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------- 53-55: MBD and DF

# The card's cuDNN convolutions and the CPU's sum in other orders; f32
# throughout (TF32 off), so an output moves by a few f32 ulps of its largest
# value a product, and the small MBD's 3 steps and 2 bands add them up.
MBD_TOL = 1e-4
DF_TOL = 1e-4
SMALL_MBD_UNET = dict(hidden=8, depth=3, num_steps=16, codec_dim=32)
SMALL_MBD = dict(n_processes=2, step_list=(15, 7, 0), processor_bands=4, eq_bands=8)
MBD_NEW = 192  # phase 54: first-stage tokens of the synthesise (a 2 s vocoder bucket at most)
MBD_TRAIN = dict(rows=4, samples=24_000, steps=3)  # phase 55: one band's batch, 1 s clips


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def card_vs_cpu(torch, label: str, fn, args: tuple, tol: float, errs: dict, dev: str = "cuda"):
    """``fn`` on the card's copy of ``args`` against ``fn`` on the CPU's:
    max |err| within ``tol`` of max |ref|, noted in ``errs``."""
    want = fn(*args)
    got = fn(*to_device(list(args), torch.device(dev)))
    sync(torch, dev)
    got = got.cpu()
    if got.shape != want.shape or not torch.isfinite(got.abs()).all():
        fail(f"53 small-mbd: {label} on the card gave {tuple(got.shape)} (finite {torch.isfinite(got.abs()).all()})")
    err, scale = (got - want).abs().max().item(), want.abs().max().item()
    if err > tol * scale:
        fail(f"53 small-mbd: {label} on the card is {err:.3g} from the CPU's (bound {tol} x {scale:.3g})")
    errs[label] = (err, tol * scale)


def phase_small_mbd(torch, dev: str = "cuda"):
    """53: the small MBD and the DF network, the card against the CPU
    (``dev="cpu"``: a rehearsal, the CPU against itself)."""
    import numpy as np

    from metavoice_tpu_torch.models import encodec as ec
    from metavoice_tpu_torch.models import enhancer as enh
    from metavoice_tpu_torch.models import mbd
    from metavoice_tpu_torch.ops.audio import stft_np

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(53)
    errs = {}
    for bottleneck in ("zeroed", "passthrough"):
        cfg = mbd.MBDConfig(unet=mbd.UNetConfig(bottleneck=bottleneck, **SMALL_MBD_UNET), **SMALL_MBD)
        params = mbd.init_params(cfg, device="cpu", generator=gen)
        unet = params["processes"][0]["unet"]
        x, cond = torch.randn(3, 2000, 1, generator=gen), torch.randn(3, 25, 32, generator=gen)
        card_vs_cpu(torch, f"unet_forward[{bottleneck}]",
                    lambda u, x, c, t: mbd.unet_forward(u, cfg.unet, x, t, c),
                    (unet, x, cond, torch.tensor([0, 7, 15])), MBD_TOL, errs, dev)
    wav, ref = torch.randn(2, 12_000, generator=gen) * 3, torch.randn(2, 12_000, generator=gen)
    card_vs_cpu(torch, "re_eq", lambda w, r: mbd.re_eq(w, r, 24_000, 32), (wav, ref), MBD_TOL, errs, dev)
    for p in params["processes"]:  # a processor off the identity
        p["processor"] = {"counts": torch.tensor([9.0]), "sum_x": 0.1 * torch.randn(4, generator=gen),
                          "sum_x2": 9 + torch.rand(4, generator=gen), "sum_target_x2": 2 + torch.rand(4, generator=gen)}
    n_iter, size = len(cfg.step_list) - 1, 6_400
    init = torch.randn(cfg.n_processes, 2, size, 1, generator=gen)
    steps = torch.randn(cfg.n_processes, n_iter, 2, size, 1, generator=gen)
    card_vs_cpu(torch, "generate", lambda p, e, i, s: mbd.generate(p, cfg, e, size, initial_noise=i, step_noise=s),
                (params, torch.randn(2, 20, 32, generator=gen), init, steps), MBD_TOL, errs, dev)
    ecfg = ec.EncodecConfig(n_filters=8, dimension=32, codebook_size=64)
    eparams = ec.init_params(ecfg, device="cpu", generator=gen)
    codes = torch.randint(0, 64, (8, 20), generator=gen)
    init, steps = init[:, :1], steps[:, :, :1]
    card_vs_cpu(torch, "tokens_to_wav",
                lambda p, e, c, i, s: mbd.tokens_to_wav(p, cfg, e, c, ecfg, initial_noise=i, step_noise=s),
                (params, eparams, codes, init, steps), MBD_TOL, errs, dev)
    dcfg = enh.DFConfig()
    dparams = enh.init_df_params(dcfg, device="cpu", generator=gen)
    dparams["df_out"] = dparams["df_out"] * 5  # taps away from the unit impulse
    spec = torch.from_numpy(stft_np(np.asarray(wav[0]), dcfg.n_fft, dcfg.hop)[None].astype(np.complex64))
    card_vs_cpu(torch, "df_enhance_spec", lambda p, x: enh.df_enhance_spec(p, dcfg, x), (dparams, spec), DF_TOL, errs, dev)
    shown = "; ".join(f"{k} {e:.3g} (bound {b:.3g})" for k, (e, b) in errs.items())
    print(f"[53 small-mbd] {cfg.n_processes} UNets {cfg.unet.channels()} channels, {n_iter} steps, card vs CPU "
          f"max |err|: {shown} ({time.perf_counter() - t0:.1f} s)")


def phase_synth_mbd(torch, workdir: str, ref: str, dev: str = "cuda", small: bool = False):
    """54: full-width TTS with the MBD vocoder: a synthesise and a stream
    through the user's entry points, K1 launched in each (``dev="cpu",
    small=True``: a rehearsal, where the launch checks fail)."""
    import numpy as np

    from metavoice_tpu_torch.runtime.tts import TTS

    t0 = time.perf_counter()
    tts = TTS.from_random(small=small, device=dev, vocoder="mbd", output_dir=os.path.join(workdir, "out_mbd"))
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    n_mbd = sum(p.numel() for p in leaves(tts.c.mbd_params).values() if p is not None)
    cfg1, ecfg = tts.c.first_stage_cfg, tts.c.encodec_cfg
    tts.synthesise(SYNTH_TEXT, ref, max_new_tokens=8)  # the speaker embedding cached, cuDNN's plans picked
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    path, total_s, counts = drive_main_path(tts, ref, max_new_tokens=MBD_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda" else float("nan")
    steps = tts.stats["decode_steps"]
    if counts["k1_launches"] != cfg1.n_layer * steps or steps == 0:
        fail(f"54 synth-mbd: K1 launches {counts['k1_launches']} != n_layer x {steps} decode steps")
    wav = check_wav(path)
    audio_s = len(wav) / ecfg.sample_rate
    frames = len(wav) // ecfg.hop_length
    bucket_s = (max(25, -(-frames // 25) * 25) if frames <= 75 else -(-frames // 75) * 75) / ecfg.frame_rate
    mbd_s = tts.timings["vocoder_mbd"]
    stages = ", ".join(f"{k} {v:.3f}" for k, v in tts.timings.items())
    _zero_counts()
    t1 = time.perf_counter()
    segs = list(tts.synthesise_streaming(SYNTH_TEXT, ref, max_new_tokens=MBD_NEW))
    stream_s = time.perf_counter() - t1
    if not segs or not all(np.isfinite(x).all() for x in segs) or read_counts()["k1_launches"] == 0:
        fail(f"54 synth-mbd: the stream gave {len(segs)} segments, K1 launches {read_counts()['k1_launches']}")
    stream_mbd = tts.timings["vocoder_mbd"]
    where = mbd_profile(torch, tts) if dev == "cuda" else "not profiled on the CPU"
    del tts
    empty_cache(torch, dev)
    print(f"[54 synth-mbd] MBD {n_mbd / 1e6:.1f} M params ({n_mbd * 4 / 1e9:.2f} GB f32), init {init_s:.2f} s; "
          f"synthesise {total_s:.2f} s ({stages} s): {steps} decode steps, {counts['k1_launches']} K1 launches, "
          f"wav {audio_s:.2f} s from a {bucket_s:.2f} s bucket; MBD {1e3 * mbd_s / bucket_s:.1f} ms per second of "
          f"bucket audio ({1e3 * mbd_s / audio_s:.1f} ms per second of output); RTF {total_s / audio_s:.3f}; peak "
          f"{peak:.2f} GiB; stream {len(segs)} segments in {stream_s:.2f} s (MBD {stream_mbd:.2f} s); one 1 s "
          f"tokens_to_wav: {where}")


def mbd_profile(torch, tts) -> str:
    """Where one MBD render of a 75-frame (1 s) bucket spends the card's
    time: device time by kernel name (the 6 largest) against the same call
    unprofiled."""
    from metavoice_tpu_torch.models import mbd

    gen = torch.Generator(device="cuda").manual_seed(54)
    codes = torch.randint(0, 1024, (8, 75), device="cuda", generator=gen)

    def run():
        mbd.tokens_to_wav(tts.c.mbd_params, tts.c.mbd_cfg, tts.c.encodec_params, codes, tts.c.encodec_cfg,
                          generator=gen)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not by:
        return f"{wall_ms:.1f} ms; the profiler saw no device time: not measured"
    total = sum(by.values())
    top = "; ".join(f"{k[:60]} {v:.1f} ms ({100 * v / total:.1f}%)"
                    for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:6])
    return (f"{wall_ms:.1f} ms unprofiled, {total:.1f} ms of device time in {len(by)} kernel names "
            f"({100 * total / wall_ms:.1f}% of the wall); {top}")


def phase_train_mbd_df(torch, dev: str = "cuda", small: bool = False):
    """55: one full-width MBD band trained 3 steps, the DF network a few
    (``dev="cpu", small=True``: a rehearsal on a small MBD)."""
    import contextlib as cl
    import io

    import numpy as np

    from metavoice_tpu_torch.models import enhancer as enh
    from metavoice_tpu_torch.models import mbd
    from metavoice_tpu_torch.training import df_trainer as dft
    from metavoice_tpu_torch.training import mbd_trainer as mt

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(55)
    cfg = mbd.MBDConfig(unet=mbd.UNetConfig(**SMALL_MBD_UNET), schedule=mbd.ScheduleConfig(num_steps=16),
                        **SMALL_MBD) if small else mbd.MBDConfig()
    unet = mbd.init_unet_params(cfg.unet, device=dev, generator=gen)
    rows, n = MBD_TRAIN["rows"], MBD_TRAIN["samples"]
    wav = 0.3 * torch.randn(rows, n, device=dev, generator=gen)
    emb = torch.randn(rows, n // 320, cfg.unet.codec_dim, device=dev, generator=gen)
    proc = mt.fit_processor(cfg, wav, generator=gen)
    target = mbd.processor_project_sample(proc, mbd.split_bands(wav, cfg.sample_rate, cfg.n_processes)[0],
                                          cfg.sample_rate, cfg.processor_bands)
    opt, step = mt.make_mbd_train_step(cfg, mt.MBDTrainConfig())
    state = opt.init(unet)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(MBD_TRAIN["steps"]):
        sync(torch, dev)
        t0 = time.perf_counter()
        state, unet, loss = step(state, unet, {"band": target, "emb": emb}, gen)
        losses.append(loss.item())
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    if not all(math.isfinite(x) for x in losses):
        fail(f"55 train-mbd: losses {losses}")
    del unet, state
    empty_cache(torch, dev)

    tcfg = dft.DFTrainConfig(max_iters=6)
    out = io.StringIO()
    t0 = time.perf_counter()
    with cl.redirect_stdout(out):
        dparams = dft.train_df(None, enh.DFConfig(), tcfg, device=dev, log_every=1)
    df_s = time.perf_counter() - t0
    df_losses = [float(x) for x in re.findall(r"loss ([-\d.e+naif]+)", out.getvalue())]
    if len(df_losses) != tcfg.max_iters or not all(math.isfinite(x) for x in df_losses):
        fail(f"55 train-df: losses {df_losses}")
    clean, noisy = dft.synth_clean_noisy(np.random.default_rng(55), 1, 24_000, 24_000, 5.0, 5.0)
    enhanced = enh.get_enhancer("df", params=dparams, device=dev)(noisy[0], 24_000)
    if enhanced.shape != noisy[0].shape or not np.isfinite(enhanced).all():
        fail("55 train-df: the trained enhancer's wav is bad")
    print(f"[55 train-mbd/df] one band of the default MBD ({cfg.unet.channels()} channels), {rows} x {n} samples: "
          f"{[round(1e3 * t, 1) for t in times]} ms a step (median after the first "
          f"{1e3 * sorted(times[1:])[len(times[1:]) // 2]:.1f} ms), losses {['%.4f' % x for x in losses]}, peak "
          f"{peak:.2f} GiB; train_df of the default DF network, {tcfg.max_iters} steps of {tcfg.batch_size} x "
          f"{tcfg.clip_s} s: {1e3 * df_s / tcfg.max_iters:.1f} ms a step (host STFT and the first step included), "
          f"losses {['%.4f' % x for x in df_losses]}; the stamped enhancer on 1 s of audio finite")


# ------------------------------------------------------------------ phases 56-57: tensor parallelism
#
# Two ranks, one process each, both on cuda:0 over gloo (NCCL holds one rank a
# card), started by parallel/mesh.spawn once the parent has built the kernels.
# They run every rank's kernels at the local shapes, through the code a
# machine with two cards runs; two ranks sharing one card time nothing of TP.

TP_SMALL = dict(n_layer=2, n_head=4, dim=512, block_size=256)  # phase 56; FFN 1536, 768 a rank
TP_PREFILL = 32  # phase 56's prompt: more than 16 tokens, the plain prefill route (K2 / K8 at 64 rows)
TP_STEPS = 8  # and its teacher-forced decode steps
TP_GEN = 48  # phase 56's tokens a rank draws under the same Gumbel draws
# phase 56's cases: (label, compute dtype, weights, cache format)
TP_SMALL_CASES = (("f32", "f32", None, None), ("f32 int4", "f32", "int4", None), ("f32 int8", "f32", "int8", None),
                  ("bf16", "bf16", None, None), ("bf16 int4", "bf16", "int4", None),
                  ("bf16 int8", "bf16", "int8", None), ("bf16 int8 cache", "bf16", None, "int8"))
# the ranks' logits against a CPU tp = 1 run of the plain path, as a share of max |ref|. f32 dense: the
# same math, the reduction and the card's sums in other orders. f32 quantized: the kernels round the
# activations to bf16, so a sum one f32 ulp apart may round one bf16 ulp apart, and int8 quantizes each
# shard with its own column scales: 1.5 times the largest gap measured on an NVIDIA H100 80GB HBM3 at a
# 700 W limit (int8 0.00731, int4 0.00497). bf16: the dense bf16 products round differently on the card
# and the CPU (SMALL4_TOL), and the reduction adds the two ranks' bf16 partial sums (measured up to 0.00656).
TP_SMALL_TOL = {"f32": 1e-4, "f32 quantized": 0.011, "bf16": 5e-2}
TP_NEW = 192  # phase 57: first-stage tokens of each synthesise
TP_DRAWN = 64  # and of its first stage, teacher-forced to tp = 1's tokens
TP_MODES = (None, "int4", "int8")  # phase 57's weights
# phase 57: the ranks' logits against tp = 1's on the same weights and the same tokens, at every one of the
# TP_DRAWN steps, as a share of max |ref|: the reductions add two bf16 partial sums, tp = 1 runs the fused
# decode stack (K3 / K7) where TP runs each projection alone (K2 / K8), and int8 quantizes each shard with
# its own column scales. 1.5 times the largest gap over two runs on an NVIDIA H100 80GB HBM3 at a 700 W
# limit, which read the same: bf16 0.0378, int4 0.133, int8 0.119
TP_SYNTH_TOL = {None: 0.057, "int4": 0.2, "int8": 0.18}


def _tp_cache_dtype(torch, dt: str, fmt):
    return fmt or {"f32": torch.float32, "bf16": torch.bfloat16}[dt]


def _tp_small_rank(rank: int, dev: str, params, idx, spk, prompt, noise) -> dict:
    """56, one rank: each case's prefill and teacher-forced steps (the
    kernels' calls held against their plain versions on the card) and each
    mode's tokens under the Gumbel draws ``noise``."""
    import torch

    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.parallel import tp_decode as tpd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = first_stage_config(**TP_SMALL)
    mesh = pmesh.make_mesh(2, device=dev)
    idx, spk = idx.to(mesh.device), spk.to(mesh.device)
    out = {"cases": {}, "tokens": {}}
    for label, dt, mode, fmt in TP_SMALL_CASES:
        p = tpd.prepare_tp_params(params, cfg, mesh, mode)
        kv = tpd.make_tp_cache(cfg, mesh, 2, data_sharded=False, dtype=_tp_cache_dtype(torch, dt, fmt))
        cdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        step = [0]
        _zero_counts()
        with captured_calls(torch, {0, 1, TP_STEPS}, lambda: step[0]) as kept:
            logits, _ = tpd.tp_forward(p, cfg, mesh, idx[:, :TP_PREFILL], spk, None, kv, 0, compute_dtype=cdt)
            seen = [logits[0][:, -1].float().cpu()]
            for i in range(TP_STEPS):
                step[0] = i + 1
                pos = TP_PREFILL + i
                logits, _ = tpd.tp_forward(p, cfg, mesh, idx[:, pos : pos + 1], spk, None, kv, pos, compute_dtype=cdt)
                seen.append(logits[0][:, 0].float().cpu())
        counts = read_counts()
        held = hold_captured(torch, f"56 tp-small {label}, rank {rank}", kept, counts) if dev != "cpu" else "-"
        out["cases"][label] = (torch.stack(seen), counts, held)
    for mode in (None, "int4", "int8"):
        p = tpd.prepare_tp_params(params, cfg, mesh, mode)
        out["tokens"][mode] = tpd.tp_generate(p, cfg, mesh, prompt, spk[0].cpu().numpy(), noise=noise.to(mesh.device),
                                              max_new_tokens=TP_GEN, top_p=1.0, compute_dtype=torch.bfloat16)
    return out


def phase_tp_small(torch, dev: str = "cuda"):
    """56: a small first stage on two ranks (``dev="cpu"``: two CPU ranks, a
    rehearsal): each rank's logits over a prefill and 8 decode steps against
    a CPU tp = 1 run of the plain path, in f32 and bf16, with None, int4 and
    int8 weights and on the int8 cache; every kernel call of the first, the
    second and the last step held against its plain version; the ranks'
    tokens under the same draws equal; the fused routes never launched."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q
    from metavoice_tpu_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    cfg = first_stage_config(**TP_SMALL)
    gen = torch.Generator().manual_seed(56)
    params = tfm.init_params(cfg, device="cpu", generator=gen, dtype=torch.float32)
    idx = torch.randint(0, cfg.vocab_size, (2, TP_PREFILL + TP_STEPS), generator=gen)
    spk = torch.randn(2, cfg.speaker_emb_dim, generator=gen)
    prompt = list(range(2100, 2140))
    noise = S.gumbel_noise((TP_GEN, 1, cfg.vocab_size), device="cpu", generator=gen)
    ranks = pmesh.spawn(_tp_small_rank, 2, args=(dev, params, idx, spk, prompt, noise), backend="gloo",
                        devices=[dev, dev], timeout=120, deadline=300)
    quant = {None: lambda p: p, "int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32}
    seen = []
    for label, dt, mode, fmt in TP_SMALL_CASES:
        got, counts, held = ranks[0]["cases"][label]
        if not torch.equal(got, ranks[1]["cases"][label][0]):
            fail(f"56 tp-small {label}: the two ranks' logits differ")
        p, cdt = quant[mode](params), {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
        kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=_tp_cache_dtype(torch, dt, fmt), device="cpu")
        with torch.inference_mode():
            logits, _ = tfm.forward(p, cfg, idx[:, :TP_PREFILL], spk_emb=spk, kv_cache=kv, compute_dtype=cdt)
            ref = [logits[0][:, -1].float()]
            for i in range(TP_STEPS):
                pos = TP_PREFILL + i
                logits, _ = tfm.forward(p, cfg, idx[:, pos : pos + 1], spk_emb=spk, kv_cache=kv, cache_pos=pos,
                                        compute_dtype=cdt)
                ref.append(logits[0][:, 0].float())
        ref = torch.stack(ref)
        tol = TP_SMALL_TOL["bf16" if dt == "bf16" else "f32" if mode is None else "f32 quantized"]
        gap = (got - ref).abs().max().item() / ref.abs().max().item()
        if not (gap <= tol and torch.isfinite(got).all()):
            fail(f"56 tp-small {label}: the ranks' logits are {gap:.4g} of max |ref| from tp = 1's (tol {tol})")
        # a quantized cache decodes on the plain dequantizing path: no K1
        want = {"k1_launches": 2 * TP_STEPS * (fmt is None), "k2_launches": 5 * 2 * (1 + TP_STEPS) * (mode == "int4"),
                "k8_launches": 5 * 2 * (1 + TP_STEPS) * (mode == "int8")}
        off = {k: n for k, n in counts.items() if k not in want and n}
        if dev != "cpu" and (any(counts[k] != n for k, n in want.items()) or off):
            fail(f"56 tp-small {label}: rank 0 launched {counts}, expected {want} and nothing else")
        seen.append(f"{label} {gap:.3g} (tol {tol}; K1 {counts['k1_launches']}, K2 {counts['k2_launches']}, "
                    f"K8 {counts['k8_launches']}; {held})")
    for mode, toks in ranks[0]["tokens"].items():
        if not (len(toks) > len(prompt) and (toks == ranks[1]["tokens"][mode]).all()):
            fail(f"56 tp-small: under the same draws the ranks' {mode} tokens differ")
    print(f"[56 tp-small] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d, 2 ranks on {dev} over gloo, prefill "
          f"{TP_PREFILL} + {TP_STEPS} steps, rank 0 against a CPU tp = 1 run of the plain path, as a share of max "
          f"|ref|: {'; '.join(seen)}; both ranks' logits bit-identical; {TP_GEN} tokens under the same draws "
          f"identical on both ranks for None, int4, int8 ({time.perf_counter() - t0:.1f} s)")


def _tp_tokens(torch, tts, noise, tp: bool):
    """The first stage's tokens of SYNTH_TEXT on tts's trees (under TP its
    shards and its tensor group), a zero speaker embedding and the Gumbel
    draws ``noise`` at top-p 1 (``forced_noise``'s: given tokens) -> the
    tokens after the prompt."""
    import numpy as np
    from metavoice_tpu_torch.core.text import normalize_text
    from metavoice_tpu_torch.models import first_stage as fs

    cfg = tts.c.first_stage_cfg
    prompt = tts.c.tokenizer.encode(normalize_text(SYNTH_TEXT))
    with torch.inference_mode():
        seq = fs.generate(tts.c.first_stage_params, cfg, prompt, np.zeros((cfg.speaker_emb_dim,), np.float32),
                          max_new_tokens=TP_DRAWN, noise=noise.to(tts.device), top_p=1.0, guidance_scale=3.0,
                          end_of_text_token=tts.c.tokenizer.eot_token, kv_cache=tts._persistent_kv_cache(3.0),
                          compute_dtype=tts._compute_dtype, tp=tts.mesh.tensor_group if tp else None)
    return seq[len(prompt):]


def forced_noise(torch, tokens, noise):
    """Draws that make a top-p 1 sampler take ``tokens`` (step i: 0 at
    tokens[i], -1e30 elsewhere), ``noise``'s past them: a run teacher-forced
    to another run's tokens."""
    forced = noise.clone()
    n = len(tokens)
    forced[:n] = -1e30
    forced[torch.arange(n), 0, torch.as_tensor(tokens, dtype=torch.int64)] = 0.0
    return forced


def _tp_synth_rank(rank: int, dev: str, small: bool, workdir: str, ref: str, forced: dict) -> dict:
    """57, one rank: per weight mode, TTS(tensor_parallel=2) at full width: a
    synthesise through the user's entry point (counts set to 0 just before
    and read just after) and the first stage teacher-forced to tp = 1's
    tokens (``forced[mode]``), each step's logits kept, its kernel calls at
    the prefill, the first and the last step held against their plain
    versions on the card."""
    import torch

    from metavoice_tpu_torch.runtime.tts import TTS

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one reduction of a decode step's partial sums (the CFG pair's rows), as the block stack makes 48 a step
    y = torch.ones((2, 1, 2048), dtype=torch.bfloat16, device=dev)
    for i in range(110):
        if i == 10:
            sync(torch, dev)
            t0 = time.perf_counter()
        dist.all_reduce(y)
    sync(torch, dev)
    out = {"reduce_ms": 1e3 * (time.perf_counter() - t0) / 100}
    for mode in TP_MODES:
        t0 = time.perf_counter()
        tts = TTS.from_random(small=small, device=dev, tensor_parallel=2, quantisation_mode=mode,
                              output_dir=os.path.join(workdir, f"out_tp_{mode}"))
        # the speaker embedding cached, the merge tickets made, every bucket run once
        tts._reference_embedding(ref)
        tts.warmup(prompt_buckets=(128,), vocoder_frame_buckets=(25,), guidance_variants=(3.0,))
        sync(torch, dev)
        init_s = time.perf_counter() - t0
        path, total_s, counts = drive_main_path(tts, ref, max_new_tokens=TP_NEW)
        steps = tts.stats["decode_steps"]
        _zero_counts()
        with recorded_logits() as seen, captured_calls(torch, {0, 1, TP_DRAWN - 1}, lambda: len(seen)) as kept:
            toks = _tp_tokens(torch, tts, forced[mode], tp=True)
        held = hold_captured(torch, f"57 tp-synth {mode}, rank {rank}", kept, read_counts()) if dev != "cpu" else "-"
        wqkv = tts.c.first_stage_params["layers"]["wqkv"]
        out[mode] = dict(path=path, counts=counts, steps=steps, total_s=total_s, init_s=init_s,
                         ms_tok=1e3 * tts.timings["first_stage"] / max(steps, 1), tokens=toks,
                         logits=[s.cpu() for s in seen], held=held, n_layer=tts.c.first_stage_cfg.n_layer,
                         wqkv=tuple((wqkv["pw"] if mode == "int4" else wqkv["p8"] if mode else wqkv).shape))
        del tts, seen, kept
        empty_cache(torch, dev)
    return out


def _forced_steps(torch, label: str, toks1, la: list, toks: list, lc: list, noise, tol: float) -> str:
    """tp = 1's tokens ``toks1`` (logits ``la``, draws ``noise``) and the
    ranks' first stage teacher-forced to them (``toks``, logits ``lc``): the
    same tokens, and at every step the logits within ``tol`` of max |ref|.
    The ranks' own draws from their logits under ``noise`` are what a free
    run of theirs would draw up to the step where it parts from tp = 1
    (the inputs are the same until then); there the two tokens must be
    tp = 1's top two scores (CFG-merged logits + the draw), closer than
    twice the largest score gap between the runs: a near-tie. -> what was
    seen."""
    from metavoice_tpu_torch.core import sampling as S

    if not (len(toks) == len(toks1) == len(la) == len(lc) and (toks == toks1).all()):
        fail(f"{label}: the ranks' first stage, teacher-forced, drew {len(toks)} tokens against tp = 1's "
             f"{len(toks1)}, or others")
    worst, at, part = 0.0, 0, None
    for i in range(len(toks1)):
        ref = la[i]
        gap = (lc[i] - ref).abs().max().item() / ref.abs().max().item()
        if not gap <= tol:
            fail(f"{label}: at step {i} of {len(toks1)}, on the same tokens, the ranks' logits differ from tp = 1's "
                 f"by {gap:.4g} of max |ref| (tol {tol})")
        if gap > worst:
            worst, at = gap, i
        if part is None and int(S.sample_cfg(lc[i], 3.0, 1.0, 1.0, noise=noise[i])[0]) != int(toks1[i]):
            part = i
    held = f"all {len(toks1)} steps' logits within {worst:.3g} of max |ref| (step {at})"
    if part is None:
        return f"{held}; the ranks' own draws equal tp = 1's at every step"
    i = part
    s1 = S.cfg_merge(la[i], 3.0)[0] + noise[i].reshape(-1)
    sc = S.cfg_merge(lc[i], 3.0)[0] + noise[i].reshape(-1)
    top2 = torch.topk(s1, 2)
    margin = (top2.values[0] - top2.values[1]).item()
    gap = (sc - s1).abs().max().item()
    mine = int(torch.argmax(sc))
    if {int(toks1[i]), mine} != set(top2.indices.tolist()) or margin > 2 * gap:
        fail(f"{label}: a free run of the ranks parts from tp = 1 at step {i} ({toks1[i]} at tp = 1, {mine} on the "
             f"ranks), and that is no near-tie: tp = 1's top two {top2.indices.tolist()} are {margin:.4g} apart, the "
             f"largest score gap between the runs is {gap:.4g}")
    return (f"{held}; the ranks' own draws equal tp = 1's for the first {i} of {len(toks1)} tokens and part at step "
            f"{i} between tp = 1's top two scores ({toks1[i]}, {mine}), {margin:.4g} apart against a largest score "
            f"gap of {gap:.4g}")


def phase_tp_synth(torch, workdir: str, ref: str, dev: str = "cuda", small: bool = False) -> dict:
    """57: TTS(tensor_parallel=2) at full width on two ranks sharing the card
    over gloo (``dev="cpu", small=True``: a rehearsal), for bf16, int4 and
    int8 weights: a synthesise (the leader's wav, each rank's launches: K1
    and K2 or K8 at the local shapes, none of K3/K5/K6/K7/K9), the first
    stage teacher-forced to tp = 1's tokens under Gumbel draws, its logits
    held to tp = 1's at every step and bit-identical on both ranks, where a
    free run would part from tp = 1 (a near-tie), and each rank's ms a
    token."""
    from metavoice_tpu_torch.core import sampling as S
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.runtime.tts import TTS

    t0 = time.perf_counter()
    vocab = first_stage_config().vocab_size
    noise = S.gumbel_noise((TP_DRAWN, 1, vocab), device="cpu", generator=torch.Generator().manual_seed(57))
    one = {}  # tp = 1's tokens and logits a mode, on the same weights
    for mode in TP_MODES:
        tts1 = TTS.from_random(small=small, device=dev, quantisation_mode=mode, output_dir=os.path.join(workdir, "out"))
        with recorded_logits() as seen1:
            toks1 = _tp_tokens(torch, tts1, noise, tp=False)
        one[mode] = (toks1, [s.cpu() for s in seen1])
        del tts1, seen1
        empty_cache(torch, dev)
    forced = {mode: forced_noise(torch, toks1, noise) for mode, (toks1, _) in one.items()}
    t1 = time.perf_counter()
    ranks = pmesh.spawn(_tp_synth_rank, 2, args=(dev, small, workdir, ref, forced), backend="gloo",
                        devices=[dev, dev], timeout=300, deadline=600)
    ranks_s = time.perf_counter() - t1
    lines, out = [], {}
    for mode in TP_MODES:
        r0, r1 = ranks[0][mode], ranks[1][mode]
        label = f"57 tp-synth {mode or 'bf16'}"
        if r1["path"] is not None or r0["path"] is None:
            fail(f"{label}: the leader returns the wav's path, the other rank None; got {r0['path']}, {r1['path']}")
        check_wav(r0["path"])
        if not (len(r0["logits"]) == len(r1["logits"])
                and all(torch.equal(a, b) for a, b in zip(r0["logits"], r1["logits"]))):
            fail(f"{label}: on the same tokens the two ranks' logits differ")
        n_layer, steps = r0["n_layer"], r0["steps"]
        for r, got in enumerate((r0, r1)):
            c = got["counts"]
            want = {"k1_launches": n_layer * got["steps"],
                    {"int4": "k2_launches", "int8": "k8_launches"}.get(mode, "k2_launches"):
                        5 * n_layer * (got["steps"] + 1) * (mode is not None)}
            if dev != "cpu" and (any(c[k] != n for k, n in want.items())
                                 or any(n for k, n in c.items() if k not in want)):
                fail(f"{label}: rank {r} launched {c}, expected {want} and nothing else ({got['steps']} steps)")
        toks1, la = one[mode]
        agree = _forced_steps(torch, label, toks1, la, r0["tokens"], r0["logits"], noise, TP_SYNTH_TOL[mode])
        c0, c1 = r0["counts"], r1["counts"]
        lines.append(
            f"{mode or 'bf16'}: local wqkv {r0['wqkv']}; synthesise {steps} steps, rank 0 {r0['total_s']:.2f} s, "
            f"{r0['ms_tok']:.2f} ms a token, rank 1 {r1['ms_tok']:.2f} ms a token (two ranks sharing one card over "
            f"gloo: not a TP latency); launches rank 0 K1 {c0['k1_launches']} K2 {c0['k2_launches']} K8 "
            f"{c0['k8_launches']}, rank 1 K1 {c1['k1_launches']} K2 {c1['k2_launches']} K8 {c1['k8_launches']}, "
            f"K3/K5/K6/K7/K9 0; held: {r0['held']}; teacher-forced to tp = 1's tokens: {agree}")
        out[mode] = {"counts": c0, "ms_per_token": r0["ms_tok"]}
    print(f"[57 tp-synth] full width, TTS(tensor_parallel=2), 2 ranks on {dev} over gloo (one all_reduce of a "
          f"(2, 1, 2048) bf16 step: {ranks[0]['reduce_ms']:.3f} ms on rank 0, {ranks[1]['reduce_ms']:.3f} on rank 1), "
          f"{TP_NEW}-token synthesise, the leader's wav written: " + " | ".join(lines) +
          f" ({t1 - t0:.1f} s tp = 1, {ranks_s:.1f} s the ranks, {time.perf_counter() - t0:.1f} s in all)")
    return out


# phases 58-59: sharded training (training/finetune.py under mesh=, parallel/sharding.py), four ranks, one
# process each, all on cuda:0 over gloo, DP 2 x TP 2: every rank's sharded forward, backward, reductions and
# optimizer step, through the code a machine with four cards runs. Four ranks sharing one card time nothing
# of DP or TP scaling: the card runs all four ranks' work and every reduction passes through the host.

SHARD_TP = 2  # phases 58-59: tensor parallel 2, so the four ranks make data parallel 2
SMALL_FT = dict(learning_rate=1e-3, min_lr=1e-4, warmup_iters=0, lr_decay_iters=20, weight_decay=0.1)
# phase 58: the ranks' losses and grad norms against the one-process step on the card, f32 throughout: the
# reductions add the shards' partial sums in another order than one product (measured 1.05e-7 on an NVIDIA
# H100 80GB HBM3 at a 700 W limit, twice); the CPU tests' rtol
SHARD_SMALL_RTOL = 1e-5
SHARD_ROWS = 4  # phase 59's global batch, rows of block_size tokens: JAX's compile_sharded_train_step's 4 x 2048
SHARD_SEED = 59
# phase 59, bf16 params and compute at full width, the ranks against tp = 1 on the same weights and batches:
# the losses and the global grad norms (rtol), and per leaf the cosine of the gathered step-1 grads (the
# least) and the ratio of their norms (the most it is off 1). 1.5 times the gaps two runs measured on an
# NVIDIA H100 80GB HBM3 at a 700 W limit, which read the same: loss 1.3e-5, grad norm 2.11e-4, cosine
# 0.999812 (wpe), norm ratio 2.1e-4 (speaker_cond)
SHARD_FULL_TOL = {"loss": 2e-5, "grad_norm": 3.2e-4, "cosine": 0.99971, "norm_ratio": 3.2e-4}


class FirstGrads:
    """The optimizer a step is given, handed on; with ``keep``, a host copy
    of the first grads it updates from (``.grads``)."""

    def __init__(self, opt, keep: bool):
        self.opt, self.keep, self.grads = opt, keep, None

    def update(self, grads, opt_state, params, norm=None):
        if self.keep and self.grads is None:
            from metavoice_tpu_torch.training import finetune as ft

            self.grads = ft.tree_map(lambda g: g.detach().cpu(), grads)
        return self.opt.update(grads, opt_state, params, norm)


def sharded_steps(torch, cfg, params, ftc, batches, mode: str, mesh=None, dtype=None, keep_grads: bool = False):
    """``len(batches)`` steps of ``mode`` ("train": ``make_train_step`` on
    the whole tree; "finetune": ``make_finetune_step`` on the last block)
    on ``params`` (this rank's shards under ``mesh``), updated in place ->
    (the stacked tree after, [(loss, grad_norm)], [seconds a step], the
    first step's grads on the host or None)."""
    from metavoice_tpu_torch.training import finetune as ft

    dtype = dtype or torch.float32
    if mode == "finetune":
        frozen, train = ft.split_trainable(params, 1)
        state, opt = ft.init_train_state(train, ftc)
        kept = FirstGrads(opt, keep_grads)
        step = ft.make_finetune_step(cfg, ftc, kept, frozen, compute_dtype=dtype, mesh=mesh)
    else:
        state, opt = ft.init_train_state(params, ftc)
        kept = FirstGrads(opt, keep_grads)
        step = ft.make_train_step(cfg, ftc, kept, compute_dtype=dtype, mesh=mesh)
    dev = ft.tree_leaves(params)[0].device
    metrics, times = [], []
    for b in batches:
        sync(torch, dev)
        t0 = time.perf_counter()
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))  # waits for the step
        times.append(time.perf_counter() - t0)
    done = ft.merge_trainable(frozen, state.params) if mode == "finetune" else state.params
    return done, metrics, times, kept.grads


def _tiny_batches(seeds) -> list:
    """phase 58's global batches (dryrun's 4 x 16 tokens), rows holding 0, 5, 16 and 11 ignored targets."""
    from metavoice_tpu_torch.parallel import dryrun

    out = []
    for seed in seeds:
        b = dryrun.tiny_batch(4, seed)
        for r, n in enumerate((0, 5, 16, 11)):
            b["y"][r, :n] = -1
        out.append(b)
    return out


def _host(tree):
    """A tree's tensors, detached copies on the host."""
    from metavoice_tpu_torch.training import finetune as ft

    return ft.tree_map(lambda t: t.detach().cpu().clone(), tree)


def _sharded_small_rank(rank: int, dev: str) -> dict:
    """58, one rank: dryrun's rank body, then two whole-tree train steps and
    one finetune step of the tiny model on this rank's shards -> each run's
    metrics, its gathered dense tree and this rank's own shards (on the
    host), and this rank's kernel counts."""
    import torch

    from metavoice_tpu_torch.parallel import dryrun
    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.parallel import sharding as psh
    from metavoice_tpu_torch.training import finetune as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _zero_counts()
    out = {"dryrun": dryrun.dryrun_rank(rank, SHARD_TP, [dev] * 4)}
    mesh = pmesh.make_mesh(SHARD_TP, device=dev)
    cfg, params = dryrun.tiny_params()
    ftc = ft.FinetuneConfig(**SMALL_FT)
    for mode, seeds in (("train", (1, 2)), ("finetune", (3,))):
        done, metrics, _, _ = sharded_steps(torch, cfg, psh.shard_params(params, cfg, mesh), ftc,
                                            _tiny_batches(seeds), mode, mesh)
        out[mode] = (metrics, _host(psh.gather_params(done, cfg, mesh)), _host(done))
    out["counts"] = read_counts()
    out["mesh"] = (mesh.data_parallel, mesh.tensor_parallel, mesh.data_rank, mesh.tensor_rank)
    return out


def same_bits_across(torch, label: str, trees: list, tp: int) -> int:
    """Rank r's ``trees[r]`` (a param tree, or ``path -> digest``) bit for
    bit its data group's in every leaf, and its tensor group's in every
    replicated leaf -> the leaves compared."""
    from metavoice_tpu_torch.parallel import sharding as psh

    flat = [t if all(isinstance(v, str) for v in t.values()) else leaves(t) for t in trees]

    def equal(a, b):
        return a == b if isinstance(a, str) else torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    n = 0
    for r, mine in enumerate(flat):
        for k, v in mine.items():
            if not equal(v, flat[r % tp][k]):
                fail(f"{label}: rank {r}'s {k} differs from its data group's rank {r % tp}")
            split = k.startswith("layers/") and k.split("/")[1] in psh.LAYER_SPLITS
            if not split and not equal(v, flat[r - r % tp][k]):
                fail(f"{label}: rank {r}'s replicated {k} differs from its tensor group's leader {r - r % tp}")
            n += 1
    return n


def leaf_digests(torch, tree) -> dict:
    """``path -> digest`` of each leaf's bytes."""
    import hashlib

    return {k: hashlib.blake2b(v.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().data).hexdigest()
            for k, v in leaves(tree).items()}


def phase_sharded_small(torch, dev: str = "cuda"):
    """58: dryrun's rank body and two train steps and a finetune step of its
    tiny first stage (2L/4H/64d, vocab 96, f32) on four ranks sharing the
    card over gloo at DP 2 x TP 2 (``dev="cpu"``: four CPU ranks, a
    rehearsal), held to the one-process port step on ``dev``: losses and
    grad norms within SHARD_SMALL_RTOL, the gathered params as phase 50
    holds two trees; every leaf bit-identical across a data group, the
    replicated ones across a tensor group; no kernel launched."""
    from metavoice_tpu_torch.parallel import dryrun
    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.training import finetune as ft

    t0 = time.perf_counter()
    cfg, params = dryrun.tiny_params()
    one = {}
    ftc0 = ft.FinetuneConfig()
    state, opt = ft.init_train_state(ft.tree_map(lambda t: t.to(dev, copy=True), params), ftc0)
    mask = ft.trainable_mask(state.params, cfg, ftc0.last_n_blocks_to_finetune)
    _, m = ft.make_train_step(cfg, ftc0, opt, grad_mask=mask, compute_dtype=torch.float32)(state, dryrun.tiny_batch(4))
    one["dryrun"] = (float(m["loss"]), float(m["grad_norm"]))
    ftc = ft.FinetuneConfig(**SMALL_FT)
    for mode, seeds in (("train", (1, 2)), ("finetune", (3,))):
        done, metrics, _, _ = sharded_steps(torch, cfg, ft.tree_map(lambda t: t.to(dev, copy=True), params), ftc,
                                            _tiny_batches(seeds), mode)
        one[mode] = (metrics, _host(done))
    t1 = time.perf_counter()
    ranks = pmesh.spawn(_sharded_small_rank, 4, args=(dev,), backend="gloo", devices=[dev] * 4, timeout=120,
                        deadline=300)
    ranks_s = time.perf_counter() - t1
    sched = ft.lr_schedule(ftc)
    worst, seen = 0.0, []
    for r, got in enumerate(ranks):
        if got["mesh"] != (2, SHARD_TP, r // SHARD_TP, r % SHARD_TP):
            fail(f"58 sharded-small: rank {r} sits at {got['mesh']} of the grid")
        if any(got["counts"].values()):
            fail(f"58 sharded-small: rank {r} launched {got['counts']}: sharded training runs no hand-written kernel")
        d = got["dryrun"]
        pairs = [((d["loss"], d["grad_norm"]), one["dryrun"])]
        pairs += [(a, b) for mode in ("train", "finetune") for a, b in zip(got[mode][0], one[mode][0])]
        for (la, na), (lb, nb) in pairs:
            gap = max(abs(la - lb) / abs(lb), abs(na - nb) / abs(nb))
            worst = max(worst, gap)
            if not gap <= SHARD_SMALL_RTOL:
                fail(f"58 sharded-small: rank {r}'s (loss, grad norm) {(la, na)} against one process's {(lb, nb)}: "
                     f"{gap:.3g} apart (rtol {SHARD_SMALL_RTOL})")
        if d["logits"] is None or not torch.isfinite(torch.as_tensor(d["logits"])).all():
            fail(f"58 sharded-small: rank {r}'s TP decode step gave no finite logits")
    for mode, steps in (("train", 2), ("finetune", 1)):
        lr_sum = sum(sched(i) for i in range(steps))
        seen.append(f"{mode}: " + params_apart(torch, ranks[0][mode][1], one[mode][1], lr_sum, ftc.learning_rate,
                                                f"58 sharded-small {mode}, the gathered params against one process's"))
    n = sum(same_bits_across(torch, f"58 sharded-small {mode}", [g[mode][2] for g in ranks], SHARD_TP)
            for mode in ("train", "finetune"))
    print(f"[58 sharded-small] dryrun's rank body and {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d vocab "
          f"{cfg.vocab_size}, f32, 4 ranks on {dev} over gloo at DP 2 x TP 2 against one process on {dev}: "
          f"{ranks[0]['dryrun']['loss']:.6f} dryrun loss; 2 train steps and 1 finetune step of 4 x 16 tokens, "
          f"losses and grad norms within {worst:.3g} (rtol {SHARD_SMALL_RTOL}); {'; '.join(seen)}; {n} leaves "
          f"bit for bit across the data groups (replicated ones across the tensor groups); no kernel launched "
          f"({t1 - t0:.1f} s one process, {ranks_s:.1f} s the ranks)")


def _full_cfg(small: bool):
    from metavoice_tpu_torch.core.config import first_stage_config

    return first_stage_config(**(dict(n_layer=2, n_head=4, dim=128, block_size=256) if small else {}))


def _full_params(torch, cfg, dev):
    """Phase 59's bf16 weights, drawn on ``dev`` from SHARD_SEED: the same in every process."""
    from metavoice_tpu_torch.models import transformer as tfm

    return tfm.init_params(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(SHARD_SEED),
                           dtype=torch.bfloat16)


def _full_batches(torch, cfg, n: int) -> list:
    """Phase 59's global batches of SHARD_ROWS x block_size tokens (on the
    host); row 1 ignores a quarter of its targets, so the two data ranks
    hold unequal counts."""
    gen = torch.Generator().manual_seed(SHARD_SEED)
    out = []
    for _ in range(n):
        shape = (SHARD_ROWS, cfg.block_size)
        y = torch.randint(0, cfg.vocab_size, shape, generator=gen)
        y[1, : cfg.block_size // 4] = -1
        out.append({"x": torch.randint(0, cfg.vocab_size, shape, generator=gen), "y": y,
                    "spk_emb": torch.randn((SHARD_ROWS, cfg.speaker_emb_dim), generator=gen)})
    return out


def _sharded_full_rank(rank: int, dev: str, small: bool, batches: list) -> dict:
    """59, one rank: two whole-tree train steps and one finetune step on
    this rank's shards of the full-width tree -> metrics, seconds a step,
    the reductions' seconds and count, peak memory, each leaf's digest after
    the steps, the kernel counts, and (data rank 0) the first step's grads."""
    import torch
    import torch.distributed as dist

    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.parallel import sharding as psh
    from metavoice_tpu_torch.training import finetune as ft

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _full_cfg(small)
    mesh = pmesh.make_mesh(SHARD_TP, device=dev)
    ftc = ft.FinetuneConfig(warmup_iters=1)
    spent = {"s": 0.0, "n": 0}
    real = dist.all_reduce

    def timed(*a, **kw):  # every reduction of a step: the tensor group's, the data group's, the norm's
        sync(torch, dev)
        t0 = time.perf_counter()
        out = real(*a, **kw)
        sync(torch, dev)
        spent["s"] += time.perf_counter() - t0
        spent["n"] += 1
        return out

    out = {"mesh": (mesh.data_parallel, mesh.tensor_parallel, mesh.data_rank, mesh.tensor_rank)}
    _zero_counts()
    dist.all_reduce = timed
    try:
        for mode, run in (("train", batches), ("finetune", batches[:1])):
            if dev != "cpu":
                torch.cuda.reset_peak_memory_stats()
            params = _full_params(torch, cfg, dev)
            shards = psh.shard_params(params, cfg, mesh)
            del params
            empty_cache(torch, dev)
            spent.update(s=0.0, n=0)
            keep = mode == "train" and mesh.data_rank == 0
            done, metrics, times, grads = sharded_steps(torch, cfg, shards, ftc, run, mode, mesh, torch.bfloat16, keep)
            out[mode] = dict(metrics=metrics, times=times, reduce_s=spent["s"], reductions=spent["n"],
                             peak=torch.cuda.max_memory_allocated() if dev != "cpu" else 0,
                             digests=leaf_digests(torch, done), grads=grads)
            del done, shards, grads
            empty_cache(torch, dev)
    finally:
        dist.all_reduce = real
    out["counts"] = read_counts()
    return out


def grads_apart(torch, got, want, dev) -> tuple[float, float, str, str]:
    """Per leaf, the cosine of two grad trees and the ratio of their norms
    (on ``dev``, in f32) -> (the least cosine, the largest |ratio - 1|, and
    the leaves where each was seen)."""
    worst_cos, worst_ratio, at_cos, at_ratio = 1.0, 0.0, "", ""
    g = leaves(got)
    for k, w in leaves(want).items():
        a, b = g[k].to(dev).float().flatten(), w.to(dev).float().flatten()
        na, nb = a.norm().item(), b.norm().item()
        if nb == 0.0:
            if na != 0.0:
                fail(f"59 sharded-full-width: the ranks' grad of {k} is not zero, tp = 1's is")
            continue
        cos, ratio = (a @ b).item() / (na * nb), abs(na / nb - 1)
        if cos < worst_cos:
            worst_cos, at_cos = cos, k
        if ratio > worst_ratio:
            worst_ratio, at_ratio = ratio, k
    return worst_cos, worst_ratio, at_cos, at_ratio


def phase_sharded_full_width(torch, smi: str, dev: str = "cuda", small: bool = False) -> dict:
    """59: ``make_train_step`` on the whole full-width tree (24L/16H/2048d,
    block 2048) with bf16 params, JAX's compile_sharded_train_step shape (a
    global batch of 4 x 2048), two steps of ``FinetuneConfig(warmup_iters=1)``
    and one ``make_finetune_step`` (last block) on four ranks sharing the
    card over gloo at DP 2 x TP 2 (``dev="cpu", small=True``: a rehearsal),
    against tp = 1 on the same weights and batches run first in this
    process: losses and global grad norms, per leaf the cosine and the norm
    ratio of the gathered step-1 grads (SHARD_FULL_TOL), every leaf
    bit-identical across a data group and the replicated ones across a
    tensor group, no kernel launched; ms a step a rank, the reductions'
    share, peak memory a rank beside ``abstract_train_state``'s bytes."""
    from metavoice_tpu_torch.parallel import aot
    from metavoice_tpu_torch.parallel import mesh as pmesh
    from metavoice_tpu_torch.parallel import sharding as psh
    from metavoice_tpu_torch.training import finetune as ft

    t0 = time.perf_counter()
    cfg = _full_cfg(small)
    batches = _full_batches(torch, cfg, 2)
    ftc = ft.FinetuneConfig(warmup_iters=1)
    one = {}
    for mode, run in (("train", batches), ("finetune", batches[:1])):
        if dev != "cpu":
            torch.cuda.reset_peak_memory_stats()
        params = _full_params(torch, cfg, dev)
        _, metrics, times, grads = sharded_steps(torch, cfg, params, ftc, run, mode, None, torch.bfloat16,
                                                 mode == "train")
        one[mode] = dict(metrics=metrics, times=times, grads=grads,
                         peak=torch.cuda.max_memory_allocated() if dev != "cpu" else 0)
        del params, grads
        empty_cache(torch, dev)
    t1 = time.perf_counter()
    ranks = pmesh.spawn(_sharded_full_rank, 4, args=(dev, small, batches), backend="gloo", devices=[dev] * 4,
                        timeout=300, deadline=900)
    ranks_s = time.perf_counter() - t1
    tol = SHARD_FULL_TOL
    worst = {"loss": 0.0, "grad_norm": 0.0}
    for r, got in enumerate(ranks):
        if got["mesh"] != (2, SHARD_TP, r // SHARD_TP, r % SHARD_TP):
            fail(f"59 sharded-full-width: rank {r} sits at {got['mesh']} of the grid")
        if any(got["counts"].values()):
            fail(f"59 sharded-full-width: rank {r} launched {got['counts']}: training runs no hand-written kernel")
        for mode in ("train", "finetune"):
            for i, ((la, na), (lb, nb)) in enumerate(zip(got[mode]["metrics"], one[mode]["metrics"])):
                for what, a, b in (("loss", la, lb), ("grad_norm", na, nb)):
                    gap = abs(a - b) / abs(b)
                    worst[what] = max(worst[what], gap)
                    if not gap <= tol[what]:
                        fail(f"59 sharded-full-width: rank {r}'s {mode} step {i + 1} {what} {a:.6g} against tp = 1's "
                             f"{b:.6g}: {gap:.3g} apart (rtol {tol[what]})")
    n = sum(same_bits_across(torch, f"59 sharded-full-width {mode}", [g[mode]["digests"] for g in ranks], SHARD_TP)
            for mode in ("train", "finetune"))
    cos, ratio, at_cos, at_ratio = grads_apart(
        torch, psh.join_shards([ranks[t]["train"]["grads"] for t in range(SHARD_TP)], cfg), one["train"]["grads"],
        dev)
    if not (cos >= tol["cosine"] and ratio <= tol["norm_ratio"]):
        fail(f"59 sharded-full-width: the gathered step-1 grads against tp = 1's: least cosine {cos:.6f} ({at_cos}; "
             f"at least {tol['cosine']}), largest norm ratio off 1 by {ratio:.3g} ({at_ratio}; at most "
             f"{tol['norm_ratio']})")
    state = aot.abstract_train_state(cfg, tp=SHARD_TP)[0]["bytes"]
    state1 = aot.abstract_train_state(cfg, tp=1)[0]["bytes"]
    rank_lines = []
    for r, got in enumerate(ranks):
        tr = got["train"]
        rank_lines.append(f"rank {r}: {1e3 * tr['times'][0]:.0f} / {1e3 * tr['times'][1]:.0f} ms steps 1 / 2, "
                          f"reductions {100 * tr['reduce_s'] / sum(tr['times']):.1f}% of them ({tr['reductions']} "
                          f"all_reduce calls), finetune {1e3 * got['finetune']['times'][0]:.0f} ms, peak "
                          f"{tr['peak'] / 2**30:.2f} GiB")
    o, r0 = one["train"], ranks[0]["train"]
    losses = [[round(m[0], 6) for m in run["metrics"]] for run in (r0, o)]
    norms = [[round(m[1], 6) for m in run["metrics"]] for run in (r0, o)]
    print(f"[59 sharded-full-width] {smi}: {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d bf16, a global batch of "
          f"{SHARD_ROWS} x {cfg.block_size} tokens, 4 ranks on {dev} over gloo at DP 2 x TP 2 against tp = 1 on the "
          f"same weights: train losses {losses[0]} (tp = 1 {losses[1]}), grad norms {norms[0]} ({norms[1]}), "
          f"finetune {ranks[0]['finetune']['metrics']} ({one['finetune']['metrics']}); worst over ranks and steps: "
          f"loss {worst['loss']:.3g} (rtol {tol['loss']}), grad norm {worst['grad_norm']:.3g} (rtol "
          f"{tol['grad_norm']}); step-1 grads gathered: least cosine {cos:.6f} ({at_cos}), largest norm ratio off 1 "
          f"{ratio:.3g} ({at_ratio}); {n} leaves bit for bit across the data groups (replicated ones across the "
          f"tensor groups); no kernel launched; " + "; ".join(rank_lines) +
          f" (four ranks sharing one card through the host's gloo: no DP or TP time); tp = 1 "
          f"{1e3 * o['times'][0]:.0f} / {1e3 * o['times'][1]:.0f} ms a step, peak {o['peak'] / 2**30:.2f} GiB; "
          f"abstract_train_state a rank: params + mu + nu {sum(state.values()) / 2**30:.2f} GiB, with grads "
          f"{4 * state['params'] / 2**30:.2f} GiB (tp = 1: {4 * state1['params'] / 2**30:.2f} GiB) "
          f"({t1 - t0:.1f} s tp = 1, {ranks_s:.1f} s the ranks)")
    return {"ranks": ranks, "one": one}


# ---------------------------------------------------------------- phase 60: the CUDA-graph decode step

GRAPH_SEGMENTS = ((376, 16), (504, 16), (1016, 16), (2032, 24))  # (pos, steps): 64 tokens, pos crosses 384,
# 512 and 1024 (K1's window buckets) and the last reaches the cache's end after 16 of its 24 steps
GRAPH_TIMED = (128, 64)  # phase 60's timed loops: 64 steps from pos 128, the CFG pair
GRAPH_RUNS = 3  # calls of each loop timed, in turns eager, graph, graph, eager, ...
GRAPH_RAGGED = (0, 37, 90, 5)  # phase 60's batch of 4: each row's left padding
GRAPH_ENGINE = (2, (0, 50), 2, 24)  # engine-shaped: slots, their left padding, segments, steps a segment


def _graph_noise(torch, n: int, b: int, vocab: int, gen, dev, eoa_free: bool = False):
    """(n, B, V) Gumbel noise drawn on the card; eoa_free: end-of-audio never drawn."""
    from metavoice_tpu_torch.core import tokens as T

    e = torch.empty((n, b, vocab), device=dev).exponential_(generator=gen)
    noise = -torch.log(e.clamp_min(1e-30))
    if eoa_free:
        noise[..., T.END_OF_AUDIO_TOKEN] = -1e4
    return noise


def _filled(torch, cfg, rows: int, gen, dev, fmt=None):
    """A cache of ``rows`` rows (bf16, or the KVCache format ``fmt``) whose
    every slot holds values, as after a prefill: N(0, 1), or random int8
    values (words) with scales in [1e-3, 2.1e-2)."""
    from metavoice_tpu_torch.models import transformer as tfm

    kv = tfm.KVCache.create(cfg, rows, cfg.block_size, dtype=fmt or torch.bfloat16, device=dev)
    for t in (kv.k, kv.v):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
        else:
            info = torch.iinfo(t.dtype)
            t.copy_(torch.randint(info.min + 1, info.max, t.shape, generator=gen, device=dev, dtype=t.dtype))
    for t in (kv.k_scale, kv.v_scale):
        if t is not None:
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.02 + 1e-3)
    return kv


def _kv_fields(kv) -> list:
    return [t for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]


def _kv_clone(kv):
    from metavoice_tpu_torch.models import transformer as tfm

    return tfm.KVCache(*(None if t is None else t.clone() for t in (kv.k, kv.v, kv.k_scale, kv.v_scale)))


def graph_vs_eager(torch, label: str, params, cfg, base, kv, cur, pos: int, n: int, spk, seed=None, phase="60",
                   **kw):
    """One decode from (cur, pos) on ``base``'s contents by the graph loop
    (on ``kv``, a cache kept across calls, so that its graphs serve them
    all) and by the eager loop (on a copy): tokens, lengths and caches (every
    field: values and scales) bit for bit, the launch counts equal;
    ``seed``: each loop draws from a generator of that seed, else ``kw``
    holds the noise. -> (tokens, lengths, the launch counts, the graph
    loop's route)."""
    from metavoice_tpu_torch.models import first_stage as fs

    dev = cur.device
    gens = [None if seed is None else torch.Generator(device=dev).manual_seed(seed) for _ in range(2)]
    eager = _kv_clone(base)
    for dst, src in zip(_kv_fields(kv), _kv_fields(base)):
        dst.copy_(src)
    runs = []
    for loop, cache, gen in ((fs.decode_eager, eager, gens[0]), (fs.decode, kv, gens[1])):
        _zero_counts()
        stats = {}
        tokens, lengths = loop(params, cfg, cur, pos, cache, spk, n, generator=gen, stats=stats, **kw)
        sync(torch, dev)
        runs.append((tokens, lengths, read_counts(), stats))
    (te, le, ce, se), (tg, lg, cg, sg) = runs
    if not (_same_bits(torch, tg, te) and _same_bits(torch, lg, le)):
        part = next((i for i in range(te.shape[1]) if not torch.equal(te[:, i], tg[:, i])), None)
        fail(f"{phase} {label}: the graph loop's tokens part from the eager loop's at step {part}")
    if not all(_same_bits(torch, a, c) for a, c in zip(_kv_fields(kv), _kv_fields(eager))):
        fail(f"{phase} {label}: the graph loop's cache differs from the eager loop's")
    if cg != ce or se["decode_steps"] != sg["decode_steps"]:
        fail(f"{phase} {label}: the graph loop credited {cg} in {sg['decode_steps']} steps, the eager loop launched "
             f"{ce} in {se['decode_steps']}")
    return tg, lg, cg, sg["decode_route"]


def _timed_loops(torch, fs, params, cfg, kv, cur, spk, noise, timed=GRAPH_TIMED) -> dict:
    """ms a token of the eager and the graph loop, GRAPH_RUNS calls each in
    turns (eager, graph, graph, eager, ...), of ``timed`` (pos, steps),
    after one untimed call of the graph loop (its first on ``kv``, a cache
    it has no graph of yet: an eager warm step and the capture of its window
    bucket; "first_ms" is its wall time, in ms)."""
    pos, n = timed
    ms = {"eager": [], "graph": []}
    order = ["graph"] + [("eager", "graph", "graph", "eager")[i % 4] for i in range(2 * GRAPH_RUNS)]
    for i, loop in enumerate(order):
        stats = {}
        sync(torch, cur.device)
        t0 = time.perf_counter()
        (fs.decode if loop == "graph" else fs.decode_eager)(params, cfg, cur, pos, kv, spk, n, noise=noise,
                                                             stats=stats)
        sync(torch, cur.device)
        wall = 1e3 * (time.perf_counter() - t0)
        if i:
            ms[loop].append(wall / stats["decode_steps"])
        else:
            ms["first_ms"] = wall
    return ms


def graph_step_profile(torch, run, steps: int) -> str:
    """Where a graph loop's device time goes: run() (``steps`` replayed
    steps, ending in a synchronise) once unprofiled for its wall time, then
    under torch.profiler -> the device's busy ms a step (the union of the
    kernels' time ranges: kernels chained by programmatic dependent launch
    overlap), its share of the wall, the kernels a step, and the kernels
    that take most of the summed kernel time."""
    run()
    t0 = time.perf_counter()
    run()
    wall = 1e3 * (time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
    by, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^void |\(anonymous namespace\)::|at::native::|<.*|\(.*", "", e.name)[:40]
            by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end))
    if not spans:
        return f"{wall / steps:.4f} ms a step of wall; the profiler saw no device time: busy share not measured"
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3
    total = sum(by.values())
    top = ", ".join(f"{k} {100 * v / total:.1f}%" for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:4])
    return (f"device busy {busy / steps:.4f} ms a step, {100 * busy / wall:.1f}% of the unprofiled wall "
            f"({wall / steps:.4f} ms a step), {len(spans) / steps:.0f} kernels a step; of the kernels' "
            f"{total / steps:.4f} ms a step: {top}")


def capture_before_eager_raises(torch, label: str, params, cfg, kv, cur, spk, phase="60", route=None):
    """With the device's merge counters not yet made (every table: K1/K4's,
    the decode GEMV's, the ring's, K2/K8's), capturing the step (a fresh
    graph set, no eager warm step, at ``route``'s window bucket of pos 100)
    raises and makes none."""
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import decode_stack as DS
    from metavoice_tpu_torch.ops import quantized as Q

    spec = fs.StepSpec(2, T.END_OF_AUDIO_TOKEN, 0, torch.bfloat16)
    graphs = fs.StepGraphs(spec, fs.init_state(cur, 100, spk, 4, spec), cfg.block_size, [], None)
    tables = ((A, "_tickets"), (DS, "_stack_tickets"), (Q, "_int4g_tickets"), (Q, "_prefill_tickets"))
    saved = [getattr(mod, name) for mod, name in tables]
    for mod, name in tables:
        setattr(mod, name, {})
    window = cfg.block_size if route is None else fs.step_window(route, 100, cfg.block_size)
    try:
        try:
            graphs.capture(params, cfg, kv, window)
        except RuntimeError as e:
            if "eager call" not in str(e):
                fail(f"{phase} {label}: a capture before any eager call raised another error: {e}")
        else:
            fail(f"{phase} {label}: a capture before any eager call did not raise")
        if any(getattr(mod, name) for mod, name in tables):
            fail(f"{phase} {label}: a refused capture made merge counters")
    finally:
        for (mod, name), table in zip(tables, saved):
            setattr(mod, name, table)


def phase_graph_decode(torch, dev: str = "cuda", small: bool = False) -> dict:
    """60: the graph loop against the eager loop at full width in bf16
    (K1), int4 (K3) and int8 (K7) -> {mode: {"eager": [ms a token], "graph": [...]}}."""
    import numpy as np

    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import first_stage as fs
    from metavoice_tpu_torch.models import transformer as tfm
    from metavoice_tpu_torch.ops import quantized as Q

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    cfg = first_stage_config(**(dict(n_layer=2, n_head=8, dim=1024) if small else {}))
    gen = torch.Generator(device=dev).manual_seed(60)
    dense = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    vocab = cfg.vocab_sizes[0]
    eot = T.TEXT_OFFSET + 256  # an end-of-text above end-of-audio, for the third guidance group
    results, shown = {}, []
    for mode in (None, "int4", "int8"):
        label = mode or "bf16"
        params = {None: lambda: dense, "int4": lambda: Q.quantize_params_int4_i32(dense),
                  "int8": lambda: Q.quantize_params_int8_i32(dense)}[mode]()
        route = fs.step_route(params, cfg, 2, tfm.KVCache.create(cfg, 2, 16, device=dev))
        want_route = "graph" if dev.type == "cuda" else "eager"
        kernel = {"K1": "k1_launches", "K3": "k3_launches", "K7": "k7_launches"}[route]
        per_step = cfg.n_layer if route == "K1" else 1
        cur = torch.randint(0, T.END_OF_AUDIO_TOKEN, (1,), generator=gen, device=dev)
        spk = torch.randn((1, cfg.speaker_emb_dim), generator=gen, device=dev)
        base = _filled(torch, cfg, 2, gen, dev)
        kv = tfm.KVCache.create(cfg, 2, cfg.block_size, dtype=torch.bfloat16, device=dev)
        knobs = dict(temperature=1.0, top_p=0.95, guidance_scale=3.0)
        # GRAPH_SEGMENTS: across every window bucket of K1, the last segment to the cache's end
        total, launches = 0, 0
        for pos, n in GRAPH_SEGMENTS:
            noise = _graph_noise(torch, n, 1, vocab, gen, dev, eoa_free=True)  # every token compared
            tokens, lengths, counts, got_route = graph_vs_eager(torch, f"{label} pos {pos}", params, cfg, base, kv,
                                                                cur, pos, n, spk, noise=noise, **knobs)
            steps = min(n, cfg.block_size - pos)
            if got_route != want_route or int(lengths.max()) > steps:
                fail(f"60 {label} pos {pos}: route {got_route}, {int(lengths.max())} tokens of {steps} steps")
            total += int(lengths[0])
            launches += counts[kernel]
        # a ragged batch of 4 with starts and per-row knobs
        b = len(GRAPH_RAGGED)
        pads = torch.tensor(GRAPH_RAGGED, dtype=torch.int32, device=dev)
        row = {"temperature": (1.0, 0.7, 1.3, 0.9), "top_p": (0.95, 0.8, 0.9, 1.0),
               "guidance_scale": (3.0, 2.0, 1.5, 3.0)}
        ragged = {k: torch.tensor(v, device=dev).reshape(b, 1) for k, v in row.items()}
        base8 = _filled(torch, cfg, 2 * b, gen, dev)
        kv8 = tfm.KVCache.create(cfg, 2 * b, cfg.block_size, dtype=torch.bfloat16, device=dev)
        cur4 = torch.randint(0, T.END_OF_AUDIO_TOKEN, (b,), generator=gen, device=dev)
        spk4 = torch.randn((b, cfg.speaker_emb_dim), generator=gen, device=dev)
        graph_vs_eager(torch, f"{label} ragged batch of {b}", params, cfg, base8, kv8, cur4, 200, 32, spk4,
                       pad_lens=pads, noise=_graph_noise(torch, 32, b, vocab, gen, dev), **ragged)
        # 3-row guidance (speaker, prompt)
        base3 = _filled(torch, cfg, 3, gen, dev)
        kv3 = tfm.KVCache.create(cfg, 3, cfg.block_size, dtype=torch.bfloat16, device=dev)
        graph_vs_eager(torch, f"{label} 3 rows", params, cfg, base3, kv3, cur, 300, 32, spk, cfg_rows=3,
                       prompt_guidance_scale=1.5, end_of_text_token=eot,
                       noise=_graph_noise(torch, 32, 1, vocab, gen, dev), **knobs)
        # the knobs are refilled before each call: two calls at another temperature and top-p
        noise = _graph_noise(torch, 24, 1, vocab, gen, dev)
        outs = [graph_vs_eager(torch, f"{label} temperature {t}, top-p {p}", params, cfg, base, kv, cur, 700, 24,
                               spk, noise=noise, temperature=t, top_p=p, guidance_scale=3.0)[0]
                for t, p in ((1.0, 0.95), (0.05, 0.3))]
        if torch.equal(outs[0], outs[1]):
            fail(f"60 {label}: two calls at other temperature and top-p drew the same tokens")
        # engine-shaped segments: slots' cache rows, left padding, per-row knobs, the generator's draws
        slots, slot_pads, n_seg, seg = GRAPH_ENGINE
        base_e = _filled(torch, cfg, 2 * slots, gen, dev)
        kv_e, kv_g = (tfm.KVCache(base_e.k.clone(), base_e.v.clone()) for _ in range(2))
        eng_knobs = {k: torch.tensor(v[:slots], device=dev).reshape(slots, 1) for k, v in row.items()}
        gens = [torch.Generator(device=dev).manual_seed(61) for _ in range(2)]
        curs = [torch.randint(0, T.END_OF_AUDIO_TOKEN, (slots,), generator=gen, device=dev)] * 2
        spk_e = torch.randn((slots, cfg.speaker_emb_dim), generator=gen, device=dev)
        pos = 128
        for k in range(n_seg):
            outs = []
            for i, (loop, cache) in enumerate(((fs.decode_eager, kv_e), (fs.decode, kv_g))):
                toks, lens = loop(params, cfg, curs[i], pos, cache, spk_e, seg, generator=gens[i],
                                  pad_lens=torch.tensor(slot_pads, dtype=torch.int32, device=dev), **eng_knobs)
                outs.append((toks, lens))
            (te, le), (tg, lg) = outs
            if not (torch.equal(te, tg) and torch.equal(le, lg)):
                fail(f"60 {label}: engine-shaped segment {k}: the graph loop's tokens differ from the eager loop's")
            last = (lg - 1).clamp(min=0)
            curs = [t.gather(1, last[:, None])[:, 0] for t in (te, tg)]
            pos += int(lg.max())
        if not (_same_bits(torch, kv_e.k, kv_g.k) and torch.equal(gens[0].get_state(), gens[1].get_state())):
            fail(f"60 {label}: engine-shaped segments left other caches or generator states")
        if dev.type == "cuda":
            capture_before_eager_raises(torch, label, params, cfg, kv, cur, spk)
        # ms a token of both loops: GRAPH_TIMED's steps from pos 128, the CFG pair
        noise = _graph_noise(torch, GRAPH_TIMED[1], 1, vocab, gen, dev, eoa_free=True)
        ms = _timed_loops(torch, fs, params, cfg, base, cur, spk, noise)
        results[label] = ms
        spread = {k: (float(np.mean(ms[k])), min(ms[k]), max(ms[k])) for k in ("eager", "graph")}
        steps = 64
        profile = graph_step_profile(torch, lambda: (fs.decode(params, cfg, cur, GRAPH_TIMED[0], base, spk, steps,
                                                               noise=noise), sync(torch, dev)), steps) \
            if dev.type == "cuda" else "not profiled off the card"
        shown.append(
            f"{label} ({route}): {total} tokens over the {len(GRAPH_SEGMENTS)} segments equal, {launches} {route} "
            f"launches credited ({per_step} a step), ragged, 3-row, two temperatures and {n_seg} engine-shaped "
            f"segments equal; ms a token eager {spread['eager'][0]:.4f} (min {spread['eager'][1]:.4f}, max "
            f"{spread['eager'][2]:.4f}), "
            f"graph {spread['graph'][0]:.4f} (min {spread['graph'][1]:.4f}, max {spread['graph'][2]:.4f}), the "
            f"graph loop's first call on a cache (an eager warm step and a capture) {ms['first_ms']:.1f} ms for "
            f"{GRAPH_TIMED[1]} steps; graph profile: {profile}")
        del params, base, kv, base8, kv8, base3, kv3, base_e, kv_e, kv_g
        fs.release_graphs()
        gc_collect()
        empty_cache(torch, dev)
    print(f"[60 graph-decode] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d, graph loop against the eager loop bit for "
          f"bit (tokens, lengths, caches, launch counts), a capture before any eager call raising; "
          + "; ".join(shown) + f"; {time.perf_counter() - t_phase:.1f} s")
    return results


# ---------------------------------------------------------------- phase 61: the graph step of every other route

# (label, weights, cache format, first-stage overrides, the route, its kernels' launches a layer a step, the
# batch of the 192-token segments); a batch of 8 (16 cache rows) is ragged, and the route's 3-row case takes a
# batch of 3 (9 rows): at 8 rows or fewer those two routes would take K7 or K3
ROUTES_61 = (
    ("int4 int8-cache", "int4", "int8", {}, "K5/K6", {"k5_launches": 1, "k6_launches": 1}, 1),
    ("int4 packed-cache", "int4", "int8_packed", {}, "K5/K6", {"k5_launches": 1, "k6_launches": 1}, 1),
    ("int8_plain", "int8_plain", None, {}, "K9/K10", {"k9_launches": 1, "k10_launches": 1}, 1),
    ("gqa bf16", None, None, {"n_local_heads": 2}, "GQA", {"k4_launches": 1}, 1),
    ("gqa int8_plain", "int8_plain", None, {"n_local_heads": 2}, "K9/K10",
     {"k11_launches": 2, "k4_launches": 1, "k10_launches": 1}, 1),
    ("int4g g128", "int4g", None, {}, "K12/K13+K1", {"k12_launches": 5, "k1_launches": 1}, 1),
    ("int4g-packed g128", "int4g_packed", None, {}, "K12/K13+K1", {"k13_launches": 5, "k1_launches": 1}, 1),
    ("int8 16 rows", "int8", None, {}, "K8+K1", {"k8_launches": 5, "k1_launches": 1}, 8),
    ("int4 16 rows", "int4", None, {}, "int4-unfused", {"k2_launches": 5, "k1_launches": 1}, 8),
    ("bf16 int8-cache", None, "int8", {}, "dequant-cache", {}, 1),
)
# phase 61's: 128 tokens across every window bucket to the cache's end (its eager steps cost about 17 ms each,
# so it stays short: the whole script has a 1200 s limit)
GRAPH_SEGMENTS_61 = ((360, 24), (488, 24), (1000, 24), (2000, 56))
GRAPH_SIDE_61 = 16  # steps of phase 61's 3-row case, and of its ragged case on routes without block attention
# (pos, steps, each row's left padding) of the ragged case on the routes through attn_row_kernel's block variant
# (K5, K9): a row that starts at 300 crosses pos 512, where a split of the bucket's plan ends at pos and only the
# split that holds pos may make the new row
GRAPH_CROSS_61 = (370, 160, (0, 17, 300, 5))
GRAPH_TIMED_61 = (128, 16)  # phase 61's timed loops: 16 steps from pos 128
GRAPH_PROFILED_61 = 16  # steps of phase 61's profiled graph loop
# (pos, starts, NaN past pos): at 512 a split of the bucket's plan ends at pos, and the row starting at 300 has a
# tile over pos in that split, which must take no new row
DEVICE_POS_61 = ((0, None, False), (255, None, False), (512, (300, 2047), True), (1000, (300, 2047), True),
                 (2047, (1, 2047), True))
K11_GQA_SETS = 8  # weight sets the GQA K11 timing turns over


def _quantize_61(torch, dense, mode):
    from metavoice_tpu_torch.ops import quantized as Q

    return {None: lambda p: p, "int4": Q.quantize_params_int4_i32, "int8": Q.quantize_params_int8_i32,
            "int8_plain": Q.quantize_params_int8, "int4g": Q.quantize_params_int4,
            "int4g_packed": Q.quantize_params_int4_packed}[mode](dense)


def route_graph_case(torch, label: str, route: str, params, cfg, fmt, per_layer: dict, b: int, gen, dev) -> str:
    """Phase 61 for one route: the graph loop against decode_eager on
    GRAPH_SEGMENTS_61 (128 tokens over every window bucket to the cache's end;
    ``b`` rows, ragged when 8), a ragged batch of 4 with per-row knobs
    (routes of 1), 3-row guidance, a capture before any eager call, then ms
    a token of both loops and a profiled graph step -> its line."""
    from metavoice_tpu_torch.core import tokens as T
    from metavoice_tpu_torch.models import first_stage as fs

    vocab = cfg.vocab_sizes[0]
    eot = T.TEXT_OFFSET + 256
    want_route = "graph" if dev.type == "cuda" else "eager"
    row = {"temperature": (1.0, 0.7, 1.3, 0.9), "top_p": (0.95, 0.8, 0.9, 1.0), "guidance_scale": (3.0, 2.0, 1.5, 3.0)}

    def knobs_of(n_rows):
        return {k: torch.tensor((v * 2)[:n_rows], device=dev).reshape(n_rows, 1) for k, v in row.items()}

    def pads_of(n_rows):
        return None if n_rows == 1 else torch.tensor((GRAPH_RAGGED * 2)[:n_rows], dtype=torch.int32, device=dev)

    cur = torch.randint(0, T.END_OF_AUDIO_TOKEN, (b,), generator=gen, device=dev)
    spk = torch.randn((b, cfg.speaker_emb_dim), generator=gen, device=dev)
    base = _filled(torch, cfg, 2 * b, gen, dev, fmt)
    kv = _filled(torch, cfg, 2 * b, gen, dev, fmt)
    if fs.step_route(params, cfg, 2 * b, kv) != route:
        fail(f"61 {label}: a step of {2 * b} rows takes {fs.step_route(params, cfg, 2 * b, kv)}, not {route}")
    total, launches = 0, {}
    for pos, n in GRAPH_SEGMENTS_61:
        noise = _graph_noise(torch, n, b, vocab, gen, dev, eoa_free=True)
        tokens, lengths, counts, got = graph_vs_eager(torch, f"{label} pos {pos}", params, cfg, base, kv, cur, pos, n,
                                                      spk, noise=noise, pad_lens=pads_of(b), phase="61",
                                                      **knobs_of(b))
        steps = min(n, cfg.block_size - pos)
        want = {k: v * cfg.n_layer * steps for k, v in per_layer.items()} if dev.type == "cuda" else {}
        if got != want_route or int(lengths.min()) != steps or {k: c for k, c in counts.items() if c} != want:
            fail(f"61 {label} pos {pos}: route {got}, {int(lengths.min())} tokens of {steps} steps, launches "
                 f"{ {k: c for k, c in counts.items() if c} } where the route makes {want}")
        total += int(lengths.sum())
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
    shown = [f"{total} tokens over the {len(GRAPH_SEGMENTS_61)} segments at {2 * b} rows"]
    if b == 1:  # a ragged batch of 4 with starts and per-row knobs
        block = "k5_launches" in per_layer or "k9_launches" in per_layer
        pos4, n4, pads4 = GRAPH_CROSS_61 if block else (200, GRAPH_SIDE_61, GRAPH_RAGGED)
        base4 = _filled(torch, cfg, 8, gen, dev, fmt)
        kv4 = _filled(torch, cfg, 8, gen, dev, fmt)
        _, lengths, _, _ = graph_vs_eager(
            torch, f"{label} ragged batch of 4", params, cfg, base4, kv4,
            torch.randint(0, T.END_OF_AUDIO_TOKEN, (4,), generator=gen, device=dev), pos4, n4,
            torch.randn((4, cfg.speaker_emb_dim), generator=gen, device=dev), phase="61",
            pad_lens=torch.tensor(pads4, dtype=torch.int32, device=dev),
            noise=_graph_noise(torch, n4, 4, vocab, gen, dev, eoa_free=block), **knobs_of(4))
        if block and int(lengths.min()) != n4:
            fail(f"61 {label} ragged batch of 4: {int(lengths.min())} tokens of {n4} steps")
        shown.append(f"a ragged batch of 4 ({n4} steps from pos {pos4}, rows starting at {', '.join(map(str, pads4))})")
        del base4, kv4
    b3 = 3 if b > 1 else 1  # 3-row guidance: 9 rows on the 16-row routes
    base3 = _filled(torch, cfg, 3 * b3, gen, dev, fmt)
    kv3 = _filled(torch, cfg, 3 * b3, gen, dev, fmt)
    graph_vs_eager(torch, f"{label} 3 rows of {b3}", params, cfg, base3, kv3, cur[:b3], 300, GRAPH_SIDE_61, spk[:b3],
                   phase="61", cfg_rows=3, prompt_guidance_scale=1.5, end_of_text_token=eot, pad_lens=pads_of(b3),
                   noise=_graph_noise(torch, GRAPH_SIDE_61, b3, vocab, gen, dev), **knobs_of(b3))
    shown.append(f"3-row guidance ({3 * b3} rows)")
    del base3, kv3
    if route == "dequant-cache":
        shown.append("no merge counter to make (plain PyTorch)")
    elif dev.type == "cuda":
        capture_before_eager_raises(torch, label, params, cfg, kv, cur, spk, phase="61", route=route)
        shown.append("a capture before any eager call raising")
    noise = _graph_noise(torch, GRAPH_TIMED_61[1], b, vocab, gen, dev, eoa_free=True)
    knobs = knobs_of(b)
    ms = _timed_loops(torch, fs, params, cfg, base, cur, spk, noise, timed=GRAPH_TIMED_61)
    spread = {k: (sum(ms[k]) / len(ms[k]), min(ms[k]), max(ms[k])) for k in ("eager", "graph")}
    steps = GRAPH_PROFILED_61
    profile = graph_step_profile(torch, lambda: (fs.decode(params, cfg, cur, GRAPH_TIMED_61[0], base, spk, steps,
                                                           noise=noise, pad_lens=pads_of(b), **knobs),
                                                 sync(torch, dev)), steps) \
        if dev.type == "cuda" else "not profiled off the card"
    del base, kv
    fs.release_graphs()
    return (f"{label} ({route}, {', '.join(f'{k[:-9]} {v}' for k, v in per_layer.items()) or 'no kernel'} a layer "
            f"a step; {sum(launches.values())} launches credited): {', '.join(shown)} equal bit for bit; ms a token "
            f"eager {spread['eager'][0]:.4f} (min {spread['eager'][1]:.4f}, max {spread['eager'][2]:.4f}), graph "
            f"{spread['graph'][0]:.4f} (min {spread['graph'][1]:.4f}, max {spread['graph'][2]:.4f}) at {2 * b} rows, "
            f"first graph call {ms['first_ms']:.1f} ms for {GRAPH_TIMED_61[1]} steps; graph profile: {profile}")


def _garbage_past(torch, kv, pos: int):
    """NaN past pos: in the values of a float cache, in the scales of a quantized one."""
    if kv.k_scale is None:
        kv.k[:, pos + 1 :] = float("nan")
        kv.v[:, pos + 1 :] = float("nan")
    elif kv.packed:
        p = torch.arange(pos + 1, kv.max_seq_len, device=kv.k.device)
        for t in (kv.k_scale, kv.v_scale):
            t[:, p % 4, p // 4] = float("nan")
    else:
        kv.k_scale[:, pos + 1 :] = float("nan")
        kv.v_scale[:, pos + 1 :] = float("nan")


def device_pos_kernels(torch, dense, gqa_dense, cfg, gqa_cfg, gen, dev) -> str:
    """K4 (GQA, T = 1), K5 (bf16, int8 and packed caches) and K9 with pos
    on the device, planned at the window bucket: at each DEVICE_POS_61 case
    (starts, NaN past pos) the host-int call's bits (y and every cache
    field) and the plain version within the kernel's tolerance; each timed
    per layer from a CUDA graph at K5_TIMED, host int and device pos -> its
    line."""
    from metavoice_tpu_torch.ops import attention as A
    from metavoice_tpu_torch.ops import quantized as Q

    b, s, n_layer = MAIN_SHAPE["b"], cfg.block_size, cfg.n_layer
    q4 = Q.quantize_params_int4_i32(dense)["layers"]
    w5 = (q4["wqkv"]["pw"], q4["wqkv"]["sc"], q4["wo"]["pw"], q4["wo"]["sc"])
    del q4
    q8 = Q.quantize_params_int8(dense)["layers"]
    w9 = [(q8["wqkv"]["q"][li], q8["wqkv"]["scales"][li], q8["wo"]["q"][li], q8["wo"]["scales"][li])
          for li in range(n_layer)]
    xa = torch.randn((b, cfg.dim), generator=gen, device=dev).to(torch.bfloat16)
    qk = torch.randn((b, cfg.n_head, 1, cfg.head_dim), generator=gen, device=dev).to(torch.bfloat16)
    kn, vn = (torch.randn((b, 2, 1, cfg.head_dim), generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    kernels = {
        "K4": (gqa_cfg, None, lambda kv, li, p, st, fn=A.decode_attention_multi, **kw:
               fn(qk, kn, vn, kv.k, kv.v, li, p, st, **kw)[0], A.decode_attention_multi_reference, K4_TOL),
        "K9": (cfg, None, lambda kv, li, p, st, fn=A.decode_attention_block_int8, **kw:
               fn(xa, *w9[li], kv.k, kv.v, li, p, cfg.n_head, st, **kw)[0], A.decode_attention_block_int8_reference,
               K9_TOL),
    }
    for fmt in ("int8", "int8_packed", None):
        kernels[f"K5 {fmt or 'bf16'}"] = (
            cfg, fmt, lambda kv, li, p, st, fn=A.decode_attention_block_int4, **kw:
            fn(xa, *w5, kv.k, kv.v, li, p, cfg.n_head, n_kv_head=cfg.n_local_heads, starts=st, k_scale=kv.k_scale,
               v_scale=kv.v_scale, **kw)[0], A.decode_attention_block_int4_reference, K5_TOL)
    layer = 5
    shown, worst = [], {}
    for name, (kcfg, fmt, call, plain, tol) in kernels.items():
        base = _filled(torch, kcfg, b, gen, dev, fmt)
        for pos, starts, nan in DEVICE_POS_61:
            st = None if starts is None else torch.tensor(starts, dtype=torch.int32, device=dev)
            kvs = [_kv_clone(base) for _ in range(3)]
            if nan:
                for kv in kvs:
                    _garbage_past(torch, kv, pos)
            window = A.attention_window(pos + 1, s)
            y = call(kvs[0], layer, pos, st)
            yd = call(kvs[1], layer, torch.tensor(pos, dtype=torch.int32, device=dev), st, window=window)
            ref = call(kvs[2], layer, pos, st, fn=plain)
            what = f"61 {name} pos {pos} starts {starts} NaN {nan}"
            if not (_same_bits(torch, y, yd) and all(_same_bits(torch, a, c) for a, c in
                                                     zip(_kv_fields(kvs[0]), _kv_fields(kvs[1])))):
                fail(f"{what}: pos on the device differs from the host-int call")
            if not torch.isfinite(yd.float()).all():
                fail(f"{what}: not finite")
            err = (yd.float() - ref.float()).abs().max().item() / max(ref.float().abs().max().item(), 1e-30)
            worst[name] = max(worst.get(name, 0.0), err)
            if err > tol:
                fail(f"{what}: {err:.3g} of max |ref| from the plain version, tol {tol}")
        times = []
        pos_t = torch.zeros((), dtype=torch.int32, device=dev)
        for pos in K5_TIMED:
            pos_t.fill_(pos)
            window = A.attention_window(pos + 1, s)
            host = _layers_ms(torch, lambda li: call(base, li, pos, None), n_layer)[0]
            on_dev = _layers_ms(torch, lambda li: call(base, li, pos_t, None, window=window), n_layer)[0]
            times.append(f"pos {pos} {host:.4f} / {on_dev:.4f}")
        shown.append(f"{name}: within {worst[name]:.3g} of max |ref| (tol {tol}); ms a layer host int / device pos "
                     f"{', '.join(times)}")
        del base
    return "; ".join(shown)


def k11_gqa_times(torch, cfg, gen, dev) -> str:
    """K11 at a GQA int8_plain decode step's shapes (M 2: qkv 2048 x 2560,
    wo 2048 x 2048), each on K11_GQA_SETS weight sets in turn, from a CUDA
    graph, beside torch._weight_int8pack_mm, torch.matmul on the
    bf16-dequantized weight and the bound -> its line."""
    from metavoice_tpu_torch.ops import quantized as Q

    m, d = 2, cfg.dim
    shown, lib_name = [], "torch._weight_int8pack_mm"
    for name, n in (("qkv", d + 2 * cfg.n_local_heads * cfg.head_dim), ("wo", d)):
        mats = [Q.quantize_int8(torch.randn((d, n), generator=gen, device=dev) * 0.02) for _ in range(K11_GQA_SETS)]
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        ref = Q.matmul_int8_reference(x, *mats[0])
        got = Q.matmul_int8(x, *mats[0])
        if (got.float() - ref.float()).abs().max().item() > K11_TOL * ref.float().abs().max().item() + \
                _bf16_ulp(torch, ref).max().item():
            fail(f"61 K11 GQA {name}: disagrees with its plain version")
        t_k = _layers_ms(torch, lambda i: Q.matmul_int8(x, *mats[i]), K11_GQA_SETS)[0]
        t_l, lib_name, t_m = _int8pack_ms(torch, x, mats, ref, lib_name, "61 K11 GQA")
        bound_ms, bound_by = bound(m * d * 2 + d * n + n * 4 + m * n * 2, 2.0 * m * d * n, BF16_FLOP_S)
        route, cut = Q.int8_route(m, d, n)
        shown.append(f"{name} {d}x{n} ({route} {'x'.join(map(str, cut))}): kernel {t_k:.4f} ms, {lib_name} "
                     f"{t_l:.4f}, torch.matmul (bf16 dequantized) {t_m:.4f}, bound {bound_ms:.4f} ({bound_by})")
        del mats
    return "; ".join(shown)


def phase_graph_decode_routes(torch, dev: str = "cuda", small: bool = False) -> None:
    """61: the graph loop against the eager loop at full width on every
    route of ROUTES_61, K4/K5/K9 with pos on the device, and K11 at GQA's
    shapes."""
    from metavoice_tpu_torch.core.config import first_stage_config
    from metavoice_tpu_torch.models import transformer as tfm

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    widths = dict(n_layer=2, n_head=8, dim=1024) if small else {}
    cfg = first_stage_config(**widths)
    gqa_cfg = first_stage_config(**widths, n_local_heads=2)
    gen = torch.Generator(device=dev).manual_seed(61)
    dense = tfm.init_params(cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    gqa_dense = tfm.init_params(gqa_cfg, device=dev, generator=gen, dtype=torch.bfloat16)
    shown = []
    for label, mode, fmt, over, route, per_layer, b in ROUTES_61:
        t0 = time.perf_counter()
        rcfg, rdense = (gqa_cfg, gqa_dense) if over else (cfg, dense)
        params = _quantize_61(torch, rdense, mode)
        line = route_graph_case(torch, label, route, params, rcfg, fmt, per_layer, b, gen, dev)
        shown.append(f"{line}; {time.perf_counter() - t0:.1f} s")
        del params
        gc_collect()
        empty_cache(torch, dev)
    kernels = k11 = "not run off the card"
    if dev.type == "cuda":
        kernels = device_pos_kernels(torch, dense, gqa_dense, cfg, gqa_cfg, gen, dev)
        k11 = k11_gqa_times(torch, gqa_cfg, gen, dev)
    print(f"[61 graph-decode-routes] {cfg.n_layer}L/{cfg.n_head}H/{cfg.dim}d, vocab {cfg.vocab_sizes[0]}, the graph "
          f"loop against decode_eager bit for bit (tokens, lengths, every cache field, launch counts): "
          + "; ".join(shown) + f". Pos on the device (the host-int call's bits, the plain version): {kernels}. "
          f"K11 on a GQA int8_plain step's shapes at M 2, device time from a CUDA graph: {k11}; "
          f"{time.perf_counter() - t_phase:.1f} s")


def gc_collect():
    import gc

    gc.collect()


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
        with tempfile.TemporaryDirectory() as ckdir:  # phase 46's files, removed after phase 49
            files = phase_checkpoint_files(torch, ckdir)
            ckpt = phase_from_checkpoints(torch, ckdir, ref, files)
            files.pop("model")  # the seeded trees: phases 48-49 read the files
            gc_collect()
            torch.cuda.empty_cache()
            phase_cli(torch, ckdir, ref, files, ckpt)
            phase_capacity_plan(torch, ckdir, ref, files, ckpt)
        del files, ckpt
        gc_collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_finetune_parity(torch)
        phase_finetune_full_width(torch, workdir, ref)
        phase_finetune_e2e(torch, workdir)
        print(f"[50-52 training] {time.perf_counter() - t0:.1f} s")
        gc_collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_small_mbd(torch)
        phase_synth_mbd(torch, workdir, ref)
        phase_train_mbd_df(torch)
        print(f"[53-55 mbd/df] {time.perf_counter() - t0:.1f} s")
        gc_collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_tp_small(torch)
        phase_tp_synth(torch, workdir, ref)
        print(f"[56-57 tensor parallel] {time.perf_counter() - t0:.1f} s")
        gc_collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_sharded_small(torch)
        phase_sharded_full_width(torch, smi)
        print(f"[58-59 sharded training] {time.perf_counter() - t0:.1f} s")
        gc_collect()
        torch.cuda.empty_cache()
        phase_graph_decode(torch)
        gc_collect()
        torch.cuda.empty_cache()
        phase_graph_decode_routes(torch)
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
