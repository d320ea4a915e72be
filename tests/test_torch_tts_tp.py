"""``TTS(tensor_parallel=2)``, the port's user-facing TP path, in two CPU
ranks over gloo (``parallel/mesh.spawn``), with the JAX package's
tests/test_tts_tp.py as the oracle: ``synthesise`` writes a wav on the
leader (tensor index 0) and returns None on the other rank, streaming
yields finite chunks on the leader and nothing elsewhere, the engine
refuses a TP instance, and the refusals keep JAX's messages and order
(plain int8, a pre-quantized first stage, a draft; without a process group
the message names ``spawn`` and ``torchrun``). Both ranks draw the same
first-stage tokens; a leader's stream closed early, a reference that
fails on the leader and a two-chunk text whose first chunk fails to render
on the leader leave the group in step; ``TTS.from_checkpoints(...,
tensor_parallel=2)`` reads reference-format ``.pt`` files on each rank.
The ranks of ``cli serve --tensor_parallel 2`` (``cli.serve_tp_rank``)
serve requests from the same world and stop on SIGTERM.

JAX is imported inside the tests only: the spawned ranks import this
module, and must not import the JAX package.
"""

import argparse
import dataclasses
import json
import os
import signal
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke as cs
from metavoice_tpu_torch import cli
from metavoice_tpu_torch.models import first_stage as fs
from metavoice_tpu_torch.ops import quantized as Q
from metavoice_tpu_torch.parallel import mesh as pmesh
from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
from metavoice_tpu_torch.runtime.tts import TTS
from metavoice_tpu_torch.utils import audio_io as aio

TEXT = "Tensor parallel hello."
NEW = 40  # first-stage tokens a chunk
# two chunks (chunk_text cuts it at the sentence): two first stages in one call
TWO_CHUNKS = ("The first sentence of a request long enough to be cut in two, so that one call runs two first stages "
              "on every rank of the group. The second sentence follows it here, and it is long enough that the two "
              "of them no longer fit in one chunk.")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    sr = 16000
    t = np.arange(31 * sr) / sr
    path = str(tmp_path_factory.mktemp("refs") / "ref.wav")
    aio.write_wav(path, (0.3 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), sr)
    return path


def _tts_rank(rank: int, out_dir: str, ref: str, files: dict) -> dict:
    """One rank: a small TP TTS (bf16, then int4 on an int8 cache), driven
    through every entry point -> what each returned."""
    torch.set_num_threads(1)
    seqs = []
    generate = fs.generate

    def recording(*a, **kw):
        seq = generate(*a, **kw)
        seqs.append(seq.tolist())
        return seq

    fs.generate = recording  # TTS calls it through the module
    tts = TTS.from_random(small=True, device="cpu", output_dir=out_dir, tensor_parallel=2)
    out = {"wqkv": tuple(tts.c.first_stage_params["layers"]["wqkv"].shape), "leader": tts.mesh.leader}
    tts.warmup(prompt_buckets=(32,), vocoder_frame_buckets=(25,), guidance_variants=(3.0,))
    out["path"] = tts.synthesise(TEXT, ref, max_new_tokens=NEW)
    out["steps"] = tts.stats["decode_steps"]
    out["chunks"] = list(tts.synthesise_streaming("Stream me in parallel.", ref, segment_tokens=16,
                                                  first_segment_tokens=8, max_new_tokens=NEW))
    stream = tts.synthesise_streaming("Closed early.", ref, segment_tokens=8, first_segment_tokens=8,
                                      max_new_tokens=NEW)
    if tts.mesh.leader:  # the leader's client goes away after one chunk
        next(stream)
        stream.close()
    else:
        list(stream)
    if tts.mesh.leader:  # the first chunk's render fails on the leader alone
        render = tts._render

        def fail_once(*a, **kw):
            tts._render = render
            raise RuntimeError("wav predicted is shorter than 400ms!")

        tts._render = fail_once
    try:
        out["fault"] = tts.synthesise(TWO_CHUNKS, ref, max_new_tokens=16)
    except RuntimeError as e:
        out["fault"] = str(e)
    out["fault_steps"] = tts.stats["decode_steps"]
    out["g3"] = tts.synthesise(TEXT, ref, max_new_tokens=16, guidance_scale=(2.0, 1.5))
    try:
        tts.synthesise(TEXT, os.path.join(out_dir, "missing.wav"))
    except FileNotFoundError as e:  # every rank raises the leader's error
        out["missing"] = str(e)
    try:
        ContinuousBatchingEngine(tts)
    except ValueError as e:
        out["engine"] = str(e)
    q = TTS.from_random(small=True, device="cpu", output_dir=out_dir, tensor_parallel=2, quantisation_mode="int4",
                        kv_cache_dtype="int8")
    out["int4"] = (q.quantisation_mode, q.decode_route, sorted(q.c.first_stage_params["layers"]["w1"]),
                   q._kv_cache.k_scale is not None, q.synthesise(TEXT, ref, max_new_tokens=NEW))
    out["seqs"] = seqs
    # from reference-format files: each rank reads the dense .pt and keeps its shard
    with pytest.warns(UserWarning, match="encodec_path"):
        f = TTS.from_checkpoints(files["first"], files["second"], files["spk"], device="cpu", tensor_parallel=2,
                                 output_dir=out_dir)
    out["ckpt"] = (tuple(f.c.first_stage_params["layers"]["wqkv"].shape), f.synthesise(TEXT, ref, max_new_tokens=16))
    out["serve"] = _serve(tts, out_dir, ref)
    return out


def _serve(tts, out_dir: str, ref: str):
    """``cli serve --tensor_parallel 2``'s ranks over ``tts``: the leader
    serves HTTP while a thread of its own sends it requests, then SIGTERM
    -> the leader's (status, first bytes) a request; None on the follower."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = argparse.Namespace(host="127.0.0.1", port=port, output_dir=out_dir, max_new_tokens=24)
    if not tts.mesh.leader:
        cli.serve_tp_rank(tts, args)
        return None
    url, got = f"http://127.0.0.1:{port}", []

    def post(body: dict):
        req = urllib.request.Request(f"{url}/tts", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, r.read()[:4]
        except urllib.error.HTTPError as e:
            return e.code, b""

    def client():
        try:
            for _ in range(200):
                try:
                    urllib.request.urlopen(f"{url}/health", timeout=5).close()
                    break
                except OSError:
                    time.sleep(0.05)
            for stream in ("false", "true"):
                got.append(post({"text": "hello ranks", "speaker_ref_path": ref, "stream": stream}))
            # the leader reports a missing reference, the follower stays in step
            got.append(post({"text": "x", "speaker_ref_path": os.path.join(out_dir, "missing.wav")}))
            got.append(post({"text": "hello ranks", "speaker_ref_path": ref}))
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=client, daemon=True).start()
    cli.serve_tp_rank(tts, args)
    return got


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ref_wav):
    out = str(tmp_path_factory.mktemp("outputs"))
    d = tmp_path_factory.mktemp("ckpt")
    comps = TTS.from_random(small=True, device="cpu", seed=3).c
    rng = np.random.default_rng(9)
    files = {k: str(d / f"{k}.pt") for k in ("first", "second", "spk")}
    torch.save(cs.gpt_checkpoint(comps.first_stage_params, comps.first_stage_cfg, cs.CKPT_TOKENIZER), files["first"])
    torch.save(cs.gpt_checkpoint(comps.second_stage_params, comps.second_stage_cfg), files["second"])
    torch.save(cs.speaker_checkpoint(torch, lambda *shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.1).astype(np.float32)))[0], files["spk"])
    return pmesh.spawn(_tts_rank, 2, args=(out, ref_wav, files), devices=["cpu"] * 2, timeout=120, deadline=400)


def test_tp_synthesise_writes_wav_on_the_leader(ranks):
    lead, other = ranks
    assert lead["leader"] and not other["leader"]
    assert os.path.exists(lead["path"]) and other["path"] is None
    wav, sr = aio.read_wav(lead["path"])
    assert sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()
    # each rank holds its half of the heads: wqkv's columns [q_r | k_r | v_r]
    assert lead["wqkv"] == other["wqkv"] == (2, 128, 3 * 128 // 2)
    assert lead["steps"] == other["steps"] > 0
    # both ranks drew the same first-stage tokens, in every call (warmup, synthesise, the 3-row guidance)
    assert lead["seqs"] == other["seqs"] and len(lead["seqs"]) >= 3
    for path in (lead["g3"], lead["int4"][-1]):
        wav, _ = aio.read_wav(path)
        assert len(wav) > 0 and np.isfinite(wav).all()
    assert other["g3"] is None and other["int4"][-1] is None


def test_tp_streaming_segments(ranks):
    lead, other = ranks
    assert len(lead["chunks"]) >= 1 and other["chunks"] == []
    assert all(c.dtype == np.float32 and len(c) > 0 and np.isfinite(c).all() for c in lead["chunks"])


def test_tp_group_stays_in_step_after_faults(ranks):
    lead, other = ranks
    # a stream closed early on the leader, then a synthesise: the group met again (same tokens on both)
    assert lead["g3"] is not None
    assert "missing.wav" in lead["missing"] and other["missing"] == lead["missing"]
    # a render that failed on the leader in the first of two chunks: both ranks ran both first stages,
    # the leader raised, and the next call (g3) met in step
    assert lead["fault"] == "wav predicted is shorter than 400ms!" and other["fault"] is None
    assert lead["fault_steps"] == other["fault_steps"] > 16


def test_tp_quantized_per_shard(ranks):
    mode, route, leaves, quantized_cache, _ = ranks[0]["int4"]
    assert (mode, route, leaves, quantized_cache) == ("int4", "unfused", ["pw", "sc"], True)
    assert ranks[1]["int4"][:4] == ranks[0]["int4"][:4]


def test_tp_from_checkpoints(ranks):
    (lead_shape, lead_path), (other_shape, other_path) = ranks[0]["ckpt"], ranks[1]["ckpt"]
    assert lead_shape == other_shape == (2, 128, 3 * 128 // 2)
    assert os.path.exists(lead_path) and other_path is None


def test_engine_rejects_tp_instance(ranks):
    for r in ranks:
        assert "does not support tensor_parallel" in r["engine"]


@pytest.fixture(scope="module")
def comps():
    return TTS.from_random(small=True, device="cpu").c


def test_tp_refusals_in_jax_order(comps):
    with pytest.raises(ValueError, match="not supported with"):
        TTS(comps, device="cpu", tensor_parallel=2, quantisation_mode="int8_plain")
    packed = dataclasses.replace(comps, first_stage_params=Q.quantize_params_int4_i32(comps.first_stage_params))
    with pytest.raises(ValueError, match="requires a DENSE"):
        TTS(packed, device="cpu", tensor_parallel=2)
    with pytest.raises(ValueError, match="requires a DENSE"):  # checked before the mode, as in JAX
        TTS(packed, device="cpu", tensor_parallel=2, quantisation_mode="int8_plain")
    draft = dict(draft_params=comps.first_stage_params, draft_cfg=comps.first_stage_cfg)
    with pytest.raises(ValueError, match="speculative decoding is not supported with tensor_parallel"):
        TTS(comps, device="cpu", tensor_parallel=2, **draft)
    with pytest.raises(RuntimeError, match=r"spawn.*torchrun"):  # no process group
        TTS(comps, device="cpu", tensor_parallel=2)


def test_cli_tp_needs_a_card_a_rank(ref_wav, tmp_path):
    n = torch.cuda.device_count() + 2  # more ranks than cards, and always TP
    with pytest.raises(ValueError, match="cards, one a rank"):
        cli.main(["synth", "--random_weights", "--small", "--tensor_parallel", str(n), "--text", "x",
                  "--spk_cond_path", ref_wav, "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="batching engine"):
        cli.main(["serve", "--random_weights", "--small", "--device", "cpu", "--tensor_parallel", "2",
                  "--batching", "2", "--output_dir", str(tmp_path)])


def test_cli_serve_tensor_parallel(ranks):
    lead, other = ranks
    assert other["serve"] is None
    # two requests answered (a wav, a live stream), a missing reference refused, one more answered
    assert [code for code, _ in lead["serve"]] == [200, 200, 500, 200], lead["serve"]
    assert all(head == b"RIFF" for code, head in lead["serve"] if code == 200)
