"""The port's telemetry (telemetry.py, TTS's user_ran_tts event) and
profiling hooks (utils/profiling.py) against the JAX package's: the spooled
record and the event have JAX's keys, the opt-outs hold, the decode metrics
keep JAX's formulas, and a trace that was asked for writes one or raises."""

import json
import os

import numpy as np
import pytest
import torch

from metavoice_tpu_torch import telemetry as tele
from metavoice_tpu_torch.runtime.tts import TTS
from metavoice_tpu_torch.utils import audio_io as aio
from metavoice_tpu_torch.utils import profiling as prof

# the JAX package's user_ran_tts properties (metavoice_tpu/runtime/tts.py:1022-1044)
EVENT_KEYS = {"model_name", "text", "temperature", "guidance_scale", "top_p", "spk_ref_path", "speech_duration_s",
              "time_to_synth_s", "real_time_factor", "quantisation_mode", "seed", "device", "telemetry_origin"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: beside the suite's other worker processes, a pool
    of torch threads each spends far longer waiting than working."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_spool_has_the_jax_record(tmp_path):
    jtele = pytest.importorskip("metavoice_tpu.telemetry")
    ours, theirs = tele.TelemetryClient(str(tmp_path / "a"), enabled=True), jtele.TelemetryClient(
        str(tmp_path / "b"), enabled=True)
    for client in (ours, theirs):
        client.capture(tele.TelemetryEvent(name="e", properties={"x": 1}))
    a, b = (json.loads(open(tmp_path / d / "telemetry.jsonl").read()) for d in ("a", "b"))
    assert a.keys() == b.keys() == {"distinct_id", "event", "properties", "timestamp"}
    assert (a["event"], a["properties"]) == (b["event"], b["properties"])
    assert tele.hash_dictionary({"b": 1, "a": 2}) == jtele.hash_dictionary({"b": 1, "a": 2})


def test_opt_outs(tmp_path, monkeypatch):
    assert not tele.TelemetryClient(str(tmp_path)).enabled  # under pytest
    assert not tele.default_client.enabled
    monkeypatch.delitem(__import__("sys").modules, "pytest")
    monkeypatch.setenv("ANONYMIZED_TELEMETRY", "False")
    assert not tele.TelemetryClient(str(tmp_path)).enabled
    monkeypatch.setenv("ANONYMIZED_TELEMETRY", "True")
    assert tele.TelemetryClient(str(tmp_path)).enabled


def test_synthesise_captures_user_ran_tts(tmp_path):
    client = tele.TelemetryClient(str(tmp_path / "spool"), enabled=True)
    tts = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path), telemetry_client=client,
                          telemetry_origin="tests")
    sr = 16000
    ref = str(tmp_path / "ref.wav")
    aio.write_wav(ref, (0.3 * np.sin(2 * np.pi * 150 * np.arange(sr) / sr)).astype(np.float32), sr)
    tts.synthesise("Hello.", ref, max_new_tokens=8)
    rec = json.loads(open(tmp_path / "spool" / "telemetry.jsonl").read())
    assert rec["event"] == "user_ran_tts" and set(rec["properties"]) == EVENT_KEYS
    assert rec["properties"]["device"] == "cpu" and rec["properties"]["telemetry_origin"] == "tests"


def test_decode_metrics_keep_jax_formulas():
    jprof = pytest.importorskip("metavoice_tpu.utils.profiling")
    kw = dict(tokens=300, seconds=1.7, param_bytes=2_500_000_000, params=1_240_000_000)
    ours, theirs = prof.DecodeMetrics(**kw), jprof.DecodeMetrics(**kw)
    for k in ("tokens_per_sec", "bandwidth_gb_s", "stage1_rtf"):
        assert getattr(ours, k) == getattr(theirs, k)
    # the same formula over the card's peak (JAX divides by its TPU's)
    assert ours.mfu * prof.H100_SXM_PEAK_BF16_FLOPS == pytest.approx(theirs.mfu * jprof.V5E_PEAK_BF16_FLOPS)
    assert ours.summary().keys() == theirs.summary().keys()
    sw = prof.Stopwatch()
    sw.lap("a")
    sw.lap("a")
    assert list(sw.laps) == ["a"] and sw.laps["a"] >= 0


def test_metrics_logger_and_trace(tmp_path, monkeypatch):
    log = prof.MetricsLogger(str(tmp_path / "m" / "metrics.jsonl"))
    log.log({"loss": 1.5}, step=3)
    rec = json.loads(open(tmp_path / "m" / "metrics.jsonl").read())
    assert rec["loss"] == 1.5 and rec["_step"] == 3 and "_time" in rec
    monkeypatch.delenv("MVTPU_TRACE_DIR", raising=False)
    with prof.trace() as p:
        assert p is None  # no directory: no trace
    monkeypatch.setenv("MVTPU_TRACE_DIR", str(tmp_path / "trace"))
    with prof.trace():
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))


def test_a_trace_that_fails_raises(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with prof.trace(str(tmp_path)):
            pass
