"""The port's HTTP server (runtime/server.py) on 127.0.0.1, port 0: /health,
/tts in JSON and multipart, the 400s and the 404, the live streaming WAV,
/metrics with the engine's counters, and a client that hangs up mid-stream;
served by the continuous-batching engine, and once through the plain
lock-serialized path. ``TTS.from_random(small=True, device="cpu")``; each
request's first stage is capped at 48 tokens, so the suite stays short.
"""

import functools
import http.client
import io
import json
import shutil
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from metavoice_tpu_torch.runtime import server as srv
from metavoice_tpu_torch.runtime.engine import ContinuousBatchingEngine
from metavoice_tpu_torch.runtime.tts import TTS
from metavoice_tpu_torch.utils import audio_io as aio

CAP = 48  # first-stage tokens a request
TIMEOUT = 300


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
    aio.write_wav(path, (0.3 * np.sin(2 * np.pi * 180 * t)).astype(np.float32), sr)
    return path


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    tts = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path_factory.mktemp("outputs")))
    eng = ContinuousBatchingEngine(tts, slots=4, segment_tokens=16)
    eng.submit = functools.partial(eng.submit, max_new_tokens=CAP)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def server(engine):
    httpd, url = _start(srv.make_handler(engine.tts, srv.ServingConfig(), batching_engine=engine))
    yield url
    httpd.shutdown()
    httpd.server_close()


def _post_json(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _post_multipart(url, text, data: bytes, filename="ref.wav"):
    boundary = "testboundary123"
    body = (
        f'--{boundary}\r\nContent-Disposition: form-data; name="text"\r\n\r\n{text}\r\n'
        f'--{boundary}\r\nContent-Disposition: form-data; name="audiodata"; filename="{filename}"\r\n'
        f"Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(url + "/tts", data=body, method="POST",
                                 headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    return {line.split()[0]: float(line.split()[1]) for line in text.splitlines() if line and line[0] != "#"}


def test_health_and_unknown_route(server):
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(server + "/nope", timeout=30)
    assert exc.value.code == 404


def test_tts_json_and_multipart(server, ref_wav):
    with _post_json(server + "/tts", {"text": "Hello from the server.", "speaker_ref_path": ref_wav}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    assert body[:4] == b"RIFF" and len(body) > 1000
    with open(ref_wav, "rb") as f:
        with _post_multipart(server, "Hi there.", f.read()) as r:
            assert r.read()[:4] == b"RIFF"


@pytest.mark.parametrize("case", ["no text", "both speaker sources", "no speaker", "non-wav upload",
                                  "short upload"])
def test_bad_requests_are_400(server, ref_wav, monkeypatch, case):
    before = _scrape(server)["tts_errors_total"]
    with pytest.raises(urllib.error.HTTPError) as exc:
        if case == "no text":
            _post_json(server + "/tts", {"speaker_ref_path": ref_wav})
        elif case == "both speaker sources":
            _post_json(server + "/tts", {"text": "hi", "speaker_ref_path": ref_wav, "audiodata": "x"})
        elif case == "no speaker":
            _post_json(server + "/tts", {"text": "hi"})
        elif case == "non-wav upload":
            monkeypatch.setattr(shutil, "which", lambda name: None)  # no ffmpeg, whatever the host has
            _post_multipart(server, "Upload test.", b"ID3\x04\x00" + b"\x00" * 2048, "ref.mp3")
        else:
            buf = io.BytesIO()
            with wave.open(buf, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(16000)
                f.writeframes(np.zeros(16000 * 5, np.int16).tobytes())  # 5 s
            _post_multipart(server, "Upload test.", buf.getvalue())
    assert exc.value.code == 400
    detail = exc.value.read().lower()
    if case == "non-wav upload":
        assert b"wav" in detail
    if case == "short upload":
        assert b"too short" in detail
    assert _scrape(server)["tts_errors_total"] == before + 1


def _read_stream(url, ref_wav, text):
    with _post_json(url + "/tts", {"text": text, "speaker_ref_path": ref_wav, "stream": "true"}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        assert r.headers.get("Content-Length") is None
        header = r.read(44)
        pcm = r.read()
    assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
    assert header[4:8] == b"\xff\xff\xff\xff" and header[40:44] == b"\xff\xff\xff\xff"  # live-stream sizes
    assert header == aio.wav_streaming_header(24000)
    assert len(pcm) > 0 and len(pcm) % 2 == 0
    wav = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
    assert np.isfinite(wav).all()
    return wav


def test_streaming_response(server, ref_wav):
    _read_stream(server, ref_wav, "Hello streaming.")


def test_metrics_count_requests_and_the_engine(server, ref_wav, engine):
    before = _scrape(server)
    with _post_json(server + "/tts", {"text": "Metrics test.", "speaker_ref_path": ref_wav}) as r:
        r.read()
    after = _scrape(server)
    assert after["tts_requests_total"] == before["tts_requests_total"] + 1
    assert after["tts_audio_seconds_total"] > before["tts_audio_seconds_total"]
    assert after["tts_wall_seconds_total"] > before["tts_wall_seconds_total"]
    _read_stream(server, ref_wav, "Metrics stream.")
    final = _scrape(server)
    assert final["tts_streaming_requests_total"] == after["tts_streaming_requests_total"] + 1
    assert final["tts_errors_total"] == after["tts_errors_total"]
    # the engine's scheduling counters, as engine_<name>_total
    for name in engine.stats:
        assert f"engine_{name}_total" in final
    assert final["engine_segments_total"] > before["engine_segments_total"]
    assert final["engine_decode_steps_total"] > before["engine_decode_steps_total"]


def test_streaming_client_disconnect_is_contained(server, ref_wav):
    """A client that hangs up mid-stream crashes nothing, splices no JSON
    into the audio and counts as no error."""
    errors = _scrape(server)["tts_errors_total"]
    conn = http.client.HTTPConnection(urllib.parse.urlparse(server).netloc, timeout=TIMEOUT)
    conn.request("POST", "/tts", headers={"Content-Type": "application/json"},
                 body=json.dumps({"text": "Disconnect test.", "speaker_ref_path": ref_wav, "stream": "1"}))
    resp = conn.getresponse()
    assert resp.status == 200
    resp.read(44)  # the header, then hang up
    conn.close()
    time.sleep(0.5)
    with urllib.request.urlopen(server + "/health", timeout=30) as r:
        assert json.loads(r.read())["status"] == "ok"
    with _post_json(server + "/tts", {"text": "After disconnect.", "speaker_ref_path": ref_wav}) as r:
        assert r.read()[:4] == b"RIFF"
    after = _scrape(server)
    assert after["tts_errors_total"] == errors
    assert "tts_client_disconnects_total" in after


def test_plain_path_serializes_on_one_tts(tmp_path, ref_wav):
    """Without an engine: synthesise and synthesise_streaming under the lock,
    the index page with the reference app's controls."""
    tts = TTS.from_random(small=True, device="cpu", output_dir=str(tmp_path))
    tts.synthesise = functools.partial(tts.synthesise, max_new_tokens=CAP)
    tts.synthesise_streaming = functools.partial(tts.synthesise_streaming, max_new_tokens=CAP)
    httpd, url = _start(srv.make_handler(tts, srv.ServingConfig()))
    try:
        with _post_json(url + "/tts", {"text": "The plain path.", "speaker_ref_path": ref_wav}) as r:
            assert r.read()[:4] == b"RIFF"
        _read_stream(url, ref_wav, "The plain stream.")
        html = urllib.request.urlopen(url + "/", timeout=30).read().decode()
        assert all(p in html for p in srv.PRESET_VOICES) and "streamPlay" in html
        assert "engine_" not in urllib.request.urlopen(url + "/metrics", timeout=30).read().decode()
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_main_refuses_checkpoints(monkeypatch):
    with pytest.raises(NotImplementedError, match="from_checkpoints"):
        srv.main(["--first_stage_path", "x.pt"])


@pytest.mark.parametrize("argv", [[], ["--small"], ["--encodec_path", "x.pt"], ["--second_stage_path", "x.pt"],
                                  ["--speaker_encoder_path", "x.pt"]])
def test_main_serves_nothing_it_cannot_load(argv):
    """Without --random_weights the server refuses to start, and it takes
    no weight path that it would not load."""
    with pytest.raises(SystemExit) as e:
        srv.main(argv)
    assert e.value.code == 2


def test_audio_helpers_match_the_jax_package():
    jaio = pytest.importorskip("metavoice_tpu.utils.audio_io")
    wav = np.random.default_rng(0).uniform(-1.5, 1.5, size=999).astype(np.float32)
    assert aio.float_to_pcm16(wav) == jaio.float_to_pcm16(wav)
    assert aio.wav_streaming_header(24000) == jaio.wav_streaming_header(24000)
