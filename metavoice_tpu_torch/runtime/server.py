"""HTTP serving of the port: POST /tts + GET /health, the reference's API.

Port of metavoice_tpu/runtime/server.py. The reference uses FastAPI +
uvicorn (serving.py:54-151: a multipart form with ``text``,
``speaker_ref_path`` or an uploaded ``audiodata``, ``guidance`` in [0,5],
``top_p`` in [0,1]; wav bytes back; one global TTS; requests serialized).
This is a dependency-free stdlib ``ThreadingHTTPServer`` with a hand-rolled
multipart parser. Without an engine, synthesis is serialized through a lock
around the one TTS, as the reference's single worker; with a
``batching_engine`` (runtime/engine.ContinuousBatchingEngine, or a
runtime/replicas.ReplicaPool) concurrent requests share its slot pool.

Endpoints:
  GET  /health            -> {"status": "ok"}  (serving.py:54-56)
  GET  /metrics           -> Prometheus text-format serving counters
                             (requests/errors/audio-seconds/wall-seconds,
                             and the engine's ``engine_*_total`` counters)
  POST /tts               -> audio/wav bytes   (serving.py:59-109)
       fields: text (required), speaker_ref_path | audiodata (one required),
               guidance (default 3.0, clamped to [0,5]),
               top_p (default 0.95, clamped to [0,1]),
               temperature (default 1.0),
               stream (default false: with a truthy value the response is a
               live PCM16 WAV written segment by segment, from the engine's
               stream or TTS.synthesise_streaming)
       content types: multipart/form-data, application/x-www-form-urlencoded,
               or application/json

``python -m metavoice_tpu_torch.runtime.server --first_stage_path ...
--second_stage_path ... --speaker_encoder_path ... [--encodec_path ...]
[--device cpu]`` serves checkpoints (``TTS.from_checkpoints``), and
``--random_weights [--small]`` (or no first-stage path) random weights.
``python -m metavoice_tpu_torch.cli serve`` adds the batching engine and
replicas.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import tempfile
import threading
import time
import urllib.parse
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from metavoice_tpu_torch.utils import audio_io as aio


@dataclass
class ServingConfig:
    """Mirrors reference ServingConfig (serving.py:29-42)."""

    host: str = "0.0.0.0"
    port: int = 58003
    seed: int = 1337
    output_dir: str = "outputs"
    # cap on a request's first-stage tokens a chunk; None (the JAX package's
    # only behaviour) decodes to end-of-audio or the context limit
    max_new_tokens: int | None = None


def _parse_multipart(body: bytes, content_type: str) -> dict[str, bytes | str]:
    m = re.search(r"boundary=([^;]+)", content_type)
    if not m:
        raise ValueError("multipart body without boundary")
    boundary = m.group(1).strip('"').encode()
    fields: dict[str, bytes | str] = {}
    for part in body.split(b"--" + boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        headers = header_blob.decode("utf-8", errors="replace")
        name_m = re.search(r'name="([^"]+)"', headers)
        if not name_m:
            continue
        name = name_m.group(1)
        is_file = 'filename="' in headers
        fields[name] = content if is_file else content.decode("utf-8", errors="replace")
    return fields


def _parse_request_fields(handler: BaseHTTPRequestHandler) -> dict:
    length = int(handler.headers.get("Content-Length", 0))
    body = handler.rfile.read(length) if length else b""
    ctype = handler.headers.get("Content-Type", "")
    if ctype.startswith("multipart/form-data"):
        return _parse_multipart(body, ctype)
    if ctype.startswith("application/json"):
        return json.loads(body.decode("utf-8") or "{}")
    if ctype.startswith("application/x-www-form-urlencoded"):
        return {k: v[0] for k, v in urllib.parse.parse_qs(body.decode()).items()}
    raise ValueError(f"unsupported content type: {ctype}")


# Preset voices + slider denormalization mirror the reference Gradio app
# (app.py:21-38): stability slider 0-10 -> top_p in [0.9, 1.0], similarity
# slider 1-5 -> guidance in [1.0, 3.0]; uploads are checked for >=30 s
# duration (server-side) and <50 MB size (client-side, app.py:40-46).
PRESET_VOICES = {
    "Bria": "https://cdn.themetavoice.xyz/speakers/bria.mp3",
    "Alex": "https://cdn.themetavoice.xyz/speakers/alex.mp3",
    "Jacob": "https://cdn.themetavoice.xyz/speakers/jacob.wav",
}

MAX_UPLOAD_MB = 50
MAX_CHARS = 220

_INDEX_HTML = """<!doctype html>
<html><head><title>TTS by metavoice-tpu</title>
<style>
 body{font-family:sans-serif;max-width:720px;margin:2em auto;line-height:1.4}
 fieldset{border:1px solid #ccc;border-radius:6px;margin:1em 0;padding:1em}
 label{display:block;margin:.6em 0 .2em}
 textarea,select,input[type=file]{width:100%%}
 .row{display:flex;gap:1em}.row>div{flex:1}
 #status{color:#666}.err{color:#b00}
 button{padding:.6em 1.6em;font-size:1em}
</style></head>
<body>
<h2>TTS by metavoice-tpu</h2>
<p>1.2B TTS: emotional speech rhythm and tone, zero-shot cloning with a
&ge;30 s reference, long-form synthesis. (port of the reference Gradio app,
app.py.)</p>

<label>What should I say!? (max %(max_chars)d characters)</label>
<textarea id="text" rows="4" maxlength="%(max_chars)d">This is a demo of text to speech by MetaVoice-1B, an open-source foundational audio model.</textarea>

<div class="row">
 <div>
  <label>Speech stability <span id="top_p_lbl"></span></label>
  <input type="range" id="top_p" min="0" max="10" step="1" value="5">
 </div>
 <div>
  <label>Speaker similarity <span id="guidance_lbl"></span></label>
  <input type="range" id="guidance" min="1" max="5" step="1" value="5">
 </div>
</div>

<fieldset>
 <legend>Choose voice</legend>
 <label><input type="radio" name="vsrc" value="preset" checked> Preset voices</label>
 <select id="preset">%(preset_options)s</select>
 <label><input type="radio" name="vsrc" value="upload"> Upload target voice (at least 30 s, &lt; %(max_mb)d MB)</label>
 <input type="file" id="upload" accept="audio/*" disabled>
</fieldset>

<label><input type="checkbox" id="stream" checked> Stream (start playing at first audio, ~0.4 s)</label>
<button id="go">Generate Speech</button> <span id="status"></span>
<p><audio id="out" controls style="width:100%%;display:none"></audio></p>

<script>
const PRESETS = %(presets_json)s;
// slider denormalization, reference app.py:30-38
const denormTopP = v => Math.round((0.9 + v / 100) * 100) / 100;
const denormGuidance = v => 1 + ((v - 1) * (3 - 1)) / (5 - 1);
const $ = id => document.getElementById(id);
function refresh() {
  $("top_p_lbl").textContent = "(top_p " + denormTopP(+$("top_p").value) + ")";
  $("guidance_lbl").textContent = "(guidance " + denormGuidance(+$("guidance").value).toFixed(1) + ")";
}
$("top_p").oninput = $("guidance").oninput = refresh; refresh();
for (const r of document.getElementsByName("vsrc"))
  r.onchange = () => { $("upload").disabled = r.value !== "upload" || !r.checked;
                       $("preset").disabled = r.value !== "preset" || !r.checked; };
$("go").onclick = async () => {
  const status = $("status"); status.className = ""; status.textContent = "";
  const text = $("text").value.trim();
  if (!text) { status.className = "err"; status.textContent = "Please provide text to synthesise"; return; }
  const fd = new FormData();
  fd.append("text", text.slice(0, %(max_chars)d));
  fd.append("top_p", denormTopP(+$("top_p").value));
  fd.append("guidance", denormGuidance(+$("guidance").value));
  const useUpload = document.querySelector('input[name="vsrc"]:checked').value === "upload";
  if (useUpload) {
    const f = $("upload").files[0];
    if (!f) { status.className = "err"; status.textContent = "Please choose an audio file"; return; }
    if (f.size >= %(max_mb)d * 1024 * 1024) {
      status.className = "err";
      status.textContent = "Please upload a sample smaller than %(max_mb)d MB (" + Math.round(f.size/1048576) + " MB provided)";
      return;
    }
    fd.append("audiodata", f);
  } else {
    fd.append("speaker_ref_path", PRESETS[$("preset").value]);
  }
  status.textContent = "Synthesising…";
  try {
    if ($("stream").checked) { await streamPlay(fd, status); return; }
    const resp = await fetch("/tts", { method: "POST", body: fd });
    if (!resp.ok) { throw new Error((await resp.json()).detail || resp.statusText); }
    const blob = await resp.blob();
    const out = $("out"); out.src = URL.createObjectURL(blob);
    out.style.display = "block"; out.play(); status.textContent = "";
  } catch (e) { status.className = "err"; status.textContent = "Something went wrong. Reason: " + e.message; }
};

// live playback: PCM16 chunks from the streaming endpoint scheduled
// back-to-back through WebAudio — audio starts at time-to-first-segment
async function streamPlay(fd, status) {
  fd.append("stream", "true");
  const resp = await fetch("/tts", { method: "POST", body: fd });
  if (!resp.ok) { throw new Error((await resp.json()).detail || resp.statusText); }
  const SR = 24000;
  const ctx = new (window.AudioContext || window.webkitAudioContext)({ sampleRate: SR });
  const reader = resp.body.getReader();
  let playhead = ctx.currentTime + 0.05, carry = new Uint8Array(0), header = 44, total = 0;
  const chunks = [];
  status.textContent = "Streaming…";
  for (;;) {
    const { done, value } = await reader.read();
    if (done) break;
    let buf = new Uint8Array(carry.length + value.length);
    buf.set(carry); buf.set(value, carry.length);
    if (header > 0) { const drop = Math.min(header, buf.length); buf = buf.slice(drop); header -= drop; }
    const usable = buf.length - (buf.length %% 2);
    carry = buf.slice(usable);
    if (!usable) continue;
    const pcm = new Int16Array(buf.buffer.slice(0, usable));
    const f32 = Float32Array.from(pcm, v => v / 32768);
    chunks.push(f32); total += f32.length;
    const ab = ctx.createBuffer(1, f32.length, SR);
    ab.getChannelData(0).set(f32);
    const src = ctx.createBufferSource();
    src.buffer = ab; src.connect(ctx.destination);
    playhead = Math.max(playhead, ctx.currentTime + 0.02);
    src.start(playhead); playhead += ab.duration;
  }
  status.textContent = "";
  // also expose the finished take in the player for replay
  const all = new Float32Array(total); let o = 0;
  for (const c of chunks) { all.set(c, o); o += c.length; }
  const wav = encodeWav(all, SR);
  const out = $("out");
  out.src = URL.createObjectURL(new Blob([wav], { type: "audio/wav" }));
  out.style.display = "block";
}

function encodeWav(f32, sr) {
  const n = f32.length, buf = new ArrayBuffer(44 + n * 2), v = new DataView(buf);
  const w = (o, s) => { for (let i = 0; i < s.length; i++) v.setUint8(o + i, s.charCodeAt(i)); };
  w(0, "RIFF"); v.setUint32(4, 36 + n * 2, true); w(8, "WAVE"); w(12, "fmt ");
  v.setUint32(16, 16, true); v.setUint16(20, 1, true); v.setUint16(22, 1, true);
  v.setUint32(24, sr, true); v.setUint32(28, sr * 2, true);
  v.setUint16(32, 2, true); v.setUint16(34, 16, true);
  w(36, "data"); v.setUint32(40, n * 2, true);
  for (let i = 0; i < n; i++) v.setInt16(44 + i * 2, Math.max(-1, Math.min(1, f32[i])) * 32767, true);
  return buf;
}
</script>
</body></html>""" % {
    "presets_json": json.dumps(PRESET_VOICES),
    "preset_options": "".join(
        f'<option value="{name}">{name}</option>' for name in PRESET_VOICES
    ),
    "max_mb": MAX_UPLOAD_MB,
    "max_chars": MAX_CHARS,
}


class ServingMetrics:
    """Thread-safe serving counters, rendered in Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self.counters = {
            "tts_requests_total": 0,
            "tts_streaming_requests_total": 0,
            "tts_errors_total": 0,
            "tts_audio_seconds_total": 0.0,
            "tts_wall_seconds_total": 0.0,
            "tts_client_disconnects_total": 0,
        }

    def observe(self, *, streaming: bool, audio_s: float, wall_s: float):
        with self._lock:
            self.counters["tts_requests_total"] += 1
            if streaming:
                self.counters["tts_streaming_requests_total"] += 1
            self.counters["tts_audio_seconds_total"] += audio_s
            self.counters["tts_wall_seconds_total"] += wall_s

    def error(self):
        with self._lock:
            self.counters["tts_errors_total"] += 1

    def disconnect(self):
        with self._lock:
            self.counters["tts_client_disconnects_total"] += 1

    def render(self) -> str:
        with self._lock:
            lines = []
            for name, val in self.counters.items():
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {val}")
            lines.append("# TYPE tts_uptime_seconds gauge")
            lines.append(f"tts_uptime_seconds {time.monotonic() - self._t0:.1f}")
            return "\n".join(lines) + "\n"


def make_handler(tts, config: ServingConfig, batching_engine=None, metrics=None):
    """Build the request handler bound to one TTS engine instance.

    With ``batching_engine`` (runtime/engine.ContinuousBatchingEngine),
    concurrent requests share the slot-pool decode — including streaming
    requests, whose wav segments fan out of the shared batch (round 2
    serialized streams on the handler lock). Without an engine, streaming
    falls back to the direct synthesise_streaming path under the lock; the
    per-request segment_tokens knobs only apply on that direct path (the
    engine's segment cadence is a batch-wide property).
    """
    # the first-stage cap goes to the engine or TTS only when set, so that their own defaults hold otherwise
    cap = {} if config.max_new_tokens is None else {"max_new_tokens": config.max_new_tokens}
    lock = threading.Lock()  # serialize synthesis on the single engine
    metrics = metrics or ServingMetrics()

    class Handler(BaseHTTPRequestHandler):
        server_version = "metavoice-tpu-torch/0.1"

        def log_message(self, fmt, *args):  # quieter default logging
            pass

        def _send(self, code: int, payload: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(payload)

        def _json(self, code: int, obj: dict):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _bad(self, detail: str):
            """400 + error-counter (all client errors count consistently)."""
            metrics.error()
            self._json(400, {"detail": detail})

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/metrics":
                body = metrics.render()
                if batching_engine is not None:
                    # engine scheduling counters (rebases reclaim timeline
                    # budget; truncations mean an utterance was cut at the
                    # block limit — should stay 0 in healthy serving)
                    for name, val in sorted(batching_engine.stats.items()):
                        body += f"# TYPE engine_{name}_total counter\n"
                        body += f"engine_{name}_total {val}\n"
                self._send(200, body.encode(), "text/plain; version=0.0.4")
            elif self.path in ("/", "/index.html"):
                self._send(200, _INDEX_HTML.encode(), "text/html")
            else:
                self._json(404, {"detail": "not found"})

        def do_POST(self):
            if self.path != "/tts":
                self._json(404, {"detail": "not found"})
                return
            tmp_upload = None
            try:
                fields = _parse_request_fields(self)
                text = fields.get("text")
                if not text or not isinstance(text, str):
                    self._bad("field 'text' is required")
                    return
                ref_path = fields.get("speaker_ref_path")
                audiodata = fields.get("audiodata")
                # exactly one speaker source (serving.py:67-72)
                if (ref_path is None) == (audiodata is None):
                    self._bad("provide exactly one of speaker_ref_path | audiodata")
                    return
                if audiodata is not None:
                    # transcode (ffmpeg when present) + 2-minute cap, the
                    # reference's _convert_audiodata_to_wav_path
                    # (serving.py:112-123); uploads are duration-gated
                    # (serving.py:79 check_audio_file) and size-capped
                    # (app.py:40-46)
                    raw = (
                        audiodata
                        if isinstance(audiodata, bytes)
                        else audiodata.encode()
                    )
                    if len(raw) >= MAX_UPLOAD_MB * 1024 * 1024:
                        self._bad(
                            f"Please upload a sample smaller than "
                            f"{MAX_UPLOAD_MB} MB for voice cloning. Provided: "
                            f"{len(raw) >> 20} MB"
                        )
                        return
                    fd, tmp_upload = tempfile.mkstemp(suffix=".wav")
                    os.close(fd)
                    ref_path = aio.transcode_upload_to_wav(raw, tmp_upload)
                    aio.check_audio_file(ref_path)

                guidance = min(max(float(fields.get("guidance", 3.0)), 0.0), 5.0)
                top_p = min(max(float(fields.get("top_p", 0.95)), 0.0), 1.0)
                temperature = float(fields.get("temperature", 1.0))
                stream = str(fields.get("stream", "")).lower() in (
                    "1", "true", "yes", "on",
                )
                # streaming granularity knobs (synthesise_streaming defaults;
                # clamped so a client can't force degenerate 1-token segments)
                seg_tokens = int(fields.get("segment_tokens", 150))
                seg_tokens = min(max(seg_tokens, 20), 600)
                first_seg_tokens = int(fields.get("first_segment_tokens", 40))
                first_seg_tokens = min(max(first_seg_tokens, 10), seg_tokens)

                if stream:
                    self._stream_tts(
                        str(text), str(ref_path), top_p, guidance, temperature,
                        segment_tokens=seg_tokens,
                        first_segment_tokens=first_seg_tokens,
                    )
                    return

                t_req = time.monotonic()
                if batching_engine is not None:
                    wav_path = batching_engine.submit(
                        str(text),
                        str(ref_path),
                        top_p=top_p,
                        guidance_scale=guidance,
                        temperature=temperature,
                        **cap,
                    ).result()
                else:
                    with lock:
                        wav_path = tts.synthesise(
                            str(text),
                            str(ref_path),
                            top_p=top_p,
                            guidance_scale=guidance,
                            temperature=temperature,
                            **cap,
                        )
                with open(wav_path, "rb") as f:
                    payload = f.read()
                metrics.observe(
                    streaming=False,
                    audio_s=aio.duration_s(wav_path),
                    wall_s=time.monotonic() - t_req,
                )
                self._send(200, payload, "audio/wav")
            except ValueError as e:
                metrics.error()
                self._json(400, {"detail": str(e)})
            except Exception as e:  # parity: 500 on engine errors (serving.py:98-106)
                metrics.error()
                self._json(500, {"detail": f"synthesis failed: {e}"})
            finally:
                if tmp_upload and os.path.exists(tmp_upload):
                    os.unlink(tmp_upload)

        def _stream_tts(
            self, text, ref_path, top_p, guidance, temperature,
            segment_tokens=150, first_segment_tokens=40,
        ):
            """Live WAV response: PCM16 segments as synthesis progresses.

            No Content-Length; RIFF sizes are 0xFFFFFFFF (live-stream
            convention) and the client reads until close. First bytes reach
            the client after one short first segment (the TTFA path) rather
            than after the whole utterance.
            """
            t_req = time.monotonic()
            sr = tts.c.encodec_cfg.sample_rate
            n_samples = 0
            if batching_engine is not None:
                # streaming through the continuous batcher: no handler lock,
                # the request joins the shared slot pool mid-flight
                stream_ctx = contextlib.nullcontext()
                gen = batching_engine.submit(
                    text, ref_path, stream=True, top_p=top_p,
                    guidance_scale=guidance, temperature=temperature,
                    **cap,
                )
            else:
                stream_ctx = lock
                gen = None
            with stream_ctx:
                if gen is None:
                    gen = tts.synthesise_streaming(
                        text, ref_path, top_p=top_p, guidance_scale=guidance,
                        segment_tokens=segment_tokens,
                        first_segment_tokens=first_segment_tokens,
                        temperature=temperature,
                        **cap,
                    )
                try:
                    first = next(gen)
                except StopIteration:
                    metrics.error()
                    self._json(500, {"detail": "synthesis produced no audio"})
                    return
                # headers only after the first segment exists, so engine
                # errors before any audio still surface as HTTP 500. Once
                # they are sent, errors must NOT fall through to do_POST's
                # JSON handler (it would splice JSON into the audio stream
                # or write on a broken socket) — contain them here.
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    self.wfile.write(aio.wav_streaming_header(sr))
                    for seg in itertools.chain((first,), gen):
                        self.wfile.write(aio.float_to_pcm16(seg))
                        self.wfile.flush()
                        n_samples += len(seg)
                except (BrokenPipeError, ConnectionResetError):
                    # client went away mid-stream: not an error, but also not
                    # a completed request — count it separately so partial
                    # streams don't inflate the success/audio-seconds totals
                    gen.close()
                    metrics.disconnect()
                    return
                except Exception:
                    metrics.error()
                    gen.close()
                    try:
                        self.wfile.close()  # truncate: client sees EOF
                    except Exception:
                        pass
                    return
            metrics.observe(
                streaming=True,
                audio_s=n_samples / sr,
                wall_s=time.monotonic() - t_req,
            )

    return Handler


def serve(tts, config: ServingConfig | None = None) -> ThreadingHTTPServer:
    """Start the server (non-blocking; returns the server object)."""
    config = config or ServingConfig()
    httpd = ThreadingHTTPServer((config.host, config.port), make_handler(tts, config))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


def main(argv=None):
    import argparse

    from metavoice_tpu_torch.runtime.tts import TTS

    ap = argparse.ArgumentParser(description="metavoice-tpu PyTorch TTS server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=58003)
    ap.add_argument("--first_stage_path")
    ap.add_argument("--second_stage_path")
    ap.add_argument("--speaker_encoder_path")
    ap.add_argument("--encodec_path", help="pretrained EnCodec vocoder (.pt/.npz)")
    ap.add_argument("--random_weights", action="store_true", help="dev mode")
    ap.add_argument("--small", action="store_true", help="small dev models")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.random_weights or not args.first_stage_path:
        tts = TTS.from_random(small=args.small, device=args.device)
    else:
        tts = TTS.from_checkpoints(args.first_stage_path, args.second_stage_path, args.speaker_encoder_path,
                                   encodec_path=args.encodec_path, device=args.device)
    cfg = ServingConfig(host=args.host, port=args.port)
    httpd = ThreadingHTTPServer((cfg.host, cfg.port), make_handler(tts, cfg))
    print(f"serving on {cfg.host}:{cfg.port}")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
