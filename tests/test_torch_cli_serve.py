"""The port's command line (``python -m metavoice_tpu_torch.cli``) on the CPU:
``synth`` writes a wav; a ``serve`` process answers /health and stops on
SIGTERM with "server stopped" and exit 0; ``capacity`` prints the plan;
``finetune`` without its CSVs, ``--tensor_parallel`` with fewer cards than ranks, ``--batching auto`` on the CPU and
``capacity`` without a card or a memory size raise."""

import json
import os
import re
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from metavoice_tpu_torch import cli
from metavoice_tpu_torch.core.config import first_stage_config
from metavoice_tpu_torch.utils import audio_io as aio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    sr = 16000
    path = str(tmp_path_factory.mktemp("ref") / "ref.wav")
    aio.write_wav(path, (0.3 * np.sin(2 * np.pi * 150 * np.arange(2 * sr) / sr)).astype(np.float32), sr)
    return path


def test_synth_random_small_cpu_writes_a_wav(ref_wav, tmp_path, capsys):
    out = str(tmp_path / "out")
    assert cli.main(["synth", "--random_weights", "--small", "--device", "cpu", "--text", "Hello there.",
                     "--spk_cond_path", ref_wav, "--output_dir", out, "--max_new_tokens", "16",
                     "--guidance_scale", "2.0", "1.5"]) == 0
    path = capsys.readouterr().out.strip().splitlines()[-1]
    wav, sr = aio.read_wav(path)
    assert path.startswith(out) and sr == 24000 and len(wav) > 0 and np.isfinite(wav).all()


def test_serve_process_answers_and_stops_on_sigterm(tmp_path):
    env = dict(os.environ, ANONYMIZED_TELEMETRY="False", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "metavoice_tpu_torch.cli", "serve", "--random_weights", "--small",
                             "--device", "cpu", "--no_warmup", "--host", "127.0.0.1", "--port", "0",
                             "--output_dir", str(tmp_path)], cwd=REPO, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        port = None
        while port is None:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            found = re.match(r"serving on 127\.0\.0\.1:(\d+)", line)
            port = found and int(found.group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=60) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "server stopped" in out


def test_what_the_port_cannot_do_raises(ref_wav, tmp_path):
    with pytest.raises(SystemExit):  # finetune runs now (test_torch_trainer.py); --train and --val are required
        cli.main(["finetune", "--steps", "1"])
    # --tensor_parallel runs (tests/test_torch_tts_tp.py): one card a rank, or --device cpu
    with pytest.raises(ValueError, match="tensor_parallel"):
        cli.main(["synth", "--random_weights", "--small", "--tensor_parallel", str(torch.cuda.device_count() + 2),
                  "--text", "x", "--spk_cond_path", ref_wav, "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="slot count"):  # no device memory to plan slots="auto" from
        cli.main(["serve", "--random_weights", "--small", "--device", "cpu", "--batching", "auto", "--no_warmup",
                  "--output_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="memory size"):  # capacity plans for the card, or --hbm_gib
            cli.main(["capacity"])
    assert cli.main([]) == 2


def test_capacity_prints_the_plan(capsys):
    from metavoice_tpu_torch.utils import capacity as cap

    assert cli.main(["capacity", "--hbm_gib", "16", "--kv_cache_dtype", "int8", "--slots", "4"]) == 0
    out = capsys.readouterr().out
    want = cap.max_slots(first_stage_config(), hbm_bytes=16 * 1024**3, kv_cache_dtype="int8")
    assert f"max slots at this config: {want}" in out and "4 slots x 2 CFG rows" in out
