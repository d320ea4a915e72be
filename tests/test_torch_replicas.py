"""The port's replica pool (runtime/replicas.py) on an explicit list of two
CPU devices: least-loaded dispatch with the submitted-count tiebreak, the
summed stats, the engine surface the server takes, and the refusals (more
replicas than devices, a TTS built on another device). Dispatch over several
cards is tested only here, on the CPU.
"""

import numpy as np
import pytest
import torch

from metavoice_tpu_torch.runtime.replicas import ReplicaPool
from metavoice_tpu_torch.runtime.tts import TTS
from metavoice_tpu_torch.utils import audio_io as aio

CPUS = ["cpu", "cpu"]
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


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("outputs"))
    p = ReplicaPool(lambda i: TTS.from_random(small=True, device="cpu", seed=i, output_dir=out),
                    devices=CPUS, slots=2, segment_tokens=16)
    yield p
    p.shutdown()


def test_pool_dispatches_to_the_least_loaded_replica(pool, ref_wav):
    futs = [pool.submit(f"Replica request number {i}.", ref_wav, max_new_tokens=32) for i in range(4)]
    for f in futs:
        wav, _ = aio.read_wav(f.result(timeout=TIMEOUT))
        assert len(wav) > 0 and np.isfinite(wav).all()
    stats = pool.stats
    # a burst spreads over both replicas (the submitted count breaks ties of load)
    assert stats["replica_0_submitted"] + stats["replica_1_submitted"] == 4
    assert stats["replica_0_submitted"] >= 1 and stats["replica_1_submitted"] >= 1
    # the counters are the engines' summed
    for key in ("segments", "decode_steps", "groups", "row_tokens"):
        assert stats[key] == sum(e.stats[key] for e in pool.engines)
    assert stats["groups"] >= 2 and pool.load == 0 == stats["replica_0_load"] + stats["replica_1_load"]


def test_pick_prefers_lower_load_then_fewer_submitted(pool, monkeypatch):
    e0, e1 = pool.engines
    monkeypatch.setattr(pool, "_submitted", [5, 0])
    monkeypatch.setattr(type(e0), "load", property(lambda self: 3 if self is e0 else 1))
    assert pool._pick() == 1
    monkeypatch.setattr(type(e0), "load", property(lambda self: 0))
    assert pool._pick() == 1  # equal load: the replica given fewer requests
    monkeypatch.setattr(pool, "_submitted", [0, 5])
    assert pool._pick() == 0


def test_pool_streams_through_a_replica(pool, ref_wav):
    chunks = list(pool.submit("Stream through the pool.", ref_wav, stream=True, max_new_tokens=48))
    assert chunks and all(np.isfinite(c).all() for c in chunks)


def test_pool_refuses_more_replicas_than_devices(tmp_path):
    built = []
    with pytest.raises(ValueError, match="3 replicas > 2 devices"):
        ReplicaPool(lambda i: built.append(i), n_replicas=3, devices=CPUS)
    assert built == []  # refused before any replica is built


def test_pool_refuses_a_tts_on_another_device(tmp_path):
    class Elsewhere:
        device = torch.device("meta")

    with pytest.raises(ValueError, match="not on replica 0"):
        ReplicaPool(lambda i: Elsewhere(), devices=["cpu"])
