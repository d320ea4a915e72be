"""The port's native BPE merge engine (metavoice_tpu_torch/native, its own
bpe.cpp built with g++ into metavoice_tpu_torch/_build/): its ids equal the
port's pure-Python merge and the JAX package's engine, on the texts of
tests/test_tokenizer.py and on seeded random unicode strings."""

import numpy as np
import pytest

from metavoice_tpu_torch import native
from metavoice_tpu_torch.tokenizer import BPEEngine, TrainedBPETokeniser

PAT = r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
TEXTS = ["Hello, world!", "the thin thinker in the ring", "don't stop won't can't 123 456",
         "  leading spaces and   runs  ", "punctuation?! (brackets) [more] {braces} ...",
         "Singing in the rain, better.", "er. ing the", ""]


def _vocab():
    """tests/test_tokenizer.py's table: single bytes and merges of two tokens,
    plus multi-byte UTF-8 merges."""
    ranks = {bytes([i]): i for i in range(256)}
    merges = [b"th", b"in", b"er", b" t", b"he", b"the", b" th", b" the", b"ing", b"er.",
              "é".encode(), "日".encode()[:2], "日".encode(), " é".encode()]
    for i, m in enumerate(merges):
        ranks[m] = 256 + i
    return ranks


def _random_texts(n=40):
    rng = np.random.default_rng(0)
    alphabet = list("the ringTHE 0123456789 .,!?'-") + ["é", "日", "本", "ß", " ", "\n", "😀", "ñ"]
    return ["".join(rng.choice(alphabet, size=rng.integers(0, 40))) for _ in range(n)]


@pytest.fixture(scope="module")
def engines():
    nat = BPEEngine(_vocab(), PAT)
    assert nat.path == "native", nat.native_error  # g++ is part of this toolchain
    return nat, BPEEngine(_vocab(), PAT, use_native=False)


def test_library_builds_into_the_ports_build_dir(engines):
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "metavoice_tpu_torch"
    assert native.load_bpe() is native.load_bpe()


@pytest.mark.parametrize("text", TEXTS + _random_texts())
def test_native_ids_equal_python_and_jax(engines, text):
    jtok = pytest.importorskip("metavoice_tpu.tokenizer")
    nat, py = engines
    want = py.encode(text)
    assert nat.encode(text) == want
    assert jtok.BPEEngine(_vocab(), PAT).encode(text) == want
    for piece in py.pattern.findall(text):
        assert nat.native.encode_piece(piece.encode()) == py._encode_piece(piece.encode())


def test_tokeniser_takes_the_native_engine_and_says_so():
    tok = TrainedBPETokeniser(mergeable_ranks=_vocab(), special_tokens={"<|endoftext|>": 300})
    assert tok.engine.path == "native" and tok.engine.native_error is None
    py = BPEEngine(_vocab(), PAT, use_native=False)
    assert py.path == "python" and py.native_error == "use_native=False"
    assert tok.encode("the ring") == [t + 2049 for t in py.encode("the ring")] + [300 + 2049]


def test_a_missing_compiler_leaves_the_python_merge(monkeypatch, tmp_path):
    """JAX's rule: no compiler, the pure-Python merge; the engine says why."""
    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", lambda *a, **k: (_ for _ in ()).throw(FileNotFoundError("g++")))
    eng = BPEEngine(_vocab(), PAT)
    assert eng.path == "python" and "g++ is not installed" in eng.native_error
    assert eng.encode("the thing") == BPEEngine(_vocab(), PAT, use_native=False).encode("the thing")
