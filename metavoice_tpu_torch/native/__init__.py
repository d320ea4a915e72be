"""The port's native (C++) BPE merge engine, bound with ctypes.

``bpe.cpp`` (this package's own copy of the JAX package's engine) is built
with g++ at first use into ``metavoice_tpu_torch/_build/`` (git-ignored),
under a name that hashes the source and the flags, so an edited source never
loads a stale build; the build writes a temporary file and renames it, so
processes that build at once never load a half-written library. Without a
compiler, or when the build fails, ``load_bpe`` raises ``NativeUnavailable``
and the tokenizer keeps its pure-Python merge (``BPEEngine.path`` says which
it took).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
SOURCE = _HERE / "bpe.cpp"
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: list = []  # the loaded library, once


class NativeUnavailable(RuntimeError):
    """The engine cannot be built or loaded here; the message says why."""


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmvbpe-{digest}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except FileNotFoundError as e:
        raise NativeUnavailable("g++ is not installed") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(f"g++ failed on {SOURCE.name}: {e.stderr[-2000:]}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_bpe() -> ctypes.CDLL:
    """The engine's library, built if this source has no build yet."""
    with _LOCK:
        if _LIB:
            return _LIB[0]
        path = library_path()
        if not path.exists():
            _build(path)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeUnavailable(f"cannot load {path}: {e}") from e
        lib.mvbpe_create.restype = ctypes.c_void_p
        lib.mvbpe_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.mvbpe_destroy.restype = None
        lib.mvbpe_destroy.argtypes = [ctypes.c_void_p]
        lib.mvbpe_encode_piece.restype = ctypes.c_int64
        lib.mvbpe_encode_piece.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                                           ctypes.POINTER(ctypes.c_uint32), ctypes.c_uint64]
        _LIB.append(lib)
        return lib


class NativeBPE:
    """One rank table in the C++ engine. ``encode_piece`` returns None where
    a part has no rank, and the caller takes the Python merge."""

    def __init__(self, mergeable_ranks: dict[bytes, int]):
        self._lib = load_bpe()
        # wire format (little-endian): u32 n, then per entry u32 rank, u32 len, len bytes
        blob = bytearray(len(mergeable_ranks).to_bytes(4, "little"))
        for token, rank in mergeable_ranks.items():
            blob += int(rank).to_bytes(4, "little") + len(token).to_bytes(4, "little") + token
        self._blob = bytes(blob)  # the engine copies it, but keep it alive for the call
        self._handle = self._lib.mvbpe_create(self._blob, len(self._blob))
        if not self._handle:
            raise NativeUnavailable("the native BPE engine refused the rank table")

    def encode_piece(self, piece: bytes) -> list[int] | None:
        cap = max(len(piece), 1)
        out = (ctypes.c_uint32 * cap)()
        n = self._lib.mvbpe_encode_piece(self._handle, piece, len(piece), out, cap)
        return None if n < 0 else list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mvbpe_destroy(self._handle)
            self._handle = None
