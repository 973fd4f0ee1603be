"""Host-side native code of the port: the shared-memory ring
(``shm_ring.cpp``, a copy of ``paddle_tpu/csrc/shm_ring.cpp``) that the
DataLoader's process workers write their batches into.

The counterpart of ``paddle_tpu/csrc/__init__.py``'s ``ShmRing``: built
with ``g++`` at first use (plain C ABI, bound with ``ctypes``), into
``build/native/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source, never into the source tree. Importing
builds nothing; :func:`available` reports whether the native path is
usable, and the loader falls back to its ``multiprocessing`` queue when
it is not. The CUDA kernels' sources beside it are built by
``kernels/_build.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "shm_ring.cpp"
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the ring's library is built: ``build/native/`` of the
    repository, named by a hash of its source."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _HERE.parents[1] / "build" / "native" / f"shm_ring-{digest}.so"


def _build(out: Path):
    """Compile the ring into ``out`` (through a temporary file, so a
    process building it at the same time never loads a half-written
    library)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    str(_SRC), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        try:
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            return None
        c = ctypes
        lib.shm_ring_create.restype = c.c_void_p
        lib.shm_ring_create.argtypes = [c.c_char_p, c.c_uint64]
        lib.shm_ring_open.restype = c.c_void_p
        lib.shm_ring_open.argtypes = [c.c_char_p]
        lib.shm_ring_push.restype = c.c_int
        lib.shm_ring_push.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64,
                                      c.c_int64]
        lib.shm_ring_pop.restype = c.c_int64
        lib.shm_ring_pop.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64,
                                     c.c_int64]
        lib.shm_ring_peek_len.restype = c.c_int64
        lib.shm_ring_peek_len.argtypes = [c.c_void_p]
        lib.shm_ring_used.restype = c.c_uint64
        lib.shm_ring_used.argtypes = [c.c_void_p]
        lib.shm_ring_mark_closed.argtypes = [c.c_void_p]
        lib.shm_ring_is_closed.restype = c.c_int
        lib.shm_ring_is_closed.argtypes = [c.c_void_p]
        lib.shm_ring_close.argtypes = [c.c_void_p, c.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class ShmRing:
    """Single-producer single-consumer shared-memory ring: :meth:`create`
    on the consumer side (the loader), :meth:`open` by name in the
    producer process (a worker)."""

    def __init__(self, handle, lib, name, owner):
        self._h = handle
        self._lib = lib
        self.name = name
        self._owner = owner

    @classmethod
    def create(cls, name: str, capacity: int = 1 << 22):
        lib = _load()
        if lib is None:
            raise RuntimeError("native shm_ring unavailable (no g++?)")
        h = lib.shm_ring_create(name.encode(), capacity)
        if not h:
            raise OSError(f"shm_ring_create({name}) failed")
        return cls(h, lib, name, owner=True)

    @classmethod
    def open(cls, name: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native shm_ring unavailable")
        h = lib.shm_ring_open(name.encode())
        if not h:
            raise OSError(f"shm_ring_open({name}) failed")
        return cls(h, lib, name, owner=False)

    def push(self, payload: bytes, timeout_ms: int = -1) -> bool:
        rc = self._lib.shm_ring_push(self._h, payload, len(payload),
                                     timeout_ms)
        if rc == -2:
            raise ValueError(
                f"message of {len(payload)} bytes exceeds ring capacity")
        return rc == 0

    def pop(self, timeout_ms: int = -1):
        """Returns bytes, None on timeout, or raises EOFError when the
        producer marked the ring closed and it drained."""
        n = self._lib.shm_ring_peek_len(self._h)
        size = max(int(n), 1 << 16)
        buf = ctypes.create_string_buffer(size)
        rc = self._lib.shm_ring_pop(self._h, buf, size, timeout_ms)
        while rc == -2:  # raced a bigger message in: regrow
            size *= 4
            buf = ctypes.create_string_buffer(size)
            rc = self._lib.shm_ring_pop(self._h, buf, size, timeout_ms)
        if rc == -1:
            return None
        if rc == -3:
            raise EOFError("producer closed")
        return buf.raw[:rc]

    def used(self) -> int:
        return int(self._lib.shm_ring_used(self._h))

    def mark_closed(self):
        self._lib.shm_ring_mark_closed(self._h)

    def close(self, unlink=None):
        if self._h:
            self._lib.shm_ring_close(
                self._h, 1 if (self._owner if unlink is None else unlink)
                else 0)
            self._h = None

    def __del__(self):
        try:
            self.close(unlink=False)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
