"""SPSC float32 audio ring buffer: native C++ core with a Python fallback.

Mirrors the reference's RT `AudioRingBuffer` (`rust-core/src/audio/buffer.rs`):
lock-free single-producer/single-consumer staging between the audio callback
threads and the DSP thread, with dropped-sample and overflow-event counters
(never blocking). The native library (`native/ringbuffer.cpp` and
`native/ingest.cpp` at the root of the checkout, read as they are) is compiled
on first use with g++ into ``build/audioforge_tpu_torch/native/`` and loaded
through ctypes; when no toolchain is available a GIL-serialised numpy ring
with identical semantics takes over. Host code: the ring never touches the
GPU. Counterpart of ``audioforge_tpu/runtime/ringbuffer.py``.
"""

from __future__ import annotations

import ctypes
import os
import hashlib
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["AudioRing", "native_ring_available"]

_LIB = None
_LIB_LOCK = threading.Lock()
_NATIVE_DISABLED = os.environ.get("AUDIOFORGE_TPU_DISABLE_NATIVE", "") == "1"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audioforge_tpu_torch" / "native"


def _native_sources() -> list[Path]:
    base = Path(__file__).resolve().parents[2] / "native"
    return [base / "ringbuffer.cpp", base / "ingest.cpp"]


def _build_and_load():
    sources = [p for p in _native_sources() if p.exists()]
    if not sources:
        return None
    cache_dir = _BUILD_DIR
    cache_dir.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256()
    for p in sources:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    lib_path = cache_dir / f"libafxring_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            *[str(p) for p in sources], "-o", str(tmp),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None

    u64 = ctypes.c_uint64
    ptr = ctypes.c_void_p
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.afx_ring_create.restype = ptr
    lib.afx_ring_create.argtypes = [u64]
    lib.afx_ring_destroy.argtypes = [ptr]
    for name, res, args in (
        ("afx_ring_capacity", u64, [ptr]),
        ("afx_ring_available", u64, [ptr]),
        ("afx_ring_free_space", u64, [ptr]),
        ("afx_ring_write", u64, [ptr, fptr, u64]),
        ("afx_ring_read", u64, [ptr, fptr, u64]),
        ("afx_ring_discard", u64, [ptr, u64]),
        ("afx_ring_dropped", u64, [ptr]),
        ("afx_ring_overflow_events", u64, [ptr]),
    ):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    lib.afx_ring_reset_dropped.argtypes = [ptr]
    lib.afx_ring_clear.argtypes = [ptr]
    return lib


def _get_lib():
    global _LIB
    if _NATIVE_DISABLED:
        return None
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _build_and_load() or False
    return _LIB or None


def native_ring_available() -> bool:
    return _get_lib() is not None


class _NativeRing:
    def __init__(self, capacity: int):
        self._lib = _get_lib()
        self._handle = self._lib.afx_ring_create(int(capacity))
        if not self._handle:
            raise MemoryError("failed to allocate native audio ring")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and self._lib is not None:
            self._lib.afx_ring_destroy(handle)
            self._handle = None

    @property
    def capacity(self) -> int:
        return int(self._lib.afx_ring_capacity(self._handle))

    def available(self) -> int:
        return int(self._lib.afx_ring_available(self._handle))

    def free_space(self) -> int:
        return int(self._lib.afx_ring_free_space(self._handle))

    def write(self, samples) -> int:
        buf = np.ascontiguousarray(samples, np.float32)
        return int(
            self._lib.afx_ring_write(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                buf.size,
            )
        )

    def read(self, count: int) -> np.ndarray:
        out = np.empty(int(count), np.float32)
        n = self._lib.afx_ring_read(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.size,
        )
        return out[: int(n)]

    def discard(self, count: int) -> int:
        return int(self._lib.afx_ring_discard(self._handle, int(count)))

    def dropped(self) -> int:
        return int(self._lib.afx_ring_dropped(self._handle))

    def overflow_events(self) -> int:
        return int(self._lib.afx_ring_overflow_events(self._handle))

    def reset_dropped(self) -> None:
        self._lib.afx_ring_reset_dropped(self._handle)

    def clear(self) -> None:
        self._lib.afx_ring_clear(self._handle)


class _PythonRing:
    """Fallback with identical drop-don't-block semantics (lock-protected)."""

    def __init__(self, capacity: int):
        cap = 1
        while cap < capacity:
            cap <<= 1
        self._data = np.zeros(cap, np.float32)
        self._cap = cap
        self._head = 0
        self._tail = 0
        self._dropped = 0
        self._overflows = 0
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._cap

    def available(self) -> int:
        with self._lock:
            return self._head - self._tail

    def free_space(self) -> int:
        with self._lock:
            return self._cap - (self._head - self._tail)

    def write(self, samples) -> int:
        buf = np.ascontiguousarray(samples, np.float32).ravel()
        with self._lock:
            free = self._cap - (self._head - self._tail)
            n = min(buf.size, free)
            if n < buf.size:
                self._dropped += buf.size - n
                self._overflows += 1
            start = self._head & (self._cap - 1)
            first = min(n, self._cap - start)
            self._data[start : start + first] = buf[:first]
            self._data[: n - first] = buf[first:n]
            self._head += n
            return n

    def read(self, count: int) -> np.ndarray:
        with self._lock:
            avail = self._head - self._tail
            n = min(int(count), avail)
            start = self._tail & (self._cap - 1)
            first = min(n, self._cap - start)
            out = np.concatenate(
                [self._data[start : start + first], self._data[: n - first]]
            )
            self._tail += n
            return out

    def discard(self, count: int) -> int:
        with self._lock:
            n = min(int(count), self._head - self._tail)
            self._tail += n
            return n

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def overflow_events(self) -> int:
        with self._lock:
            return self._overflows

    def reset_dropped(self) -> None:
        with self._lock:
            self._dropped = 0

    def clear(self) -> None:
        with self._lock:
            self._tail = self._head


def AudioRing(capacity: int):
    """Create an SPSC audio ring (native when buildable, else Python)."""
    if _get_lib() is not None:
        return _NativeRing(capacity)
    return _PythonRing(capacity)
