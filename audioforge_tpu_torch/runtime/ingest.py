"""Native host ingest: mixdown + resample + ring staging in one C call.

ctypes wrapper over ``native/ingest.cpp`` — the capture-callback-side
counterpart of the reference's RT input path; a copy of
``audioforge_tpu/runtime/ingest.py``. The polyphase table comes from
:mod:`..ops.resample` so the C and Python paths share one filter design.
Falls back to the Python mixdown/resample pipeline when the native library
is unavailable (phase-safe mono always uses the Python kernel — its delay
scan is block-adaptive, not stream-steady state).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops.resample import (
    OVERSAMPLING,
    PRODUCT_SINC_LEN,
    PRODUCT_WINDOW_NAME,
    _auto_cutoff,
    _phase_table,
)
from .ringbuffer import _get_lib

__all__ = ["NativeIngest", "native_ingest_available"]

_MIX_MODE_IDS = {"average": 0, "left": 1, "right": 2, "max_rms": 3}


def _ingest_lib():
    lib = _get_lib()
    if lib is None or not hasattr(lib, "afx_ingest_create"):
        return None
    if getattr(lib, "_afx_ingest_wired", False):
        return lib
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
    ptr = ctypes.c_void_p
    fptr = ctypes.POINTER(ctypes.c_float)
    lib.afx_ingest_create.restype = ptr
    lib.afx_ingest_create.argtypes = [
        ptr, i32, i32, i32, ctypes.c_double, ctypes.c_double, fptr
    ]
    lib.afx_ingest_destroy.argtypes = [ptr]
    lib.afx_ingest_push.restype = i64
    lib.afx_ingest_push.argtypes = [ptr, fptr, i64]
    lib._afx_ingest_wired = True
    return lib


def native_ingest_available() -> bool:
    return _ingest_lib() is not None


class NativeIngest:
    """Owns a native ingest pipeline writing into an existing native ring."""

    def __init__(self, ring, channels: int, mix_mode: str,
                 device_rate: float, engine_rate: float = 48000.0):
        self._lib = _ingest_lib()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        if mix_mode not in _MIX_MODE_IDS:
            raise ValueError(f"unsupported native mix mode {mix_mode!r}")
        ring_handle = getattr(ring, "_handle", None)
        if not ring_handle:
            raise RuntimeError("native ingest needs a native ring")
        if device_rate == engine_rate:
            sinc_len = 0
            table_ptr = None
        else:
            sinc_len = min(PRODUCT_SINC_LEN, 256)
            ratio = engine_rate / device_rate
            cutoff = round(
                _auto_cutoff(sinc_len, PRODUCT_WINDOW_NAME) * min(1.0, ratio), 9
            )
            table, _ = _phase_table(sinc_len, PRODUCT_WINDOW_NAME, cutoff)
            self._table = np.ascontiguousarray(np.asarray(table), np.float32)
            assert self._table.shape == (OVERSAMPLING + 3, sinc_len)
            table_ptr = self._table.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)
            )
        self._handle = self._lib.afx_ingest_create(
            ring_handle, int(channels), _MIX_MODE_IDS[mix_mode],
            sinc_len, float(device_rate), float(engine_rate), table_ptr,
        )
        if not self._handle:
            raise RuntimeError("failed to construct native ingest")

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and self._lib is not None:
            self._lib.afx_ingest_destroy(handle)
            self._handle = None

    # the native shim bounds one push to its fixed stack buffers
    # (`native/ingest.cpp` kMaxChunk); catch-up reads after a scheduling
    # stall can exceed it, so pushes are chunked here
    MAX_PUSH_FRAMES = 8192

    def push(self, interleaved: np.ndarray) -> int:
        """Feed interleaved float32 frames ``[n, channels]`` (or mono
        ``[n]``); returns frames written to the ring."""
        buf = np.ascontiguousarray(interleaved, np.float32)
        frames = buf.shape[0]
        total = 0
        for start in range(0, frames, self.MAX_PUSH_FRAMES):
            chunk = np.ascontiguousarray(
                buf[start: start + self.MAX_PUSH_FRAMES])
            written = self._lib.afx_ingest_push(
                self._handle,
                chunk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                chunk.shape[0],
            )
            if written < 0:
                raise RuntimeError(f"native ingest error {written}")
            total += int(written)
        return total
