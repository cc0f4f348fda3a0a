"""Build, bind and launch the hand-written CUDA kernels under ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
all started together) and links the objects into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), loaded
with :mod:`ctypes` at first use. The library lands in
``build/audioforge_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and flags: an edited source rebuilds, an unchanged one loads
the earlier build. A missing ``nvcc`` or a failed build raises with the
compiler's output.

Each launcher returns ``cudaGetLastError()``; :func:`launch` raises when it is
not 0 and otherwise adds one to the kernel's entry in :data:`launch_counts`.
A replay of a captured CUDA graph launches without Python: the serving
engine adds the launches its capture recorded to :data:`launch_counts` on
every replay. Inside :func:`recording_launches` a thread's launches go to a
dict of its own instead (a capture records its graph's launches there while
another thread keeps launching).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = [
    "BUILD_DIR",
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "add_launches",
    "recording_launches",
    "build",
    "library",
    "launch",
    "check_tensor",
    "check_aligned",
    "scalar",
    "stream_of",
    "resolve_device",
]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "audioforge_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Sources built with -fmad=false: every product and sum rounds on its own, as
# the plain twins' elementwise ops round them. These kernels compare smoothed
# levels with thresholds, and a contracted FMA would move a level by an ulp
# and flip a decision (the limiter form of max_affine_scan compares its target
# with the gain of the sample before; the RNNoise pitch tracker picks periods
# by comparing gains and scores).
NO_FMA_SOURCES = ("cleanup_scan.cu", "deesser_scan.cu", "gate_scan.cu",
                  "max_affine_scan.cu", "rnnoise_frame.cu", "silero_lstm.cu")

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# kernel name -> (C entry point, argtypes); every entry returns cudaError_t
KERNELS = {
    "env_scan": ("afk_env_scan", (_P, _P, _P, _P, _I, _I, _P)),
    "max_affine_scan": ("afk_max_affine_scan", (_P, _P, _P, _P, _P, _I, _I, _P)),
    "limiter_gain_scan": (
        "afk_limiter_gain_scan",
        (_P, _I, _P, _I, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _P)),
    "biquad_cascade": (
        "afk_biquad_cascade", (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P)),
    "compressor_scan": (
        "afk_compressor_scan",
        (_P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _I, _I, _P)),
    "gate_scan": (
        "afk_gate_scan",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _I, _I,
         _I, _P)),
    "deesser_scan": (
        "afk_deesser_scan", (_P, _P, _P, _P, _I, _I, _P, _I, _I, _P)),
    "cleanup_scan": (
        "afk_cleanup_scan",
        (_P,) * 12 + (_I, _I, _F, _F, _F, _I, _I, _D, _P)),
    "vad_front": ("afk_vad_front", (_P,) * 7 + (_I, _P)),
    "vad_lstm_head": ("afk_vad_lstm_head", (_P,) * 14 + (_I, _I, _P)),
    "dfn_features": ("afk_dfn_features", (_P,) * 8 + (_I, _F, _F, _P)),
    "dfn_spec_synth": ("afk_dfn_spec_synth", (_P,) * 8 + (_I, _P)),
    "rnnoise_pitch": ("afk_rnnoise_pitch", (_P,) * 12 + (_I, _P)),
    "rnnoise_features": ("afk_rnnoise_features", (_P,) * 15 + (_I, _P)),
}

# launches per kernel since the last reset, counted where the kernel launches
launch_counts = {name: 0 for name in KERNELS}


_counts_lock = threading.Lock()
_local = threading.local()


def reset_launch_counts() -> None:
    with _counts_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def add_launches(counts: dict) -> None:
    """Add ``counts`` (kernel -> launches) to :data:`launch_counts`, or to
    the calling thread's recording."""
    rec = getattr(_local, "recording", None)
    if rec is not None:
        for name, k in counts.items():
            rec[name] = rec.get(name, 0) + k
        return
    with _counts_lock:
        for name, k in counts.items():
            launch_counts[name] += k


@contextlib.contextmanager
def recording_launches():
    """Count the calling thread's launches into the yielded dict, not into
    :data:`launch_counts`, until the block ends."""
    outer = getattr(_local, "recording", None)
    _local.recording = {}
    try:
        yield _local.recording
    finally:
        _local.recording = outer


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        f"nvcc not found on PATH or under {home}: the CUDA kernels of "
        "audioforge_tpu_torch cannot be built")


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + NO_FMA_SOURCES).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libafk_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built.
    Returns the library path; the compiler's log sits beside it (``.log``)."""
    out = _library_path()
    if out.is_file():
        return out
    nvcc = _find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        sources = sorted(CSRC.glob("*.cu"))
        jobs = []
        for src in sources:
            fmad = ("-fmad=false",) if src.name in NO_FMA_SOURCES else ()
            cmd = [nvcc, *NVCC_FLAGS, *fmad, "-c", "-o", f"{tmp}/{src.stem}.o",
                   str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", f"{tmp}/lib.so", *(f"{tmp}/{src.stem}.o" for src in sources)]
        log = []
        for cmd, proc in jobs:
            log.append(proc.communicate()[0])
            if proc.returncode != 0:
                for _, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{log[-1]}")
        proc = subprocess.run(link, capture_output=True, text=True, check=False)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n{log[-1]}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(f"{tmp}/lib.so", out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for entry, argtypes in KERNELS.values():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.afk_error_string.argtypes = (ctypes.c_int,)
    lib.afk_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s launcher; raise if the launch was refused."""
    lib = library()
    err = getattr(lib, KERNELS[name][0])(*args)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.afk_error_string(err).decode()} "
            f"(cudaError {err})")
    add_launches({name: 1})


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — the kernels take raw pointers and trust their layout."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


def check_aligned(name: str, t: torch.Tensor, alignment: int) -> None:
    """Raise unless ``t``'s data starts on an ``alignment``-byte boundary (a
    kernel reads it as float2 or float4)."""
    if t.data_ptr() % alignment:
        raise ValueError(f"{name}: data is not {alignment}-byte aligned")


def scalar(v, device) -> torch.Tensor:
    """``v`` as a 0-d f32 tensor on ``device``; a kernel reads a control the
    serving engine keeps on the device through its pointer. A tensor already
    of that type and place is returned as it is."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; raise when it asks for a CUDA device
    and none is available (the entry points run on the card by default)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA device by default and none is available: "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle, after checking
    that ``device`` is the current CUDA device (the launchers use it)."""
    if device.index is not None and device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {device} but the current CUDA device is "
            f"{torch.cuda.current_device()}")
    return torch.cuda.current_stream(device).cuda_stream
