"""The port's own ctypes binding of the native host DSP library
(``native/dsp.cpp``, host C++: a WAV parser and a Kaldi fbank).

The library accelerates the host data plane (WAV parse + fbank), the
reference's torchaudio/Kaldi C++ surface. Its ``.so`` is a build output, not
a file of the checkout: ``available()`` builds it with ``make -C native`` at
first use (once a process) and is false when it cannot be built, as
``avsiam_tpu/data/native_dsp.py`` is when the library is absent; the callers
then take the NumPy and stdlib paths.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LIB_NAME = "libavsiam_dsp.so"


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "native")


_build_lock = threading.Lock()
_build_tried = []  # one attempt a process


def build(quiet: bool = True) -> bool:
    """Build the library with make; returns True on success."""
    try:
        subprocess.run(["make", "-C", _native_dir()],
                       capture_output=quiet, check=True)
        # an earlier available() may have cached a None handle from before
        # the library existed — drop it so the fresh build is picked up
        _load.cache_clear()
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    path = os.path.join(_native_dir(), _LIB_NAME)
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.wav_read_pcm16.restype = ctypes.c_int
    lib.wav_read_pcm16.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.mean_center.restype = None
    lib.mean_center.argtypes = [np.ctypeslib.ndpointer(np.float32),
                                ctypes.c_int64]
    lib.fbank_num_frames.restype = ctypes.c_int
    lib.fbank_num_frames.argtypes = [ctypes.c_int64, ctypes.c_double,
                                     ctypes.c_double, ctypes.c_double]
    lib.fbank.restype = ctypes.c_int
    lib.fbank.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")]
    return lib


def available() -> bool:
    """Whether the library loads, building it first (once a process) when
    it is missing."""
    with _build_lock:
        if _load() is None and not _build_tried:
            _build_tried.append(True)
            build()
    return _load() is not None


def _library() -> ctypes.CDLL:
    if not available():
        raise RuntimeError("native DSP library not built (make -C native)")
    return _load()


def read_wav_mono(path: str) -> Tuple[np.ndarray, int]:
    """PCM16 WAV -> (mono float32 [-1, 1], sample_rate) via native parse."""
    lib = _library()
    with open(path, "rb") as f:
        data = f.read()
    n = ctypes.c_int64()
    ch = ctypes.c_int32()
    sr = ctypes.c_int32()
    rc = lib.wav_read_pcm16(data, len(data), None, ctypes.byref(n),
                            ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"native WAV parse failed ({rc}) for {path}")
    out = np.empty(n.value, dtype=np.float32)
    lib.wav_read_pcm16(data, len(data),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    return out, int(sr.value)


def mean_center(x: np.ndarray) -> np.ndarray:
    lib = _library()
    # always copy: the C function centers in place, and the pure
    # media.mean_center this replaces returns a NEW array
    x = np.array(x, dtype=np.float32, order="C", copy=True)
    lib.mean_center(x, x.size)
    return x


def fbank(waveform: np.ndarray, sample_freq: float = 16000.0,
          num_mel_bins: int = 128, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0, preemph: float = 0.97,
          remove_dc: bool = True) -> np.ndarray:
    """Native Kaldi-compatible fbank; same numerics as ops/fbank.py's
    ``kaldi_fbank_np``."""
    lib = _library()
    w = np.ascontiguousarray(waveform, dtype=np.float32)
    m = lib.fbank_num_frames(w.size, sample_freq, frame_length_ms,
                             frame_shift_ms)
    out = np.empty((max(m, 0), num_mel_bins), dtype=np.float32)
    rc = lib.fbank(w, w.size, sample_freq, num_mel_bins, frame_length_ms,
                   frame_shift_ms, preemph, int(remove_dc), out)
    if rc < 0:
        raise ValueError("fbank failed (waveform too short?)")
    return out
