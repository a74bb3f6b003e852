"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``avsiam_tpu_torch/csrc/*.cu`` have a plain C interface. At
first use, ``library()`` compiles each source with ``nvcc`` for ``sm_90a``
(all sources at once, one process each), links the objects into one shared
library under ``build/avsiam_tpu_torch/`` at the root of the checkout (named
by a hash of the sources and flags, so an edit rebuilds it) and loads it with
ctypes. Nothing is built when a module is imported: the CPU tests import
every module of the port and have no ``nvcc``.

``LAUNCHES`` holds one plain integer per kernel wrapper of the step's work
(the phase stamps of ``utils/profiling.py`` are not counted); a wrapper
adds one where it launches its kernel and nowhere else, so a run can show
that the main path went through the kernels. A CUDA graph's replay runs no wrapper:
the graphed pretrain step keeps the counts its capture added and adds them
again at each later replay (``add_launches``), so a count still reads
launches per step.
"""

from __future__ import annotations

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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "avsiam_tpu_torch"
SOURCES = ("attention.cu", "attention_hm.cu", "layernorm.cu", "ln_mlp.cu",
           "mlp.cu", "stamp.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0, "ln_mlp_fwd": 0,
            "mlp_fwd": 0, "mlp_bwd": 0, "mlp_bwd_dx": 0, "mlp_dw": 0,
            "ln_bwd": 0, "attention_hm_fwd": 0, "attention_hm_bwd": 0,
            "mlp_gelu_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p, or ctypes would
# pass them as 32-bit ints and cut them
_SIGNATURES = {
    # qkv, key_valid, out, stats, B, N, H, D, dtype, scale, stream
    "avsiam_attn_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # qkv, key_valid, out, dout, stats, delta, dqkv, B, N, H, D, dtype,
    # scale, stream
    "avsiam_attn_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                        _P),
    # x, ln_g, ln_b, n16, rows, D, dtype, eps, stream
    "avsiam_ln_mlp_rows": (_P, _P, _P, _P, _I, _I, _I, _F, _P),
    # x16, w1, b1, hpre (or None), act16, rows, D, H, dtype, gelu form,
    # stream
    "avsiam_mlp_fc1": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # act16, w2, b2, x (residual, or None), out, partial (or None), rows, D,
    # H, splits, dtype, stream
    "avsiam_mlp_fc2": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x16, w1, b1, w2, do16, gh, act, gh16, colsum (or None), db1 (or
    # None), rows, D, H, dtype, gelu form, stream
    "avsiam_mlp_bwd_gh": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _I, _I, _P),
    # dh, hpre, gh, act, colsum, db1, rows, H, dtype, gelu form, stream
    "avsiam_mlp_gelu_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # gh16, w1, dx, partial (or None), rows, D, H, splits, dtype, stream
    "avsiam_mlp_bwd_dx": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # a, g, dw, db, rows, m, n, tile rows, tile columns, dtype, stream
    "avsiam_mlp_dw": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, dy, scale, dx, dgamma, dbeta, stats, rows, C, rows per warp,
    # row ranges, dtype, eps, stream
    "avsiam_ln_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                      _P),
    # q, k, v, key_valid, out, stats, B, N, H, D, batch stride, row stride,
    # dtype, scale, stream
    "avsiam_attn_hm_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                           _I, _F, _P),
    # q, k, v, key_valid, out, dout, stats, delta, dq, dk, dv, B, N, H, D,
    # batch stride, row stride, dtype, scale, stream
    "avsiam_attn_hm_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _I, _L, _L, _I, _F, _P),
    # out (uint64 slots), slot, stream: utils/profiling.py's phase marks
    "avsiam_phase_stamp": (_P, _I, _P),
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib = None
_build_error = None  # a failed build is not retried in the same process


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(delta: dict) -> None:
    """Add ``delta`` ({kernel: launches}) to the counts: what a replayed
    CUDA graph launched, as its capture counted it."""
    for k, n in delta.items():
        LAUNCHES[k] += n


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _build(nvcc: str, lib_path: Path) -> None:
    """Compile every source in parallel, then link them into ``lib_path``;
    the compilers' output (registers, spills) goes to ``build.log``. Objects
    and the library are written in a private directory and the library is
    renamed into place, so concurrent builds cannot mix their files."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / f"{Path(src).stem}.o"
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        log, failed = [], []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            log.append(f"== {src} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if not failed:
            tmp_lib = Path(tmp) / lib_path.name
            link = subprocess.run(
                [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}")
            if link.returncode == 0:
                os.replace(tmp_lib, lib_path)
            else:
                failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log)[-6000:])


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise _build_error
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.iterdir()):
            digest.update(src.name.encode() + src.read_bytes())
        lib_path = BUILD_DIR / f"libavsiam_tpu_torch_{digest.hexdigest()[:12]}.so"
        if not lib_path.exists():
            try:
                _build(_nvcc(), lib_path)
            except RuntimeError as err:
                _build_error = err
                raise
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
