"""Native (C++) host runtime, loaded with ctypes.

Counterpart of `bert_vits2_tpu/native/`: a threaded batch loader
(dataloader.cc) that fills fixed-shape training batches straight from
.npy / .wav files without holding the interpreter lock, in place of the
reference's DataLoader worker processes (train_ms.py:127-146).

Build model: compiled at first use with g++ (one small translation unit,
~1 s) into `build/` at the root of the checkout, named by a hash of the
source as `_build.py` names the CUDA libraries, so an edited source
rebuilds and an unchanged one loads at once. Nothing is built at import.
With no compiler, or when the build fails, `available()` is false and the
callers take the numpy path of `data/dataset.py`, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from bert_vits2_tpu_torch._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "dataloader.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"dataloader-{digest}.so"


def _build(out: Path) -> bool:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    tmp.replace(out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = lib_path()
        if not so.is_file() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.bv2_pool_create.restype = ctypes.c_void_p
        lib.bv2_pool_create.argtypes = [ctypes.c_int]
        lib.bv2_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.bv2_load_npy_batch.restype = ctypes.c_int
        lib.bv2_load_npy_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.bv2_load_wav_batch.restype = ctypes.c_int
        lib.bv2_load_wav_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (builds it on first call)."""
    return _load() is not None


class BatchLoader:
    """Persistent thread pool that fills padded batch rows in parallel.

    load_npy_into(paths, dst): dst [n, ...] float32 C-contiguous; each file's
    float32 payload is copied row-major into dst[i] (truncated to the row
    size, remainder zeroed). Returns (rows, cols) arrays with each source
    file's original 2-D shape (-1 where a file failed: the caller falls
    back).
    """

    def __init__(self, n_threads: int | None = None):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native dataloader unavailable (no g++?)")
        self._pool = self._lib.bv2_pool_create(n_threads or os.cpu_count() or 2)

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.bv2_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    @staticmethod
    def _paths_arr(paths):
        arr = (ctypes.c_char_p * len(paths))()
        arr[:] = [os.fsencode(p) for p in paths]
        return arr

    def load_npy_into(self, paths, dst: np.ndarray):
        n = len(paths)
        assert dst.dtype == np.float32 and dst.flags.c_contiguous
        assert dst.shape[0] == n
        stride = int(np.prod(dst.shape[1:], dtype=np.int64))
        rows = np.empty(n, np.int64)
        cols = np.empty(n, np.int64)
        self._lib.bv2_load_npy_batch(
            self._pool, self._paths_arr(paths), n,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            stride, stride,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        )
        return rows, cols

    def load_wav_into(self, paths, dst: np.ndarray):
        """dst [n, max_samples] float32; returns (lengths, sample_rates),
        -1 entries where a file failed or has an unsupported codec."""
        n = len(paths)
        assert dst.dtype == np.float32 and dst.flags.c_contiguous
        assert dst.shape[0] == n and dst.ndim == 2
        stride = int(dst.shape[1])
        lens = np.empty(n, np.int64)
        srs = np.empty(n, np.int32)
        self._lib.bv2_load_wav_batch(
            self._pool, self._paths_arr(paths), n,
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            stride, stride,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return lens, srs


__all__ = ["BatchLoader", "available"]
