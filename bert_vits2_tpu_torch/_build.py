"""Build and load the hand-written Hopper kernels.

Each source in `csrc/` compiles with nvcc into its own shared library with a
plain C interface (`-gencode arch=compute_90a,code=sm_90a`), loaded with
ctypes. Libraries land in `build/` at the root of the checkout, named by a
hash of their source and of the shared headers (`csrc/*.cuh`), so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time: the first kernel launch builds what it needs, and `build_all`
builds every source in parallel (one nvcc process per source, all started
together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("banded_attn.cu", "banded_attn_bwd.cu", "banded_attn_wide.cu", "mrf.cu",
           "mas.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points, by source
SIGNATURES = {
    "banded_attn.cu": {
        # q, k, v, mask, ek, ev, out, b, h, t, d, w, device, stream
        "banded_attn_fwd": [_P] * 7 + [_I] * 6 + [_P],
        # q, k, v, mask, ek, ev, out, m, l, b, h, t, d, w, drop, thr, seed,
        # salt_base, salt_stride, scale, device, stream
        "banded_attn_fwd_train": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
        # as banded_attn_fwd, every tensor bf16
        "banded_attn_fwd_bf16": [_P] * 7 + [_I] * 6 + [_P],
        # as banded_attn_fwd_train: q, k, v, mask, ek, ev, out bf16; m, l fp32
        "banded_attn_fwd_train_bf16": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
    },
    "banded_attn_bwd.cu": {
        # b, h, t
        "banded_attn_bwd_q_blocks": [_I] * 3,
        # q, k, v, mask, ek, ev, g, m, l, D, dq, partials, dek, dev, b, h, t,
        # d, w, drop, thr, seed, salt_base, salt_stride, scale, device, stream
        "banded_attn_bwd_q": [_P] * 14 + [_I] * 10 + [_F, _I, _P],
        # q, k, v, mask, ek, ev, g, m, l, D, dk, dv, b, h, t, d, w, drop, thr,
        # seed, salt_base, salt_stride, scale, device, stream
        "banded_attn_bwd_k": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
        # as the two above: q, k, v, mask, ek, ev, g and the outputs dq, dek,
        # dev, dk, dv bf16; m, l, D and the partials fp32
        "banded_attn_bwd_q_bf16": [_P] * 14 + [_I] * 10 + [_F, _I, _P],
        "banded_attn_bwd_k_bf16": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
    },
    "banded_attn_wide.cu": {
        # as banded_attn.cu's two entry points
        "banded_attn_wide_fwd": [_P] * 7 + [_I] * 6 + [_P],
        "banded_attn_wide_fwd_train": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
        "banded_attn_wide_fwd_bf16": [_P] * 7 + [_I] * 6 + [_P],
        # q, k, v, mask, ek, ev, g, m, l, D, dq, band_ds, band_pd, dek, dev,
        # b, h, t, d, w, drop, thr, seed, salt_base, salt_stride, scale,
        # device, stream
        "banded_attn_wide_bwd_q": [_P] * 15 + [_I] * 10 + [_F, _I, _P],
        # as banded_attn_bwd.cu's banded_attn_bwd_k
        "banded_attn_wide_bwd_k": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
        # the train forward, B5 and B6 on bf16 operands (m, l, D and the
        # band scratch fp32), arguments as above
        "banded_attn_wide_fwd_train_bf16": [_P] * 9 + [_I] * 10 + [_F, _I, _P],
        "banded_attn_wide_bwd_q_bf16": [_P] * 15 + [_I] * 10 + [_F, _I, _P],
        "banded_attn_wide_bwd_k_bf16": [_P] * 12 + [_I] * 10 + [_F, _I, _P],
    },
    "mrf.cu": {
        # x, mask, weights, out, b, c, t, tile, nb, ks, ns, dils, offs,
        # device, stream
        "mrf_fwd": [_P] * 4 + [_I] * 5 + [_P] * 4 + [_I, _P],
        # x, mask, weights, acc, out, then as mrf_fwd
        "mrf_fwd_bf16": [_P] * 5 + [_I] * 5 + [_P] * 4 + [_I, _P],
    },
    "tc_probe.cu": {  # built on demand by utils/tc_probe.py, not by build_all
        # A, B, D, lbo, sbo, stream
        "tc_probe_layout": [_P] * 3 + [_I] * 2 + [_P],
        # sink, kind, iters, blocks, stream
        "tc_probe_rate": [_P] + [_I] * 3 + [_P],
    },
    "mas.cu": {
        # neg_cent, t_ys, t_xs, path, decisions (or NULL), b, t_y, t_x, k,
        # warps, shared-memory bytes, device, stream
        "mas_fwd": [_P] * 5 + [_I] * 7 + [_P],
        # out, steps, kind, threads, device, stream
        "mas_link_probe": [_P] + [_I] * 4 + [_P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(source: str) -> Path:
    h = hashlib.sha1((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str) -> tuple[Path, subprocess.Popen | None]:
    out = _lib_path(source)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish(source: str, out: Path, proc: subprocess.Popen | None) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    tmp.replace(out)
    return log


def _load(source: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_all() -> dict[str, str]:
    """Build every kernel source in parallel and load it.

    Returns the compiler's output per source (empty for a source whose
    library was already built)."""
    with _lock:
        started = {s: _start(s) for s in SOURCES if s not in _libs}
        logs = {s: _finish(s, *started[s]) for s in started}
        for s in started:
            _libs[s] = _load(s, started[s][0])
    return logs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        if source not in _libs:
            path, proc = _start(source)
            _finish(source, path, proc)
            _libs[source] = _load(source, path)
        return _libs[source]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError_t {err}")
