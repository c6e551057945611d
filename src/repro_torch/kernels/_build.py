"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``repro_torch/csrc/<name>.cu`` has a plain C interface and is compiled
on its own by ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` at the repository root, named by a hash of
its source and flags, so a changed source is rebuilt and an unchanged one
is reused. All missing libraries are compiled in parallel, one ``nvcc``
process per source. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
_F = ctypes.c_float
_FLASH = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
_DECODE = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
#: C signatures of each library's entry points: {symbol: argtypes}
SIGNATURES: Dict[str, Dict[str, list]] = {
    "kmeans_assign": {
        "kmeans_assign_tiled_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "kmeans_assign_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
        "kmeans_assign_attributes": [_I, _I, _I, _I, _P],
    },
    "window_agg": {
        "window_agg_scan_f32": [_P, _P, _I, _I, _I, _I, _P],
        "window_agg_f32": [_P, _P, _I, _I, _I, _I, _I, _P],
        "window_agg_global_f32": [_P, _P, _I, _I, _I, _I, _I, _P],
        "window_agg_attributes": [_I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_f32": _FLASH,
        "flash_attention_bf16": _FLASH,
        "flash_attention_wide_f32": _FLASH,
        "flash_attention_wide_bf16": _FLASH,
        "flash_attention_attributes": [_I, _I, _P],
    },
    "decode_attention": {
        "decode_attention_f32": _DECODE,
        "decode_attention_bf16": _DECODE,
        "decode_attention_wide_f32": _DECODE,
        "decode_attention_wide_bf16": _DECODE,
        "decode_attention_attributes": [_I, _I, _I, _P],
    },
}
SOURCES = tuple(SIGNATURES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library of ``names`` that is not built yet, all at once.

    Raises with nvcc's stderr when a compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}  # det: ok key-addressed
    procs = {}
    for name, out in todo.items():  # det: ok one compile per source; order is irrelevant
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), tmp)
    errors = []
    for name, (proc, tmp) in procs.items():  # det: ok waits on every compile
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` declared on each entry point of :data:`SIGNATURES`; call
    an entry point as an attribute, e.g. ``library(name).window_agg_f32``."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for symbol, argtypes in SIGNATURES[name].items():  # det: ok key-addressed
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
