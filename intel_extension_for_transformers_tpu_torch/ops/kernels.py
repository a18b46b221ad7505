"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled at first use by nvcc into one shared
library with a plain C interface, loaded with ctypes: pointers and the CUDA
stream go in as `c_void_p`, and each entry point returns `cudaGetLastError()`
after its launch. The library's name carries a hash of the sources, so an
edited kernel is rebuilt and a stale build is never loaded. Nothing is built
or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w, scales, zeros, codebook, out, M, N, K, group_size, scheme,
    # x_bf16, out_bf16, stream
    "itx_woq_int4": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, docs, vals, ids, B, N, D, size, n_tile, stream
    "itx_scan_top2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the build for the current sources lives (it may not exist yet)."""
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libitx_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Compile `csrc/*.cu` for sm_90a if needed and load the library."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in _sources() if s.suffix == ".cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.itx_error_string.argtypes = (ctypes.c_int,)
    lib.itx_error_string.restype = ctypes.c_char_p
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if status != 0:
        msg = load_kernels().itx_error_string(status).decode()
        raise RuntimeError(f"{name} failed: CUDA error {status} ({msg})")
