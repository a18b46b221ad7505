"""Build and load the port's CUDA kernels.

The sources under `csrc/` are compiled at first use by nvcc, one process per
source and all at once, then linked into one shared library with a plain C
interface, loaded with ctypes: pointers and the CUDA
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # x, w, scales, zeros, codebook, out, part, counters, M, N, K,
    # group_size, scheme, route, bm, k_chunk, vec, x_bf16, out_bf16, stream
    "itx_woq_int4": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, w, scales, zeros, out, part, counters, M, N, K, group_size, asym,
    # route, bm, k_chunk, vec, x_bf16, out_bf16, stream
    "itx_woq_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, docs, vals, ids, B, N, D, size, n_tile, route, stream
    "itx_scan_top2": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, words, scales, zeros, out, part, counters, M, N, K, Kp, group_size,
    # asym, m1, bm, k_chunk, vec, x_bf16, out_bf16, stream
    "itx_woq_w32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, B, T, S, H, Hkv, D, scale, causal, q_offset, bf16, stream
    "itx_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # q, packed, scales, row_ids, lists, base, out_s, out_i, B, nprobe, D, L,
    # G, group_size, bits, k, code_mult, code_offset, track_positions, stream
    "itx_ivf_scan_lists": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # in_s, in_i, out_s, out_i, B, R, k, stream
    "itx_ivf_merge_topk": (_P, _P, _P, _P, _I, _I, _I, _P),
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
        tag = f"{lib_path.stem}.{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        tmp = lib_path.with_name(f"{tag}.so.tmp")
        if not errors:
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                errors.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if errors:
            raise RuntimeError("\n".join(errors))
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
