"""Build and load the port's CUDA kernels (ops/csrc/).

Each ``csrc/*.cu`` file is compiled by ``nvcc`` on first use into its own
shared library with a plain C interface, under
``<checkout>/build/aiocluster_torch/`` and named by a hash of every
source and of the flags, and loaded with ``ctypes``. Sources are built
in parallel (one ``nvcc`` each, all started together). A missing
``nvcc`` or a failed build raises: nothing falls back.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so no multiply
and add are contracted into an FMA (bit parity with the reference's
float32 arithmetic); never ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aiocluster_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float

# C signature of each library's entry point (argtypes in order).
SIGNATURES = {
    "pairs_pull": (
        "aiocluster_pairs_pull",
        [_P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _P, _P, _P, _P, _P, _P,
         _I, _P, _P, _P, _P, _P, _F, _I, _F, _F, _F, _I, _I, _I, _I, _I,
         _I, _P, _P, _I, _P],
    ),
    "pairs_totals": (
        "aiocluster_pairs_totals",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "m8_pull": (
        "aiocluster_m8_pull",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "m8_totals": (
        "aiocluster_m8_totals",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "fd": (
        "aiocluster_fd",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _F, _F, _I, _I, _P],
    ),
}

# Libraries of staged kernels, which export aiocluster_<name>_static_smem.
STATIC_SMEM_QUERIES = ("pairs_pull", "m8_pull")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None  # wall time of the last build_all()
ptxas_report: dict[str, str] = {}  # nvcc's resource report per library


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "aiocluster_torch are built from source at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_source_hash()}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Build every library that is not built yet (one nvcc per source,
    all at once) and load them all. Raises on any failure."""
    global build_seconds
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    procs = []
    for name in todo:
        out = _lib_path(name)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, out, tmp, proc))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    for name in SIGNATURES:
        load(name)
    build_seconds = time.perf_counter() - start
    return dict(_libs)


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building everything on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all()
        return _libs[name]
    lib = ctypes.CDLL(str(path))
    entry, argtypes = SIGNATURES[name]
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if name in STATIC_SMEM_QUERIES:
        query = getattr(lib, f"aiocluster_{name}_static_smem")
        query.argtypes = [ctypes.POINTER(_I)]
        query.restype = ctypes.c_int
    lib.aiocluster_error_string.argtypes = [ctypes.c_int]
    lib.aiocluster_error_string.restype = ctypes.c_char_p
    _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.aiocluster_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
