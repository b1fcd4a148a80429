"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` is compiled on its own into a shared library with a
plain C interface (one ``nvcc`` per source, all started together) for
``sm_90a``, into ``build/repro_torch/<hash of the sources>/`` at the root
of the checkout.  Nothing is built when a module is imported: the first
kernel launch builds everything (or ``build_all()`` does, explicitly).

``LAUNCHES`` holds one plain integer per kernel wrapper; a wrapper adds one
where it launches its kernel and nowhere else.  ``ORACLE_CALLS`` counts the
calls that take a documented plain route of the reference on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("dense_matmat", "lowrank_matmat", "block_cholesky", "block_cholesky_solve",
           "aca", "morton", "recompress", "trsm_panels", "schur_dense",
           "hattention_nearfield", "hattention_nearfield_bwd")

LAUNCHES: dict[str, int] = {
    "batched_kernel_matvec": 0,
    "batched_kernel_matmat": 0,
    "batched_aca": 0,
    "batched_lowrank_matmat": 0,
    "batched_block_cholesky": 0,
    "batched_block_cholesky_solve": 0,
    "morton_encode": 0,
    "batched_recompress": 0,
    "batched_trsm_panels": 0,
    "batched_schur_dense": 0,
    "hattention_nearfield": 0,
    "hattention_nearfield_bwd": 0,
}

# calls of a documented plain route of the reference that a wrapper takes on
# the card (the QR + SVD oracle of batched_recompress below its Gram floor);
# not launches
ORACLE_CALLS: dict[str, int] = {"batched_recompress": 0}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, object] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, ORACLE_CALLS):
        for name in counts:
            counts[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source not yet built, in parallel, and load them all.

    Returns ``BUILD_INFO``: the build directory, the seconds the build took
    (0 when everything was built before) and ``nvcc``'s ``-Xptxas -v`` report
    per source.  Raises ``RuntimeError`` with the compiler's output on failure.
    """
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return BUILD_INFO
        out_dir = BUILD_ROOT / _source_hash()
        missing = [name for name in SOURCES if not (out_dir / f"lib{name}.so").exists()]
        nvcc = _nvcc() if missing else None
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in missing:
            lib = out_dir / f"lib{name}.so"
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, lib)
        reports, failed = {}, []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            reports[name] = out
            if proc.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (rc={proc.returncode})\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
        for name in SOURCES:
            _LIBS[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        BUILD_INFO.update(dir=str(out_dir), seconds=time.perf_counter() - t0,
                          ptxas=reports)
        return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def c_function(lib_name: str, fn_name: str, argtypes: list, restype=ctypes.c_int):
    """A C entry point with its ctypes signature set (pointers and the
    stream as ``c_void_p``, so they are not cut to 32 bits)."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
