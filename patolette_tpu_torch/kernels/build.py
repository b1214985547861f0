"""Build and load the port's CUDA kernels.

Every source under ``patolette_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc -c`` per source, all started together), linked into
ONE shared library with a plain C interface, and loaded with ``ctypes``.
The library lives under ``build/kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once. Nothing is built when this
module is imported: :func:`library` builds on the first kernel launch.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "kernels"
SOURCES = ("segment_sum.cu", "lq_candidates.cu", "assign.cu", "kmeans.cu",
           "hilbert.cu", "dither.cu", "mbd.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libpatolette_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry points: name -> argument types (every one returns an int error).
SIGNATURES = {
    "pt_segment_sum": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "pt_lq_candidates": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "pt_assign_planar": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "pt_kmeans_step": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                       _P),
    "pt_hilbert_keys": (_L, _I, _I, _P, _P),
    "pt_dither_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "pt_mbd": (_P, _P, _P, _P, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")


def build() -> pathlib.Path:
    """Compile the sources if this hash has no library yet; return its
    path. Concurrent builders each work in their own directory and the
    first to finish publishes with an atomic rename."""
    final = BUILD_ROOT / source_hash()
    lib_path = final / LIB_NAME
    if lib_path.exists():
        return lib_path
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = BUILD_ROOT / f"{final.name}.tmp{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    nvcc = _nvcc()
    procs = []
    for name in SOURCES:
        obj = work / (name + ".o")
        procs.append((name, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log = []
    failed = []
    for name, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(log)[-8000:]
        )
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(work / LIB_NAME),
         *(str(work / (n + ".o")) for n in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
    (work / "build.log").write_text("\n".join(log))
    try:
        os.rename(work, final)
    except OSError:  # another process published the same hash first
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors) -> None:
    """Shared wrapper precondition: CUDA, contiguous, all on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
