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

The host half of the LUT route (``csrc/lut_map.cpp``, plain C++ on POSIX
threads: the map, and the decode of K6's run words) is built the same way by the host C++ compiler into
``build/host/<hash>/`` (:func:`host_library`); it runs on the CPU too, so
the tests reach it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "kernels"
SOURCES = ("segment_sum.cu", "lq_candidates.cu", "assign.cu", "kmeans.cu",
           "hilbert.cu", "dither.cu", "mbd.cu", "lut.cu", "colorspace.cu",
           "rle.cu", "gq_dp.cu")
HEADERS = ("common.cuh", "nearest.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libpatolette_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: name -> argument types (every one returns an int error).
SIGNATURES = {
    "pt_segment_sum": (_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "pt_lq_candidates": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P),
    "pt_assign_planar": (_P, _P, _P, _P, _P, _I, _I, _P, _P),
    "pt_kmeans_moments": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                          _P),
    "pt_kmeans_update": (_P, _P, _P, _I, _P, _P, _P),
    "pt_visit_order": (_I, _I, _I, _I, _P, _P),
    "pt_dither_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "pt_mbd": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "pt_lut_argmin": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P),
    "pt_nearest_probe": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "pt_color_convert": (_P, _P, _P, _I, _L, _L, _I, _I, _P, _P, _P, _P),
    "pt_pow_exact_check": (_D, _P, _P),
    "pt_rle_encode_u8_v2": (_P, _I, _P, _P, _L, _P),
    "pt_rle_encode_u8": (_P, _I, _P, _P, _L, _P),
    "pt_rle_encode_u16_v2": (_P, _I, _P, _P, _L, _P),
    "pt_gq_dp": (_P, _I, _I, _I, _P, _P, _P, _P, _P),
}

HOST_SOURCE = "lut_map.cpp"
HOST_ROOT = CSRC.parent.parent / "build" / "host"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
HOST_LIB_NAME = "libpatolette_host.so"
HOST_SIGNATURES = {
    "pt_lut_map": (_P, _L, _P, _I, _P, _I),
    "pt_rle_decode_u8_v2": (_P, _L, _P, _L),
    "pt_rle_decode_u8": (_P, _L, _P, _L),
    "pt_rle_decode_u16_v2": (_P, _L, _P, _L),
}

_lock = threading.Lock()
_lib = None
_host_lib = None
_scratch = {}


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


def _publish(final: pathlib.Path, lib_name: str, make) -> pathlib.Path:
    """Run ``make(work_dir)`` unless ``final`` already holds the library.
    Concurrent builders each work in their own directory and the first to
    finish publishes with an atomic rename."""
    lib_path = final / lib_name
    if lib_path.exists():
        return lib_path
    final.parent.mkdir(parents=True, exist_ok=True)
    work = final.parent / f"{final.name}.tmp{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    make(work)
    try:
        os.rename(work, final)
    except OSError:  # another process published the same hash first
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _make_kernels(work: pathlib.Path) -> None:
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


def build() -> pathlib.Path:
    """Compile the CUDA sources if this hash has no library yet; return
    its path."""
    return _publish(BUILD_ROOT / source_hash(), LIB_NAME, _make_kernels)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler found (set CXX or PATH)")
    return cxx


def host_build() -> pathlib.Path:
    """Compile ``csrc/lut_map.cpp`` with the host C++ compiler (keyed by
    the source, the flags and the compiler's version) and return the
    library's path."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    h = hashlib.sha256(" ".join([cxx, *HOST_FLAGS, version]).encode())
    h.update((CSRC / HOST_SOURCE).read_bytes())

    def make(work):
        res = subprocess.run(
            [cxx, *HOST_FLAGS, str(CSRC / HOST_SOURCE), "-o",
             str(work / HOST_LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"host build failed:\n{res.stdout[-8000:]}")

    return _publish(HOST_ROOT / h.hexdigest()[:16], HOST_LIB_NAME, make)


def _load(path: pathlib.Path, signatures: dict):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _load(build(), SIGNATURES)
    return _lib


def host_library():
    """The loaded host library (built on first use)."""
    global _host_lib
    if _host_lib is not None:
        return _host_lib
    with _lock:
        if _host_lib is None:
            _host_lib = _load(host_build(), HOST_SIGNATURES)
    return _host_lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def scratch(name: str, numel: int, dtype, device, zero: bool = False):
    """A flat device buffer of at least ``numel`` elements that the kernels
    asking for ``name`` reuse from call to call (kept per name, type and
    device; replaced by a larger one when a call needs more). The kernels
    run in order on the current stream, so one call's use of it ends
    before the next call's begins; K1, K2 and K4 share ``"partials"``
    (each is done with its partial sums when its launches end). ``zero``:
    zero-filled when made (tickets and hand-over words, which the
    kernels leave zero)."""
    import torch

    key = (name, dtype, device)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < numel:
        make = torch.zeros if zero else torch.empty
        buf = make((max(numel, 1),), dtype=dtype, device=device)
        _scratch[key] = buf
    return buf


def clear_scratch() -> None:
    """Release every kernel's reused buffers."""
    _scratch.clear()


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count


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
