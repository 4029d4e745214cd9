"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface and include no PyTorch
header, so ``nvcc`` needs seconds, not minutes.  At first use every ``.cu``
file is compiled for ``sm_90a`` into an object (one ``nvcc`` process per
source, all started together), the objects are linked into ONE shared
library under ``_build/`` and the library is loaded with ``ctypes``.  The
library's name carries a hash of the sources, so an edited source rebuilds
and an unchanged one does not.

Nothing here runs at import time: modules that hold a kernel import this
one lazily, inside the wrapper that launches, so the package imports on a
machine with no compiler and no GPU.  A failed build raises; nothing falls
back to another implementation.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_lib = None
#: what nvcc printed for each source in the last ``build(verbose=True)``
BUILD_LOG: dict = {}


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _sources(csrc_dir: str = CSRC_DIR) -> list[str]:
    return sorted(f for f in os.listdir(csrc_dir) if f.endswith(".cu"))


def _source_hash(csrc_dir: str = CSRC_DIR) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(csrc_dir)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(csrc_dir, name), "rb") as fh:
                h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False, csrc_dir: str = CSRC_DIR) -> str:
    """Compile (if needed) and return the path of the shared library.
    ``verbose`` always compiles and prints what ``ptxas -v`` says of every
    kernel (registers, shared memory, spills).  ``csrc_dir`` names another
    directory of sources with the same C interface (an earlier version of
    the kernels, to be timed beside this one)."""
    tag = _source_hash(csrc_dir)
    so_path = os.path.join(BUILD_DIR, f"libhso_kernels_{tag}.so")
    if os.path.exists(so_path) and not verbose:
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = []
    for src in _sources(csrc_dir):
        obj = os.path.join(BUILD_DIR, f"{os.path.splitext(src)[0]}_{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", csrc_dir, "-c",
               os.path.join(csrc_dir, src), "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for src, obj, p in procs:          # every process is waited for
        out, _ = p.communicate()
        if verbose:
            BUILD_LOG[src] = out
            print(out)
        if p.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
        objs.append(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = so_path + f".tmp{os.getpid()}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so_path)
    return so_path


def kernel_resources(log: str) -> dict:
    """What ``ptxas -v`` said of each kernel in one source's compiler output:
    ``{mangled entry name: {registers, stack, spill_stores, spill_loads,
    smem}}`` (bytes but for the registers; ``smem`` is the static part)."""
    found, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            found[entry] = {}
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            found[entry].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            found[entry]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            found[entry]["smem"] = int(sm.group(1)) if sm else 0
    return found


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class LevelTable(ctypes.Structure):
    """Host-side table of pyramid level pointers and dims (``csrc/window.cu``)."""
    MAX_LEVELS = 8
    _fields_ = [("img", _P * 8), ("h", _I * 8), ("w", _I * 8)]


class WindowJob(ctypes.Structure):
    """One job of ``hso_extract_windows_jobs``: the windows of one image
    (``csrc/window.cu``)."""
    _fields_ = [("img", _P), ("h", _I), ("w", _I), ("au", _P), ("av", _P), ("n", _I),
                ("out", _P)]


class PatternTable(ctypes.Structure):
    """Pattern offsets of one coarse level (``csrc/coarse.cu``)."""
    MAX_POINTS = 32
    _fields_ = [("dx", _I * 32), ("dy", _I * 32)]


#: every pointer and the stream are declared c_void_p: without ``argtypes``
#: ctypes passes a Python int as a 32-bit C int and cuts the pointer
_SIGNATURES = {
    "hso_extract_windows": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "hso_pack_level_windows": [ctypes.POINTER(LevelTable), _I, _P, _P, _P, _I, _I, _P, _P],
    "hso_extract_windows_jobs": [ctypes.POINTER(WindowJob), _I, _I, _P],
    "hso_coarse_level_ic": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _F, _F, _F, _F, _I, _I, _I, _I,
                            ctypes.POINTER(PatternTable), _I, _I, _I, _I, _I, _P, _P],
    "hso_coarse_level_ic_model": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _F, _F, _F, _F, _I, _I, _I, _I,
                                  ctypes.POINTER(PatternTable), _I, _I, _I, _I, _I,
                                  _I, _F, _F, _F, _F, _F, _P, _P],
    "hso_align_match": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    "hso_pose_lm": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "hso_zmncc_line_scores": [_P] * 11 + [_I, _I, _I] + [_P, _P, _P, _P],
    "hso_coarse_launch_plan": [_I, _I, ctypes.POINTER(_I * 4)],
    "hso_zmncc_launch_plan": [_I, _I, _I, ctypes.POINTER(_I * 3)],
    "hso_align_launch_plan": [_I, _I, ctypes.POINTER(_I * 3)],
    "hso_window_launch_plan": [_I, _I, _I, ctypes.c_ulonglong, ctypes.POINTER(_I * 3)],
    "hso_coarse_plan_override": [_I, _I],
    "hso_probe_latency": [_I, _I, _I, _I, _P, _P],
    "hso_if_node_begin": [_P, _P, _I, _P],
    "hso_if_node_end": [_P, ctypes.POINTER(ctypes.c_longlong),
                        ctypes.POINTER(ctypes.c_longlong)],
    "hso_capture_counts": [_P, ctypes.POINTER(ctypes.c_longlong),
                           ctypes.POINTER(ctypes.c_longlong)],
    "hso_probe_tma": [_I, _P, _I, _I, _P, _P],
}


def load(so_path: str) -> ctypes.CDLL:
    """Load a built library and declare the signatures of the functions it
    has (an earlier version of the sources may lack the newer ones)."""
    handle = ctypes.CDLL(so_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _I
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


@contextlib.contextmanager
def using_lib(handle: ctypes.CDLL):
    """Route every wrapper to another build of the kernels (an earlier version
    of the sources, to be held against this one) while the block runs."""
    global _lib
    old, _lib = _lib, handle
    try:
        yield
    finally:
        _lib = old


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def check_tensor(t, dtype, shape: tuple, device, name: str) -> None:
    """Raise unless ``t`` is what a kernel takes: on a CUDA device (the
    given one), of the dtype and the shape, and contiguous (a kernel reads
    raw pointers)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: a CUDA kernel was handed tensors on {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
