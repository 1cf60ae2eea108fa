"""Build, bind and count the port's CUDA kernels.

Each kernel lives in ``csrc/<name>.cu`` with a plain C interface; it may
include ``csrc/*.cuh`` headers, and editing one rebuilds every kernel that
includes it.  At first use it is compiled with ``nvcc`` for ``sm_90a`` into
``hbbft_tpu_torch/build/lib<name>.so`` and loaded with ``ctypes``; tensors
cross as ``data_ptr()`` ints and the launch goes to PyTorch's current
stream.  Every C entry point returns the ``cudaGetLastError()`` of its
launch, and :func:`check` raises on anything but success.

``LAUNCHES`` counts launches per kernel: a wrapper calls :func:`count`
exactly where it launches its kernel, so a run can prove the main path went
through it.  The count is taken under a lock: the pipelined epoch driver
launches ladders from a worker thread while the main thread launches SHA3.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

# kernel name → (source file, C entry point, its argument types)
_VP = ctypes.c_void_p
KERNELS = {
    "fp_mul_lazy": (
        "fp_mul_lazy.cu", "hb_fp_mul_lazy",
        [_VP, _VP, _VP, _VP, ctypes.c_int, _VP],
    ),
    "sha3_256": (
        "keccak.cu", "hb_sha3_256",
        [_VP, ctypes.c_int64, ctypes.c_int64, _VP, _VP],
    ),
    "ladder_lazy": (
        "ladder_lazy.cu", "hb_ladder_lazy",
        [_VP] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP],
    ),
    "ladder_window": (
        "ladder_window.cu", "hb_ladder_window",
        [_VP] * 11 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP],
    ),
    "bitplane": (
        "bitplane.cu", "hb_bitplane",
        [_VP, _VP, _VP] + [ctypes.c_int] * 4 + [ctypes.c_int64, _VP],
    ),
    "ladder_mxu": (
        "ladder_mxu.cu", "hb_ladder_mxu",
        [_VP] * 12 + [ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP],
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count(name: str) -> None:
    """One launch of kernel ``name``, from any thread."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """The kernel's ``.cu`` file and every ``csrc`` header it includes."""
    src = os.path.join(CSRC, KERNELS[name][0])
    with open(src) as fh:
        headers = _INCLUDE.findall(fh.read())
    return [src] + [os.path.join(CSRC, h) for h in headers]


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    return any(built < os.path.getmtime(src) for src in _sources(name))


def _start(name: str):
    """Start nvcc for one kernel; it writes a temporary file that
    :func:`_finish` renames into place."""
    os.makedirs(BUILD, exist_ok=True)
    tmp = _lib_path(name) + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, KERNELS[name][0])]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, _lib_path(name))
    return log


def build_all(force: bool = False) -> Dict[str, dict]:
    """Compile every stale kernel, one ``nvcc`` per source, all started
    together.  Returns ``{name: {"seconds", "ptxas"}}`` for what it built."""
    with _LOCK:
        names = [n for n in KERNELS if force or _stale(n)]
        t0 = time.perf_counter()
        procs = {n: _start(n) for n in names}
        out = {}
        for n, (proc, tmp) in procs.items():
            log = _finish(n, proc, tmp)
            out[n] = {
                "seconds": time.perf_counter() - t0,
                "ptxas": [ln.strip() for ln in log.splitlines()
                          if "ptxas" in ln or "spill" in ln],
            }
        return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    hit = _LIBS.get(name)
    if hit is not None:
        return hit
    if _stale(name):
        build_all()
    with _LOCK:
        if name not in _LIBS:
            cdll = ctypes.CDLL(_lib_path(name))
            _, entry, argtypes = KERNELS[name]
            fn = getattr(cdll, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            cdll.hb_error_string.argtypes = [ctypes.c_int]
            cdll.hb_error_string.restype = ctypes.c_char_p
            _LIBS[name] = cdll
    return _LIBS[name]


def check(name: str, rc: int) -> None:
    """Raise on a failed launch (``rc`` is its ``cudaGetLastError()``)."""
    if rc != 0:
        msg = lib(name).hb_error_string(rc).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {msg} ({rc})")


def stream_ptr(tensor) -> int:
    """PyTorch's current stream on ``tensor``'s device, as an int."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
