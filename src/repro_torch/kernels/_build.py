"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Every source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface under
``build/kernels/`` at the repository root (``.gitignore`` lists it).  A
library's file name carries a hash of its source and flags, so an
up-to-date build from an earlier process is loaded as it is and an edited
source is rebuilt.  Nothing here runs when the module is imported: the CPU
tests import every module, and the CPU has no ``nvcc``.

``build_count`` counts how often this process resolved the libraries
(compiled or loaded).  It stays at 1 for the life of a process: a new
straggler mask or a new shape is a kernel argument, never a new build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["library", "build_count", "build_log", "BUILD_DIR", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
# C entry point of each source: (name, argtypes); every one returns the
# launch's cudaError_t as an int
_ENTRY = {
    "berrut_combine": ("berrut_combine_launch",
                       [_VP, _VP, _VP, _I, _I, _I64, _I, _VP]),
    "coded_matmul": ("coded_matmul_launch",
                     [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP]),
    "mask_add": ("mask_add_launch",
                 [_VP, _VP, _VP, _I64, _I, _I64,
                  ctypes.POINTER(ctypes.c_uint32), _I, _I, _VP]),
    "flash_attention": ("flash_attention_launch",
                        [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                         ctypes.POINTER(ctypes.c_int64), _F, _F, _I, _I,
                         _VP]),
}

build_count = 0
build_log: dict = {}     # source stem -> nvcc's stderr (ptxas register report)
_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{digest[:16]}.so"


def _build_all() -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {stem: _target(stem) for stem in _ENTRY}
    todo = {stem: t for stem, t in targets.items() if not t.exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for stem, target in todo.items():
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, target)
    failed = []
    for stem, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        build_log[stem] = (out or "") + (err or "")
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n"
                          f"{build_log[stem]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    libs = {}
    for stem, target in targets.items():
        lib = ctypes.CDLL(str(target))
        name, argtypes = _ENTRY[stem]
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[stem] = fn
    return libs


def library(stem: str):
    """The bound C launch function of ``csrc/<stem>.cu``, building every
    kernel library on the first call of the process."""
    global build_count, _libs
    with _lock:
        if not _libs:
            _libs = _build_all()
            build_count += 1
    return _libs[stem]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
