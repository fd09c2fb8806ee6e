"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Every source under ``csrc/`` is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface under
``build/kernels/`` at the repository root (``.gitignore`` lists it).  A
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an up-to-date build from an earlier
process is loaded as it is and an edited source or header is rebuilt.
nvcc's output (ptxas's ``-v`` register report) is kept beside each library
as ``lib<stem>-<hash>.log``, so ``build_log`` holds every source's report
whether this process compiled it or loaded it.
The tensor-core kernels reach the driver's ``cuTensorMapEncodeTiled``
through the runtime's ``cudaGetDriverEntryPointByVersion``
(``csrc/hopper.cuh``), so nothing links ``-lcuda``.  Nothing here runs
when the module is imported: the CPU tests import every module, and the
CPU has no ``nvcc``.

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

__all__ = ["library", "function", "load_prebuilt", "build_count",
           "build_log", "BUILD_DIR", "NVCC_FLAGS"]

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
                     [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                      _I, _VP]),
    "mask_add": ("mask_add_launch",
                 [_VP, _VP, _VP, _I64, _I, _I64,
                  ctypes.POINTER(ctypes.c_uint32), _I, _I, _VP]),
    "flash_attention": ("flash_attention_launch",
                        [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                         _I, _I, ctypes.POINTER(ctypes.c_int64), _F, _F, _I,
                         _I, _I, _VP]),
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                             _VP, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_int64), _F, _F, _I, _I,
                             _I, _VP]),
}
# further C functions of a source: name -> (source stem, argtypes)
_HELPERS = {
    "coded_matmul_scratch": ("coded_matmul",
                             [_I, _I, _I, _I, ctypes.POINTER(_I64)]),
    "berrut_combine_load_path": ("berrut_combine", [_VP, _I64, _I]),
    "flash_attention_scratch": ("flash_attention",
                                [_I, _I, _I, _I, _I, _I, _I,
                                 ctypes.POINTER(_I64)]),
    "flash_attention_split": ("flash_attention",
                              [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                               _I, ctypes.POINTER(_I64), _F, _VP]),
    "flash_attention_bwd_scratch": ("flash_attention_bwd",
                                    [_I, _I, _I, _I, _I, _I, _I, _I,
                                     ctypes.POINTER(_I64)]),
    "flash_attention_bwd_split": ("flash_attention_bwd",
                                  [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                                   _I, _I, _I, _I, _I,
                                   ctypes.POINTER(_I64), _F, _VP]),
}

build_count = 0
build_log: dict = {}     # source stem -> nvcc's output (ptxas register report)
_libs: dict = {}         # C function name -> bound function
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
    # the source, the shared headers it may include, and the flags
    src = (CSRC / f"{stem}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
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
        log = (out or "") + (err or "")
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            # the log first: a library on disk always has its log beside it
            _log_path(target).write_text(log)
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    entries = {name: (stem, argtypes)
               for stem, (name, argtypes) in _ENTRY.items()}
    entries.update(_HELPERS)
    dlls = {stem: ctypes.CDLL(str(target)) for stem, target in targets.items()}
    libs = {}
    for name, (stem, argtypes) in entries.items():
        fn = getattr(dlls[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[name] = fn
    for stem, target in targets.items():
        log = _log_path(target)
        build_log[stem] = log.read_text() if log.exists() else ""
    return libs


def _log_path(target: Path) -> Path:
    return target.with_suffix(".log")


def function(name: str):
    """The bound C function ``name`` of one of ``csrc/*.cu``, building
    every kernel library on the first call of the process."""
    global build_count, _libs
    with _lock:
        if not _libs:
            _libs = _build_all()
            build_count += 1
    return _libs[name]


def load_prebuilt() -> None:
    """Load every kernel library that another process of this checkout
    built, and never compile: a socket-mesh worker calls this at start-up,
    after its master built them.  Raises when one is missing."""
    missing = [f"{stem}.cu" for stem in _ENTRY if not _target(stem).exists()]
    if missing:
        raise RuntimeError(
            f"kernel libraries not built under {BUILD_DIR}: "
            f"{', '.join(missing)} (the master builds them before it starts "
            "its workers; a worker never compiles)")
    function(_ENTRY["mask_add"][0])


def library(stem: str):
    """The bound C launch function of ``csrc/<stem>.cu``."""
    return function(_ENTRY[stem][0])


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
