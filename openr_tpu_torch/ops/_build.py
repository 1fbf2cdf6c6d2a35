"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface.  It is compiled by `nvcc`
for sm_90a into a shared library under `build/kernels/` at the root of
the checkout, named by a hash of its source and flags, and loaded with
ctypes.  Builds happen at first use, never at import; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the port's CUDA "
            "kernels are built at first use on a machine with the CUDA "
            "toolkit"
        )
    return str(path)


def library_path(name: str) -> Path:
    source = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together.  Returns seconds per built library;
    the compiler's report (registers, spills) is kept beside it as
    `<library>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, lib, time.perf_counter())
    seconds = {}
    failures = []
    for name, (proc, tmp, lib, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


_LOAD_LOCK = threading.Lock()


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    lib_path = library_path(name)
    if not lib_path.exists():
        build([name])
    return ctypes.CDLL(str(lib_path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first when missing.
    Safe from any thread (Decision computes on its event-base thread):
    one build at a time, whose temporary file is named per process."""
    with _LOAD_LOCK:
        return _load(name)
