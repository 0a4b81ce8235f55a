"""Build a kernel source of this folder into a shared library and load it.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
on a source with a plain C interface, loaded with ``ctypes``: seconds per
build, and no ``ninja`` and no PyTorch headers are needed (both of which
``torch.utils.cpp_extension.load`` would want, at minutes per build). The
library lands in ``_build/`` beside the sources, named by the hash of the
source and of the shared headers (``*.cuh``) beside it, so an edited
kernel is never served from a stale build. Processes that load the same
source at once (the ranks of a data-parallel run) take turns on a lock
file beside it: the first builds, the others wait and load its library.
``start`` begins builds in the background, so that sources a model will
launch build side by side and not one after the other at their first
launches.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile ``<name>.cu`` (once per source content) and ``dlopen`` it."""
    src = _HERE / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_HERE.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        # The kernel releases the lock with the file, also when a build
        # fails or its process dies.
        with open(BUILD_DIR / f"{lib.stem}.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not lib.exists():  # built while this process waited
                _compile(name, src, lib)
    return ctypes.CDLL(str(lib))


@functools.lru_cache(maxsize=None)
def _builders() -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(len(list(_HERE.glob("*.cu"))))


def start(*names: str) -> None:
    """Begin ``load(name)`` of each source in a thread of its own and return.
    A later ``load`` takes the library, or waits for the build (the lock)
    and, where it failed, builds again and raises its error."""
    for name in names:
        _builders().submit(load, name)


def _compile(name: str, src: Path, lib: Path) -> None:
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a reader never sees half a file
