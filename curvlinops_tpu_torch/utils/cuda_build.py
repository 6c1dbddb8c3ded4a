"""Build and load the port's hand-written CUDA kernels.

Each kernel source under a ``csrc/`` directory has a plain C interface; it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use
and called through ``ctypes``. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable

# the builds go next to the package, in the checkout's ignored build/ dir
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libraries: dict[Path, ctypes.CDLL] = {}


def _with_headers(source: Path) -> bytes:
    """The source's bytes followed by those of the headers it includes with
    ``#include "..."`` (one level: the port's headers include no others)."""
    text = source.read_bytes()
    names = re.findall(rb'^#include "([^"]+)"', text, flags=re.M)
    return text + b"".join((source.parent / n.decode()).read_bytes() for n in names)


def build(source: Path, build_dir: Path = BUILD_DIR) -> tuple[Path, float, str]:
    """Compile one kernel source with ``nvcc`` for ``sm_90a``.

    The library's name carries the source's stem and a hash of the source,
    the headers it includes and the flags, so an edited source or header is
    rebuilt; an existing build is reused.
    Builds of different sources may run at the same time.

    Returns:
        ``(library path, build seconds, compiler output)``; the seconds are
        0 and the output empty when the library already existed.

    Raises:
        RuntimeError: If ``nvcc`` is missing or the compilation fails.
    """
    digest = hashlib.sha256(_with_headers(source) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = build_dir / f"{source.stem}-{digest}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH.")
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    return lib_path, seconds, proc.stdout + proc.stderr


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built if needed; ``bind`` sets the
    C functions' ``argtypes``/``restype`` once, when it is first loaded."""
    lib = _libraries.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)[0]))
        bind(lib)
        _libraries[source] = lib
    return lib
