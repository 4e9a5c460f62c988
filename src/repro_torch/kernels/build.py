"""Build the port's CUDA sources into shared libraries with a plain C
interface and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` at first
use, into ``repro_torch/_build/`` (listed in ``.gitignore``), under a file
name carrying a hash of the source, of every local header it includes
(``#include "..."`` resolved against ``csrc/``, transitively) and of the
flags, so an edited source or header rebuilds and an unchanged one is
loaded as it is. The compiler's output (``ptxas -v``: registers and
spills of each kernel) is kept beside the library as
``lib<name>-<hash>.ptxas.txt`` and read back when the library is found
built, so ``BUILD_LOG`` holds it either way. Nothing here runs at
import time, so a machine without the CUDA toolkit imports the kernel
modules (and runs their plain versions on CPU tensors).
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
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of each library
# built or found built
BUILD_LOG: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit's usual home."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU, from the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, transitively,
    in a fixed order (the source first, then the headers by name)."""
    top = CSRC / f"{name}.cu"
    seen, todo = {top}, [top]
    while todo:
        for inc in _LOCAL_INCLUDE.findall(todo.pop().read_bytes()):
            dep = CSRC / inc.decode()
            if dep not in seen and dep.is_file():
                seen.add(dep)
                todo.append(dep)
    return [top] + sorted(seen - {top})


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.relative_to(CSRC).as_posix().encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(library: Path) -> Path:
    """Where the compiler's output of ``library`` is kept."""
    return library.with_suffix(".ptxas.txt")


def build(name: str) -> Tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless the hashed library and its
    compiler log exist. Returns (library path, seconds spent compiling; 0
    if cached) and leaves the compiler log in ``BUILD_LOG[name]``."""
    out = library_path(name)
    log = log_path(out)
    if out.exists() and log.exists():
        BUILD_LOG[name] = log.read_text()
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to private names, then rename, the log before the library:
    # a concurrent build never loads a half-written library, and a library
    # found built has its log
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    secs = time.perf_counter() - t0
    BUILD_LOG[name] = proc.stderr + proc.stdout
    fd, tmp_log = tempfile.mkstemp(suffix=".txt", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(BUILD_LOG[name])
    os.replace(tmp_log, log)
    os.replace(tmp, out)
    return out, secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
