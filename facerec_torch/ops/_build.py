"""Build the port's native libraries from the repo's sources at first use.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a``, each
``csrc/*.cpp`` file (host code) with the host C++ compiler, into a
shared library with a plain C interface, loaded with ctypes.  Libraries
go into ``facerec_torch/_build/`` (listed in ``.gitignore``) under a
name keyed by a hash of the source and the flags, so an edited source
is rebuilt and a built one is reused.  A missing compiler or a failed
compile raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# flags of one source only: the tracker and the alignment round every
# float expression as their plain versions' separate tensor operations
# do (no contraction of a multiply and an add into one fma)
EXTRA_FLAGS = {"tracker": ("-fmad=false",), "align": ("-fmad=false",)}


def source(name: str) -> str:
    """The ``csrc`` source that library ``name`` is built from: its
    ``.cu`` file, else its ``.cpp`` file."""
    stem = os.path.join(CSRC_DIR, name)
    return stem + ".cu" if os.path.exists(stem + ".cu") else stem + ".cpp"


def is_host(name: str) -> bool:
    """Whether library ``name`` is host code (a ``.cpp`` source)."""
    return source(name).endswith(".cpp")


def flags(name: str) -> tuple:
    """The compiler's flags for library ``name``."""
    base = CXX_FLAGS if is_host(name) else NVCC_FLAGS
    return base + EXTRA_FLAGS.get(name, ())

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``,
    then ``PATH``."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    return found


def find_cxx() -> str:
    """Path of the host C++ compiler: ``$CXX``, then ``c++`` and ``g++``
    on ``PATH``."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = c and shutil.which(c)
        if found:
            return found
    raise RuntimeError("no host C++ compiler ($CXX, c++, g++); the host "
                       "libraries cannot be built")


def library_path(name: str) -> str:
    """Where library ``name`` lives."""
    with open(source(name), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(flags(name)).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile library ``name`` unless an up-to-date one exists;
    returns the library path.  ``verbose`` prints the compiler's
    report, for a kernel with ``-Xptxas -v`` (registers, shared
    memory, spills)."""
    out = library_path(name)
    if os.path.exists(out) and not verbose:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    host = is_host(name)
    cmd = [find_cxx() if host else find_nvcc(), *flags(name)]
    if verbose and not host:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, source(name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    tool = os.path.basename(cmd[0])
    if proc.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"{tool} failed for {name} "
                           f"({os.path.basename(source(name))}):\n"
                           f"{proc.stderr}")
    if verbose:
        print(f"[{tool} {name}]\n{proc.stderr}", end="", flush=True)
    os.replace(tmp, out)   # atomic: a concurrent build never sees half
    return out


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Build every ``csrc`` source at once, one compiler per library,
    all started together; returns {name: library path}."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(os.path.splitext(f)[0] for f in os.listdir(CSRC_DIR)
                   if f.endswith((".cu", ".cpp")))
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {n: pool.submit(build, n, verbose) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library ``name``, built first if needed
    (once per process)."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
