"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (with the shared headers ``csrc/*.cuh`` it includes)
is compiled by ``nvcc`` into a shared library with a plain C interface, once,
at first use::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/mmlspark_tpu_torch/lib<name>-<hash>.so \\
         csrc/<name>.cu

and loaded with :mod:`ctypes`. The library name carries a hash of the source,
the headers and the flags, so an edited source or header is rebuilt and a
stale build is never loaded. The build directory is
``build/mmlspark_tpu_torch/`` beside the package (``build/`` is git-ignored).
Only sources inside the package are built. There is no fallback: if ``nvcc``
is missing or the build fails, the call raises, and the wrapper that asked
for the kernel raises with it.

Every C entry point takes pointers and the stream as ``void*`` (declared
``ctypes.c_void_p``) and returns ``cudaGetLastError()`` as an ``int``;
:func:`check` turns a non-zero code into an exception.

The host route builds the port's C++ host engines, ``native/<name>.cpp``,
with the host compiler (``$CXX``, else ``c++`` or ``g++``)::

    c++ -std=c++17 -O3 -shared -fPIC -pthread \\
        -o build/mmlspark_tpu_torch/lib<name>-<hash>.so native/<name>.cpp

under the same rules: hashed name, built once, a missing compiler or a
failed build raises (:func:`build_host`, :func:`load_host`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
NATIVE_DIR = os.path.join(PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "mmlspark_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels cannot be built")


def source_path(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"kernel source {path} does not exist")
    return path


def library_path(name: str) -> str:
    """Where ``name``'s library lands: keyed by the bytes of the source and
    of every shared header in ``csrc/`` (``*.cuh``), and by the flags."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source_path(name)] + [os.path.join(CSRC_DIR, f)
                                       for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str, out: str, compiler: list, src: str,
             verbose: bool = False) -> str:
    """Run ``compiler -o <tmp> src`` and move the library to ``out``
    unless it exists already. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [*compiler, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler[0])} failed building {name} (rc "
            f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}"
            f"{proc.stderr}")
    if verbose and (proc.stdout or proc.stderr):
        print(proc.stdout + proc.stderr, end="", flush=True)
    os.replace(tmp, out)     # atomic: a concurrent loader never sees half
    return out


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library already exists;
    returns the library path. Raises ``RuntimeError`` with nvcc's output
    when the build fails."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    return _compile(name, out, [find_nvcc(), *flags], source_path(name),
                    verbose)


def build_all(names: Iterable[str], verbose: bool = False) -> Dict[str, str]:
    """Build several kernels at once: one ``nvcc`` per source, all started
    together."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futures = {n: ex.submit(build, n, verbose) for n in names}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (each library exports
    ``mm_error_string`` for the message)."""
    if code != 0:
        lib.mm_error_string.restype = ctypes.c_char_p
        lib.mm_error_string.argtypes = [ctypes.c_int]
        msg = lib.mm_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on
    ``PATH``."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    raise RuntimeError(
        "no host C++ compiler found ($CXX, c++, g++): the port's native "
        "engines cannot be built")


def host_source_path(name: str) -> str:
    path = os.path.join(NATIVE_DIR, f"{name}.cpp")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"native source {path} does not exist")
    return path


@functools.lru_cache(maxsize=None)
def _cxx_identity(cxx: str) -> str:
    """The compiler's resolved path and the first line of its
    ``--version``: a library built by another compiler (another machine's
    libstdc++ or glibc) gets another name."""
    try:
        ver = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"host C++ compiler {cxx} does not run: {e}")
    return os.path.realpath(cxx) + "\n" + (ver.splitlines() or [""])[0]


def host_library_path(name: str) -> str:
    """Where ``native/<name>.cpp``'s library lands, keyed by the source's
    bytes, the flags and the compiler (:func:`_cxx_identity`)."""
    h = hashlib.sha256()
    with open(host_source_path(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(HOST_CXX_FLAGS).encode())
    h.update(_cxx_identity(find_cxx()).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_host(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its library already exists;
    returns the library path. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    out = host_library_path(name)
    if os.path.isfile(out):
        return out
    return _compile(name, out, [find_cxx(), *HOST_CXX_FLAGS],
                    host_source_path(name))


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``native/<name>.cpp``, built on first use."""
    key = f"host:{name}"
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(build_host(name))
            _LIBS[key] = lib
        return lib
