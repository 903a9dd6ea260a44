"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, all started together, with `csrc/` on the include
path for the shared `csrc/*.cuh` headers, and the objects are linked into one
shared library with a plain C interface that `ctypes` loads. The library goes
into `rmp_tpu_torch/_build/<hash>/`, keyed by a hash of the sources, the
headers and the flags, so a changed source or header is rebuilt and an
unchanged tree is built once per checkout. Nothing here runs at import: the first CUDA tensor
that reaches a kernel wrapper triggers the build.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_NAME = "librmp_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


CUDA_ROOTS = ("/usr/local/cuda",)


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or a CUDA_ROOTS entry."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
        f"{[r + '/bin' for r in CUDA_ROOTS]}): the CUDA kernels cannot be "
        "built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in sources() + headers():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, source_hash(), LIB_NAME)


def build() -> str:
    """Compile and link the kernels unless this source hash is built;
    returns the library path. The compiler's messages (ptxas register and
    spill counts) are kept in build.log beside the library. Objects go to
    a per-process directory and the library and log are moved into place
    whole, so processes building at once do not read each other's halves."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    nvcc = find_nvcc()
    out_dir = os.path.dirname(lib_path)
    work = os.path.join(out_dir, f"tmp{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        jobs = []
        for src in sources():
            obj = os.path.join(work, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)}\n{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib_tmp = os.path.join(work, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", lib_tmp, *(obj for _, obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        log_tmp = os.path.join(work, "build.log")
        with open(log_tmp, "w") as f:
            f.write("\n".join(log))
        os.replace(log_tmp, os.path.join(out_dir, "build.log"))
        os.replace(lib_tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def build_log() -> str:
    path = os.path.join(os.path.dirname(library_path()), "build.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(build())
        return _lib


def c_function(name: str, argtypes: list):
    """A C entry point of the library with its argument types declared
    (pointers as c_void_p: ctypes would otherwise pass a Python int as a
    32-bit int and cut the pointer). Every entry point returns an int."""
    fn = getattr(load(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
