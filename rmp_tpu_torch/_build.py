"""Build and load the package's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`), one
`nvcc` process per source, at most one a CPU at a time, with `csrc/` on the
include path for the shared `csrc/*.cuh` headers, and the objects are
linked into one shared library with a plain C interface that `ctypes`
loads. The library goes into `rmp_tpu_torch/_build/<hash>/`, keyed by a
hash of the sources, the headers and the flags, so a changed source or
header is rebuilt and an unchanged tree is built once per checkout. Nothing
here runs at import: the first CUDA tensor that reaches a kernel wrapper
triggers the build.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_NAME = "librmp_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# {library path: compile_into's seconds} of the builds this process made
_built: dict[str, dict] = {}


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


def compile_into(work: str) -> dict:
    """Compile every source into objects under `work`, one nvcc process
    each and at most one a CPU at a time, and link them into
    `work`/LIB_NAME. Returns {'nvcc_s': {file: seconds from the build's
    start to its nvcc's end}, 'link_s', 'total_s', 'jobs': the most nvcc
    processes at a time, 'cpus': os.cpu_count(), 'log': the compiler's
    messages}; raises if a compile or the link fails."""
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    srcs = sources()
    # started all at once, the longest jobs shared the CPUs with every
    # other and the build took 55.0-56.4 s against 43.9-49.6 s capped (an
    # H100 host's 8 CPUs, 18 sources)
    jobs = os.cpu_count() or 1
    gate = threading.Semaphore(jobs)
    jobs_run, outputs, seconds, codes = [], {}, {}, {}

    def compile_one(src, obj):
        # a thread a process: each one's own finish time, and no pipe left
        # full while another is waited on
        with gate:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            outputs[src] = proc.communicate()[0]
            codes[src] = proc.returncode
            seconds[os.path.basename(src)] = time.perf_counter() - t0
    for src in srcs:
        obj = os.path.join(work, os.path.basename(src)[:-3] + ".o")
        jobs_run.append((src, obj, threading.Thread(target=compile_one,
                                                    args=(src, obj))))
    for _, _, thread in jobs_run:
        thread.start()
    for _, _, thread in jobs_run:
        thread.join()
    log = [f"== {os.path.basename(src)}\n{outputs[src]}"
           for src, _, _ in jobs_run]
    failed = [os.path.basename(src) for src, _, _ in jobs_run
              if codes[src] != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    t1 = time.perf_counter()
    link = subprocess.run(
        [nvcc, "-shared", "-o", os.path.join(work, LIB_NAME),
         *(obj for _, obj, _ in jobs_run)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    t2 = time.perf_counter()
    return dict(nvcc_s=seconds, link_s=t2 - t1, total_s=t2 - t0, jobs=jobs,
                cpus=os.cpu_count(), log="\n".join(log))


def build() -> str:
    """Compile and link the kernels unless this source hash is built;
    returns the library path. The compiler's messages (ptxas register and
    spill counts) are kept in build.log beside the library, the build's
    seconds in this process (`build_times`). Objects go to a per-process
    directory and the library and log are moved into place
    whole, so processes building at once do not read each other's halves."""
    lib_path = library_path()
    if os.path.exists(lib_path):
        return lib_path
    out_dir = os.path.dirname(lib_path)
    work = os.path.join(out_dir, f"tmp{os.getpid()}")
    os.makedirs(work, exist_ok=True)
    try:
        built = compile_into(work)
        with open(os.path.join(work, "build.log"), "w") as f:
            f.write(built.pop("log"))
        os.replace(os.path.join(work, "build.log"),
                   os.path.join(out_dir, "build.log"))
        os.replace(os.path.join(work, LIB_NAME), lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _built[lib_path] = built
    return lib_path


def build_times() -> dict:
    """The seconds of this source hash's build (compile_into's nvcc_s,
    link_s, total_s) if this process made it, else {}: a library found
    already built has no build to report."""
    return dict(_built.get(library_path(), {}))


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


def raw_stream(device) -> int:
    """The cudaStream_t of PyTorch's current stream on `device`, as an int.
    torch.cuda.current_stream(device).cuda_stream gives the same handle but
    builds a Stream object, several microseconds of host time per launch.
    A device without an index means the current one."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def c_function(name: str, argtypes: list):
    """A C entry point of the library with its argument types declared
    (pointers as c_void_p: ctypes would otherwise pass a Python int as a
    32-bit int and cut the pointer). Every entry point returns an int."""
    fn = getattr(load(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
