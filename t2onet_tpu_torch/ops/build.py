"""Build the kernel sources of `csrc/` with nvcc and load them with ctypes.

Every `csrc/*.cu` becomes its own shared library with a plain C interface
in the package's git-ignored `_build/` directory (or the directory
T2ONET_TORCH_BUILD_DIR names). Processes that build at once each write
their own temporary file and rename it into place. One hash over all the
sources names the libraries, so an edit to any source rebuilds them all;
the nvcc processes run side by side. Nothing is built when this module is
imported: the first `library(name)` (or `build()`) does it.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
# T2ONET_TORCH_BUILD_DIR puts the libraries elsewhere (a cold build)
BUILD_DIR = os.environ.get("T2ONET_TORCH_BUILD_DIR",
                           os.path.join(_PKG, "_build"))

# no --use_fast_math: the quotients need IEEE division; -fmad=false rounds
# every multiply and add on its own, as the plain versions' separate
# tensor ops do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

# source name -> {"cmd", "output", "seconds"} of its last compile
BUILD_LOG = {}
_libs = {}


def sources():
    """{name: path} of every kernel source, e.g. {"chain": ".../chain.cu"}."""
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _digest() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (default /usr/local/cuda)."""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> dict:
    """Compile every source for sm_90a, one nvcc per source started
    together, and return {name: library path}. Libraries already built
    from the same sources are reused."""
    digest = _digest()
    libs = {name: os.path.join(BUILD_DIR, f"libt2o_{name}_{digest}.so")
            for name in sources()}
    todo = {n: so for n, so in libs.items() if not os.path.exists(so)}
    if not todo:
        return libs
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _find_nvcc()
    srcs = sources()
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, srcs[name]]
        procs[name] = (cmd, tmp, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (cmd, tmp, so, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = {"cmd": " ".join(cmd), "output": out,
                           "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def library(name: str):
    """The ctypes handle of csrc/<name>.cu's library, built at first use.
    Each library exports `t2o_error_string(int)`."""
    if name not in _libs:
        lib = ctypes.CDLL(build()[name])
        lib.t2o_error_string.argtypes = [ctypes.c_int]
        lib.t2o_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


@functools.lru_cache(maxsize=None)
def sm_count(index) -> int:
    """The multiprocessors of CUDA device `index`, which the kernels' plans
    fill first."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
