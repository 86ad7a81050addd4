"""nvcc build and ctypes loader for the package's hand-written CUDA kernels.

Every source under skani_tpu_torch/csrc/*.cu is compiled for Hopper
(`sm_90a`) into one shared library with a plain C interface,
skani_tpu_torch/_build/libskani_torch_kernels.so, at first use and from the
package's own sources only.  The sources are compiled to objects in
parallel (one nvcc per source, all started together) and then linked.
The library is rebuilt whenever a source is newer than it; the link writes
a process-private temporary file that is renamed into place, so processes
that build at the same time never load a half-written library.

Each C entry point takes every pointer and the CUDA stream as `void*` and
returns `cudaGetLastError()` after its launches; `check` turns a non-zero
code into a RuntimeError.  The kernels allocate nothing and never
synchronise: the Python wrappers allocate outputs with torch and launch on
torch's current stream.

Nothing here runs at import: the CPU-only test host has no nvcc.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SO = os.path.join(BUILD_DIR, "libskani_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of every entry point (pointers and the stream as void*)
_SIGNATURES = {
    "skt_row_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "skt_row_scatter_multi": [_P, _P, _P, _I, _I, _I, _I, _P],
    "skt_windowed_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "skt_genome_map_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "skt_dp_chain_compact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _I, _P],
    "skt_dp_chain_compact_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _P],
    "skt_dp_chain": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    "skt_dp_chain_packed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    "skt_expand_anchors": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ptxas resource report (registers, spills) of the last build, or "" when
#: the library was already up to date
build_log = ""


def nvcc_path() -> str:
    p = shutil.which("nvcc")
    if p:
        return p
    p = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(p):
        return p
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _up_to_date() -> bool:
    if not os.path.exists(SO):
        return False
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return all(os.path.getmtime(SO) >= os.path.getmtime(d) for d in deps)


def build() -> str:
    """Compile the kernel library if it is missing or stale; returns its
    path.  Raises RuntimeError with nvcc's output when a build fails."""
    global build_log
    if _up_to_date():
        return SO
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, p in zip(sources(), procs):
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    tmp = f"{SO}.{tag}.tmp"
    try:
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed)
                               + "\n" + "\n".join(logs))
        r = subprocess.run([nvcc, "-shared", *objs, "-o", tmp],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + r.stdout)
        os.replace(tmp, SO)
    finally:
        for f in objs + [tmp]:
            if os.path.exists(f):
                os.remove(f)
    build_log = "\n".join(logs)
    return SO


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = so
        return _lib


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
