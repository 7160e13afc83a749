"""Build the hand-written CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes.  Libraries go to ``kernels/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.  All missing libraries are compiled in parallel,
one ``nvcc`` process per source.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

SOURCES = {
    "emb_gather": "emb_gather.cu",
    "sparse_update": "sparse_update.cu",
    "gemm": "gemm.cu",
    "int4_gemm": "int4_gemm.cu",
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "ring": "ring.cu",
    "coalesce": "coalesce.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled at first use")


def lib_path(name: str) -> str:
    """Library path keyed by the source, the shared headers and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [SOURCES[name]] + headers:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names=None) -> float:
    """Compile every missing kernel library in parallel; returns seconds."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        out = lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        with open(f"{out}.log", "w") as f:
            f.write(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for the built library ``name``, with ptxas's resource
    report (registers, spills) for each kernel."""
    with open(lib_path(name) + ".log") as f:
        return f.read()


def kernel_resources(name: str) -> Dict[str, dict]:
    """Per kernel of library ``name`` (its mangled name), ptxas's registers
    and spill-store / spill-load bytes, read from :func:`build_log`."""
    out: Dict[str, dict] = {}
    kernel = None
    for line in build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = m.group(1)
            out[kernel] = {}
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[kernel].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        _libs[name] = lib
    return lib
