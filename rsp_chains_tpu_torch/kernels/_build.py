"""Build and load the hand-written CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The first use in a process
builds it into ``rsp_chains_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of the sources and flags, so a checkout builds once and a
source edit builds anew. The sources compile in parallel, one ``nvcc`` each,
and one more ``nvcc`` links them. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mag_cfar.cu", "chain_ca.cu", "mag_gos_cfar.cu", "chain_gos.cu",
           "wire_ca.cu", "chain_int.cu", "chain_int_gos.cu", "rd_ca.cu",
           "rd_2d.cu", "halo.cu")
HEADERS = ("ca_cfar.cuh", "gos_cfar.cuh", "fft_radix2.cuh", "int_front.cuh",
           "rd_front.cuh", "cfar_2d.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# How many times this process produced the library: compiled it, or loaded a
# copy compiled earlier from the same sources. A register write must never
# raise it.
BUILDS = 0

# Launches of each CUDA kernel in this process, by kernel name; a wrapper adds
# one where it launches its kernel, and the plain path never adds.
LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "it is needed to build the CUDA kernels")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librsp_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> str:
    """Wait for every ``(cmd, Popen)``; raise on the first failure, after
    stopping the others. Returns the compilers' reports."""
    report = []
    try:
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}{err}")
            report.append(out + err)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "".join(report)


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a temporary directory, then rename the library: a
    # concurrent process sees either no library or a whole one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        compiles = []
        for src, obj in zip(SOURCES, objs):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
            compiles.append((cmd, subprocess.Popen(
                cmd, cwd=CSRC, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        report = _run(compiles)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, "-shared", "-o", lib, *objs]
        report += _run([(cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))])
        out.with_suffix(".log").write_text(report)
        os.replace(lib, out)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global BUILDS
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    BUILDS += 1
    return lib


def build_log() -> str:
    """The compiler's report (ptxas registers, shared memory, spills) of the
    library's build, or '' before the first build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""
