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
SOURCES = ("mag_cfar.cu", "chain_ca.cu", "pc_ca.cu", "mag_gos_cfar.cu",
           "chain_gos.cu", "wire_ca.cu", "chain_int.cu", "chain_int_gos.cu",
           "int_mid.cu", "int_split.cu", "rd_ca.cu", "rd_2d.cu", "halo.cu")
HEADERS = ("ca_cfar.cuh", "gos_cfar.cuh", "gos_rows.cuh", "int_front.cuh",
           "int_rows.cuh", "row_fft.cuh", "rd_front.cuh", "cfar_2d.cuh")
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


def library_path(sources: tuple = SOURCES, defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for name in sources + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librsp_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list) -> list:
    """Wait for every ``(cmd, Popen)``; raise on the first failure, after
    stopping the others. Returns each command's report."""
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
    return report


def _popen(cmd: list, **kw) -> tuple:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, **kw)


def _compile(builds: list) -> None:
    """Build each ``(library path, sources, -D flags)`` of ``builds``: every
    source of every build compiles at once, then each build links."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build under a temporary directory, then rename the library: a
    # concurrent process sees either no library or a whole one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [[os.path.join(tmp, f"{k}_{Path(s).stem}.o") for s in sources]
                for k, (_, sources, _) in enumerate(builds)]
        reports = iter(_run([
            _popen([nvcc, *NVCC_FLAGS, *defines, "-c", "-o", obj,
                    str(CSRC / src)], cwd=CSRC)
            for (_, sources, defines), o in zip(builds, objs)
            for src, obj in zip(sources, o)]))
        for (out, sources, _), o in zip(builds, objs):
            report = "".join(next(reports) for _ in sources)
            lib = os.path.join(tmp, out.name)
            report += _run([_popen([nvcc, "-shared", "-o", lib, *o])])[0]
            out.with_suffix(".log").write_text(report)
            os.replace(lib, out)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    global BUILDS
    path = library_path()
    if not path.exists():
        _compile([(path, SOURCES, ())])
    lib = ctypes.CDLL(str(path))
    BUILDS += 1
    return lib


def variants(sources: tuple, defines: list) -> list:
    """Libraries of ``sources`` alone, one for each tuple of ``-D`` flags in
    ``defines``, all compiled at once: for comparing a kernel's build
    options. Their loads do not count in ``BUILDS``."""
    paths = [library_path(sources, d) for d in defines]
    todo = [(p, sources, d) for p, d in zip(paths, defines) if not p.exists()]
    if todo:
        _compile(todo)
    return [ctypes.CDLL(str(p)) for p in paths]


def build_log(sources: tuple = SOURCES, defines: tuple = ()) -> str:
    """The compiler's report (ptxas registers, shared memory, spills) of the
    library's build (or of a variant's), or '' before the first build."""
    log = library_path(sources, defines).with_suffix(".log")
    return log.read_text() if log.exists() else ""
