"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``build/gcn_maxcut_tpu_torch/`` at the repository root, then loaded with
``ctypes``.  Libraries are named by a hash of their source, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when a
module is imported: the first launch builds what it needs, and
``build_all`` compiles every source at once (one ``nvcc`` each, all started
together).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gcn_maxcut_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, Path(tmp), out


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every ``csrc/*.cu`` in parallel; returns each source's
    compiler log (``-Xptxas -v``: registers, shared memory, spills), empty
    for a library that was already built."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    jobs = {name: _start(name) for name in names}
    return {
        name: ("" if job is None else _finish(name, job))
        for name, job in jobs.items()
    }


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    return ctypes.CDLL(str(library_path(name)))
