"""Builds the port's CUDA kernels from ``csrc/`` and loads them with ctypes.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), at first
use, into ``build/repro_torch_kernels/`` at the repository root, keyed by a
hash of the source, every shared header ``csrc/*.cuh`` and the flags.  The
flash kernel's TMA descriptors are encoded by ``cuTensorMapEncodeTiled``,
looked up at run time with ``cudaGetDriverEntryPoint``, so nothing links
``-lcuda``.  A missing ``nvcc`` or a failed build raises: there is no
fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: kernel library name -> source file under csrc/
SOURCES = {"crc32": "crc32.cu", "flash_attention": "flash_attention.cu",
           "decode_attention": "decode_attention.cu", "moe": "moe.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> nvcc's output (ptxas register / shared-memory report) of the build
#: made by this process
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class LaunchCount:
    """Launches of one kernel and the rows they covered.  Its wrapper adds
    to it where it launches the kernel and nowhere else, so a run can show
    that its path went through the kernel."""
    launches: int = 0
    rows: int = 0
    #: launch shape -> launches at that shape
    shapes: Dict[Tuple[int, ...], int] = dataclasses.field(default_factory=dict)

    def add(self, shape: Tuple[int, ...]) -> None:
        self.launches += 1
        self.rows += shape[0]
        self.shapes[shape] = self.shapes.get(shape, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.rows = 0
        self.shapes = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (a copy if needed), as
    the kernels' 16-byte loads and TMA copies require."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every library in ``names`` (default: all) that is not built
    yet: one ``nvcc`` per source, all started together.  Returns the seconds
    each build took; raises with nvcc's output if any build fails."""
    todo = [(n, library_path(n)) for n in (names or SOURCES)]
    todo = [(n, out) for n, out in todo if not out.exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        took = {}
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} "
                                   f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
            BUILD_LOG[name] = log
            took[name] = time.perf_counter() - t0
        return took
    finally:
        for _name, _out, tmp, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
