"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``paddle_tpu_torch/csrc/<name>.cu`` is compiled on its own by ``nvcc``
for Hopper (``sm_90a``) into ``paddle_tpu_torch/csrc/build/lib<name>-<hash>.so``,
a library with a plain C interface that :mod:`ctypes` loads. The hash covers
the source, the shared header and the flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. Builds of several sources run as
parallel ``nvcc`` processes. Nothing is built when this module is imported:
the first call that needs a kernel builds it.
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
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
HEADERS = ("flash_common.cuh",)
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd_dkv": "flash_bwd_dkv.cu",
    "flash_bwd_dq": "flash_bwd_dq.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass
class BuildInfo:
    name: str
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the library was cached
    ptxas: List[str]      # ptxas's register / shared-memory / spill lines


_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(stderr: str) -> List[str]:
    keep = ("registers", "spill", "smem", "Compiling entry")
    return [ln.strip() for ln in stderr.splitlines() if any(k in ln for k in keep)]


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildInfo]:
    """Compiles every named source that has no library yet, one ``nvcc``
    per source, all started together; raises with nvcc's output if one
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, BuildInfo] = {}
    running = []
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = BuildInfo(name, target, 0.0, [])
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in running:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{stdout}{stderr}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent process sees all or nothing
        out[name] = BuildInfo(name, target, seconds, _ptxas_lines(stderr))
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LIBS[name] = lib
    return lib
