"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each source in ``csrc/`` has a plain C interface (no PyTorch headers), so
one ``nvcc`` call per source builds a shared library in seconds. The
library goes into ``build/`` at the root of the checkout, under a name
keyed by a hash of the source, the ``csrc/`` headers it includes and the
flags, so a changed source or header is rebuilt and an unchanged one is
built once per checkout. Several sources are compiled by concurrent
``nvcc`` processes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300
_LOCAL_INCLUDE = re.compile(rb'^\s*#include\s+"([^"]+)"', re.MULTILINE)

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: its library, the build's seconds (0 when the
    library was already there) and the compiler's output."""

    name: str
    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _source_bytes(path: Path, seen: set) -> bytes:
    """The file's bytes followed by those of every ``#include "..."`` it
    (transitively) names in ``csrc/``, each file once."""
    if path in seen:
        return b""
    seen.add(path)
    text = path.read_bytes()
    for header in _LOCAL_INCLUDE.findall(text):
        text += _source_bytes(CSRC_DIR / header.decode(), seen)
    return text


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: named by a hash of the
    source, the local headers it includes and the flags."""
    src = _source_bytes(CSRC_DIR / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> List[Built]:
    """Compile ``csrc/<name>.cu`` for each name not yet built, all at once.

    Raises with the compiler's output if any build fails or runs past
    ``BUILD_TIMEOUT_S``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    done = []
    for name in names:
        out = library_path(name)
        if out.exists():
            done.append(Built(name, out, 0.0, ""))
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        try:
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc ran past {BUILD_TIMEOUT_S} s\n{log}")
            continue
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        done.append(Built(name, out, time.perf_counter() - t0, log))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    if name not in _LOADED:
        (built,) = build([name])
        _LOADED[name] = ctypes.CDLL(str(built.path))
    return _LOADED[name]
