"""Native (C++) host-side loops, built with ``g++`` at first use and bound
with ``ctypes``.

The card runs the model; this package covers the host's hot loops:
event-stream integration into frames, the IDX batch decode and spike
bit-packing (``event_ops.cc``). The library goes into ``build/`` at the
root of the checkout, as the CUDA sources do (``ops/_build.py``), under a
name keyed by a hash of the source, the flags and the compiler's version,
so that a changed source is rebuilt and an unchanged one is built once per
checkout.

There is no silent fallback: a failed build raises with the compiler's
output. The plain numpy versions are ``data.events.integrate_events_to_frames(
..., use_native=False)`` and the ``*_plain`` functions here, which the tests
hold the native ones against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from spiking_diffusion_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "event_ops.cc"
CXX = os.environ.get("CXX", "g++")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_LIB: Optional[ctypes.CDLL] = None


def _compiler_version() -> str:
    try:
        out = subprocess.run([CXX, "--version"], capture_output=True, text=True,
                             timeout=30)
    except OSError as exc:
        raise RuntimeError(f"no C++ compiler: {CXX!r} ({exc})") from exc
    return out.stdout.splitlines()[0] if out.stdout else ""


def library_path() -> Path:
    """Where the library goes: named by a hash of the source, the flags and
    the compiler's version."""
    key = SOURCE.read_bytes() + " ".join((CXX, *CXX_FLAGS, _compiler_version())).encode()
    return BUILD_DIR / f"event_ops-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``event_ops.cc`` unless its library is there; its path.

    Raises with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built on the first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def _declare(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name in ("integrate_events_time", "integrate_events_number"):
        fn = getattr(lib, name)
        fn.argtypes = [i64p, i64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, f32p]
        fn.restype = ctypes.c_int
    lib.decode_idx_batch.argtypes = [u8p, i64p, ctypes.c_int64, ctypes.c_int64, f32p]
    lib.decode_idx_batch.restype = None
    lib.pack_spikes_f32.argtypes = [f32p, ctypes.c_int64, u8p]
    lib.pack_spikes_f32.restype = None
    lib.unpack_spikes_f32.argtypes = [u8p, ctypes.c_int64, f32p]
    lib.unpack_spikes_f32.restype = None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def integrate_events_to_frames(events: Dict[str, np.ndarray], H: int, W: int,
                               num_frames: int, split_by: str = "time") -> np.ndarray:
    """(t, x, y, p) events -> (num_frames, H, W, 2) float32 count frames in
    the C++ loop; the contract of ``data.events.integrate_events_to_frames``.
    Raises ValueError on a coordinate outside the frame."""
    if split_by not in ("time", "number"):
        raise ValueError(f"unknown split_by {split_by!r}")
    lib = load()
    t, x, y, p = (np.ascontiguousarray(events[k], np.int64) for k in ("t", "x", "y", "p"))
    frames = np.zeros((num_frames, H, W, 2), np.float32)
    fn = lib.integrate_events_time if split_by == "time" else lib.integrate_events_number
    rc = fn(_ptr(t, ctypes.c_int64), _ptr(x, ctypes.c_int64), _ptr(y, ctypes.c_int64),
            _ptr(p, ctypes.c_int64), t.shape[0], H, W, num_frames,
            _ptr(frames, ctypes.c_float))
    if rc != 0:
        raise ValueError("event coordinates out of bounds")
    return frames


def _check_indices(indices: np.ndarray, n_images: int) -> np.ndarray:
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n_images):
        raise IndexError(f"decode_idx_batch: index out of range [0, {n_images})")
    return idx


def decode_idx_batch(images_u8: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Gather a batch from (N, H, W[, C]) uint8 images and scale it to
    [0, 1]: (B, H, W[, C]) float32."""
    lib = load()
    idx = _check_indices(indices, images_u8.shape[0])
    imgs = np.ascontiguousarray(images_u8)
    row = int(np.prod(imgs.shape[1:]))
    out = np.empty((idx.shape[0], row), np.float32)
    lib.decode_idx_batch(_ptr(imgs.reshape(imgs.shape[0], row), ctypes.c_uint8),
                         _ptr(idx, ctypes.c_int64), idx.shape[0], row,
                         _ptr(out, ctypes.c_float))
    return out.reshape((idx.shape[0],) + imgs.shape[1:])


def decode_idx_batch_plain(images_u8: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """``decode_idx_batch`` in numpy, the C++ loop's arithmetic: each byte
    times the float32 1 / 255."""
    idx = _check_indices(indices, images_u8.shape[0])
    return images_u8[idx].astype(np.float32) * (np.float32(1.0) / np.float32(255.0))


def pack_spikes(spikes: np.ndarray) -> np.ndarray:
    """0/1 float32 spikes (any shape) -> uint8 bytes, LSB first."""
    lib = load()
    flat = np.ascontiguousarray(spikes, np.float32).reshape(-1)
    out = np.zeros(((flat.size + 7) // 8,), np.uint8)
    lib.pack_spikes_f32(_ptr(flat, ctypes.c_float), flat.size, _ptr(out, ctypes.c_uint8))
    return out


def pack_spikes_plain(spikes: np.ndarray) -> np.ndarray:
    """``pack_spikes`` in numpy."""
    flat = np.asarray(spikes, np.float32).reshape(-1)
    return np.packbits((flat != 0).astype(np.uint8), bitorder="little")


def unpack_spikes(packed: np.ndarray, shape) -> np.ndarray:
    """``pack_spikes``'s bytes -> float32 spikes of ``shape``."""
    lib = load()
    n = int(np.prod(shape))
    out = np.empty((n,), np.float32)
    lib.unpack_spikes_f32(_ptr(np.ascontiguousarray(packed, np.uint8), ctypes.c_uint8), n,
                          _ptr(out, ctypes.c_float))
    return out.reshape(shape)


def unpack_spikes_plain(packed: np.ndarray, shape) -> np.ndarray:
    """``unpack_spikes`` in numpy."""
    n = int(np.prod(shape))
    return np.unpackbits(np.asarray(packed, np.uint8), bitorder="little")[:n].astype(
        np.float32).reshape(shape)
