"""ctypes bindings for the native host data library (``csrc/dataloader.cc``).

Counterpart of ``unibev_tpu/data/native.py``.  The port compiles the same
source itself with the host compiler (``c++ -O3 -shared -fPIC``) into
``build/host/`` on first use, under a name that carries a hash of the
source, so an edited source is rebuilt and ``csrc/`` is never written.  A
failed build raises with the compiler's message: there is no numpy stand-in
whose shuffle would differ from the library's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np

_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
SOURCE = osp.join(_ROOT, "csrc", "dataloader.cc")
BUILD_DIR = osp.join(_ROOT, "build", "host")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_LIB = None
_LOCK = threading.Lock()


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
    return osp.join(BUILD_DIR, f"libunibev_data-{digest.hexdigest()[:12]}.so")


def _build(path: str) -> None:
    """Compile to a private name, then rename: concurrent builds (test
    workers, loader processes) never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    r = subprocess.run(["c++", *CXX_FLAGS, "-o", tmp, SOURCE],
                       capture_output=True, text=True)
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE} with c++ failed:\n{r.stderr}")
    os.replace(tmp, path)


def lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not osp.exists(path):
                _build(path)
            so = ctypes.CDLL(path)
            so.load_points_bin.restype = ctypes.c_int64
            so.range_filter_shuffle_pad.restype = ctypes.c_int64
            _LIB = so
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def load_points_bin(path: str, max_points: int, dim: int = 5) -> np.ndarray:
    """A float32 ``.bin`` cloud of ``dim`` columns, at most ``max_points``."""
    out = np.empty((max_points, dim), np.float32)
    n = lib().load_points_bin(path.encode(), _ptr(out),
                              ctypes.c_int64(max_points), ctypes.c_int64(dim))
    if n < 0:
        raise FileNotFoundError(path)
    return out[:n]


def transform_points(points: np.ndarray, R: np.ndarray,
                     t: np.ndarray) -> np.ndarray:
    """In place ``points[:, :3] = points[:, :3] @ R.T + t``; returns points."""
    points = np.ascontiguousarray(points, np.float32)
    Rr = np.ascontiguousarray(R, np.float32).reshape(9)
    tt = np.ascontiguousarray(t, np.float32).reshape(3)
    lib().transform_points(_ptr(points), ctypes.c_int64(len(points)),
                           ctypes.c_int64(points.shape[1]), _ptr(Rr), _ptr(tt))
    return points


def range_filter_shuffle_pad(points: np.ndarray, pc_range, max_out: int,
                             shuffle: bool = True, seed: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The points inside ``pc_range`` (at most ``max_out``, optionally
    shuffled by a seeded Fisher-Yates) in a zero-padded (max_out, dim)
    buffer, its mask and the kept count."""
    points = np.ascontiguousarray(points, np.float32)
    dim = points.shape[1]
    out = np.empty((max_out, dim), np.float32)
    mask = np.empty((max_out,), np.uint8)
    rng = np.ascontiguousarray(pc_range, np.float32)
    n = lib().range_filter_shuffle_pad(
        _ptr(points), ctypes.c_int64(len(points)), ctypes.c_int64(dim),
        _ptr(rng), ctypes.c_int(1 if shuffle else 0), ctypes.c_uint64(seed),
        _ptr(out), _ptr(mask), ctypes.c_int64(max_out))
    return out, mask.astype(bool), int(n)


def normalize_pad_image(img: np.ndarray, mean, std, to_rgb: bool,
                        out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 BGR (or float32 without ``to_rgb``) -> normalized
    float32, zero-padded to ``out_hw``."""
    H, W = img.shape[:2]
    oh, ow = out_hw
    mean = np.ascontiguousarray(mean, np.float32)
    stdinv = np.ascontiguousarray(1.0 / np.asarray(std, np.float32))
    out = np.empty((oh, ow, 3), np.float32)
    if img.dtype == np.uint8:
        src = np.ascontiguousarray(img)
        lib().normalize_pad_image_u8(
            _ptr(src), ctypes.c_int64(H), ctypes.c_int64(W), _ptr(mean),
            _ptr(stdinv), ctypes.c_int(1 if to_rgb else 0), _ptr(out),
            ctypes.c_int64(oh), ctypes.c_int64(ow))
    else:
        if to_rgb:
            raise ValueError("the float32 path takes BGR already ordered")
        src = np.ascontiguousarray(img, np.float32)
        lib().normalize_pad_image_f32(
            _ptr(src), ctypes.c_int64(H), ctypes.c_int64(W), _ptr(mean),
            _ptr(stdinv), _ptr(out), ctypes.c_int64(oh), ctypes.c_int64(ow))
    return out
