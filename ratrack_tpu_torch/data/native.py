"""ctypes bindings for the native host-side data path (native/).

The port's own copy of `ratrack_tpu/data/native.py`, over the same
library: the repository's top-level `native/libvod_native.so` (source
`native/src/vod_native.cpp`), which belongs to neither package. Every
entry point has the JAX module's NumPy fallback, so the library is
optional. It covers the per-point host loops of the streaming pipeline:
scan decode, homogeneous transforms, ego compensation, OBB membership, and
padding.

Routes, tried in order on first use (`route()` names the one taken):
  "committed"  the committed native/libvod_native.so loads;
  "built"      it does not (another C library, say), so the source is
               compiled with the host C++ compiler into the port's
               git-ignored kernels/build/ (never into native/) and loaded;
  "numpy"      neither: the NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libvod_native.so")
_SOURCE = os.path.join(_REPO_ROOT, "native", "src", "vod_native.cpp")
_BUILT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kernels", "build", "libvod_native.so")
_lib = None
_route: Optional[str] = None

_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _build() -> Optional[ctypes.CDLL]:
    """Compile the library's source into kernels/build/ (through a
    temporary file and a rename) and load it; None where that fails."""
    if not os.path.exists(_SOURCE):
        return None
    os.makedirs(os.path.dirname(_BUILT_PATH), exist_ok=True)
    tmp = f"{_BUILT_PATH}.tmp{os.getpid()}"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
           "-shared", "-o", tmp, _SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return None
    os.replace(tmp, _BUILT_PATH)
    return _load(_BUILT_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None when unavailable."""
    global _lib, _route
    if _route is not None:
        return _lib
    lib = _load(_LIB_PATH) if os.path.exists(_LIB_PATH) else None
    _route = "committed"
    if lib is None:
        lib, _route = _build(), "built"
    if lib is None:
        _route = "numpy"
        return None
    lib.vod_decode_scan.restype = ctypes.c_int
    lib.vod_decode_scan.argtypes = [ctypes.c_char_p, _F32P, ctypes.c_int,
                                    ctypes.c_int]
    lib.vod_transform_points.restype = None
    lib.vod_transform_points.argtypes = [_F32P, ctypes.c_int, _F64P, _F32P]
    lib.vod_compensate_ego.restype = None
    lib.vod_compensate_ego.argtypes = [_F32P, ctypes.c_int, _F64P, _F32P]
    lib.vod_points_in_obb.restype = ctypes.c_int
    lib.vod_points_in_obb.argtypes = [_F32P, ctypes.c_int, _F64P, _F64P,
                                      _F64P, ctypes.c_double, _U8P]
    lib.vod_pad_cloud.restype = ctypes.c_int
    lib.vod_pad_cloud.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _F32P, _U8P]
    _lib = lib
    return _lib


def available() -> bool:
    """True where the native library serves the entry points (`route()`
    says from which file), False where the NumPy fallbacks do."""
    return get_lib() is not None


def route() -> str:
    """"committed", "built" or "numpy": see the module's docstring."""
    get_lib()
    return _route


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _f64(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


def decode_scan(path: str, stride: int,
                max_pts: int = 1 << 20) -> np.ndarray:
    """Binary float32 scan file → (n, stride) array (np.fromfile fallback)."""
    lib = get_lib()
    if lib is None:
        return np.fromfile(path, np.float32).reshape(-1, stride)
    out = np.empty((max_pts, stride), np.float32)
    n = lib.vod_decode_scan(path.encode(), out.ctypes.data_as(_F32P),
                            max_pts, stride)
    if n == -1:
        raise FileNotFoundError(path)
    if n == -2:
        raise ValueError(f"{path}: size not a multiple of {stride} floats")
    return out[:n].copy()


def transform_points(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(N,3) homogeneous transform (native or numpy)."""
    lib = get_lib()
    if lib is None:
        hom = np.concatenate([points, np.ones((points.shape[0], 1),
                                              points.dtype)], axis=1)
        return (t @ hom.T).T[:, :3].astype(np.float32)
    pts = _f32(points)
    out = np.empty_like(pts)
    lib.vod_transform_points(pts.ctypes.data_as(_F32P), pts.shape[0],
                             _f64(t).ctypes.data_as(_F64P),
                             out.ctypes.data_as(_F32P))
    return out


def compensate_ego(points: np.ndarray, ego_motion: np.ndarray) -> np.ndarray:
    """Reference ego compensation: (hom(p) @ inv(T.T))[:, :3]."""
    lib = get_lib()
    m = np.linalg.inv(np.asarray(ego_motion, np.float64).T)
    if lib is None:
        hom = np.concatenate([points, np.ones((points.shape[0], 1),
                                              points.dtype)], axis=1)
        return (hom @ m)[:, :3].astype(np.float32)
    pts = _f32(points)
    out = np.empty_like(pts)
    lib.vod_compensate_ego(pts.ctypes.data_as(_F32P), pts.shape[0],
                           _f64(m).ctypes.data_as(_F64P),
                           out.ctypes.data_as(_F32P))
    return out


def points_in_obb(points: np.ndarray, center: np.ndarray, rot: np.ndarray,
                  extent: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """(N,) bool closed in-box test (matches data.gt.points_in_obb)."""
    lib = get_lib()
    if lib is None:
        local = (points.astype(np.float64) - center) @ rot
        return np.all(np.abs(local) <= np.asarray(extent) / 2.0 + eps,
                      axis=1)
    pts = _f32(points)
    out = np.empty(pts.shape[0], np.uint8)
    lib.vod_points_in_obb(pts.ctypes.data_as(_F32P), pts.shape[0],
                          _f64(center).ctypes.data_as(_F64P),
                          _f64(rot).ctypes.data_as(_F64P),
                          _f64(extent).ctypes.data_as(_F64P),
                          ctypes.c_double(eps),
                          out.ctypes.data_as(_U8P))
    return out.astype(bool)


def pad_cloud(src: np.ndarray,
              n_max: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """(n, c) → zero-padded (n_max, c) + bool mask + kept count."""
    lib = get_lib()
    if lib is None:
        n = min(src.shape[0], n_max)
        out = np.zeros((n_max,) + src.shape[1:], np.float32)
        out[:n] = src[:n]
        mask = np.zeros(n_max, bool)
        mask[:n] = True
        return out, mask, n
    s = _f32(src)
    c = s.shape[1]
    out = np.empty((n_max, c), np.float32)
    mask = np.empty(n_max, np.uint8)
    n = lib.vod_pad_cloud(s.ctypes.data_as(_F32P), s.shape[0], c, n_max,
                          out.ctypes.data_as(_F32P),
                          mask.ctypes.data_as(_U8P))
    return out, mask.astype(bool), n
