"""Build the CUDA kernels with nvcc and load them with ctypes.

Every `ratrack_tpu_torch/csrc/*.cu` compiles into ONE shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). One
nvcc per source, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o \
         kernels/build/libratrack_kernels_<hash>.so *.o

The library is built at first use into `kernels/build/` (git-ignored),
keyed by a hash of the sources and flags, so a fresh checkout builds
everything on its first kernel launch and a changed source rebuilds.
Nothing here runs at import time. `measuring(...)` switches the wrappers,
for a block of `kernels/tune.py`, to a second build with a measuring macro
defined; the port's own build defines none.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every launcher returns cudaGetLastError().
# An entry ending in _bf16 is the bfloat16-operand instantiation of the
# entry without the suffix, with its arguments.
SIGNATURES = {
    "ratrack_sa_pair": [_P, _P, _P, _I, _I, _I,
                        _P, _P, _P, _P, _P, _I, _F, _I, _P, _P,
                        _P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _I, _P],
    "ratrack_sa_scale": [_P, _P, _P, _I, _I, _I,
                         _P, _P, _P, _P, _P, _I, _F, _I, _P, _P, _I, _P],
    "ratrack_three_interpolate": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                  _I, _P, _P, _P],
    "ratrack_knn": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "ratrack_corr_aggregate": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P],
    "ratrack_corr_apply": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                           _P, _P, _P, _P, _P, _P, _P, _P],
    "ratrack_corr_apply_rows": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                                _P, _P, _P, _P, _P, _P, _I, _P, _P],
    "ratrack_knn_tiled": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                          _P],
    "ratrack_transport_flow": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                               _P, _P, _P, _P, _P],
    "ratrack_dbscan_labels": [_P, _P, _I, _I, _F, _I, _I, _P, _P],
    "ratrack_fps": [_P, _P, _I, _I, _I, _P, _I, _I, _P],
    "ratrack_sinkhorn": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "ratrack_sinkhorn_variant": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "ratrack_sa_train_fwd": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "ratrack_sa_train_bwd": [_P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P],
    "ratrack_sa_train_fwd_clusters": [_I, _I],
    "ratrack_sa_train_bwd_clusters": [_I, _I],
    "ratrack_sa_scale_train_fwd": [_P, _P, _P, _I, _I, _I, _F, _P, _P],
    "ratrack_sa_scale_train_bwd": [_P, _P, _I, _I, _I, _F, _P, _P, _P, _P],
    "ratrack_corr_train_fwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                               _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "ratrack_corr_train_bwd": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
}
SIGNATURES.update({f"{name}_bf16": SIGNATURES[name] for name in (
    "ratrack_sa_pair", "ratrack_sa_scale", "ratrack_three_interpolate",
    "ratrack_corr_aggregate", "ratrack_corr_apply",
    "ratrack_corr_apply_rows")})

# Macros of a measuring build (kernels/tune.py), never of the port's:
# RATRACK_SKELETON makes B1 / B1' skip their layers (outputs 0), B5 and
# B3's selection insert no candidate and B2 scan one known point a lane,
# the floor of each launch; RATRACK_KNN_NO_GATE makes B5 visit every chunk
# that holds a valid candidate.
MEASURING_MACROS = ("RATRACK_SKELETON", "RATRACK_KNN_NO_GATE")

_libs: dict[tuple[str, ...], ctypes.CDLL] = {}
_macros: tuple[str, ...] = ()   # of the build `load` returns
last_build: dict = {}


class Counter:
    """Launches of one kernel (`.launches`): its wrapper adds one where it
    launches the kernel, and nowhere else."""

    def __init__(self) -> None:
        self.launches = 0


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _flags(macros) -> list[str]:
    return NVCC_FLAGS + [f"-D{m}" for m in macros]


def source_hash(macros=()) -> str:
    h = hashlib.sha256(" ".join(_flags(macros)).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(macros=()) -> Path:
    """Compile csrc/ (with `macros` defined) into the library unless a
    build of these exact sources exists. Safe against concurrent builds
    (file lock + atomic rename). Records the seconds spent and nvcc's
    stderr (ptxas register, shared memory and spill report per kernel) in
    `last_build`."""
    target = BUILD_DIR / f"libratrack_kernels_{source_hash(macros)}.so"
    if target.exists():
        last_build.update(seconds=0.0, cached=True, log="")
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            last_build.update(seconds=0.0, cached=True, log="")
            return target
        tmp = target.with_suffix(f".tmp{os.getpid()}")
        obj_dir = BUILD_DIR / f"obj{os.getpid()}"
        obj_dir.mkdir(exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in (p for p in sources() if p.suffix == ".cu"):
            cmd = [nvcc, *_flags(macros), "-c", str(src), "-o",
                   str(obj_dir / f"{src.stem}.o")]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        log = []
        for cmd, proc in jobs:
            _, err = proc.communicate()
            log.append(err)
            if proc.returncode != 0:
                for _, other in jobs:
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{err}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *[str(cmd[-1]) for cmd, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)
        shutil.rmtree(obj_dir, ignore_errors=True)
        last_build.update(seconds=time.perf_counter() - t0, cached=False,
                          log="".join(log))
    return target


def load() -> ctypes.CDLL:
    """The kernels' library, built on first call."""
    lib = _libs.get(_macros)
    if lib is None:
        lib = ctypes.CDLL(str(build(_macros)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ratrack_error_string.argtypes = [ctypes.c_int]
        lib.ratrack_error_string.restype = ctypes.c_char_p
        _libs[_macros] = lib
    return lib


@contextlib.contextmanager
def measuring(*macros: str):
    """Inside the block every kernel wrapper launches the build with
    `macros` (of MEASURING_MACROS) defined: a floor or a variant to time,
    whose results are not the kernels' function."""
    global _macros
    unknown = set(macros) - set(MEASURING_MACROS)
    if unknown:
        raise ValueError(f"not a measuring macro: {sorted(unknown)}")
    saved, _macros = _macros, tuple(sorted(macros))
    try:
        yield
    finally:
        _macros = saved


def check(code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = load().ratrack_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def ptr(t) -> int | None:
    """Device pointer of a tensor, None for None (a null pointer)."""
    return None if t is None else t.data_ptr()


def ptr_array(tensors) -> ctypes.Array:
    """A host array of device pointers, null for None entries (the caller
    keeps `tensors` alive)."""
    return (ctypes.c_void_p * max(len(tensors), 1))(
        *[ptr(t) for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * max(len(values), 1))(*values)


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name: str, shape, device, dtype=None, align16: bool = False):
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype`
    (float32 by default), contiguous, of `shape` (None entries match any
    size) and, for float4 access, 16-byte aligned."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if align16 and t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")
