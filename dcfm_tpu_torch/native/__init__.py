"""Native (C++) host-side assembler, built with g++ on first use and
loaded with ctypes.

The port's copy of ``dcfm_tpu/native``: the final covariance assembly
(utils/estimate.py) is a memory-bound O(p^2) stitch that NumPy needs four
passes for and ``assemble.cpp`` does in one output-row-major pass.

The source is compiled by ``g++ -O3 -shared -fPIC -std=c++17 -Wall
-Wextra`` at first use into ``dcfm_tpu_torch/build/`` (generated, never
committed), named by a hash of the source and the flags so an edit
rebuilds and an unchanged tree reuses the library; each process builds
under a name of its own and renames the finished library into place, so
concurrent processes never load a half-written object.  Without a compiler,
or when the build fails, :func:`available` is false and callers take the
NumPy path, which computes the same bits (utils/estimate.py).

Two switches, the JAX package's: ``DCFM_NATIVE_DISABLE=1`` turns the
library off (every caller takes the NumPy path; the server's ``/healthz``
then reports ``degraded``), and ``DCFM_NATIVE_SANITIZE=1`` selects a
separate ASan+UBSan build (``-O1 -g -fsanitize=address,undefined``, its own
hash, so the two builds never replace each other).  The sanitized library
loads only when the ASan runtime is already in the process
(``LD_PRELOAD=$(gcc -print-file-name=libasan.so)``): loading it without
one aborts the process, so without it the module degrades to the NumPy
path instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "assemble.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
SANITIZE_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer",
                  "-fsanitize=address,undefined", "-shared", "-fPIC",
                  "-std=c++17", "-Wall", "-Wextra")

_lock = threading.Lock()
_lib = None
_build_failed = False


def sanitize_requested() -> bool:
    """True when DCFM_NATIVE_SANITIZE=1 selects the ASan/UBSan build."""
    return os.environ.get("DCFM_NATIVE_SANITIZE") == "1"


def _flags() -> tuple:
    return SANITIZE_FLAGS if sanitize_requested() else CXX_FLAGS


def _asan_runtime_loaded() -> bool:
    """True when the ASan runtime is already in this process (LD_PRELOAD):
    loading the sanitized library without it terminates the process at
    ``dlopen`` instead of raising, so the loader checks first."""
    try:
        with open("/proc/self/maps", "r") as f:
            return "libasan" in f.read()
    except OSError:
        return False


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(_flags()).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD, f"libdcfm_assemble_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the assembler (the sanitized build under
    DCFM_NATIVE_SANITIZE=1) if its library is missing; returns its path.
    Raises when no g++ is found or the compile fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native assembler is built "
                           "from dcfm_tpu_torch/native/assemble.cpp")
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        out = subprocess.run([cxx, *_flags(), "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"g++ failed on assemble.cpp:\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if os.environ.get("DCFM_NATIVE_DISABLE") == "1" or (
                sanitize_requested() and not _asan_runtime_loaded()):
            # the kill switch, or a sanitized build that would abort the
            # process at load: every caller takes the NumPy path
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(build())
        except (OSError, RuntimeError):
            _build_failed = True     # no compiler: the NumPy path serves
            return None
        f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
        fn = lib.assemble_covariance_rowmajor
        fn.restype = None
        fn.argtypes = [f32, i64, i64, i64, f32, ctypes.POINTER(i64), f32,
                       i64]
        fnq = lib.assemble_covariance_q8_rowmajor
        fnq.restype = None
        fnq.argtypes = [ctypes.POINTER(ctypes.c_int8), f32, i64, i64, i64,
                        f32, ctypes.POINTER(i64), f32, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def g_from_pairs(n_pairs: int) -> int:
    """Invert n_pairs = g(g+1)/2, validating that n_pairs is a full upper
    triangle (the single home for this derivation)."""
    g = int(round((np.sqrt(8 * n_pairs + 1) - 1) / 2))
    if n_pairs != g * (g + 1) // 2:
        raise ValueError(
            f"{n_pairs} pairs is not a full upper triangle (g={g})")
    return g


def _check_maps(g: int, P: int, scale, out_map) -> None:
    if scale.shape != (g * P,) or out_map.shape != (g * P,):
        raise ValueError(
            f"scale/map must be ({g * P},), got {scale.shape}/{out_map.shape}")


def assemble_covariance(upper: np.ndarray, scale: np.ndarray,
                        out_map: np.ndarray,
                        p_out: int) -> Optional[np.ndarray]:
    """One-pass upper panels -> final (p_out, p_out) covariance.

    ``upper`` must hold the FULL g(g+1)/2 upper-triangle panel set in
    np.triu_indices order.  Returns None when the native library is
    unavailable (callers take the NumPy path).  See assemble.cpp for the
    contract."""
    lib = _load()
    if lib is None:
        return None
    n_pairs, P, P2 = upper.shape
    if P != P2:
        raise ValueError(f"upper blocks must be square, got {upper.shape}")
    g = g_from_pairs(n_pairs)
    upper = np.ascontiguousarray(upper, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    out_map = np.ascontiguousarray(out_map, np.int64)
    _check_maps(g, P, scale, out_map)
    if out_map.max() >= p_out:
        raise ValueError("map index beyond p_out")
    out = np.zeros((p_out, p_out), np.float32)  # dcfm: ignore[DCFM1501] - the assembler's output; callers gate on materialize_sigma
    lib.assemble_covariance_rowmajor(
        _ptr(upper, ctypes.c_float), n_pairs, P, g,
        _ptr(scale, ctypes.c_float), _ptr(out_map, ctypes.c_int64),
        _ptr(out, ctypes.c_float), p_out)
    return out


def assemble_q8(q_panels: np.ndarray, panel_scale: np.ndarray,
                scale: np.ndarray, out_map: np.ndarray,
                out: np.ndarray) -> bool:
    """Assemble the final covariance STRAIGHT from int8-quantized panels
    into ``out`` (pre-zeroed, C-contiguous, square float32): the
    dequantization (entry * panel_scale/127) folds into the same pass.
    Returns False when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    n_pairs, P, P2 = q_panels.shape
    if P != P2:
        raise ValueError(f"panels must be square, got {q_panels.shape}")
    if q_panels.dtype != np.int8:
        raise ValueError(f"expected int8 panels, got {q_panels.dtype}")
    g = g_from_pairs(n_pairs)
    if not (out.flags.c_contiguous and out.dtype == np.float32
            and out.ndim == 2 and out.shape[0] == out.shape[1]):
        raise ValueError("out must be C-contiguous square float32")
    if np.shape(panel_scale) != (n_pairs,):
        raise ValueError(
            f"panel_scale must be ({n_pairs},), got {np.shape(panel_scale)}")
    q_panels = np.ascontiguousarray(q_panels, np.int8)
    panel_scale = np.ascontiguousarray(panel_scale, np.float32)
    scale = np.ascontiguousarray(scale, np.float32)
    out_map = np.ascontiguousarray(out_map, np.int64)
    _check_maps(g, P, scale, out_map)
    if out_map.max() >= out.shape[0]:
        raise ValueError("map index beyond out")
    lib.assemble_covariance_q8_rowmajor(
        _ptr(q_panels, ctypes.c_int8), _ptr(panel_scale, ctypes.c_float),
        n_pairs, P, g, _ptr(scale, ctypes.c_float),
        _ptr(out_map, ctypes.c_int64), _ptr(out, ctypes.c_float),
        out.shape[0])
    return True
