"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``dcfm_tpu_torch/csrc/*.cu`` (and the ``*.cuh`` headers
they share), plain C entry points with no PyTorch headers.  On first use
each source is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one
shared library under ``dcfm_tpu_torch/build/`` (generated, never
committed), named by a hash of the sources and flags so an edit rebuilds
and an unchanged tree reuses it.  The library is loaded with ``ctypes``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper
adds one where it launches its kernel and nowhere else.  Under CUDA graphs
a launch made while a graph is captured runs nothing, so it is counted into
that graph's own tally (:func:`capture_tally`), and each replay of the
graph adds the tally to ``LAUNCHES`` (:func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("chol_sample.cu", "batched_solve.cu", "lam_rows.cu", "sse_ps.cu")
HEADERS = ("chol_group.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"chol_sample": 0, "chol_solve_sample": 0, "cho_solve": 0,
            "lam_update": 0, "sse_ps": 0}

_lock = threading.Lock()
_lib = None
_entries: dict = {}             # C entry name -> ctypes function
_raw_stream = None
_tally = None                   # the tally of the graph being captured


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def capture_tally():
    """Count the launches made inside the block into a tally of their own
    (yielded), not into ``LAUNCHES``: wrap a CUDA graph's capture in it."""
    global _tally
    outer, _tally = _tally, dict.fromkeys(LAUNCHES, 0)
    try:
        yield _tally
    finally:
        _tally = outer


def add_launches(tally: dict) -> None:
    """Count a replay of a graph whose capture counted ``tally``."""
    for name, count in tally.items():
        LAUNCHES[name] += count


def nvcc_path() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's kernels are built from "
        "dcfm_tpu_torch/csrc on first use on the GPU")


def _tag() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build() -> tuple[str, str]:
    """Compile and link the kernels if needed; returns (library path,
    compiler log with the ``-Xptxas -v`` register/spill report)."""
    os.makedirs(BUILD, exist_ok=True)
    tag = _tag()
    lib_path = os.path.join(BUILD, f"libdcfm_kernels_{tag}.so")
    log_path = lib_path + ".log"
    if os.path.exists(lib_path) and os.path.exists(log_path):
        with open(log_path) as f:
            return lib_path, f.read()
    nvcc = nvcc_path()
    jobs = []
    for name in SOURCES:
        # per-process object names: two processes building at once never
        # write the same file (only the finished library is shared)
        obj = os.path.join(
            BUILD, f"{os.path.splitext(name)[0]}_{tag}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               os.path.join(CSRC, name), "-o", obj]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, obj, proc in jobs:            # wait for every job, then judge
        out, _ = proc.communicate()
        logs.append(f"== nvcc {name}\n{out}")
        if proc.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = f"{lib_path}.tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *(o for _, o, _ in jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _, obj, _ in jobs:
        os.remove(obj)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log = "\n".join(logs)
    with open(f"{log_path}.tmp{os.getpid()}", "w") as f:
        f.write(log)
    os.replace(f"{log_path}.tmp{os.getpid()}", log_path)
    os.replace(tmp, lib_path)
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use); its C entries are
    resolved once, into ``_entries``."""
    global _lib, _raw_stream
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for name, argtypes in (
                    ("dcfm_chol_sample", [ptr] * 4 + [i64, i32, ptr]),
                    ("dcfm_chol_solve_sample", [ptr] * 4 + [i64, i32, ptr]),
                    ("dcfm_cho_solve", [ptr] * 3 + [i64, i32, ptr]),
                    ("dcfm_lam_rows", [ptr] * 6 + [i64, i64, i32, ptr]),
                    ("dcfm_sse_ps", [ptr] * 7 + [i64, i32, ctypes.c_float,
                                                 ptr]),
                    # the card's floor, timed by chip_smoke.py only
                    ("dcfm_floor_empty", [ptr]),
                    ("dcfm_floor_pass", [ptr] * 7 + [i64, i32, ptr])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, i32
                _entries[name] = fn
            lib.dcfm_cuda_error_string.argtypes = [i32]
            lib.dcfm_cuda_error_string.restype = ctypes.c_char_p
            # the current stream's cudaStream_t of a device index, without
            # building a torch.cuda.Stream (PyTorch's own compiled code
            # reads it the same way)
            _raw_stream = torch._C._cuda_getCurrentRawStream
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if err:
        msg = library().dcfm_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def call(entry: str, device, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current stream of
    ``device`` and raise on the cudaError_t it returns.  The device is made
    current only when it is not already.  Counts nothing."""
    if _lib is None:
        library()
    index = device.index
    if index == torch.cuda.current_device():
        err = _entries[entry](*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = _entries[entry](*args, _raw_stream(index))
    check(err, entry)


def launch(kernel: str, entry: str, device, *args) -> None:
    """:func:`call`, then count one launch of ``kernel``: into the tally of
    the graph being captured, if any, else into ``LAUNCHES``.  A capture
    outside :func:`capture_tally` is refused: its replays would go
    uncounted."""
    call(entry, device, *args)
    if _tally is not None:
        _tally[kernel] += 1
    elif torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{kernel} was captured into a CUDA graph outside "
            "cuda_lib.capture_tally(): its replays would not be counted")
    else:
        LAUNCHES[kernel] += 1
