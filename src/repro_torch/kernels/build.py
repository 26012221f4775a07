"""Build the port's CUDA kernels from `csrc/` and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for ``sm_90a``
(all started together), then the objects are linked into one shared
library with a plain C interface under ``build/repro_torch/`` at the repo
root. The library's name carries a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is loaded as it is. No PyTorch
header is compiled, so a build takes seconds and ``import repro_torch``
needs no ``nvcc``: the build runs at the first launch.

A missing ``nvcc``, a failed compile or a failed load raises with the
compiler's output; there is no stub.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel wrapper, counted where the wrapper launches its kernel
# (one per call, `count_launch`) and where a CUDA graph that holds it is
# replayed (`add_launches`); `ops.LAUNCHES` is this dict.
LAUNCHES = {"binary_probe_lb": 0, "block_mips": 0, "decode_attention": 0,
            "mips_score": 0, "quick_probe_select": 0, "scan_blocks": 0,
            "sketch_scores": 0}

_lock = threading.Lock()
_lib = None
_capture = threading.local()


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name`` in `LAUNCHES`; while this thread
    captures a CUDA graph (`counting_into`), in the graph's own tally
    instead, since a capture launches nothing."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        LAUNCHES[name] += 1
    else:
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def counting_into(tally: dict):
    """Route this thread's `count_launch` calls into ``tally`` (the kernels
    a CUDA graph being captured holds)."""
    prev = getattr(_capture, "tally", None)
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = prev


def add_launches(tally: dict) -> None:
    """Count the kernels of one replay of a graph whose tally is ``tally``."""
    for name, n in tally.items():
        LAUNCHES[name] += n


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (neither on PATH nor at "
                           "/usr/local/cuda/bin/nvcc): the CUDA kernels "
                           "cannot be built")
    return path


def _run(cmds):
    """Run the commands in parallel; raise with the output of any failure."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return "".join(outs)


def build():
    """Compile and link the kernels if the hashed library is missing.

    Returns (path of the library, the compiler's output; empty when the
    library was already built)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):   # the sources and their headers
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"libpromips_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                    for src, obj in zip(sources, objs)])
        tmp_lib = str(Path(tmp) / lib_path.name)
        log += _run([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib]])
        os.replace(tmp_lib, lib_path)
    return lib_path, log


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading {path} failed: {e}") from e
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.binary_probe_lb_launch.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
            lib.binary_probe_lb_launch.restype = i32
            lib.quick_probe_select_launch.argtypes = (
                [ptr] * 10 + [i32] * 3 + [ctypes.c_float] * 2 + [ptr])
            lib.quick_probe_select_launch.restype = i32
            lib.block_mips_launch.argtypes = (
                [ptr] * 16 + [i32] * 6 + [ctypes.c_longlong, ptr])
            lib.block_mips_work_bytes.argtypes = [i32] * 3
            lib.block_mips_work_bytes.restype = ctypes.c_longlong
            lib.block_mips_launch.restype = i32
            lib.decode_attention_launch.argtypes = (
                [ptr] * 7 + [i32] * 5 + [ctypes.c_float, ptr])
            lib.decode_attention_launch.restype = i32
            lib.decode_attention_scratch_floats.argtypes = [i32] * 5
            lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
            lib.mips_score_launch.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
            lib.mips_score_launch.restype = i32
            lib.mips_score_b_small.argtypes = []
            lib.mips_score_b_small.restype = i32
            lib.scan_blocks_launch.argtypes = (
                [ptr] * 16 + [i32] * 8 + [ctypes.c_float] * 2
                + [ptr, ctypes.c_longlong, ptr])
            lib.scan_blocks_launch.restype = i32
            lib.scan_blocks_scratch_bytes.argtypes = [i32] * 4
            lib.scan_blocks_scratch_bytes.restype = ctypes.c_longlong
            lib.scan_blocks_smem_bytes.argtypes = [i32] * 2
            lib.scan_blocks_smem_bytes.restype = ctypes.c_longlong
            lib.scan_blocks_max_smem.argtypes = []
            lib.scan_blocks_max_smem.restype = i32
            lib.sketch_scores_launch.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
            lib.sketch_scores_launch.restype = i32
            lib.kernels_error_string.argtypes = [i32]
            lib.kernels_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def require(kernel: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: the kernels index their inputs unchecked."""
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, not {device}")
    if t.dtype != dtype:
        raise ValueError(f"{kernel}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err:
        msg = library().kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
