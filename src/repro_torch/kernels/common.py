"""Shared helpers for the Hopper kernels of the port.

Counterpart of :mod:`repro.kernels.common`. Three concerns live here:

* :func:`pad_to` — the same integer rounding the reference uses;
* :func:`resolve_device` — entry points run on the card unless the caller
  asks for the CPU, and they refuse to fall back to the CPU quietly;
* :func:`count_launch` — the wrappers' launch counters, safe to bump from
  the serving tier's replica threads;
* :func:`load_cuda_library` — compiles ``csrc/<name>.cu`` with ``nvcc`` for
  ``sm_90a`` into a shared library with a plain C interface on first use and
  loads it with :mod:`ctypes`. The build lands in ``kernels/_build/`` (git
  ignored), keyed by a hash of the source, the shared ``csrc/*.cuh`` headers
  and the flags, so a second call in the same checkout reuses it. Distinct
  libraries build concurrently (one ``nvcc`` each).

Nothing here compiles anything at import time: the CPU tests import every
module of the package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

__all__ = [
    "pad_to", "resolve_device", "on_cuda", "load_cuda_library",
    "build_cuda_library", "check_status", "count_launch", "cuda_function",
    "launch_on", "SMEM_BYTES_PER_BLOCK",
]

# Shared memory one block may use on an H100 (227 KB of the SM's 256 KB).
SMEM_BYTES_PER_BLOCK = 232_448

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_BUILD = os.path.join(os.path.dirname(__file__), "_build")   # git-ignored
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
_build_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_count_lock = threading.Lock()


def pad_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return -(-x // m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    ``device=None`` means the card. Without a card that is an error — the
    port never carries on quietly on the CPU; pass ``device="cpu"`` for the
    plain PyTorch versions of the kernels. A CUDA device also pins float32
    matrix products to full fp32 (no TF32), which the reference's parity
    relies on for navigation, assignment and the rescore.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def on_cuda(*tensors) -> bool:
    """True when the (first) tensor lies on a CUDA device; every other
    tensor must lie on the same device, or the call raises."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(
                f"tensors on different devices: {dev} and {t.device}"
            )
    return dev.type == "cuda"


def count_launch(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to ``wrapper.<attr>`` under a lock: replicas launch from
    several threads, and a bare ``+=`` is a read-modify-write that can lose
    an increment between them."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(
            f"{name}: kernel launch failed with cudaError {status}"
        )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.sep, "usr", "local", "cuda", "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the CUDA kernels are compiled from "
        "src/repro_torch/kernels/csrc on first use"
    )


def build_cuda_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` (if not built yet); return the .so path.

    The output name carries a hash of the source and the flags, and the
    library is written to a temporary name and renamed into place, so two
    processes building at once never load a half-written file.
    """
    src = os.path.join(_CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(_CSRC, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    out_dir = _BUILD
    out = os.path.join(out_dir, f"lib{name}-{digest.hexdigest()[:16]}.so")
    with _locks_guard:
        lock = _build_locks.setdefault(name, threading.Lock())
    with lock:
        if os.path.exists(out):
            return out
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {res.returncode}):\n"
                    f"{res.stdout}\n{res.stderr}"
                )
            with open(out + ".ptxas.txt", "w") as f:
                f.write(res.stderr)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@functools.cache
def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (first use) and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(build_cuda_library(name))


@functools.cache
def cuda_function(name: str, fn_name: str, n_ptr: int, n_int: int):
    """``fn_name`` of the library built from ``csrc/<name>.cu``, declared as
    ``int fn(<n_ptr pointers>, <n_int ints>, stream)`` (looked up once).
    Every pointer (and the stream) is a ``c_void_p``: an undeclared Python
    int would be passed as a 32-bit int and cut the pointer."""
    fn = getattr(load_cuda_library(name), fn_name)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
    fn.restype = ctypes.c_int
    return fn


def launch_on(dev: torch.device, fn, *args) -> int:
    """Call the C entry point ``fn(*args, stream)`` on ``dev``'s current
    stream; the CUDA runtime's current device is switched only when it is
    not ``dev`` already (the switch costs host time on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
