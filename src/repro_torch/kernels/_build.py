"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/kernels/<name>-<hash>.so`` at the
repository root, and loaded with ``ctypes``. The hash covers the source, the
shared headers and the flags, so an edited source is rebuilt at its next use
and an unchanged one never is. All missing libraries are compiled together,
one ``nvcc`` process per source, the first time any kernel is needed: nothing
is built when a module is imported, and nothing here runs on a CPU-only host
unless a kernel is asked for on a CUDA tensor.

No ``--use_fast_math``: the sampler's ``logf`` must be the full-precision one.

Every kernel wrapper adds one to ``LAUNCHES[<name>]`` where it launches its
kernel, so a run can show which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "sampling")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

LAUNCHES: Dict[str, int] = {
    "rmsnorm": 0, "flash_attention": 0, "decode_attention": 0, "fused_sample": 0,
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on the machine with "
            "the GPU (CUDA toolkit under /usr/local/cuda)")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current hash."""
    digest = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel whose library is missing, all in parallel.
    Returns the seconds spent compiling (0.0 when everything was built)."""
    todo = [(n, library_path(n)) for n in KERNELS if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        lib = _LIBS[name] = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def entry(name: str, fn: str, argtypes) -> Callable[..., int]:
    """A C entry point of ``csrc/<name>.cu`` with its argument types set;
    every entry point returns a CUDA error code."""
    f = getattr(library(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def launch_site(t: torch.Tensor):
    """(device index, stream handle) to launch on for a CUDA tensor: the
    tensor's device and PyTorch's current stream there."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def require(ok: bool, what: str) -> None:
    """Raise ValueError unless a kernel's precondition holds."""
    if not ok:
        raise ValueError(what)


def require_cuda(*tensors) -> None:
    """All tensors on one CUDA device, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        require(t.device == dev, f"tensors on {t.device} and {dev}")
        require(t.is_contiguous(), f"tensor of shape {tuple(t.shape)} is not contiguous")
        require(t.data_ptr() % 16 == 0, "tensor data is not 16-byte aligned")
