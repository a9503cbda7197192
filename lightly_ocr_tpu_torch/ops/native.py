"""Build and load the port's CUDA kernels: ``nvcc`` + ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
taking raw pointers, sizes and a ``cudaStream_t``; no PyTorch headers).  On
first use it is compiled by ONE ``nvcc`` call into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout, where
the hash covers the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  :func:`build` starts one ``nvcc`` per
missing library and waits for all of them, so several kernels compile in
parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc's output (ptxas register use)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names) -> float:
    """Compile every library in ``names`` that is not built yet, all
    ``nvcc`` processes at once.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The built library ``name`` with ``argtypes`` set from
    ``functions`` (``{symbol: [ctypes types]}``; every launcher returns
    a ``cudaError_t`` as int)."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for sym, argtypes in functions.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
