"""Build and load the port's native libraries: ``nvcc`` / ``g++`` + ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"`` launchers
taking raw pointers, sizes and a ``cudaStream_t``; no PyTorch headers).  On
first use it is compiled by ONE ``nvcc`` call into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout, where
the hash covers the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  :func:`build` starts one compiler per
missing library and waits for all of them, so several kernels compile in
parallel.  A ``csrc/<name>.cc`` (host C++, the post-processing library) is
built the same way by ``g++ -O3 -fPIC -std=c++17 -shared``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
# held from a miss in ``_libs`` through the build to the load: the replicas
# of a mesh launch from one thread each, so two of them may miss together
_load_lock = threading.RLock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _gxx() -> str:
    gxx = shutil.which(os.environ.get("CXX", "g++"))
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


def source(name: str) -> Path:
    """``csrc/<name>.cu``, else ``csrc/<name>.cc``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cc"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS


def library_path(name: str) -> Path:
    src = source(name)
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(src)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names) -> float:
    """Compile every library in ``names`` that is not built yet, all
    compilers at once.  Returns the wall seconds spent."""
    with _load_lock:
        return _build(names)


def _build(names) -> float:
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out, src = library_path(n), source(n)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cc = _nvcc() if src.suffix == ".cu" else _gxx()
        cmd = [cc, *_flags(src), "-o", str(tmp), str(src)]
        procs.append((n, out, tmp, Path(cc).name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for n, out, tmp, cc, p in procs:
        log, _ = p.communicate()
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"{n}: {cc} exited {p.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str, functions: dict) -> ctypes.CDLL:
    """The built library ``name`` with ``argtypes`` set from
    ``functions`` (``{symbol: [ctypes types]}``; every launcher returns
    a ``cudaError_t`` as int)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _load_lock:
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


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (the launch count of a kernel's
    wrapper), under a lock: the replicas of a mesh launch from one thread
    each."""
    with _count_lock:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
