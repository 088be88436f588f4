"""Build and bind the hand-written CUDA kernels of ``ops/csrc``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per ``.cu`` file, all started together, then one link) into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``. The library lives in
``<checkout>/build/torch_kernels/`` under a name keyed by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused. Nothing is built or loaded when this module is imported.

Each kernel entry point takes its parameters as a pointer to a
``ctypes.Structure``, device pointers and the CUDA stream as ``void*`` and
the batch size as ``int``, and returns ``cudaGetLastError()`` right after
the launch; :class:`Kernel` raises on a non-zero code and counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# C functions of the library that take the horizon N and return bytes of
# dynamic shared memory per block, and those that return sizeof(params)
SMEM_SIZERS = ("walking_mpc_prep_smem_bytes", "walking_tick_smem_bytes",
               "walking_tick_kf_smem_bytes", "standing_tick_smem_bytes",
               "standing_tick_kf_smem_bytes", "fused_qp_nu3_smem_bytes",
               "fused_qp_nu6_smem_bytes")
PARAMS_SIZERS = ("walking_mpc_params_bytes", "walking_tick_params_bytes")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME or PATH): the walking kernels are "
            "built from ops/csrc at first use on a CUDA machine")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every ``.cu`` of ops/csrc to an object (the compilers run
    side by side), link them into `out`; returns the compilers' reports."""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(CSRC))))
    log, failed = "", []
    for src, obj, proc in jobs:
        text = proc.communicate()[0]
        log += f"--- {src.name}\n{text}"
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = BUILD_DIR / f"{tag}.tmp"
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, out)
    finally:
        for o in objs:
            Path(o).unlink(missing_ok=True)
    return log


@functools.lru_cache(maxsize=None)
def build_library() -> dict:
    """Compile (if needed) and load the kernel library once per process.

    Returns {"lib": CDLL, "path": str, "seconds": build wall time (0.0
    when reused), "built": bool, "log": nvcc's -Xptxas -v report}.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libmpc_torch_kernels_{source_hash()}.so"
    log, seconds, built = "", 0.0, False
    if not out.is_file():
        t0 = time.perf_counter()
        log = _compile(out)
        seconds = time.perf_counter() - t0
        built = True
    lib = ctypes.CDLL(str(out))
    lib.mpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpc_cuda_error_string.restype = ctypes.c_char_p
    for name in SMEM_SIZERS:
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    for name in PARAMS_SIZERS:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return {"lib": lib, "path": str(out), "seconds": seconds,
            "built": built, "log": log}


class Kernel:
    """One C entry point of the kernel library with a launch counter.

    ``launches`` counts the launches made through this object; it is bumped
    only after a launch that CUDA accepted.
    """

    def __init__(self, name: str, n_ptr: int, params_sizer: str):
        self.name = name
        self.n_ptr = n_ptr
        self.params_sizer = params_sizer   # C function: sizeof(params)
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0

    def _fn(self):
        lib = build_library()["lib"]
        fn = getattr(lib, self.name)
        fn.argtypes = ([ctypes.c_void_p] * (1 + self.n_ptr)
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return fn, lib

    def launch(self, params: ctypes.Structure, ptrs, batch: int,
               stream: int) -> None:
        if len(ptrs) != self.n_ptr:
            raise ValueError(f"{self.name}: {len(ptrs)} pointers, "
                             f"expected {self.n_ptr}")
        fn, lib = self._fn()
        sizer = getattr(lib, self.params_sizer)
        if sizer() != ctypes.sizeof(params):
            raise RuntimeError(
                f"{self.name}: parameter structure is {ctypes.sizeof(params)}"
                f" bytes in Python but {sizer()} in the library")
        rc = fn(ctypes.cast(ctypes.pointer(params), ctypes.c_void_p),
                *ptrs, int(batch), stream)
        if rc != 0:
            msg = lib.mpc_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name} launch failed: CUDA error "
                               f"{rc} ({msg})")
        self.launches += 1


def check_tensor(name: str, t, shape, device) -> None:
    """Raise unless t is a contiguous float32 tensor of `shape` on
    `device`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes "
                        f"torch.float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
