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
the launch; :class:`Kernel` launches it under the device of its tensors,
raises on a non-zero code and counts launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")
# The entry points built on the MPC core (csrc/mpc_core.cuh). C functions
# of the library that take the horizon N: `<entry>_smem_bytes` (dynamic
# shared memory per block) and `<entry>_blocks_per_sm` (blocks an SM holds,
# cudaOccupancyMaxActiveBlocksPerMultiprocessor); then those that return
# sizeof(params)
MPC_ENTRIES = ("walking_mpc_prep", "walking_tick", "walking_tick_kf",
               "standing_tick", "standing_tick_kf", "fused_qp_nu3",
               "fused_qp_nu6", "walking_mpc_prep_inv", "walking_tick_inv",
               "walking_tick_kf_inv", "fused_qp_nu3_inv",
               "standing_tick_inv", "standing_tick_kf_inv",
               "fused_qp_nu6_inv")
SMEM_SIZERS = tuple(f"{e}_smem_bytes" for e in MPC_ENTRIES) + tuple(
    f"{e}_blocks_per_sm" for e in MPC_ENTRIES)
# the held-force tick forms (no MPC, no dynamic shared memory): a half warp
# a scenario, `<entry>_blocks_per_sm()` (no argument) the blocks an SM holds
HOLD_ENTRIES = ("walking_tick_hold", "walking_tick_kf_hold",
                "standing_tick_hold", "standing_tick_kf_hold")
HOLD_SIZERS = tuple(f"{e}_blocks_per_sm" for e in HOLD_ENTRIES)
PARAMS_SIZERS = ("walking_mpc_params_bytes", "walking_tick_params_bytes",
                 "chol_params_bytes", "pdip_params_bytes",
                 "walking_session_params_bytes")
# those that take two sizes: the matrix order n and the number of
# right-hand sides k (csrc/chol.cu), or n and the inequality rows m
# (csrc/pdip_fused.cu)
PAIR_SMEM_SIZERS = ("cholesky_smem_bytes", "chol_solve_smem_bytes",
                    "posdef_solve_smem_bytes", "posdef_solve_fast_smem_bytes",
                    "pdip_fused_smem_bytes")


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
            "nvcc not found (CUDA_HOME or PATH): the kernels are "
            "built from ops/csrc at first use on a CUDA machine")
    return found


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def source_hash(defines: tuple = ()) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, defines: tuple = ()) -> str:
    """Compile every ``.cu`` of ops/csrc to an object (the compilers run
    side by side), link them into `out`; returns the compilers' reports."""
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *_flags(defines), "-c", "-o", str(obj), str(src)],
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
def build_library(defines: tuple = ()) -> dict:
    """Compile (if needed) and load the kernel library once per process.

    `defines`: preprocessor macros of a separate instrumented build (the
    kernels launch from the default build, which defines none; the timing
    tool's ``MPC_STAGE_CLOCKS`` build is loaded beside it). Returns {"lib":
    CDLL, "path": str, "seconds": build wall time (0.0 when reused),
    "built": bool, "log": nvcc's -Xptxas -v report}.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "".join(f"_{d.lower()}" for d in defines)
    out = BUILD_DIR / f"libmpc_torch_kernels{tag}_{source_hash(defines)}.so"
    log, seconds, built = "", 0.0, False
    if not out.is_file():
        t0 = time.perf_counter()
        log = _compile(out, defines)
        seconds = time.perf_counter() - t0
        built = True
    lib = ctypes.CDLL(str(out))
    lib.mpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpc_cuda_error_string.restype = ctypes.c_char_p
    for name in SMEM_SIZERS:
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    for name in PAIR_SMEM_SIZERS:
        getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    for name in PARAMS_SIZERS + HOLD_SIZERS:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return {"lib": lib, "path": str(out), "seconds": seconds,
            "built": built, "log": log}


def ptxas_resources(log: str) -> dict:
    """The resource use ptxas reports for each kernel of a build's log
    (:func:`build_library`'s ``log``, compiled with ``-Xptxas -v``):
    {(source, mangled kernel name): "Used ... registers, ... smem ...;
    ... spill stores, ... spill loads"}. The tag nvcc gives an unnamed
    namespace differs from build to build and is left out of the name
    (``_GLOBAL__N__<hex>_`` -> ``_GLOBAL__N__``)."""
    out, source, entry = {}, None, None
    spills = {}
    for line in log.splitlines():
        line = line.strip()
        if line.startswith("--- "):
            source = line[4:]
        elif "Compiling entry function" in line or \
                "Function properties for" in line:
            entry = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                           line.split("'")[1] if "'" in line
                           else line.split()[-1])
        elif "bytes spill stores" in line and entry is not None:
            spills[(source, entry)] = line
        elif line.startswith("ptxas info") and "Used" in line \
                and entry is not None:
            key = (source, entry)
            out[key] = line.split(":", 1)[1].strip()
    return {k: f"{v}; {spills.get(k, '')}" for k, v in out.items()}


# every Kernel made, so that a CUDA graph can keep their counters true
# (ops/graphs.py)
KERNELS: list = []


class Kernel:
    """One C entry point of the kernel library with a launch counter.

    ``launches`` counts the launches made through this object; it is bumped
    only after a launch that CUDA accepted. A launch recorded into a CUDA
    graph runs nothing: ``ops.graphs.Graph`` takes it off again and adds
    it back at every replay.
    """

    def __init__(self, name: str, n_ptr: int, params_sizer: str):
        self.name = name
        self.n_ptr = n_ptr
        self.params_sizer = params_sizer   # C function: sizeof(params)
        self.launches = 0
        KERNELS.append(self)

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
               device: torch.device) -> None:
        """Launch on `device`, the CUDA device of the kernel's tensors, in
        its current stream. The library sets the kernel's shared-memory
        attribute and launches on the current device, so the launch runs
        with `device` made current (a tensor on ``cuda:1`` would otherwise
        be launched on ``cuda:0`` into a stream of ``cuda:1``). The stream
        is read at the launch: inside a CUDA graph capture it is the
        capture's."""
        if len(ptrs) != self.n_ptr:
            raise ValueError(f"{self.name}: {len(ptrs)} pointers, "
                             f"expected {self.n_ptr}")
        fn, lib = self._fn()
        sizer = getattr(lib, self.params_sizer)
        if sizer() != ctypes.sizeof(params):
            raise RuntimeError(
                f"{self.name}: parameter structure is {ctypes.sizeof(params)}"
                f" bytes in Python but {sizer()} in the library")
        with torch.cuda.device(device):
            rc = fn(ctypes.cast(ctypes.pointer(params), ctypes.c_void_p),
                    *ptrs, int(batch),
                    torch.cuda.current_stream(device).cuda_stream)
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
