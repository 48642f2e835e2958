"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch_kernels/lib<name>-<hash>.so``
under the repository root, compiled for Hopper (``sm_90a``) with a plain C
interface.  The hash is taken over the source and the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt and a stale library is
never loaded.  Libraries build on first use; ``build_all`` starts one
nvcc per source at once; ``load`` builds and loads under a lock, so threads
that first call a kernel together run one nvcc.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("rmsnorm", "flash_attention", "moe_matmul", "ssd_scan", "launch_floor")
MAX_SMEM_BYTES = 232_448  # dynamic shared memory one Hopper block may have
NUM_SMS = 132  # streaming multiprocessors of an H100 SXM, for persistent grids
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # threads that first call a kernel together build it once


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # shared headers change every library
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if already built."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    # ptxas -v: registers, shared memory, stack frame and spills of each kernel
    for line in out.splitlines():
        if "ptxas" in line or "spill" in line:
            print(f"[build {name}] {line.strip()}", flush=True)
    os.replace(tmp, target)  # atomic: a concurrent build sees all or nothing


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Compile every missing library, one nvcc process per source in parallel."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as e:  # finish the other builds, then report all
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.

    Every library exports ``<name>_error_string(int) -> const char*``.
    """
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(_library_path(name)))
                err_fn = getattr(lib, f"{name}_error_string")
                err_fn.argtypes = [ctypes.c_int]
                err_fn.restype = ctypes.c_char_p
                _loaded[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point of ``name``."""
    if err != 0:
        msg = getattr(_loaded[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
