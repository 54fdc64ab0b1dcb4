"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch header is included, so a file builds in seconds).  The build runs
at first use, from the sources in the package only, into ``_build/`` next
to this file (listed in ``.gitignore``); a library is rebuilt when a
source is newer than it.  :func:`build_all` starts one ``nvcc`` per
kernel, all at once.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have no ``nvcc``.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNELS = ("flash", "anchor", "stripe_select", "sparse")
CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dtype codes of csrc/common.cuh.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: collections.Counter = collections.Counter()
# Per kernel: the ptxas register/spill lines of its last build.
PTXAS: dict[str, list[str]] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch build on a "
            "machine with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build_all(names=KERNELS, force: bool = False) -> float:
    """Compile every stale kernel library, one ``nvcc`` each, in parallel.

    Returns the wall seconds spent.  Raises with the compiler's output if
    any build fails.
    """
    t0 = time.perf_counter()
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        PTXAS[name] = [ln.split("ptxas info    : ", 1)[-1].strip()
                       for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
        os.replace(tmp, _library_path(name))  # atomic for concurrent builds
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, rc: int) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = library(name).repro_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, what: str) -> None:
    """Raise ``ValueError`` for an input the kernel does not take."""
    if not cond:
        raise ValueError(what)


def check_cuda_tensors(op: str, dtype_ref: torch.Tensor, **tensors) -> None:
    """Device, dtype and contiguity checks shared by the wrappers: every
    float tensor on ``dtype_ref``'s CUDA device in its dtype, every tensor
    contiguous."""
    require(dtype_ref.dtype in DTYPES,
            f"{op}: dtype {dtype_ref.dtype} not supported (float32, bfloat16)")
    for key, t in tensors.items():
        if t is None:
            continue
        require(t.is_cuda and t.device == dtype_ref.device,
                f"{op}: {key} must lie on {dtype_ref.device}, got {t.device}")
        require(t.is_contiguous(), f"{op}: {key} must be contiguous")
