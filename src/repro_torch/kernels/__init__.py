"""Hand-written CUDA kernels for Hopper, and their build.

Each kernel is one CUDA C++ source under ``src/repro_torch/csrc/`` with a
plain C interface.  It is compiled with ``nvcc`` for ``sm_90a`` on first
use into ``build/repro_torch_kernels/`` at the root of the checkout, keyed
by a hash of the source, and loaded with ``ctypes``.  Nothing is fetched
and no binary is shipped.  ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for every one of them.

  fed_agg        — staleness-discounted model aggregation (paper eq. 14)
  pairwise_dist  — pairwise squared-L2 between flattened models (grouping)

Each kernel's wrapper (``kernels/<name>/ops.py``) takes its plain PyTorch
version (``kernels/<name>/ref.py``) only for a tensor on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("fed_agg", "pairwise_dist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

# loaded shared libraries, one per source: a library, once loaded, is
# process state whatever holds the handle
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lives (keyed by its hash)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=SOURCES, *, verbose: bool = False) -> Dict[str, str]:
    """Compile every source in ``names`` that has no build yet: one
    ``nvcc`` process per source, all started together and all waited for.
    Returns the compiler's output per compiled source (``-Xptxas -v``
    register and shared-memory use when ``verbose``); raises
    ``RuntimeError`` naming every source that failed."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (so, tmp, proc) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, so)       # atomic: a reader never sees half a .so
        else:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n"
                          f"{logs[name]}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str, signatures) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed.
    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream must be ``ctypes.c_void_p``, or ctypes passes
    a 32-bit int and cuts the address.  Each source also exports
    ``<name>_error_string(int)``."""
    lib = _LIBS.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(so))
        sigs = dict(signatures)
        sigs[f"{name}_error_string"] = ([ctypes.c_int], ctypes.c_char_p)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def launch_error(lib: ctypes.CDLL, name: str, code: int) -> RuntimeError:
    """The error for a launch of ``name`` that returned CUDA error
    ``code``."""
    msg = getattr(lib, f"{name}_error_string")(code).decode()
    return RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
