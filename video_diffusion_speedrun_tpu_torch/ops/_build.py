"""Build and load the port's CUDA kernels (counterpart of `ops/pallas_utils.py`).

Each `csrc/<name>.cu` compiles with one `nvcc` call into its own shared
library with a plain C interface, loaded with `ctypes`. The libraries go to
`csrc/build/` (listed in .gitignore), named by a hash of their source and
the shared headers (`csrc/*.cuh`), so a changed source rebuilds and an
unchanged one loads from disk. Every `.cu`
exports `<name>_error_string(int)`. Builds happen at first use, never at
import: the CPU tests import every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
# name → (seconds, ptxas report) of the builds this process ran
build_log: Dict[str, Tuple[float, str]] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: List[str]) -> None:
    """Compile the named sources that are not built yet, one `nvcc` each,
    all started together. Raises with the compiler's output on failure."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        build_log[name] = (time.perf_counter() - t0, log)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes, err_str.restype = [ctypes.c_int], ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(name: str, err: int) -> None:
    """Raise on the `cudaError_t` that an entry point of `csrc/<name>.cu`
    returned; every entry point returns `cudaGetLastError()` after its
    launch, since a refused launch never runs and no sync reports it."""
    if err != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")
