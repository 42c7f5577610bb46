"""Build and load the port's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of the package with ``nvcc`` into
one shared library with a plain C interface, at first use, under
``build/procgen_tpu_torch/<hash of the sources and flags>/`` beside the
package, and loads it with ctypes.  Importing this module needs no CUDA
toolkit; a failed build raises.

The flags keep the arithmetic IEEE and unfused (``-fmad=false``, exact
division and square root, denormals kept), because the kernels must give
the bytes of their plain torch versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(HERE), "build", "procgen_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

_LIB = None
# what the last build reported: seconds, ptxas register/spill lines, path
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def build() -> str:
    """Compile the kernels (if this exact build is absent); returns the
    library path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libprocgen_tpu_torch.so")
    if os.path.isfile(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}"
        )
    os.replace(tmp, lib_path)
    ptxas = [ln.strip() for ln in r.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    BUILD_INFO.update(path=lib_path, seconds=dt, cached=False, ptxas=ptxas)
    return lib_path


def load():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        fn = lib.render_suffix
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
