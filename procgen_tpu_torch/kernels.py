"""Build and load the port's CUDA kernels.

``load()`` compiles every ``csrc/*.cu`` of the package with ``nvcc``, one
process per source, all started together, links the objects into one
shared library with a plain C interface, at first use, under
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

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [
    *ARCH,
    "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xptxas", "-v",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# argument types of each C entry point: a c_void_p for every pointer and
# the stream, a c_int for every int
ENTRY_POINTS = {
    "render_suffix": [_P] * 8 + [_I] * 11 + [_P],
    "render_frame": [_P] * 12 + [_I] * 21 + [_P],
    "assetgen_bg": [_P] * 5 + [_I] * 4 + [_P],
    "render_suffix_occupancy": [_I] * 2 + [_P],
    "render_frame_occupancy": [_I] * 4 + [_P],
}

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


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; their stderr, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = []
    failed = None
    for cmd, p in zip(cmds, procs):
        _, err = p.communicate()
        errs.append(err)
        if p.returncode != 0 and failed is None:
            failed = f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{err}"
    if failed:
        raise RuntimeError(failed)
    return errs


def build() -> str:
    """Compile the kernels (if this exact build is absent); returns the
    library path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(glob.glob(os.path.join(CSRC, "*"))):
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libprocgen_tpu_torch.so")
    if os.path.isfile(lib_path):
        BUILD_INFO.update(path=lib_path, seconds=0.0, cached=True)
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    tag = os.getpid()
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    errs = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                     for s, o in zip(srcs, objs)])
    tmp = f"{lib_path}.{tag}.tmp"
    _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    dt = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    for o in objs:
        os.remove(o)
    ptxas = [ln.strip() for err in errs for ln in err.splitlines()
             if "registers" in ln or "spill" in ln]
    BUILD_INFO.update(path=lib_path, seconds=dt, cached=False, ptxas=ptxas)
    return lib_path


def load():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
