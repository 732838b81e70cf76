"""Build the CUDA sources under ``csrc/`` with nvcc and load them (ctypes).

The kernels have a plain C interface (``extern "C"`` launchers taking
device pointers, sizes and a stream), so they compile in seconds without
PyTorch's headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/sqz_tpu_torch/libsqz4cuda.so csrc/*.cu

The library is built on first use into ``build/sqz_tpu_torch/`` at the
root of the checkout (rebuilt when a source is newer), and nothing is
built or loaded when the package is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("sqz4_encode.cu", "sqz4_decode.cu")
HEADERS = ("sqz4_coder.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sqz_tpu_torch"
LIB = BUILD_DIR / "libsqz4cuda.so"
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda, or PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the sqz4 CUDA "
                           "kernels are built from source on first use")
    return found


def build(force: bool = False) -> Path:
    """Compile the kernels unless the library is newer than every source.
    The compiler's report (``-Xptxas -v``: registers, spills, shared
    memory) is kept beside the library as ``nvcc.log``."""
    srcs = [CSRC / s for s in SOURCES + HEADERS]
    if (not force and LIB.exists()
            and LIB.stat().st_mtime >= max(s.stat().st_mtime for s in srcs)):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp)]
    cmd += [str(CSRC / s) for s in SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIB)
    return LIB


def library() -> ctypes.CDLL:
    """The built kernel library, with its launchers' signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.sqz4_encode_launch.restype = i
            lib.sqz4_encode_launch.argtypes = [p, p, i, i, i, p, i, p, i, p]
            lib.sqz4_decode_launch.restype = i
            lib.sqz4_decode_launch.argtypes = [p, p, i, i, i, i, p, i, p, i,
                                               p, i, p, i, p]
            _lib = lib
        return _lib
