"""Build the CUDA sources under ``csrc/`` with nvcc and load them (ctypes).

The kernels (the sqz4 coders and compaction, the squeeze bit-packer, the
primitive probes) have a plain C interface (``extern "C"`` launchers taking
device pointers, sizes and a stream), so they compile in seconds without
PyTorch's headers. Each source compiles in its own nvcc process, all
started together, and one more nvcc links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC -o <source>.o csrc/<source>.cu      (each source)
    nvcc -shared -o build/sqz_tpu_torch/libsqz4cuda.so *.o

The library is built on first use into ``build/sqz_tpu_torch/`` at the
root of the checkout (rebuilt when a source is newer), and nothing is
built or loaded when the package is imported. Builds write to files named
after the process and move the result into place with ``os.replace``, so
concurrent builders (parallel test workers) never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("sqz4_encode.cu", "sqz4_decode.cu", "sqz4_encode_tok.cu",
           "sqz4_compact.cu", "squeeze_bitpack.cu", "sqz4_encode_stats.cu",
           "probe.cu")
HEADERS = ("sqz4_coder.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sqz_tpu_torch"
LIB = BUILD_DIR / "libsqz4cuda.so"
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None


def is_fresh(lib: Path, deps) -> bool:
    """True when ``lib`` exists and is newer than every dependency."""
    return lib.exists() and lib.stat().st_mtime >= max(
        d.stat().st_mtime for d in deps)


def run_parallel(cmds):
    """Start every command at once and wait for all: [(rc, output)]."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [(p.returncode, out) for p, out in zip(procs, outs)]


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
    srcs = [CSRC / s for s in SOURCES]
    if not force and is_fresh(LIB, srcs + [CSRC / h for h in HEADERS]):
        return LIB
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = nvcc_path(), os.getpid()
    objs = [BUILD_DIR / f"{s.stem}.{pid}.o" for s in srcs]
    tmp = LIB.with_suffix(f".{pid}.tmp")
    try:
        res = run_parallel([
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)])
        if all(rc == 0 for rc, _ in res):
            res += run_parallel([[nvcc, "-shared", "-o", str(tmp),
                                  *map(str, objs)]])
        log = "".join(out for _, out in res)
        (BUILD_DIR / "nvcc.log").write_text(log)
        if any(rc != 0 for rc, _ in res):
            raise RuntimeError(f"nvcc failed:\n{log}")
        os.replace(tmp, LIB)
    finally:
        for f in objs + [tmp]:
            f.unlink(missing_ok=True)
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
            lib.sqz4_encode_tok_launch.restype = i
            lib.sqz4_encode_tok_launch.argtypes = [p, i, p, i, i, i, i, p, i,
                                                   p, i, i, p]
            lib.sqz4_compact_launch.restype = i
            lib.sqz4_compact_launch.argtypes = [p, i, p, i, p, i, p]
            lib.squeeze_bitpack_launch.restype = i
            lib.squeeze_bitpack_launch.argtypes = [p, i, i, i, p, i, p, i, p]
            lib.sqz4_encode_stats_launch.restype = i
            lib.sqz4_encode_stats_launch.argtypes = [p, p, p, i, i, i, p, i,
                                                     p, i, p]
            lib.probe_launch.restype = i
            lib.probe_launch.argtypes = [i, p, p, p, i, i, p]
            _lib = lib
        return _lib
