#!/usr/bin/env python3
"""Where a CTA of the squeeze bit-packer spends its time, on one CUDA card.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/bitpack_timeline.py

Builds a copy of ``sqz_tpu_torch/csrc/squeeze_bitpack.cu`` into
``build/bitpack_timeline/`` whose kernel stamps the device clock
(``%globaltimer``, ns) at four points of every CTA: its start, after its
tile is loaded and the segment sums meet, before and after its
look-back, and at its end. Launches it once on the exact parse's write
records of 512 blocks of 64 KiB of ``corpus.texty`` and of
``corpus.random_bytes`` (seed 1, window 2^15; the package's tile rows),
checks the outputs against the package kernel's, and prints per input:
the CTAs, the span from the first CTA's start to the last one's end, the
mean CTA time and its phases (ticket and load, pack, look-back, store),
and the most CTAs alive at once.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "bitpack_timeline")
STAMPS = 5

# (old, new): the stamps, in the kernel's text
EDITS = (
    ("template <int kRows>\nstruct PackSmem",
     "__device__ unsigned long long g_stamp[1 << 16][5];\n"
     "__device__ __forceinline__ unsigned long long now() {\n"
     "    unsigned long long t;\n"
     "    asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "    return t;\n}\n\ntemplate <int kRows>\nstruct PackSmem"),
    ("    if (tid == 0) sm.ticket = atomicAdd(ticket, 1u);",
     "    const unsigned long long t0 = now();\n"
     "    if (tid == 0) sm.ticket = atomicAdd(ticket, 1u);"),
    ("    if (!__syncthreads_or(bits != 0)) {",
     "    const int any = __syncthreads_or(bits != 0);\n"
     "    const unsigned long long t1 = now();\n    if (!any) {"),
    ("    look_back(st, lane_step, t, pending, base);",
     "    const unsigned long long t2 = now();\n"
     "    look_back(st, lane_step, t, pending, base);\n"
     "    const unsigned long long t3 = now();"),
    ("\n}\n\ntemplate <int kRows>\nint launch(",
     "\n    __syncthreads();\n"
     "    if (tid == 0 && k < (1 << 16)) {\n"
     "        const unsigned long long s[5] = {t0, t1, t2, t3, now()};\n"
     "        for (int i = 0; i < 5; ++i) g_stamp[k][i] = s[i];\n    }\n"
     "}\n\ntemplate <int kRows>\nint launch("),
)


def build():
    """The stamped kernel library (ctypes)."""
    from sqz_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    for f in os.listdir(_build.CSRC):
        with open(os.path.join(_build.CSRC, f)) as fh:
            text = fh.read()
        if f == "squeeze_bitpack.cu":
            for old, new in EDITS:
                if old not in text:
                    raise ValueError(f"{old!r} not in {f}")
                text = text.replace(old, new)
            text += ('\nextern "C" int get_stamps(void* dst, int bytes) {\n'
                     "    return static_cast<int>(cudaMemcpyFromSymbol(\n"
                     "        dst, squeeze::g_stamp, bytes));\n}\n")
        with open(os.path.join(OUT, f), "w") as fh:
            fh.write(text)
    so = os.path.join(OUT, "lib.so")
    subprocess.run([_build.nvcc_path(), "-gencode", _build.ARCH,
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, os.path.join(OUT, "squeeze_bitpack.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.squeeze_bitpack_launch.argtypes = [p, i, i, i, p, i, p, p, i, p]
    lib.get_stamps.argtypes = [p, i]
    return lib


def records(data):
    """The exact parse's write records of data, one group on the card."""
    import torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.ops import sqz4_host as host, squeeze_cuda
    words, mx = native.squeeze_plan_pack(data, 15, 16, host.LANES,
                                         squeeze_cuda.record_cap(16))
    rows = -(-int(mx) // squeeze_cuda.ROW_CHUNK) * squeeze_cuda.ROW_CHUNK
    return squeeze_cuda.upload_rows(words, rows, torch.device("cuda"))


def timeline(lib, ops):
    """Launch the stamped kernel on the records ops; returns (the stamps
    of the CTAs that packed bits, ns [CTAs, 5], the CTAs launched) after
    checking the outputs against the package kernel's."""
    import numpy as np
    import torch
    from sqz_tpu_torch.ops import sqz4_host as host, squeeze_cuda
    G, T, B = ops.shape
    cw = host.cap_words_for((1 << 16) + 4096)
    tiles = -(-T // squeeze_cuda.TILE_ROWS)
    got = [torch.zeros((G, cw, B), dtype=torch.int32, device=ops.device),
           torch.zeros((G, 8, B), dtype=torch.int32, device=ops.device)]
    scratch = torch.zeros(1 + G * tiles * B, dtype=torch.int64,
                          device=ops.device)
    rc = lib.squeeze_bitpack_launch(
        ops.data_ptr(), G, T, B, got[0].data_ptr(), cw, got[1].data_ptr(),
        scratch.data_ptr(), squeeze_cuda.TILE_ROWS,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    want = squeeze_cuda.bitpack(ops, cw)
    if not all(torch.equal(a, b.view(torch.int32))
               for a, b in zip(got, want)):
        raise AssertionError("the stamped kernel differs from the package's")
    n = G * tiles * -(-B // 32)
    stamps = np.zeros((1 << 16, STAMPS), np.uint64)
    if lib.get_stamps(stamps.ctypes.data, stamps.nbytes):
        raise RuntimeError("reading the stamps failed")
    stamps = stamps[:min(n, 1 << 16)].astype(np.int64)
    return stamps[stamps[:, 0] > 0], n


def main():
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from sqz_tpu_torch.utils import corpus
    if not torch.cuda.is_available():
        print("bitpack_timeline: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    print(torch.cuda.get_device_name(0))
    for mix, data in (("texty", corpus.texty(32 << 20, seed=1)),
                      ("random", corpus.random_bytes(32 << 20, seed=1))):
        ops = records(data)
        timeline(lib, ops)                       # warm
        st, n = timeline(lib, ops)
        rel = (st - st[:, 0].min()) / 1e3        # us
        phases = np.diff(rel, axis=1).mean(0)
        starts, ends = np.sort(rel[:, 0]), np.sort(rel[:, 4])
        alive = np.arange(1, len(starts) + 1) - np.searchsorted(
            ends, starts, side="right")
        print(f"{mix}: {n} CTAs ({len(st)} with bits), span "
              f"{rel[:, 4].max():.2f} us, a CTA "
              f"{(rel[:, 4] - rel[:, 0]).mean():.2f} us = ticket and load "
              f"{phases[0]:.2f} + pack {phases[1]:.2f} + look-back "
              f"{phases[2]:.2f} + store {phases[3]:.2f}; at most "
              f"{int(alive.max())} CTAs alive", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
