#!/usr/bin/env python3
"""Where a CTA of the cell assembly spends its time, on one CUDA card.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/cell_timeline.py [--base DIR] [--variants T,K,N ...]

Builds a copy of ``sqz_tpu_torch/csrc/sqz4_cell.cu`` into
``build/cell_timeline/`` whose kernel stamps the device clock
(``%globaltimer``, ns) at five points of every warp: its start, its
walk's inputs staged, its walk done, the literal cells written (the
rounds of staged chunks, after a barrier for every walk), its end (its
lane's match cells and the far-copy check). ``--base DIR`` adds the same kernel from another
checkout (its sqz4_cell.cu; the first design, one lane a CTA, is
stamped by text edits: start, inputs staged, the one-thread walk done,
the fill of every cell done, end). ``--variants`` adds this checkout's kernel
at other geometries: lanes a CTA, literal cells a chunk, chunk buffers.

Makes one group of the resident restore: the rle container of 512
blocks of 64 KiB of ``synthetic.resident_mix(seed=1)`` (and of its lz
container), compressed and decoded by the package's kernels on the card;
runs every build on the decoder's outputs, checks blocks and bad flags
against the package kernel's, and prints per build and group: the
kernel's time (mean of 20 launches, CUDA events, in turns: each build
once, then in reverse order), the span from the first CTA's start to the
last one's end, the mean time of a CTA's warp 0 split into its phases
(phase 3: the literal cells, the first design's fill; phase 4: the match
cells and the check, nothing in the first design) and, for a build of a
warp a lane, the walk and phase 4 by the kind of the mix's lane (mean
and most).
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "cell_timeline")
STAMPS = 5
MAX_CTAS = 4096

WARPS = 16           # stamps kept a CTA: lane 0 of each warp's

STAMP_HEAD = r"""
#include <stdint.h>
__device__ unsigned long long g_cell_stamp[%d][%d][%d];
__device__ __forceinline__ unsigned long long cell_now() {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
    return t;
}
#define SQZ_CELL_STAMP(i) do { \
    if ((threadIdx.x & 31) == 0 && blockIdx.x < %d \
        && (threadIdx.x >> 5) < %d) \
        g_cell_stamp[blockIdx.x][threadIdx.x >> 5][i] = cell_now(); \
    } while (0)
""" % (MAX_CTAS, WARPS, STAMPS, MAX_CTAS, WARPS)

STAMP_TAIL = r"""
extern "C" int get_stamps(void* dst, int bytes) {
    return static_cast<int>(cudaMemcpyFromSymbol(dst, g_cell_stamp, bytes));
}
extern "C" int clear_stamps() {
    static unsigned long long zero[%d][%d][%d];
    return static_cast<int>(cudaMemcpyToSymbol(g_cell_stamp, zero,
                                               sizeof(zero)));
}
""" % (MAX_CTAS, WARPS, STAMPS)
KINDS = ("weights", "periods", "repeats", "text", "random")

# (old, new): the stamps in the first design's text (one lane a CTA)
FIRST_DESIGN_EDITS = (
    ("    uint8_t* s_nz = s_prev + 2 * kCell;\n",
     "    uint8_t* s_nz = s_prev + 2 * kCell;\n    SQZ_CELL_STAMP(0);\n"),
    ("    cta_sync();\n    bool flag = false;",
     "    cta_sync();\n    SQZ_CELL_STAMP(1);\n    bool flag = false;"),
    ("    cta_sync();\n    for (int c = 0; c < kRing - 1; ++c)",
     "    cta_sync();\n    SQZ_CELL_STAMP(2);\n"
     "    for (int c = 0; c < kRing - 1; ++c)"),
    ("    if (tid == 0) *bad = flag;\n}",
     "    SQZ_CELL_STAMP(3);\n    if (tid == 0) *bad = flag;\n"
     "    SQZ_CELL_STAMP(4);\n}"),
)


def source(csrc, name):
    """The stamped build of csrc/sqz4_cell.cu (a file in OUT)."""
    with open(os.path.join(csrc, "sqz4_cell.cu")) as fh:
        text = fh.read()
    if "SQZ_CELL_STAMP" not in text:        # the first design
        for old, new in FIRST_DESIGN_EDITS:
            if old not in text:
                raise ValueError(f"{old!r} not in {csrc}/sqz4_cell.cu")
            text = text.replace(old, new)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write(STAMP_HEAD + text + STAMP_TAIL)
    return path


def build(builds):
    """builds: [(name, csrc dir, -D flags)] -> {name: ctypes library},
    one nvcc each, all at once."""
    from sqz_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    cmds, libs = [], {}
    for name, csrc, flags in builds:
        so = os.path.join(OUT, f"lib{name}.so")
        cmds.append([_build.nvcc_path(), "-gencode", _build.ARCH,
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", f"-I{csrc}", *flags, "-o", so,
                     source(csrc, name)])
        libs[name] = so
    for (rc, out), cmd in zip(_build.run_parallel(cmds), cmds):
        if rc:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {os.path.basename(cmd[-1])}: {line.strip()}")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        lib.sqz4_cell_launch.argtypes = [p, i, p, i, p, i, p, p, i, i, p, p,
                                         p]
        lib.get_stamps.argtypes = [p, i]
        libs[name] = lib
    return libs


def default_tile(csrc):
    """The lanes a CTA of csrc/sqz4_cell.cu's kernel."""
    with open(os.path.join(csrc, "sqz4_cell.cu")) as fh:
        return int(fh.read().split("#define SQZ_CELL_TILE ")[1].split()[0])


def group(mode):
    """The decoder's outputs of one group of the resident mix's container
    in ``mode`` and the block sizes, on the card."""
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import resident
    from sqz_tpu_torch.utils import synthetic
    data = synthetic.resident_mix(512, 16, seed=1)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda()
    blob = sqz_tpu_torch.compress_resident(x, blk_bits=16, mode=mode)
    _bb, _os, payloads, sizes = resident.unpack_cold_container(blob)
    dargs = resident.decoder_args(16, 512)
    buf, plens, szs, _over = resident.pack_payload_group(
        payloads, sizes, dargs["Pw"], 512)
    dev = torch.device("cuda")
    szs_d = torch.from_numpy(szs).to(dev)
    outs = resident.run_decoder(convert.to_device(buf, dev),
                                torch.from_numpy(plens).to(dev), szs_d,
                                dargs)
    return outs, szs_d


def run(lib, outs, sizes, bs):
    """One launch of a build's kernel -> (blocks, bad)."""
    import torch
    lit, tok, mrec, counts = outs
    B = sizes.shape[0]
    szs = sizes.to(torch.int32)
    blocks = torch.empty((B, bs), dtype=torch.uint8, device=lit.device)
    bad = torch.empty((B,), dtype=torch.bool, device=lit.device)
    rc = lib.sqz4_cell_launch(
        lit.data_ptr(), lit.shape[1], tok.data_ptr(), tok.shape[1],
        mrec.data_ptr(), mrec.shape[1], counts.data_ptr(), szs.data_ptr(),
        B, bs // 128, blocks.data_ptr(), bad.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return blocks, bad


def mean_ms(fn, n=20):
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def stamps(lib, outs, sizes, bs):
    """One stamped launch -> the stamps, ns relative to the first start
    [CTAs, WARPS, 5] (0 for a warp that stamped nothing)."""
    import numpy as np
    import torch
    lib.clear_stamps()
    run(lib, outs, sizes, bs)
    torch.cuda.synchronize()
    st = np.zeros((MAX_CTAS, WARPS, STAMPS), np.uint64)
    if lib.get_stamps(st.ctypes.data, st.nbytes):
        raise RuntimeError("reading the stamps failed")
    st = st[st[:, 0, 0] > 0].astype(np.int64)
    t0 = st[:, 0, 0].min()
    return np.where(st > 0, st - t0, 0)


def main():
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="a checkout whose kernel runs beside")
    ap.add_argument("--variants", nargs="*", default=[],
                    help="geometries T,K,N: lanes a CTA, literal cells a "
                         "chunk, chunk buffers")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_timeline: no CUDA device", file=sys.stderr)
        return 2
    from sqz_tpu_torch.ops import _build, resident
    csrc = str(_build.CSRC)
    builds = [("this", csrc, [])]
    if args.base:
        builds.append(("base", os.path.join(
            os.path.abspath(args.base), "sqz_tpu_torch", "csrc"), []))
    for v in args.variants:
        t, k, n = v.split(",")
        builds.append((f"t{t}k{k}n{n}", csrc, [
            f"-DSQZ_CELL_TILE={t}", f"-DSQZ_CELL_CHUNK={k}",
            f"-DSQZ_CELL_BUFS={n}"]))
    libs = build(builds)
    tiles = {name: (1 if name == "base" else int(
        next((f for f in flags if "TILE" in f), "=%d" % default_tile(csrc))
        .split("=")[1])) for name, _c, flags in builds}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    bs = 1 << 16
    for mode in ("rle", "lz"):
        outs, sizes = group(mode)
        want = resident.assemble_cells(*outs, sizes, bs)
        for name in list(libs):
            try:
                run(libs[name], outs, sizes, bs)
            except RuntimeError as e:      # a geometry the card refuses
                print(f"{name}: {e}")
                del libs[name]
        order = list(libs) + list(libs)[::-1]
        ms = {name: [] for name in libs}
        for name in order:
            got = run(libs[name], outs, sizes, bs)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{name} differs from the package "
                                     f"kernel on the {mode} group")
            ms[name].append(mean_ms(lambda: run(libs[name], outs, sizes,
                                                bs)))
        for name, lib in libs.items():
            st = stamps(lib, outs, sizes, bs) / 1e3       # us
            w0 = st[:, 0]                                  # warp 0's
            ph = (w0[:, 1:] - w0[:, :-1]).mean(0)
            print(f"{mode} {name}: kernel "
                  f"{' / '.join(f'{m:.4f}' for m in ms[name])} ms, "
                  f"{len(st)} CTAs, span {st[:, :, 4].max():.2f} us, a CTA "
                  f"(warp 0) {(w0[:, 4] - w0[:, 0]).mean():.2f} us = "
                  f"staging {ph[0]:.2f} + walk {ph[1]:.2f} + phase 3 "
                  f"{ph[2]:.2f} + phase 4 {ph[3]:.2f}; bad lanes "
                  f"{int(want[1].sum())}", flush=True)
            tile = tiles[name]
            if tile > 1:      # a warp a lane: the phases by the lane's kind
                parts = []
                for k, kind in enumerate(KINDS):
                    sel = [(cta, w) for cta in range(len(st))
                           for w in range(tile) if (cta * tile + w) % 5 == k
                           and st[cta, w, 4] > 0]
                    walk = [st[c, w, 2] - st[c, w, 1] for c, w in sel]
                    last = [st[c, w, 4] - st[c, w, 3] for c, w in sel]
                    parts.append(f"{kind} walk {np.mean(walk):.1f}/"
                                 f"{np.max(walk):.1f} phase 4 "
                                 f"{np.mean(last):.1f}/{np.max(last):.1f}")
                print(f"  by lane (mean/max us): " + "; ".join(parts),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
