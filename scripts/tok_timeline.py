#!/usr/bin/env python3
"""Where the token encoder's lit_skip mode spends its time, on one CUDA
card.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/tok_timeline.py [--base DIR] [--groups 1 2 4]
                                    [--variants NAME=VALUE[,...] ...]

Builds ``sqz_tpu_torch/csrc/sqz4_encode_tok.cu`` twice into
``build/tok_timeline/``: as it is, and with ``-DSQZ_PAIR_CLOCKS``, where
each warp of a block's pair sums ``clock64()`` spans of its phases
(``Clocks``, csrc/sqz4_pair.cuh) and stores them at its end: the coder
warp's wait for a full buffer, its coding (``drain``), its hand-back and
the ops it coded; the producer warp's wait for an empty buffer, the byte
emission, the fill, the hand-over and the last words, and inside the
fill the literal staging, the literal statistics, the match tokens, the
token fetches and the reciprocals, with the literals and match tokens it
expanded. ``--base DIR`` adds the kernel of another checkout (for
example the parent commit, unpacked with ``git archive``; stamped where
its sources have the counters), ``--variants`` this checkout's kernel
built with other macros (``SQZ_GANG``: blocks a gang, ``SQZ_RING_OPS``:
ops a hand-over buffer; comma-separated, a build each).

Each build launches in its own geometry: gangs (a coder lane a block,
csrc/sqz4_pair.cuh), or in a checkout before them pairs (256 threads a
CTA, a coder warp a block).

Inputs: lit_skip's two shapes, one 512-lane group of 64 KiB blocks each:
the resident mix's rle group (``synthetic.resident_mix(seed=1)``, the
cell parse on the card) and the checkpoint's first group (the filtered
stream of GPT-2 small's AdamW state, ``chip_smoke.gpt2_small_state``,
its first 32 MiB, the cell parse), and ``--groups`` of each in one
launch (the resident mix's group repeated, the checkpoint's next
groups). Every build's outputs must equal the package kernel's. Prints,
per input and groups a launch, each build's kernel time (mean of 5
launches by CUDA events, the builds in turns and then in reverse), the
chains a launch and the ms a group; then, from the stamped build, the
coder warp's split (SM cycles: wait, code, hand-back; coded ops; cycles
a coded op) and the producer's, as the mean over lanes and for the lane
with the most coded ops, and for the resident mix by the lane's kind;
then a JSON object of it all.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "tok_timeline")
MAX_LANES = 4 * 512
SLOTS = 16
KINDS = ("weights", "periods", "repeats", "text", "random")
CODER = ("wait", "code", "ops", "hand")
PRODUCER = ("wait", "emit", "fill", "hand", "finish", "", "", "",
            "stage", "lit", "match", "fetch", "recip", "literals",
            "matches", "")

HEAD = r"""
#include <stdint.h>
#define SQZ_PAIR_CLOCKS
__device__ long long g_tok_clock[%d][2][%d];
// a warp's counters: lane 0 stores them at its block's row, the coder's
// and the producer's apart (one warp doing both: the coder's row)
// (a gang of 160 threads: lane b of the coder warp 0 at block b's row,
// producer warp 1 + b's lane 0 at block b's)
__device__ __forceinline__ void sqz_pair_clock_store(int base,
                                                     const long long* t) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    long long n;
    int role;
    if (blockDim.x == 160) {   // the default gang
        if (warp == 0 ? lane >= 4 : lane != 0) return;
        n = static_cast<long long>(blockIdx.x) * 4 + (warp ? warp - 1 : lane);
        role = warp != 0;
    } else {
        if (lane != 0) return;
        const int per = blockDim.x == 32 ? 1 : blockDim.x / 64;
        n = static_cast<long long>(blockIdx.x) * per + warp %% per;
        role = blockDim.x != 32 && warp >= per;
    }
    if (n >= %d) return;
    for (int k = 0; k < 8; ++k) g_tok_clock[n][role][base + k] = t[k];
}
""" % (MAX_LANES, SLOTS, MAX_LANES)

TAIL = r"""
extern "C" int get_clocks(void* dst, long long bytes) {
    return static_cast<int>(cudaMemcpyFromSymbol(dst, g_tok_clock, bytes));
}
extern "C" int clear_clocks() {
    static long long zero[%d][2][%d];
    return static_cast<int>(cudaMemcpyToSymbol(g_tok_clock, zero,
                                               sizeof(zero)));
}
""" % (MAX_LANES, SLOTS)


def sources(name, csrc, stamped):
    """The build's source file in OUT (the stamped one with the counters'
    store and accessors around the kernel)."""
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as fh:
        fh.write((HEAD if stamped else "") + '#include "sqz4_encode_tok.cu"\n'
                 + (TAIL if stamped else ""))
    return path


def build(builds):
    """builds: [(name, csrc dir, -D flags, stamped)] -> {name: ctypes
    library}, one nvcc each, all at once (and the package's kernels)."""
    from sqz_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    cmds, libs = [], {}
    for name, csrc, flags, stamped in builds:
        so = os.path.join(OUT, f"lib{name}.so")
        cmds.append([_build.nvcc_path(), "-gencode", _build.ARCH,
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", f"-I{csrc}", *flags, "-o", so,
                     sources(name, csrc, stamped)])
        libs[name] = (so, stamped)
    for (rc, out), cmd in zip(_build.run_parallel(cmds), cmds):
        if rc:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out}")
        for line in out.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {os.path.basename(cmd[-1])}: {line.strip()}")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (so, stamped) in libs.items():
        lib = ctypes.CDLL(so)
        lib.sqz4_encode_tok_launch.argtypes = [p, i, p, i, i, i, i, p, i, p,
                                               i, i, p]
        lib.stamped = stamped
        csrc, flags = {n: (c, f) for n, c, f, _s in builds}[name]
        gang = next((int(f.split("=")[1]) for f in flags
                     if f.startswith("-DSQZ_GANG=")), 4)
        with open(os.path.join(csrc, "sqz4_pair.cuh")) as fh:
            lib.gang = gang if "kGang" in fh.read() else 0
        # threads a CTA: one gang, or four pairs in a checkout before the
        # gangs
        lib.threads = 32 * (gang + 1) if lib.gang else 256
        if stamped:
            lib.get_clocks.argtypes = [p, ctypes.c_longlong]
        libs[name] = lib
    return libs


def rle_rows(flat, groups):
    """The cell parse of ``groups`` 512-lane groups of 64 KiB blocks of the
    uint8 CUDA tensor ``flat``: (toks [G, 512, Tt] u32, blocks [G, 512,
    bs] u8, pair budget, cap_words), as the rle encode launches them."""
    import torch
    from sqz_tpu_torch.ops import resident
    args = resident.rle_group_args(16)
    blocks, lengths, _nb = resident._prep_blocks(flat, 16, 512, flat.device)
    toks, pairs = resident.rle_plan_device(blocks, lengths, args["Tt"])
    G = groups
    return (toks.reshape(G, 512, -1).contiguous(),
            blocks.reshape(G, 512, -1).contiguous(), int(pairs.max()),
            args["cap_words"])


def inputs(groups):
    """{name: (toks, blocks, t_max, cap_words)} of both shapes at
    ``groups`` groups a launch."""
    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from sqz_tpu_torch.utils import checkpoint, synthetic
    dev = torch.device("cuda")
    mix = torch.frombuffer(bytearray(synthetic.resident_mix(512, 16, seed=1)),
                           dtype=torch.uint8).to(dev)
    state = chip_smoke.gpt2_small_state(dev)
    stream = checkpoint.filtered_stream(state, device=dev)[0]
    del state
    out = {}
    one = rle_rows(mix, 1)
    for g in groups:
        out[f"mix-rle/x{g}"] = (one[0].repeat(g, 1, 1), one[1].repeat(g, 1, 1),
                                one[2], one[3])
        out[f"ckpt/x{g}"] = rle_rows(stream[:g << 25].clone(), g)
    del stream
    torch.cuda.empty_cache()
    return out


def launch(lib, args, threads):
    """One launch of ``lib``'s kernel on ``args`` at ``threads`` a CTA (one
    gang, or four pairs) -> (words, lens)."""
    import torch
    from sqz_tpu_torch.ops import launch as lch
    toks, blocks, t_max, cw = args
    G, B, TT = toks.shape
    words = lch.zeros((G, cw, B), torch.uint32, toks.device)
    lens = lch.zeros((G, 8, B), torch.int32, toks.device)
    rc = lib.sqz4_encode_tok_launch(
        toks.data_ptr(), TT, blocks.data_ptr(), blocks.shape[2], G, B,
        t_max, words.data_ptr(), cw, lens.data_ptr(), threads, 1,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"launch failed: {rc}")
    return words, lens


def mean_ms(fn, n=5):
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


def clocks(lib, args, threads):
    """One stamped launch -> int64 [lanes, 2, SLOTS]: each block's coder
    (row 0) and producer (row 1) counters."""
    import numpy as np
    import torch
    lib.clear_clocks()
    launch(lib, args, threads)
    torch.cuda.synchronize()
    st = np.zeros((MAX_LANES, 2, SLOTS), np.int64)
    if lib.get_clocks(st.ctypes.data, st.nbytes):
        raise RuntimeError("reading the counters failed")
    n = args[0].shape[0] * args[0].shape[1]
    return st[:n]


def split(st, lanes):
    """The coder's and the producer's phases over ``lanes`` (indices into
    st): mean cycles, and the lane with the most coded ops (a gang's
    lanes share their coder warp's spans)."""
    import numpy as np
    sel = st[lanes]
    top = sel[int(np.argmax(sel[:, 0, 2]))]
    out = {}
    for tag, row in (("mean", sel.mean(0)), ("longest", top)):
        c, p = row[0], row[1]
        ops = max(float(c[2]), 1.0)
        out[tag] = {
            "coder": {k: float(c[i]) for i, k in enumerate(CODER)},
            "coder_total": float(c[0] + c[1] + c[3]),
            "code_cycles_per_op": float(c[1]) / ops,
            "busy_cycles_per_op": float(c[0] + c[1] + c[3]) / ops,
            "producer": {k: float(p[i]) for i, k in enumerate(PRODUCER)
                         if k},
            "producer_fill_cycles_per_op": float(p[2]) / ops}
    return out


def show(tag, sp):
    for which in ("mean", "longest"):
        s = sp[which]
        c, p = s["coder"], s["producer"]
        tot = max(s["coder_total"], 1.0)
        print(f"  {tag} {which}: coder {s['coder_total']:.0f} cycles = "
              f"wait {100 * c['wait'] / tot:.1f}% + code "
              f"{100 * c['code'] / tot:.1f}% + hand {100 * c['hand'] / tot:.1f}"
              f"%; {c['ops']:.0f} ops, {s['code_cycles_per_op']:.1f} cycles "
              f"an op coding, {s['busy_cycles_per_op']:.1f} in all; "
              f"producer wait {p['wait']:.0f} emit {p['emit']:.0f} fill "
              f"{p['fill']:.0f} (stage {p['stage']:.0f} lit {p['lit']:.0f} "
              f"match {p['match']:.0f} fetch {p['fetch']:.0f} recip "
              f"{p['recip']:.0f}; {p['literals']:.0f} literals, "
              f"{p['matches']:.0f} matches) hand {p['hand']:.0f} finish "
              f"{p['finish']:.0f}", flush=True)


def main():
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", help="a checkout whose kernel runs beside")
    ap.add_argument("--groups", nargs="*", type=int, default=[1, 2, 4])
    ap.add_argument("--variants", nargs="*", default=[],
                    help="macros of this checkout's kernel (NAME=VALUE, "
                         "comma-separated), a build each")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tok_timeline: no CUDA device", file=sys.stderr)
        return 2
    from sqz_tpu_torch.ops import _build, sqz4_cuda
    csrc = str(_build.CSRC)
    builds = [("this", csrc, [], False), ("this-clocks", csrc, [], True)]
    if args.base:
        bdir = os.path.join(os.path.abspath(args.base), "sqz_tpu_torch",
                            "csrc")
        builds += [("base", bdir, [], False), ("base-clocks", bdir, [], True)]
    for v in args.variants:
        builds.append((v.replace(",", "+"), csrc,
                       [f"-D{f}" for f in v.split(",")], False))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    _build.build()
    libs = build(builds)
    res = {"card": smi.stdout.strip(), "times": {}, "splits": {},
           "occupancy": {}}
    for name, lib in libs.items():
        if lib.gang:
            ctas, smem = ctypes.c_int(), ctypes.c_int()
            if lib.sqz4_encode_tok_occupancy(1, ctypes.byref(ctas),
                                             ctypes.byref(smem)):
                raise RuntimeError(f"{name}: occupancy query failed")
            res["occupancy"][name] = dict(
                gangs_an_sm=ctas.value, chains_an_sm=lib.gang * ctas.value,
                smem_a_cta=smem.value)
            print(f"{name}: {ctas.value} gangs an SM "
                  f"({lib.gang * ctas.value} chains), {smem.value} B of "
                  f"shared memory a gang", flush=True)
    # (label, library, threads a CTA) of every build
    runs = [(n, lib, lib.threads) for n, lib in libs.items()]
    for name, a in inputs(args.groups).items():
        want = sqz4_cuda.encode_tok(a[0], a[1], a[2], a[3], lit_skip=True)
        for label, lib, t in runs:
            got = launch(lib, a, t)
            if not all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(got, want)):
                raise AssertionError(f"{label} differs from the package "
                                     f"kernel on {name}")
        order = [r for r in runs if not r[1].stamped]
        ms = {r[0]: [] for r in order}
        for label, lib, t in order + order[::-1]:
            ms[label].append(mean_ms(lambda: launch(lib, a, t)))
        G = a[0].shape[0]
        for label, _lib, _t in order:
            res["times"][f"{label}/{name}"] = ms[label]
            print(f"{name} {label}: "
                  f"{' / '.join(f'{m:.3f}' for m in ms[label])} ms, "
                  f"{G * 512} chains, {min(ms[label]) / G:.3f} ms a group; "
                  f"t_max {a[2]}", flush=True)
        for label, lib, t in runs:
            if not lib.stamped:
                continue
            st = clocks(lib, a, t)
            if not st.any():
                continue
            lanes = np.arange(st.shape[0])
            sp = {"all": split(st, lanes)}
            show(f"{name} {label}", sp["all"])
            if name.startswith("mix") and G == 1:
                for k, kind in enumerate(KINDS):
                    sp[kind] = split(st, lanes[lanes % 5 == k])
                    show(f"{name} {label} {kind}", sp[kind])
            res["splits"][f"{label}/{name}"] = sp
        del a
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
