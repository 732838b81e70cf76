#!/usr/bin/env python3
"""Time variants of the token encoder's and the decoder's kernels on one
CUDA card, to see what their serial chains wait on.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/chain_variants.py            # every variant
    python3 scripts/chain_variants.py dec dec-nostore

A variant is a kernel source from ``sqz_tpu_torch/csrc`` with a few text
substitutions in it or its headers (some drop work the kernel must do, so
their outputs differ: they are timing probes), compiled alone with nvcc into
``build/chain_variants/<name>/`` and launched through its C entry point on
one group of 512 blocks of 64 KiB of ``corpus.texty`` and of
``corpus.random_bytes`` (seed 1, window 2^15), the shapes chip_smoke.py
times. Prints one line per variant and input (best of three launches by
CUDA events, and whether the outputs equal the package kernel's), then a
JSON object of them all.
"""

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "sqz_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "chain_variants")
TOK, DEC = "sqz4_encode_tok.cu", "sqz4_decode.cu"
CHAIN = "sqz4_chain.cuh"

# name: (source, threads a CTA, blocks of the group launched,
#        [(file, old, new)])
VARIANTS = {
    "tok@256": (TOK, 256, 512, []),
    "tok@64": (TOK, 64, 512, []),
    "tok@32": (TOK, 32, 512, []),
    # half the blocks: one coder warp a scheduler at 64 threads a CTA
    "tok@64-half": (TOK, 64, 256, []),
    # the producer warps alone: the coder codes no op and records no byte
    "tok@256-nocode": (TOK, 256, 512, [
        (TOK, "c.code(total, start, size, m, r.pre + i, r.cnt + i);",
         "r.cnt[i] = 0;")]),
    # the producer turns no record into bytes
    "tok@256-noemit": (TOK, 256, 512, [
        (TOK, "e.put(r.pre, r.cnt, r.n + r.flushes);", "")]),
    # the coder's quotient by `/` (the software u64 divide)
    "tok@256-udiv": (TOK, 256, 512, [
        (CHAIN, "const u64 qe = mulhi64(rng, m);",
         "const u64 qe = rng / total;")]),
    # the settled bytes by compares instead of a leading-zero count
    "tok@256-cmp": (TOK, 256, 512, [
        (CHAIN, "const int c = lead_zero_bytes(lo ^ (lo + rg));", """int c = 0;
        SQZ_UNROLL()
        for (int k = 1; k < 8; ++k)
            c += (lo ^ (lo + rg)) < (1ull << (64 - 8 * k));""")]),
    "dec": (DEC, 32, 512, []),
    "dec-half": (DEC, 32, 256, []),
    # no record stores (the chain is the same)
    "dec-nostore": (DEC, 32, 512, [(DEC, "const bool st = lane_id() == 0;",
                                    "const bool st = false;")]),
    # no underflow escape (the rare branch and its test)
    "dec-noescape": (DEC, 32, 512, [(DEC, """        if (rng < tot) {   // rare: re-inflate the range
            code = (code << 16) | src.take(2);
            low <<= 16;
            rng = ~low;
        }
""", "")]),
    # the quotient rng / tot by `/` (the software u64 divide)
    "dec-udiv": (DEC, 32, 512, [(DEC, "return mulhi64(rng, m);",
                                 "return rng / tot;")]),
    # a model's next reciprocal computed at its update, not read from the
    # window of 32
    "dec-rcp-each": (DEC, 32, 512, [(DEC, """    if ((tot & 31) == 0) rcp_fill(sm, slot, tot);
    return sm->rcp[slot][tot & 31];""", "    return recip64(tot);")]),
}


def build(name):
    src, _, _, subs = VARIANTS[name]
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(CSRC):
        with open(os.path.join(CSRC, f)) as fh:
            text = fh.read()
        for where, old, new in subs:
            if where != f:
                continue
            if old not in text:
                raise ValueError(f"{name}: {old!r} not in {f}")
            text = text.replace(old, new)
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    so = os.path.join(d, "lib.so")
    from sqz_tpu_torch.ops import _build
    subprocess.run([_build.nvcc_path(), "-gencode", _build.ARCH,
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", so, os.path.join(d, src)], check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    if src == TOK:
        lib.sqz4_encode_tok_launch.argtypes = [p, i, p, i, i, i, i, p, i,
                                               p, i, i, p]
    else:
        lib.sqz4_decode_launch.argtypes = [p, p, i, i, i, i, p, i, p, i, p,
                                           i, p, i, p]
    return name, lib


def main(names):
    import torch
    sys.path.insert(0, ROOT)
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    from sqz_tpu_torch.utils import corpus
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 2
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(build, names))
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    bs = 1 << 16
    cw = host.cap_words_for(bs + 2048)
    res = {}
    for mix, data in (("texty", corpus.texty(32 << 20, seed=1)),
                      ("random", corpus.random_bytes(32 << 20, seed=1))):
        nb = len(data) // bs
        payloads = native.blocks_compress(data, 1, 15, 16)
        plan = host.plan_decode_dispatch(nb, 16, lanes=nb)
        pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
        buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, nb,
                                           plan["G"], pw)
        pt, mt = convert.decoder_inputs(buf, meta, dev)
        dims = (plan["lw"], plan["tw"], plan["mw"])
        dwant = sqz4_cuda.decode(pt, mt, plan["t_max"], *dims)
        grp = sqz4_cuda.plan_tok_group(data, 16, 1 << 15, True)
        toks = grp.toks.to(dev).view(torch.uint32)
        lits = grp.lits.to(dev)
        twant = sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw)
        for name in names:
            src, threads, k, _ = VARIANTS[name]
            lib = libs[name]
            if src == TOK:
                tk, lk = toks[:, :k].contiguous(), lits[:, :k].contiguous()
                want = [x[..., :k].contiguous() for x in twant]
                got = [torch.zeros_like(x) for x in want]

                def run():
                    for x in got:
                        x.zero_()
                    return lib.sqz4_encode_tok_launch(
                        tk.data_ptr(), tk.shape[2], lk.data_ptr(),
                        lk.shape[2], 1, k, grp.t_max, got[0].data_ptr(), cw,
                        got[1].data_ptr(), threads, 0, stream)
            else:
                pk, mk = pt[..., :k].contiguous(), mt[..., :k].contiguous()
                want = [x[..., :k].contiguous() for x in dwant]
                got = [torch.zeros_like(x) for x in want]

                def run():
                    for x in got:
                        x.zero_()
                    return lib.sqz4_decode_launch(
                        pk.data_ptr(), mk.data_ptr(), 1, pw, k,
                        plan["t_max"], got[0].data_ptr(), dims[0],
                        got[1].data_ptr(), dims[1], got[2].data_ptr(),
                        dims[2], got[3].data_ptr(), threads, stream)
            if run():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want))
            best = None
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run()
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                best = ms if best is None else min(best, ms)
            res[f"{name}/{mix}"] = {"ms": best, "equal": equal}
            print(f"{name} {mix} {best:.3f} ms "
                  f"{'equal' if equal else 'differs'}", flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
