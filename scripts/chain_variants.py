#!/usr/bin/env python3
"""Time variants of the coders' kernels (the token, op-stream and
stats-fed encoders, the decoder) on one CUDA card, to see what their
serial chains wait on, and the squeeze bit-packer's and the payload
compaction's tile sizes.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/chain_variants.py            # every variant
    python3 scripts/chain_variants.py dec dec-nostore
    python3 scripts/chain_variants.py --base DIR tok dec

``--base DIR`` also builds each named variant from the sources of the
checkout at DIR (for example the parent commit, unpacked with ``git
archive``) and times it beside this checkout's as ``base:<name>``, in
turns (base, this, this, base): for kernels whose launcher has the same
signature and launch geometry there (the token encoder's gangs, 160
threads a CTA, since PR 14; the decoder's
in checkouts whose launcher takes the seed column, as this one's does;
and variants whose substitutions name files that checkout has), and for
the bit-packer and the compaction, whose first designs (one thread a
lane, 32 a CTA; one CTA a lane, 256 threads) are launched with their own
arguments. Every variant runs cold (a null seed).

A variant is a kernel source from ``sqz_tpu_torch/csrc`` with a few text
substitutions in it or its headers (some drop work the kernel must do, so
their outputs differ: they are timing probes), compiled alone with nvcc into
``build/chain_variants/<name>/`` and launched through its C entry point on
one group of 512 blocks of 64 KiB of ``corpus.texty``, of
``corpus.random_bytes`` (seed 1, window 2^15) and of the two with runs
and zeros in turn (``mixed``), the shapes chip_smoke.py times: the exact
parse's op streams, the fast parse's tokens, the payloads; the stats-fed
encoder on the statistics of the first 512
blocks of 16 KiB; the bit-packer on the squeeze exact parse's write
records (``native.squeeze_plan_pack``); the compaction on the token
encoder's output. Prints one line per variant, input and turn: ``ms``,
the best of three calls that zero the outputs and launch (the wrapper's
work), and ``kernel_ms``, the mean of 20 launches alone (events around
each launch, after its zeroing; the compaction, which overwrites its
whole output, as 20 launches back to back, as chip_smoke.py times it),
by CUDA events, with whether the outputs equal the package kernel's;
then a JSON object of them all.
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
ENC, STATS = "sqz4_encode.cu", "sqz4_encode_stats.cu"
PACK, COMPACT = "squeeze_bitpack.cu", "sqz4_compact.cu"
# the first designs' geometry (threads a CTA), for a base checkout whose
# launcher takes it in place of the tile rows
FIRST_THREADS = {PACK: 32, COMPACT: 256}
CHAIN, PAIR = "sqz4_chain.cuh", "sqz4_pair.cuh"
STATS_BITS = 14
# the coder warp codes no op and records no byte: the producers alone
NOCODE = (PAIR, "c.code(total, start, size, m, r.pre + i, r.cnt + i);",
          "r.cnt[i] = 0;")
# threads a CTA of the token encoder: one gang (csrc/sqz4_pair.cuh)
GANG = 160

# name: (source, threads a CTA (the bit-packer and the compaction: rows
#        a tile), blocks of the group launched, [(file, old, new)])
VARIANTS = {
    # the squeeze bit-packer: 32 lanes x 256 or 128 record rows a CTA
    "pack": (PACK, 256, 512, []),
    "pack@128": (PACK, 128, 512, []),
    # no packing (the words stay zero)
    "pack-nopack": (PACK, 256, 512, [(PACK, """    if (bits) pack_segment(rec, off, sm.words + l * Smem::kWords);
""", "")]),
    # no look-back (every tile at offset 0)
    "pack-nolook": (PACK, 256, 512, [(PACK,
                                      "look_back(st, lane_step, t, pending,"
                                      " base);", "")]),
    # no word stores
    "pack-nostore": (PACK, 256, 512, [(PACK,
                                       "    if (k >= n || w0 + k >= cap_words) "
                                       "return;", "    return;")]),
    # the words stored lane by lane: a store of a warp touches 32 rows
    "pack-lanes": (PACK, 256, 512, [(PACK, """    for (uint32_t r = rmin + warp; r <= rmax; r += kPackWarps)
        store_tile_word(sm.words + l * Smem::kWords, base_l, bits_l,
                        r - first, out, lanes,""", """    for (int c = warp; c < kLanes; c += kPackWarps)
    for (uint32_t k = l; k <= Smem::kWords; k += 32)
        store_tile_word(sm.words + c * Smem::kWords, sm.base[c], sm.bits[c],
                        k, out - l + c, lanes,""")]),
    # the compaction: 32 lanes x 128 or 64 rows a tile
    "compact": (COMPACT, 128, 512, []),
    "compact@64": (COMPACT, 64, 512, []),
    # the token encoder's gangs (four blocks a coder warp)
    "tok": (TOK, GANG, 512, []),
    # half the blocks: one gang on 64 of the SMs
    "tok-half": (TOK, GANG, 256, []),
    # the producer warps alone: the coder codes no op and records no byte
    "tok-nocode": (TOK, GANG, 512, [NOCODE]),
    # the producer turns no record into bytes
    "tok-noemit": (TOK, GANG, 512, [
        (PAIR, "e.put(r.pre, r.cnt, r.n + r.flushes);", "")]),
    # the coder's quotient by `/` (the software u64 divide)
    "tok-udiv": (TOK, GANG, 512, [
        (CHAIN, "const u64 qe = mulhi64(rng, m);",
         "const u64 qe = rng / total;")]),
    # the settled bytes by compares instead of a leading-zero count
    "tok-cmp": (TOK, GANG, 512, [
        (CHAIN, "const int c = lead_zero_bytes(lo ^ (lo + rg));", """int c = 0;
        SQZ_UNROLL()
        for (int k = 1; k < 8; ++k)
            c += (lo ^ (lo + rg)) < (1ull << (64 - 8 * k));""")]),
    # the op-stream encoder: four pairs of warps a CTA, one, one warp
    "enc@256": (ENC, 256, 512, []),
    "enc@64": (ENC, 64, 512, []),
    "enc@32": (ENC, 32, 512, []),
    "enc@256-nocode": (ENC, 256, 512, [NOCODE]),
    # the stats-fed encoder
    "stats@256": (STATS, 256, 512, []),
    "stats@32": (STATS, 32, 512, []),
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


def build(name, base=None):
    """Compile variant ``name`` from this checkout's sources, or from the
    checkout at ``base`` (then named ``base:<name>``)."""
    src, _, _, subs = VARIANTS[name]
    csrc = CSRC if base is None else os.path.join(base, "sqz_tpu_torch",
                                                  "csrc")
    name = name if base is None else f"base:{name}"
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    missing = {w for w, _, _ in subs} - set(os.listdir(csrc))
    if missing:
        raise ValueError(f"{name}: no {sorted(missing)} in {csrc}")
    with open(os.path.join(csrc, src)) as fh:
        tiled = "tile_rows" in fh.read()
    for f in os.listdir(csrc):
        with open(os.path.join(csrc, f)) as fh:
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
    elif src == ENC:
        lib.sqz4_encode_launch.argtypes = [p, p, i, i, i, p, i, p, p, i,
                                           i, p]
    elif src == STATS:
        lib.sqz4_encode_stats_launch.argtypes = [p, p, p, i, i, i, p, i, p,
                                                 i, p]
    elif src == PACK:
        lib.squeeze_bitpack_launch.argtypes = (
            [p, i, i, i, p, i, p, p, i, p] if tiled
            else [p, i, i, i, p, i, p, i, p])
    elif src == COMPACT:
        lib.sqz4_compact_launch.argtypes = [p, i, p, i, p, i, p]
    else:
        lib.sqz4_decode_launch.argtypes = [p, p, i, i, i, i, p, i, p, i, p,
                                           i, p, p, i, p]
    lib.tiled = tiled
    return name, lib


def launcher(src, lib, inputs, threads, k, stream):
    """(zero, launch, got, want): a function that zeroes the outputs
    ``got``, one that launches the variant on the first k blocks of
    ``inputs`` (returns the launch's error code), and the package kernel's
    outputs there."""
    import torch
    if src == TOK:
        toks, lits, t_max, cw, want = inputs
        args = (toks[:, :k].contiguous(), lits[:, :k].contiguous())
    elif src == COMPACT:
        words, offsets, want = inputs
        want = [want]
    else:
        args = tuple(x[..., :k].contiguous() for x in inputs[0])
        want = inputs[-1]
    if src != COMPACT:
        want = [x[..., :k].contiguous() for x in want]
    got = [torch.zeros_like(x) for x in want]
    if src == PACK:   # the ticket and the status words (tiles >= 128 rows)
        G, T, B = args[0].shape
        got.append(torch.zeros(1 + G * -(-T // 128) * B, dtype=torch.int64,
                               device=args[0].device))
    geometry = threads if lib.tiled else FIRST_THREADS.get(src, threads)

    def zero():
        for x in got:
            x.zero_()

    def launch():
        if src == PACK:
            G, T, B = args[0].shape
            extra = (got[2].data_ptr(),) if lib.tiled else ()
            return lib.squeeze_bitpack_launch(
                args[0].data_ptr(), G, T, B, got[0].data_ptr(), inputs[1],
                got[1].data_ptr(), *extra, geometry, stream)
        if src == COMPACT:
            return lib.sqz4_compact_launch(
                words.data_ptr(), words.shape[2], offsets.data_ptr(),
                offsets.numel() - 1, got[0].data_ptr(), geometry, stream)
        if src == TOK:
            return lib.sqz4_encode_tok_launch(
                args[0].data_ptr(), args[0].shape[2], args[1].data_ptr(),
                args[1].shape[2], 1, k, t_max, got[0].data_ptr(), cw,
                got[1].data_ptr(), threads, 0, stream)
        if src == ENC:
            return lib.sqz4_encode_launch(
                args[0].data_ptr(), args[1].data_ptr(), 1, args[0].shape[1],
                k, got[0].data_ptr(), inputs[1], got[1].data_ptr(), None, -1,
                threads, stream)
        if src == STATS:
            return lib.sqz4_encode_stats_launch(
                *(a.data_ptr() for a in args), 1, args[0].shape[1], k,
                got[0].data_ptr(), inputs[1], got[1].data_ptr(), threads,
                stream)
        pw, steps, dims = inputs[1]
        return lib.sqz4_decode_launch(
            args[0].data_ptr(), args[1].data_ptr(), 1, pw, k, steps,
            got[0].data_ptr(), dims[0], got[1].data_ptr(), dims[1],
            got[2].data_ptr(), dims[2], got[3].data_ptr(), None, threads,
            stream)
    return zero, launch, got[:len(want)], want


def kernel_inputs(src, data):
    """The package kernel's inputs and outputs for one group of ``data``
    (see ``launcher``)."""
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    dev = torch.device("cuda")
    bs = 1 << 16
    nb = len(data) // bs
    cw = host.cap_words_for(bs + 2048)
    if src == TOK:
        grp = sqz4_cuda.plan_tok_group(data, 16, 1 << 15, True)
        toks = grp.toks.to(dev).view(torch.uint32)
        lits = grp.lits.to(dev)
        return (toks, lits, grp.t_max, cw,
                sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw))
    if src == ENC:
        mw, sw, mx = native.sqz4_plan_pack(data, 1 << 15, 16, True, nb,
                                           host.op_stream_cap(16))
        m, s = convert.encoder_inputs(mw, sw, -(-int(mx) // 4), dev)
        return (m, s), cw, sqz4_cuda.encode_full(m, s, cw)
    if src == PACK:
        from sqz_tpu_torch.ops import squeeze_cuda
        words, mx = native.squeeze_plan_pack(data, 15, 16, nb,
                                             squeeze_cuda.record_cap(16))
        rows = -(-int(mx) // squeeze_cuda.ROW_CHUNK) * squeeze_cuda.ROW_CHUNK
        ops = squeeze_cuda.upload_rows(words, rows, dev)
        pcw = host.cap_words_for(bs + 4096)
        return (ops,), pcw, squeeze_cuda.bitpack(ops, pcw)
    if src == COMPACT:
        from sqz_tpu_torch.ops import sqz4_ref
        grp = sqz4_cuda.plan_tok_group(data, 16, 1 << 15, True)
        words, lens = sqz4_cuda.encode_tok(
            grp.toks.to(dev).view(torch.uint32), grp.lits.to(dev),
            grp.t_max, cw)
        n = len(grp.fit)
        return (words, sqz4_ref.compact_offsets(lens, n, words.shape[1]),
                sqz4_cuda.compact_words(words, lens, n))
    if src == STATS:
        part = data[:host.LANES << STATS_BITS]
        st = host.op_stream_stats(part, 1 << 15, STATS_BITS)
        packed = sqz4_cuda.pack_group_stats(st, dev)
        scw = host.cap_words_for((1 << STATS_BITS) + 2048)
        return packed, scw, sqz4_cuda.encode_stats(*packed, scw)
    payloads = native.blocks_compress(data, 1, 15, 16)
    plan = host.plan_decode_dispatch(nb, 16, lanes=nb)
    pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
    buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, nb, plan["G"],
                                       pw)
    pt, mt = convert.decoder_inputs(buf, meta, dev)
    dims = (plan["lw"], plan["tw"], plan["mw"])
    return ((pt, mt), (pw, plan["t_max"], dims),
            sqz4_cuda.decode(pt, mt, plan["t_max"], *dims))


def mixed_blocks(corpus):
    """512 blocks of 64 KiB: pseudo-text, runs, zeros and random bytes in
    turn, so that the lanes' payloads differ in length by orders of
    magnitude."""
    bs = 1 << 16
    return b"".join(
        (corpus.texty(bs, seed=b), corpus.rle4(bs), corpus.zeros(bs),
         corpus.random_bytes(bs, seed=b))[b % 4] for b in range(512))


def main(argv):
    import torch
    sys.path.insert(0, ROOT)
    from sqz_tpu_torch.utils import corpus
    if not torch.cuda.is_available():
        print("chain_variants: no CUDA device", file=sys.stderr)
        return 2
    base = None
    if argv[:1] == ["--base"]:
        base, argv = os.path.abspath(argv[1]), argv[2:]
    names = argv or list(VARIANTS)
    jobs = [(n, None) for n in names] + [(n, base) for n in names if base]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(lambda job: build(*job), jobs))
    # in turns with the base: base, this, this, base
    order = [m for n in names
             for m in ((f"base:{n}", n, n, f"base:{n}") if base else (n,))]
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for mix, data in (("texty", corpus.texty(32 << 20, seed=1)),
                      ("random", corpus.random_bytes(32 << 20, seed=1)),
                      ("mixed", mixed_blocks(corpus))):
        inputs = {src: kernel_inputs(src, data)
                  for src in {VARIANTS[n][0] for n in names}}
        for name in order:
            src, threads, k, _ = VARIANTS[name.removeprefix("base:")]
            zero, launch, got, want = launcher(src, libs[name], inputs[src],
                                               threads, k, stream)
            zero()
            if launch():
                raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want))
            best = None
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                zero()
                launch()
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                best = ms if best is None else min(best, ms)
            kernel = 0.0
            for _ in range(1 if src == COMPACT else 20):
                zero()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20 if src == COMPACT else 1):
                    launch()
                b.record()
                b.synchronize()
                kernel += a.elapsed_time(b) / 20
            r = res.setdefault(f"{name}/{mix}", {"ms": [], "kernel_ms": [],
                                                 "equal": True})
            r["ms"].append(best)
            r["kernel_ms"].append(kernel)
            r["equal"] &= equal
            print(f"{name} {mix} {best:.4f} ms, kernel {kernel:.4f} ms "
                  f"{'equal' if equal else 'differs'}", flush=True)
        del inputs
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
