#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, card, nvcc, power limit;
  2. build: the native host runtime (g++) and the CUDA kernels (one nvcc
     per source), all at once, from the sources in the checkout;
  3. each kernel on the card against its plain PyTorch version on the
     same inputs (the coders' plain versions on CPU copies of them, each
     in a worker process, side by side), first at 64 blocks of 1 KiB (a
     quick gate), then at the
     main paths' shapes (512 blocks of 64 KiB, one group; the stats-fed
     encoder at 512 blocks of 16 KiB, the largest blocks whose model
     totals stay below its 2^15 limit; the probes at their fixed inputs):
     outputs must be equal (tolerance 0, a lossless integer codec), and
     the payloads equal the native engine's;
  4. the serial main path: 32 MiB of pseudo-text in 64 KiB blocks (one
     group), compressed and decompressed through ``sqz_tpu_torch.compress``
     / ``decompress``. The exact-parse container must equal the native
     engine's byte for byte; both parses must round-trip, and the native
     engine must decode the fast-parse container. The op-stream encoder's
     and the decoder's launch counts over this run must be > 0;
  5. the pipelined main path: 128 MiB (4 groups) through ``compress`` /
     ``decompress`` with their defaults (fast parse, planner thread, token
     kernel, compaction kernel). The container must equal the serial
     path's (SQZ_PIPELINE=0), round-trip, and decode on the native engine;
     the token kernel's and the compaction kernel's launch counts over
     this run must be > 0. The pipeline (compact and trim fetch) and the
     serial path are then timed in turns, and profiled once each for the
     card's busy time; the pipeline's stage times are printed;
  6. the squeeze main path: the 32 MiB input through ``compress(fmt=
     "squeeze")`` / ``decompress``, cold exact, warm exact (sqzt v2) and
     cold fast. The exact containers, cold and warm, must equal the native
     engine's byte for byte; every container must round-trip, and the
     native engine must decode the fast one. The bit-packer's launch
     count over this run must be > 0. One run's stages are printed, and
     one default ``compress`` is profiled for the card's idle share;
  7. the stats-fed encoder's main path, ``sqz4_cuda.encode_groups`` on the
     statistics of 512 blocks of 16 KiB (payloads equal the native
     engine's), and the probes' main path, ``probe.run_probes`` (every
     probe equals its expected value), each with its launch count > 0;
  8. a corrupt payload byte must be rejected, naming its block.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_BLOCKS, SMALL_BITS = 64, 10
MAIN_BYTES, MAIN_BITS, MAIN_WIN_BITS = 32 << 20, 16, 15
PIPE_BYTES = 128 << 20
CORRUPT_BLOCK = 100
REPS = 3
PALLAS = "sqz_tpu/ops/sqz4_pallas.py"
PLAIN_WORKERS = 5   # one per coder's plain version checked at a shape
STATS_BITS = 14   # the stats-fed encoder's full-size blocks (16 KiB)

# Roofs of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# CUDA cores' rate (the fp32 rate outside the tensor cores; the coders'
# integer operations issue at no more than it).
HBM_BPS = 3.35e12
CORE_OPS = 67e12
# Integer operations of one coded symbol: a 64-bit divide, two
# multiplies, adds, xor, clz, shifts and a compare in the coder, and the
# model lookup and update (Fenwick tree) around it.
OPS_PER_SYMBOL = 20
# Integer operations of one statistic coded by the stats-fed encoder: the
# divide, two multiplies, add, xor, clz, shifts and a compare, with no
# model work.
OPS_PER_STAT = 12
# Integer operations of one bit-packer record: decode the count and the
# value, the shift of the value into the 64-bit accumulator, the OR, the
# spill test.
OPS_PER_RECORD = 10


def log(*a):
    print(*a, flush=True)


def events_ms(fn, reps):
    """Best device time of ``reps`` calls of fn, by CUDA events."""
    import torch
    best = None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        best = ms if best is None else min(best, ms)
    return best


def mean_events_ms(fn, n):
    """Mean device time of ``n`` back-to-back calls of fn (after one warm
    call), by CUDA events: for kernels too short to time one launch."""
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


def bound(nbytes, nops):
    """(bound ms, what bounds it): the larger of bytes over HBM bandwidth
    and operations over the cores' rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, nops / CORE_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(xs, ys):
    import torch
    return max(int((x.view(torch.int32).to(torch.int64)
                    - y.view(torch.int32).to(torch.int64)).abs().max())
               if x.numel() else 0
               for x, y in zip(xs, ys))


def environment():
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} count "
        f"{torch.cuda.device_count()}")
    from sqz_tpu_torch.ops import _build
    nv = subprocess.run([_build.nvcc_path(), "--version"],
                        capture_output=True, text=True, check=True)
    log("nvcc:", nv.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def build():
    """The native runtime and the CUDA kernels, built at once."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.ops import _build
    t = time.perf_counter()
    errors = []

    def run(fn):
        try:
            fn(force=True)
        except BaseException as e:           # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (native.build, _build.build)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    native.library()
    _build.library()
    log(f"build: native and cuda {time.perf_counter() - t:.1f} s")
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            log("ptxas:", line.strip())


def plain_in_worker(plain, args):
    """In a worker process: plain(*args) on CPU tensors made from the numpy
    arrays among args, one intra-op thread. Returns (numpy outputs, ms)."""
    import numpy as np
    import torch
    from sqz_tpu_torch import convert
    torch.set_num_threads(1)
    args = [convert.to_device(a, "cpu") if isinstance(a, np.ndarray) else a
            for a in args]
    t = time.perf_counter()
    out = plain(*args)
    ms = (time.perf_counter() - t) * 1e3
    return [convert.to_numpy(x) for x in out], ms


class PlainCheck:
    """A kernel held against its plain PyTorch version on the same inputs.
    The plain version runs on CPU copies of them in a worker process of
    ``pool`` (the long checks then run side by side), while the kernel
    runs here on the card; ``got`` holds the kernel's outputs."""

    def __init__(self, pool, kernel, plain, args, reps):
        import torch
        from sqz_tpu_torch import convert
        self.future = pool.submit(plain_in_worker, plain, [
            convert.to_numpy(a) if isinstance(a, torch.Tensor) else a
            for a in args])
        self.got = kernel(*args)
        torch.cuda.synchronize()
        self.ms = events_ms(lambda: kernel(*args), reps)

    def result(self):
        """(max_abs_err, kernel ms, plain ms); raises if the outputs
        differ."""
        import numpy as np
        import torch
        wants, plain_ms = self.future.result()
        err = max_abs_err(
            [g.cpu() for g in self.got],
            [torch.from_numpy(w.view(np.int32) if w.dtype == np.uint32
                              else w) for w in wants])
        if err:
            raise AssertionError(f"kernel differs from its plain version "
                                 f"(max_abs_err {err})")
        return err, self.ms, plain_ms


def coded_symbols(m_words):
    """Coded symbols of op streams (numpy u32 words of four u8 ops): ops
    below 36 and flushes; pads code nothing."""
    import numpy as np
    ops = m_words.astype(">u4").view(np.uint8)
    return int(((ops < 36) | (ops == 254)).sum())


def tok_symbols(grp):
    """Coded symbols of a token group: 2 a literal, 2 + nbits a match
    (flag, size, bits, nbits - 1 distance bits), 10 for the EOS token."""
    import numpy as np
    t = grp.toks.numpy().view(np.uint32).astype(np.int64)
    live = t != 0
    match = live & ((t >> 8) & 1 == 1)
    eos = match & ((t & 0xFF) == 255)
    lit = live & ~match
    return int((2 * (t & 0xFF) * lit).sum()
               + (2 + ((t >> 9) & 0x1F))[match & ~eos].sum()
               + 10 * eos.sum())


def kernels_vs_plain(data, blk_bits, win_bits, lanes, reps, stats_bits,
                     pool):
    """Each kernel on the card against its plain PyTorch version on the
    same inputs (the coders' in worker processes of ``pool``, see
    PlainCheck), at the shapes the main paths give them for ``data`` (one
    group; the stats-fed encoder on its first ``lanes`` blocks of
    2^stats_bits bytes): equal outputs (tolerance 0), the payloads equal
    the native engine's, the blocks restore. Returns per kernel
    (max_abs_err, kernel ms, plain ms, bound ms, bound_by, library ms or
    None)."""
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import _build, sqz4_cuda, sqz4_host as host
    from sqz_tpu_torch.ops import sqz4_ref
    dev = torch.device("cuda")
    bs = 1 << blk_bits
    nb = len(data) // bs
    cw = host.cap_words_for(bs + 2048)
    checks = {}   # kernel -> (PlainCheck, bound and library entries)

    # op-stream encoder, exact parse
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << win_bits, blk_bits, True,
                                       lanes, host.op_stream_cap(blk_bits))
    rows = -(-int(mx) // 4)
    m, s = convert.encoder_inputs(mw, sw, rows, dev)
    enc = PlainCheck(pool, sqz4_cuda.encode_full, sqz4_ref.encode_full_ref,
                     (m, s, cw), reps)
    words, lens = (convert.to_numpy(x) for x in enc.got)
    payloads = host.unpack_group_payloads(words, lens, nb)
    if payloads != native.blocks_compress(data, 1, win_bits, blk_bits):
        raise AssertionError("encoder payloads differ from native")
    symbols = coded_symbols(mw[:, :rows])
    pay_bytes = int(lens[:, 0].sum())
    checks["sqz4_encode"] = enc, bound(
        2 * m.numel() * 4 + pay_bytes + lens.nbytes,
        symbols * OPS_PER_SYMBOL) + (None,)

    # decoder
    plan = host.plan_decode_dispatch(nb, blk_bits, lanes=lanes)
    pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
    buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, lanes,
                                       plan["G"], pw)
    pt, mt = convert.decoder_inputs(buf, meta, dev)
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    dec = PlainCheck(pool, sqz4_cuda.decode, sqz4_ref.decode_ref,
                     (pt, mt) + args, reps)
    outs = host.postprocess_decode(*[convert.to_numpy(x) for x in dec.got],
                                   payloads, [bs] * nb, bs)
    if b"".join(outs) != data:
        raise AssertionError("decoder kernel did not restore the blocks")
    cnt = convert.to_numpy(dec.got[3])
    out_bytes = int(cnt[:, 1].sum() + (cnt[:, 2].sum() + 7) // 8
                    + 4 * cnt[:, 3].sum()) + cnt.nbytes
    checks["sqz4_decode"] = dec, bound(
        pt.numel() * 4 + mt.numel() * 4 + out_bytes,
        symbols * OPS_PER_SYMBOL) + (None,)

    # token encoder, fast parse (the pipeline's group)
    grp = sqz4_cuda.plan_tok_group(data, blk_bits, 1 << win_bits, True)
    if grp.over:
        raise AssertionError(f"blocks over the token caps: {grp.over}")
    toks = grp.toks.to(dev).view(torch.uint32)
    lits = grp.lits.to(dev)
    tok = PlainCheck(pool, sqz4_cuda.encode_tok, sqz4_ref.encode_tok_ref,
                     (toks, lits, grp.t_max, cw), reps)
    twords, tlens = tok.got
    tlens_np = convert.to_numpy(tlens)
    tpay = host.unpack_group_payloads(convert.to_numpy(twords), tlens_np,
                                      len(grp.fit))
    fast = native.blocks_compress(data, 1, win_bits, blk_bits,
                                  parse="fast")
    if any(tpay[i] != fast[b] for i, b in enumerate(grp.fit)):
        raise AssertionError("token encoder payloads differ from the "
                             "native fast parse")
    checks["sqz4_encode_tok"] = tok, bound(
        toks.numel() * 4 + lits.numel() + int(tlens_np[:, 0].sum())
        + tlens_np.nbytes, tok_symbols(grp) * OPS_PER_SYMBOL) + (None,)

    # compaction of the token encoder's output (every lane)
    n = len(grp.fit)
    flat = sqz4_cuda.compact_words(twords, tlens, n)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = sqz4_ref.compact_ref(twords, tlens, n)
    torch.cuda.synchronize()
    cplain = (time.perf_counter() - t) * 1e3
    cerr = max_abs_err([flat], [want])
    if cerr:
        raise AssertionError(f"compaction differs from its plain version "
                             f"(max_abs_err {cerr})")
    offsets = sqz4_ref.compact_offsets(tlens, n, twords.shape[1])
    out = torch.empty_like(flat)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    kms = mean_events_ms(lambda: lib.sqz4_compact_launch(
        twords.data_ptr(), twords.shape[2], offsets.data_ptr(), n,
        out.data_ptr(), sqz4_cuda.COMPACT_THREADS, stream), 20)
    if not torch.equal(out.view(torch.int32), flat.view(torch.int32)):
        raise AssertionError("timed compaction launches differ")
    # the library yardstick: one torch call for the same concatenation
    wc = offsets[1:] - offsets[:-1]
    mask = (torch.arange(twords.shape[1], device=dev)[None, :]
            < wc[:, None])
    cols = twords[0].view(torch.int32).t()[:n]
    lib_out = torch.masked_select(cols, mask)
    if not torch.equal(lib_out.view(torch.int32), flat.view(torch.int32)):
        raise AssertionError("masked_select differs from the compaction")
    lms = mean_events_ms(lambda: torch.masked_select(cols, mask), 20)
    compact = (cerr, kms, cplain) + bound(
        2 * flat.numel() * 4 + offsets.numel() * 8, 0) + (lms,)

    checks["squeeze_bitpack"] = bitpack_vs_plain(data, blk_bits, win_bits,
                                                 lanes, reps, pool)
    checks["sqz4_encode_stats"] = stats_vs_plain(
        data[:lanes << stats_bits], stats_bits, win_bits, lanes, reps, pool)
    probes = probes_vs_plain()
    res = {k: c.result() + extra for k, (c, extra) in checks.items()}
    res["sqz4_compact"], res["probe"] = compact, probes
    res["shape"] = f"{nb} blocks x {bs} B"
    log(f"kernels vs plain at {res['shape']}: " + ", ".join(
        f"{k} {v[1]:.3f} ms (plain {v[2]:.1f} ms, bound {v[3]:.4f} ms "
        f"by {v[4]}, err {v[0]}"
        + (f", library {v[5]:.4f} ms" if v[5] is not None else "") + ")"
        for k, v in res.items() if k != "shape"))
    return res


def bitpack_vs_plain(data, blk_bits, win_bits, lanes, reps, pool):
    """The squeeze bit-packer against its plain version on the exact
    parse's write records for ``data``; its payloads equal the native
    engine's. Returns (PlainCheck, bound and library entries)."""
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_host as host, squeeze_cuda
    from sqz_tpu_torch.ops import squeeze_ref
    bs = 1 << blk_bits
    words, mx = native.squeeze_plan_pack(data, win_bits, blk_bits, lanes,
                                         squeeze_cuda.record_cap(blk_bits))
    rows = max(-(-int(mx) // squeeze_cuda.ROW_CHUNK)
               * squeeze_cuda.ROW_CHUNK, squeeze_cuda.ROW_CHUNK)
    ops = squeeze_cuda.upload_rows(words, rows, torch.device("cuda"))
    del words
    cw = host.cap_words_for(bs + 4096)
    chk = PlainCheck(pool, squeeze_cuda.bitpack, squeeze_ref.bitpack_ref,
                     (ops, cw), reps)
    words, lens = (convert.to_numpy(x) for x in chk.got)
    if host.unpack_group_payloads(words, lens, len(data) // bs) != \
            native.blocks_compress(data, 0, win_bits, blk_bits):
        raise AssertionError("bit-packer payloads differ from native")
    records = int((ops.view(torch.int32) != 0).sum())
    return chk, bound(ops.numel() * 4 + int(lens[:, 0].sum())
                      + lens.nbytes, records * OPS_PER_RECORD) + (None,)


def stats_vs_plain(data, blk_bits, win_bits, lanes, reps, pool):
    """The stats-fed encoder against its plain version on the statistics
    of the exact parse's op streams for ``data`` (flushes as (0, 0, 1));
    its payloads equal the native engine's. Returns (PlainCheck, bound and
    library entries)."""
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
    bs = 1 << blk_bits
    nb = len(data) // bs
    st = host.op_stream_stats(data, 1 << win_bits, blk_bits, lanes=lanes)
    packed = [convert.to_device(a, "cuda") for a in
              sqz4_cuda.pack_group_stats(st, lanes)]
    cw = host.cap_words_for(bs + 2048)
    chk = PlainCheck(pool, sqz4_cuda.encode_stats, sqz4_ref.encode_stats_ref,
                     (*packed, cw), reps)
    words, lens = (convert.to_numpy(x) for x in chk.got)
    if host.unpack_group_payloads(words, lens, nb) != \
            native.blocks_compress(data, 1, win_bits, blk_bits):
        raise AssertionError("stats encoder payloads differ from native")
    coded = int((st[2] != 0).sum())
    return chk, bound(3 * packed[0].numel() * 4 + int(lens[:, 0].sum())
                      + lens.nbytes, coded * OPS_PER_STAT) + (None,)


def probe_library_calls(dev):
    """One torch call per probe that a single call computes (on int64
    copies of the inputs; the others need a 32-bit wrap or a loop)."""
    import torch
    from sqz_tpu_torch.ops import probe
    d = {k: torch.from_numpy(v.astype("int64")).to(dev)
         for k, v in probe.inputs().items()}
    return {
        "var_shr": lambda: torch.bitwise_right_shift(d["x"], d["s"]),
        "sublane_reduce": lambda: torch.sum(d["t"], 0, keepdim=True),
        "sublane_cumsum": lambda: torch.cumsum(d["t"], 0),
        "onehot_extract": lambda: torch.gather(d["t"], 0, d["idx"]),
        "f32_div": lambda: torch.div(d["num"], d["den"],
                                     rounding_mode="floor"),
        "u8_convert": lambda: d["u8buf"][:1].to(torch.int32),
        "dyn_sublane_read": lambda: torch.index_select(d["t"], 0,
                                                       d["off"][0]),
        "smem_scalar": lambda: torch.add(d["t"][:1], 7),
    }


def probes_vs_plain():
    """Every probe kernel against its plain version and its expected
    value; kernel and library times are means of 20 launches, summed
    over the probes."""
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import _build, probe
    dev = torch.device("cuda")
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    calls = probe_library_calls(dev)
    kms = plain_ms = lib_ms = 0.0
    nbytes = 0
    for i, name in enumerate(probe.PROBES):
        a, b = probe.probe_tensors(name, dev)
        got = probe.probe(name, a, b)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = probe.plain(name, a, b)
        torch.cuda.synchronize()
        plain_ms += (time.perf_counter() - t) * 1e3
        if max_abs_err([got], [want]) or not (
                convert.to_numpy(got) == probe.expected(name)).all():
            raise AssertionError(f"probe {name} differs from its plain "
                                 f"version or its expected value")
        out = torch.empty_like(got)
        kms += mean_events_ms(lambda: lib.probe_launch(
            i, a.data_ptr(), b.data_ptr() if b is not None else None,
            out.data_ptr(), probe.B, a.shape[0], stream), 20)
        if not torch.equal(out.view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"timed probe {name} launches differ")
        if name in calls:
            if not (calls[name]().cpu().numpy()
                    == probe.expected(name)).all():
                raise AssertionError(f"library call for {name} differs")
            lib_ms += mean_events_ms(calls[name], 20)
        nbytes += sum(x.numel() * x.element_size() for x in (a, b, got)
                      if x is not None)
    return (0, kms, plain_ms) + bound(nbytes, 0) + (lib_ms,)


def main_path():
    """Phase 4: the serial (one group) main path through the public API."""
    import sqz_tpu_torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
    from sqz_tpu_torch.ops import sqz4_cuda
    from sqz_tpu_torch.utils import corpus
    t = time.perf_counter()
    data = corpus.texty(MAIN_BYTES, seed=1)
    ref = container.pack(
        SQZT_FORMAT_SQZ4, MAIN_WIN_BITS, MAIN_BITS, len(data),
        native.blocks_compress(data, 1, MAIN_WIN_BITS, MAIN_BITS),
        container.fnv1a64(data))
    log(f"input + native reference: {time.perf_counter() - t:.1f} s")
    kw = dict(blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS)

    sqz4_cuda.encode_full.launches = 0
    sqz4_cuda.decode.launches = 0
    t = time.perf_counter()
    blob = sqz_tpu_torch.compress(data, parse="exact", **kw)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    out = sqz_tpu_torch.decompress(blob)
    dec_s = time.perf_counter() - t
    t = time.perf_counter()
    fblob = sqz_tpu_torch.compress(data, parse="fast", **kw)
    fenc_s = time.perf_counter() - t
    t = time.perf_counter()
    fout = sqz_tpu_torch.decompress(fblob)
    fdec_s = time.perf_counter() - t
    launches = {"sqz4_encode": sqz4_cuda.encode_full.launches,
                "sqz4_decode": sqz4_cuda.decode.launches}

    if blob != ref:
        raise AssertionError("exact-parse container differs from the "
                             "native engine's")
    if out != data or fout != data:
        raise AssertionError("round trip failed")
    if native.blocks_decompress(container.unpack(fblob)[4], len(data), 1,
                                MAIN_BITS) != data:
        raise AssertionError("native engine cannot decode the fast-parse "
                             "container")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    mb = len(data) / 1e6
    log(f"serial main path, 32 MiB in 64 KiB blocks: exact enc {enc_s:.3f} "
        f"s ({mb / enc_s:.1f} MB/s) dec {dec_s:.3f} s ({mb / dec_s:.1f} "
        f"MB/s) ratio {len(blob) / len(data):.4f}; fast enc {fenc_s:.3f} s "
        f"({mb / fenc_s:.1f} MB/s) dec {fdec_s:.3f} s "
        f"({mb / fdec_s:.1f} MB/s) ratio {len(fblob) / len(data):.4f}")
    log(f"launches over the serial main path: {launches}")
    return data, blob, launches, dict(
        exact_enc_MBps=mb / enc_s, exact_dec_MBps=mb / dec_s,
        fast_enc_MBps=mb / fenc_s, fast_dec_MBps=mb / fdec_s,
        exact_ratio=len(blob) / len(data), fast_ratio=len(fblob) / len(data))


def stage_times(data):
    """One run's host stage times of the exact encode and the decode."""
    from sqz_tpu_torch.ops import sqz4_cuda
    bs = 1 << MAIN_BITS
    enc_st, dec_st = {}, {}
    payloads = sqz4_cuda.encode_data_full(
        data, MAIN_BITS, 1 << MAIN_WIN_BITS, True, bs + 2048, parse="exact",
        stats=enc_st)
    sqz4_cuda.decode_groups(payloads, [bs] * len(payloads), MAIN_BITS,
                            stats=dec_st)
    log("stages (s): encode " + json.dumps(
        {k: round(v, 4) for k, v in enc_st.items()}) + " decode "
        + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))


def timed_compress(data, env, profiled=False, **kw):
    """(container, wall seconds, card-busy ms or None) of one default
    ``compress`` (64 KiB blocks, ``kw`` added) under the environment
    ``env``; ``profiled``: the card's busy time (kernels and copies,
    torch.profiler) over the call."""
    import sqz_tpu_torch
    import torch
    from torch.profiler import ProfilerActivity, profile
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        busy = None
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                blob = sqz_tpu_torch.compress(data, blk_bits=MAIN_BITS,
                                              win_bits=MAIN_WIN_BITS, **kw)
                wall = time.perf_counter() - t
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e3
        else:
            t = time.perf_counter()
            blob = sqz_tpu_torch.compress(data, blk_bits=MAIN_BITS,
                                          win_bits=MAIN_WIN_BITS, **kw)
            wall = time.perf_counter() - t
        return blob, wall, busy
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# the pipelined phase's configurations, timed in turns (A B C C B A)
PIPE_RUNS = {"pipeline": {}, "serial": {"SQZ_PIPELINE": "0"},
             "trim": {"SQZ_FETCH": "trim"}}
PIPE_ORDER = ("pipeline", "serial", "trim", "trim", "serial", "pipeline")


def pipelined_path():
    """Phase 5: 128 MiB (4 groups) through the defaults: the pipeline with
    the token and compaction kernels, against the serial path."""
    import sqz_tpu_torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import pipeline, sqz4_cuda
    from sqz_tpu_torch.utils import corpus
    t = time.perf_counter()
    data = corpus.texty(PIPE_BYTES, seed=1)
    log(f"input 128 MiB: {time.perf_counter() - t:.1f} s")
    counters = (sqz4_cuda.encode_full, sqz4_cuda.encode_tok,
                sqz4_cuda.compact_words, sqz4_cuda.decode)
    for c in counters:
        c.launches = 0
    blob, _s, _b = timed_compress(data, {})
    t = time.perf_counter()
    out = sqz_tpu_torch.decompress(blob)
    dec_s = time.perf_counter() - t
    launches = {"sqz4_encode": sqz4_cuda.encode_full.launches,
                "sqz4_encode_tok": sqz4_cuda.encode_tok.launches,
                "sqz4_compact": sqz4_cuda.compact_words.launches,
                "sqz4_decode": sqz4_cuda.decode.launches}
    log(f"launches over the pipelined main path: {launches}")
    if out != data:
        raise AssertionError("pipelined round trip failed")
    if min(launches["sqz4_encode_tok"], launches["sqz4_compact"]) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if native.blocks_decompress(container.unpack(blob)[4], len(data), 1,
                                MAIN_BITS) != data:
        raise AssertionError("native engine cannot decode the pipelined "
                             "container")
    walls = {k: [] for k in PIPE_RUNS}
    for name in PIPE_ORDER:
        other, wall, _b = timed_compress(data, PIPE_RUNS[name])
        if other != blob:
            raise AssertionError(f"the {name} container differs from the "
                                 f"pipeline's")
        walls[name].append(wall)
    busy = {k: timed_compress(data, PIPE_RUNS[k], profiled=True)[1:]
            for k in ("pipeline", "serial")}
    st = {}
    pipeline.encode_data_pipelined(data, MAIN_BITS, 1 << MAIN_WIN_BITS,
                                   True, (1 << MAIN_BITS) + 2048, stats=st)
    mb = len(data) / 1e6
    log("128 MiB compress wall (s), in turns "
        + " ".join(PIPE_ORDER) + ": " + json.dumps(
            {k: [round(w, 4) for w in v] for k, v in walls.items()}))
    log("128 MiB compress under torch.profiler (wall s, card busy ms, "
        "idle share): " + json.dumps(
            {k: [round(w, 4), round(b, 2), round(1 - b / 1e3 / w, 4)]
             for k, (w, b) in busy.items()}))
    log(f"pipelined main path, 128 MiB in 64 KiB blocks (best of 2): "
        + ", ".join(f"{k} enc {min(v):.3f} s ({mb / min(v):.1f} MB/s)"
                    for k, v in walls.items())
        + f"; dec {dec_s:.3f} s ({mb / dec_s:.1f} MB/s); ratio "
        f"{len(blob) / len(data):.4f}")
    log("pipeline stages (s): " + json.dumps(
        {k: round(v, 4) for k, v in st.items()}))
    return blob, launches, dict(
        pipe_enc_MBps=mb / min(walls["pipeline"]),
        pipe_trim_enc_MBps=mb / min(walls["trim"]),
        serial_enc_MBps=mb / min(walls["serial"]),
        pipe_dec_MBps=mb / dec_s, pipe_ratio=len(blob) / len(data))


def squeeze_path(data):
    """Phase 6: the 32 MiB input through the squeeze format, cold exact,
    warm exact and cold fast, against the native engine."""
    import sqz_tpu_torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQUEEZE
    from sqz_tpu_torch.ops import squeeze_cuda
    t = time.perf_counter()
    cold = native.blocks_compress(data, 0, MAIN_WIN_BITS, MAIN_BITS)
    native_s = time.perf_counter() - t
    csum = container.fnv1a64(data)
    ref = container.pack(SQZT_FORMAT_SQUEEZE, MAIN_WIN_BITS, MAIN_BITS,
                         len(data), cold, csum)
    wpay, wfresh = native.blocks_compress(data, 0, MAIN_WIN_BITS, MAIN_BITS,
                                          warm=True)
    wref = container.pack(SQZT_FORMAT_SQUEEZE, MAIN_WIN_BITS, MAIN_BITS,
                          len(data), wpay, csum, warm=True,
                          fresh_mask=wfresh)
    log(f"squeeze native references: {time.perf_counter() - t:.1f} s")
    kw = dict(fmt="squeeze", blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS)
    runs = {}
    squeeze_cuda.bitpack.launches = 0
    for name, extra in (("exact", dict(parse="exact")),
                        ("warm", dict(parse="exact", warm=True)),
                        ("fast", dict(parse="fast"))):
        t = time.perf_counter()
        blob = sqz_tpu_torch.compress(data, **kw, **extra)
        enc_s = time.perf_counter() - t
        t = time.perf_counter()
        out = sqz_tpu_torch.decompress(blob)
        runs[name] = (blob, enc_s, time.perf_counter() - t)
        if out != data:
            raise AssertionError(f"squeeze {name} round trip failed")
    launches = squeeze_cuda.bitpack.launches
    if runs["exact"][0] != ref:
        raise AssertionError("squeeze exact container differs from the "
                             "native engine's")
    if runs["warm"][0] != wref:
        raise AssertionError("squeeze warm container differs from the "
                             "native engine's")
    fblob = runs["fast"][0]
    if native.blocks_decompress(container.unpack(fblob)[4], len(data), 0,
                                MAIN_BITS) != data:
        raise AssertionError("native engine cannot decode the squeeze "
                             "fast-parse container")
    if launches < 1:
        raise AssertionError("the bit-packer was not launched")
    mb = len(data) / 1e6
    log("squeeze main path, 32 MiB in 64 KiB blocks: " + "; ".join(
        f"{k} enc {e:.3f} s ({mb / e:.1f} MB/s) dec {d:.3f} s "
        f"({mb / d:.1f} MB/s) ratio {len(b) / len(data):.4f}"
        for k, (b, e, d) in runs.items())
        + f"; warm blocks {wfresh.count(False)} of {len(wfresh)}")
    log(f"launches over the squeeze main path: {launches}")
    st = {}
    squeeze_cuda.squeeze_encode_data(data, MAIN_BITS, MAIN_WIN_BITS,
                                      (1 << MAIN_BITS) + 4096,
                                      parse="exact", stats=st)
    log("squeeze stages (s), exact encode: " + json.dumps(
        {k: round(v, 4) for k, v in st.items()})
        + f"; the native engine's exact encode of the same blocks (host "
        f"threads, no write records): {native_s:.4f} s")
    _b, wall, busy = timed_compress(data, {}, profiled=True, fmt="squeeze")
    log(f"squeeze default compress under torch.profiler: wall {wall:.4f} "
        f"s, card busy {busy:.2f} ms, idle share "
        f"{1 - busy / 1e3 / wall:.4f}")
    return launches, {
        **{f"squeeze_{k}_enc_MBps": mb / e for k, (_, e, _) in runs.items()},
        **{f"squeeze_{k}_dec_MBps": mb / d for k, (_, _, d) in runs.items()},
        **{f"squeeze_{k}_ratio": len(b) / len(data)
           for k, (b, _, _) in runs.items()},
        "squeeze_idle_share": 1 - busy / 1e3 / wall}


def stats_and_probe_paths(data):
    """Phase 7: ``encode_groups`` on the first 512 blocks of 16 KiB of
    ``data`` and ``run_probes``, each with its launches counted."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.ops import probe, sqz4_cuda, sqz4_host as host
    part = data[:host.LANES << STATS_BITS]
    st = host.op_stream_stats(part, 1 << MAIN_WIN_BITS, STATS_BITS)
    sqz4_cuda.encode_stats.launches = 0
    t = time.perf_counter()
    payloads = sqz4_cuda.encode_groups(*st, (1 << STATS_BITS) + 2048)
    enc_s = time.perf_counter() - t
    stats_launches = sqz4_cuda.encode_stats.launches
    if payloads != native.blocks_compress(part, 1, MAIN_WIN_BITS,
                                          STATS_BITS):
        raise AssertionError("encode_groups payloads differ from native")
    probe.probe.launches = 0
    res = probe.run_probes("cuda")
    probe_launches = probe.probe.launches
    bad = [k for k, (got, want) in res.items() if not (got == want).all()]
    if bad:
        raise AssertionError(f"probes differ from their values: {bad}")
    if min(stats_launches, probe_launches) < 1:
        raise AssertionError("a kernel was not launched: "
                             f"{stats_launches}, {probe_launches}")
    log(f"encode_groups, 512 x 16 KiB of statistics: {enc_s:.3f} s, "
        f"launches {stats_launches}; probes all equal, launches "
        f"{probe_launches}")
    return {"sqz4_encode_stats": stats_launches, "probe": probe_launches}


def corrupt_rejected(blob):
    """Phase 8: one flipped payload byte -> ValueError naming the block."""
    import sqz_tpu_torch
    from sqz_tpu_torch.formats import container
    code, win_bits, blk_bits, osize, payloads, csum, _f, _a = \
        container.unpack(blob)
    p = bytearray(payloads[CORRUPT_BLOCK])
    p[len(p) // 2] ^= 0xFF
    payloads[CORRUPT_BLOCK] = bytes(p)
    bad = container.pack(code, win_bits, blk_bits, osize, payloads, csum)
    try:
        sqz_tpu_torch.decompress(bad)
    except ValueError as e:
        if str(CORRUPT_BLOCK) not in str(e):
            raise AssertionError(f"rejection does not name block "
                                 f"{CORRUPT_BLOCK}: {e}") from e
        log(f"corrupt block {CORRUPT_BLOCK} rejected: {e}")
        return
    raise AssertionError("corrupt payload was not rejected")


KERNELS = (   # name, source, the TPU kernel it replaces
    ("sqz4_encode", "sqz4_encode.cu", f"{PALLAS}:686"),
    ("sqz4_decode", "sqz4_decode.cu", f"{PALLAS}:1705"),
    ("sqz4_encode_tok", "sqz4_encode_tok.cu", f"{PALLAS}:1127"),
    ("sqz4_compact", "sqz4_compact.cu", f"{PALLAS}:464"),
    ("squeeze_bitpack", "squeeze_bitpack.cu", f"{PALLAS}:1489"),
    ("sqz4_encode_stats", "sqz4_encode_stats.cu", f"{PALLAS}:281"),
    ("probe", "probe.cu", "tools/pallas_probe.py:13"),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import sqz_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sqz_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = environment()
    build()
    from sqz_tpu_torch.ops import sqz4_host
    from sqz_tpu_torch.utils import corpus
    pool = ProcessPoolExecutor(
        PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        kernels_vs_plain(corpus.texty(SMALL_BLOCKS << SMALL_BITS, seed=7),
                         SMALL_BITS, 10, SMALL_BLOCKS, 10, SMALL_BITS, pool)
        data, blob, launches, e2e = main_path()
        _pblob, plaunches, pe2e = pipelined_path()
        launches.update({k: plaunches[k]
                         for k in ("sqz4_encode_tok", "sqz4_compact")})
        launches["squeeze_bitpack"], se2e = squeeze_path(data)
        launches.update(stats_and_probe_paths(data))
        t = time.perf_counter()
        full = kernels_vs_plain(data, MAIN_BITS, MAIN_WIN_BITS,
                                sqz4_host.LANES, REPS, STATS_BITS, pool)
        log(f"kernels vs plain at the full shapes: "
            f"{time.perf_counter() - t:.1f} s")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    stage_times(data)
    corrupt_rejected(blob)
    if any(m.split(".")[0] in ("jax", "sqz_tpu") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    kernels = []
    shapes = {"sqz4_encode_stats":
              f"{sqz4_host.LANES} blocks x {1 << STATS_BITS} B",
              "probe": "the reference's probe inputs, [1, 128] and "
                       "[256, 128]"}
    for name, src, replaces in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by, lib_ms = full[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sqz_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "shape": shapes.get(name, full["shape"])})
    log(json.dumps({"card": card, "wall_s": round(
        time.perf_counter() - t0, 1), **{k: round(v, 4) for k, v in
                                         {**e2e, **pe2e, **se2e}.items()}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
