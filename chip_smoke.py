#!/usr/bin/env python3
"""Drive the PyTorch port's sqz4 main paths once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, card, nvcc, power limit;
  2. build: the native host runtime (g++) and the CUDA kernels (one nvcc
     per source), all at once, from the sources in the checkout;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs, first at 64 blocks of 1 KiB (a quick gate), then at the
     main paths' shapes (512 blocks of 64 KiB, one group): outputs must be
     equal (tolerance 0, a lossless integer codec), and the payloads equal
     the native engine's;
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
  6. a corrupt payload byte must be rejected, naming its block.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_BLOCKS, SMALL_BITS = 64, 10
MAIN_BYTES, MAIN_BITS, MAIN_WIN_BITS = 32 << 20, 16, 15
PIPE_BYTES = 128 << 20
CORRUPT_BLOCK = 100
REPS = 3
PALLAS = "sqz_tpu/ops/sqz4_pallas.py"

# Roofs of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# CUDA cores' rate (the fp32 rate outside the tensor cores; the coders'
# integer operations issue at no more than it).
HBM_BPS = 3.35e12
CORE_OPS = 67e12
# Integer operations of one coded symbol: a 64-bit divide, two
# multiplies, adds, xor, clz, shifts and a compare in the coder, and the
# model lookup and update (Fenwick tree) around it.
OPS_PER_SYMBOL = 20


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


def probe():
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


def plain_vs_kernel(kernel, plain, reps):
    """(max_abs_err, kernel ms, plain ms, kernel outputs); raises if the
    outputs differ."""
    import torch
    got = kernel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"kernel differs from its plain version "
                             f"(max_abs_err {err})")
    return err, events_ms(kernel, reps), plain_ms, got


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


def kernels_vs_plain(data, blk_bits, win_bits, lanes, reps):
    """Each kernel against its plain PyTorch version on the card, on the
    same inputs, at the shapes the main paths give them for ``data`` (one
    group): equal outputs (tolerance 0), the payloads equal the native
    engine's, the blocks restore. Returns per kernel (max_abs_err, kernel
    ms, plain ms, bound ms, bound_by, library ms or None)."""
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import _build, sqz4_cuda, sqz4_host as host
    from sqz_tpu_torch.ops import sqz4_ref
    dev = torch.device("cuda")
    bs = 1 << blk_bits
    nb = len(data) // bs
    cw = host.cap_words_for(bs + 2048)
    res = {}

    # op-stream encoder, exact parse
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << win_bits, blk_bits, True,
                                       lanes, host.op_stream_cap(blk_bits))
    rows = -(-int(mx) // 4)
    m, s = convert.encoder_inputs(mw, sw, rows, dev)
    enc = plain_vs_kernel(lambda: sqz4_cuda.encode_full(m, s, cw),
                          lambda: sqz4_ref.encode_full_ref(m, s, cw), reps)
    words, lens = (convert.to_numpy(x) for x in enc[3])
    payloads = host.unpack_group_payloads(words, lens, nb)
    if payloads != native.blocks_compress(data, 1, win_bits, blk_bits):
        raise AssertionError("encoder payloads differ from native")
    symbols = coded_symbols(mw[:, :rows])
    pay_bytes = int(lens[:, 0].sum())
    res["sqz4_encode"] = enc[:3] + bound(
        2 * m.numel() * 4 + pay_bytes + lens.nbytes,
        symbols * OPS_PER_SYMBOL) + (None,)

    # decoder
    plan = host.plan_decode_dispatch(nb, blk_bits, lanes=lanes)
    pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
    buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, lanes,
                                       plan["G"], pw)
    pt, mt = convert.decoder_inputs(buf, meta, dev)
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    dec = plain_vs_kernel(lambda: sqz4_cuda.decode(pt, mt, *args),
                          lambda: sqz4_ref.decode_ref(pt, mt, *args), reps)
    outs = host.postprocess_decode(*[convert.to_numpy(x) for x in dec[3]],
                                   payloads, [bs] * nb, bs)
    if b"".join(outs) != data:
        raise AssertionError("decoder kernel did not restore the blocks")
    cnt = convert.to_numpy(dec[3][3])
    out_bytes = int(cnt[:, 1].sum() + (cnt[:, 2].sum() + 7) // 8
                    + 4 * cnt[:, 3].sum()) + cnt.nbytes
    res["sqz4_decode"] = dec[:3] + bound(
        pt.numel() * 4 + mt.numel() * 4 + out_bytes,
        symbols * OPS_PER_SYMBOL) + (None,)

    # token encoder, fast parse (the pipeline's group)
    grp = sqz4_cuda.plan_tok_group(data, blk_bits, 1 << win_bits, True)
    if grp.over:
        raise AssertionError(f"blocks over the token caps: {grp.over}")
    toks = grp.toks.to(dev).view(torch.uint32)
    lits = grp.lits.to(dev)
    tok = plain_vs_kernel(
        lambda: sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw),
        lambda: sqz4_ref.encode_tok_ref(toks, lits, grp.t_max, cw), reps)
    twords, tlens = tok[3]
    tlens_np = convert.to_numpy(tlens)
    tpay = host.unpack_group_payloads(convert.to_numpy(twords), tlens_np,
                                      len(grp.fit))
    fast = native.blocks_compress(data, 1, win_bits, blk_bits,
                                  parse="fast")
    if any(tpay[i] != fast[b] for i, b in enumerate(grp.fit)):
        raise AssertionError("token encoder payloads differ from the "
                             "native fast parse")
    res["sqz4_encode_tok"] = tok[:3] + bound(
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
    res["sqz4_compact"] = (cerr, kms, cplain) + bound(
        2 * flat.numel() * 4 + offsets.numel() * 8, 0) + (lms,)

    res["shape"] = f"{nb} blocks x {bs} B"
    log(f"kernels vs plain at {res['shape']}: " + ", ".join(
        f"{k} {v[1]:.3f} ms (plain {v[2]:.1f} ms, bound {v[3]:.4f} ms "
        f"by {v[4]}, err {v[0]}"
        + (f", library {v[5]:.4f} ms" if v[5] is not None else "") + ")"
        for k, v in res.items() if k != "shape"))
    return res


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


def timed_compress(data, env, profiled=False):
    """(container, wall seconds, card-busy ms or None) of one default
    ``compress`` under the environment ``env``; ``profiled``: the card's
    busy time (kernels and copies, torch.profiler) over the call."""
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
                                              win_bits=MAIN_WIN_BITS)
                wall = time.perf_counter() - t
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       ) / 1e3
        else:
            t = time.perf_counter()
            blob = sqz_tpu_torch.compress(data, blk_bits=MAIN_BITS,
                                          win_bits=MAIN_WIN_BITS)
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


def corrupt_rejected(blob):
    """Phase 6: one flipped payload byte -> ValueError naming the block."""
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


KERNELS = (   # name, source, the TPU kernel it replaces (line in PALLAS)
    ("sqz4_encode", "sqz4_encode.cu", 686),
    ("sqz4_decode", "sqz4_decode.cu", 1705),
    ("sqz4_encode_tok", "sqz4_encode_tok.cu", 1127),
    ("sqz4_compact", "sqz4_compact.cu", 464),
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
    card = probe()
    build()
    from sqz_tpu_torch.ops import sqz4_host
    from sqz_tpu_torch.utils import corpus
    kernels_vs_plain(corpus.texty(SMALL_BLOCKS << SMALL_BITS, seed=7),
                     SMALL_BITS, 10, SMALL_BLOCKS, 10)
    data, blob, launches, e2e = main_path()
    _pblob, plaunches, pe2e = pipelined_path()
    launches.update({k: plaunches[k]
                     for k in ("sqz4_encode_tok", "sqz4_compact")})
    full = kernels_vs_plain(data, MAIN_BITS, MAIN_WIN_BITS, sqz4_host.LANES,
                            REPS)
    stage_times(data)
    corrupt_rejected(blob)
    if any(m.split(".")[0] in ("jax", "sqz_tpu") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    kernels = []
    for name, src, line in KERNELS:
        err, ms, plain_ms, bound_ms, bound_by, lib_ms = full[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sqz_tpu_torch/csrc/{src}",
            "replaces": f"{PALLAS}:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "shape": full["shape"]})
    log(json.dumps({"card": card, "wall_s": round(
        time.perf_counter() - t0, 1), **{k: round(v, 4) for k, v in
                                         {**e2e, **pe2e}.items()}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
