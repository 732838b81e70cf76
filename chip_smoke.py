#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, card, nvcc, power limit;
  2. build: the native host runtime (g++), the CUDA kernels (one nvcc
     per source) and the token encoder with its phase counters, all at
     once, from the sources in the checkout;
  3. each kernel on the card against its plain PyTorch version on the
     same inputs (the coders' plain versions on CPU copies of them, each
     in a worker process, side by side), first at 64 blocks of 1 KiB (a
     quick gate), then at the
     main paths' shapes (512 blocks of 64 KiB, one group; the stats-fed
     encoder at 512 blocks of 16 KiB, the largest blocks whose model
     totals stay below its 2^15 limit; the probes at their fixed inputs):
     outputs must be equal (tolerance 0, a lossless integer codec), and
     the payloads equal the native engine's; at the main shape the
     bit-packer also packs the exact parse's records of 32 MiB of random
     bytes (its longest record columns). At both sizes the op-stream
     and stats-fed encoders also code synthetic streams that reach every
     op code, flushes and pads anywhere and blocks of mixed lengths
     (``sqz_tpu_torch.utils.synthetic``), against their plain versions.
     The seeded modes of the op-stream encoder and the decoder (warm
     start) are checked the same way at both sizes: the device pass of a
     warm container (blocks 1+ from block 0's final state, block 0 cold)
     against the plain version and the native seeded codec, then its
     warm blocks through the seeded decoder against the plain version.
     Then the coders' chain figures: the op-stream encoder, the decoder
     and the token encoder timed on one group of the pseudo-text and of
     32 MiB of random bytes (the literal-heavy mix), and the stats-fed
     encoder on the pseudo-text's 512 x 16 KiB statistics, in ns and SM
     cycles per coded symbol, each checked against the native engine
     (``chain_figures``; ``python3 chip_smoke.py --chain`` runs only the
     build and this);
  4. the one-group main path: 32 MiB of pseudo-text in 64 KiB blocks
     (one group through the pipeline), compressed and decompressed
     through ``sqz_tpu_torch.compress`` / ``decompress``. The exact-parse
     container must equal the native engine's byte for byte; both parses
     must round-trip, and the native engine must decode the fast-parse
     container. The op-stream encoder's and the decoder's launch counts
     over this run must be > 0;
  5. the pipelined main path: 128 MiB (4 groups) through ``compress`` /
     ``decompress`` with their defaults (fast parse, planner thread, token
     kernel, compaction kernel). The container's payloads must equal the
     serial path's (``sqz4_cuda.encode_data_full``: the op-stream kernel
     in one launch), and the container must round-trip and decode on the
     native engine; its size and sha256 are printed; the token kernel's
     and the compaction kernel's launch counts over this run must be > 0.
     The pipeline and the serial path are then timed in turns, and
     profiled once each for the card's busy time; the pipeline's stage
     times are printed;
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
     probe equals its expected value, all fourteen in one launch), each
     with its launch count > 0 (the probes' exactly 1);
  8. a corrupt payload byte must be rejected, naming its block;
  9. sqz4 warm start (sqzt v2): the 32 MiB input through ``compress(warm=
     True)`` / ``decompress``, exact and fast parse. The exact container
     must equal the native copy's (``blocks_compress(warm=True)``); both
     must round-trip, and the seeded encoder's and the seeded decoder's
     launch counts over this run must be > 0;
 10. anchored warm start (sqzt v3), sqz4 and squeeze: 1.75 MiB mixing
     pseudo-text, random bytes and runs, so that the planner picks several
     anchors, through ``compress(warm="anchors")`` / ``decompress``: round
     trip, and (sqz4) one seeded decoder launch per anchor;
 11. sqz4 above 64 KiB blocks (the route of ``blk_bits`` 17..40: exact
     tokens and model statistics on the host, the stats-fed encoder, the
     decoder cold and seeded): the 32 MiB input at ``blk_bits`` 17 (256
     lanes) and 20 (32 lanes) through ``compress`` / ``decompress``, the
     native engine on the same input in turns (card native native card),
     enc and dec MB/s, one run's stages and both kernels' CUDA-event times
     and bounds at those shapes; two blocks of random bytes at 18 (the
     literal models' totals past 2^17); warm (v2) and anchored (v3, the
     seeded decoder) on 4 MiB at 17; one 16 MiB block at 24 (one lane)
     beside the native engine. Every container equals the native copy's
     exact one byte for byte and every round trip holds; the route's
     block count and the stats-fed encoder's, the decoder's and the
     seeded decoder's launches over the API calls must be > 0. Both
     kernels are held against their plain versions (in workers) on the
     route's group at 17, the 256 lanes of 128 KiB the timed kernels
     take. Then the widest block: 2^27 + 4096 bytes of the pseudo-text in
     one block at ``blk_bits`` 28 through ``compress`` / ``decompress``
     on the card, equal to the native copy's container (made in a worker
     meanwhile), its times logged; a block above 2^28 bytes must raise
     ValueError naming engine="native";
 12. the resident paths: 32 MiB of ``synthetic.resident_mix`` (512 blocks
     of 64 KiB: sparse float32 weights, periodic content, repeated cells,
     pseudo-text, random bytes, a short last block), uploaded once as a
     CUDA tensor, through ``compress_resident`` in modes lit, rle and lz
     and ``decompress_resident`` of each container and of phase 4's
     fast-parse container. Every container must round-trip through
     ``decompress`` and the native copy; each restore must return a CUDA
     tensor equal to its input, lit and rle by the cell assembly in every
     lane, lz by the general assembly in every lane with a match (in
     every lane under ``assembly="general"``), the fast-parse container
     by the general assembly in every lane, no lane on the host; a
     corrupt payload byte must raise; the cold token kernel's, its
     lit_skip mode's, the compaction's and the cell assembly's launch
     counts over the run must be > 0. The compaction is held against its
     plain version on the lit encode's payloads (the largest it meets).
     The cell assembly kernel is held against its plain version (in
     workers) on the decoder's outputs of the rle container's group and
     of the lz container's group (where it rejects the lanes with
     matches off the cell grid): equal blocks and bad flags. The lit_skip
     kernel is held against its plain version (in a worker) at the rle
     path's shape, and, on the rle and the lz tokens, against the cold
     kernel on the same tokens with the literals compacted on the host.
     Then lit_skip at the checkpoint's shape: the first group of phase
     13's stream against its plain version (in a worker) and the cold
     kernel on compacted literals, its first three groups in one launch
     (as the save hands them over) equal to one launch a group, and on
     that group and the resident mix's rle group the coder warp's and
     the producer warp's split in SM cycles (the token encoder built with
     its phase counters, ``scripts/tok_timeline.py``) and the ns and SM
     cycles a coded op of the longest lane;
 13. the checkpoint path: the AdamW training state of GPT-2 small (124M,
     its published shapes; 1.49 GB of fp32 parameters and moments made on
     the card from a seed) through ``utils.checkpoint.save_pytree``
     (mode rle) and ``load_pytree``. Every leaf must come back a CUDA
     tensor equal to the saved one; the native copy must decode the
     file's container to the stream the save built; the lit_skip token
     kernel's, the compaction's, the decoder's and the cell assembly's
     launch counts over the run must be > 0, and the cell route must
     restore every lane. Then ``params`` alone in
     mode lit (the cold token kernel) must round-trip, a corrupt payload
     byte in that file must raise, and the CLI must agree on the card:
     ``ckpt-save`` / ``ckpt-load`` of a small .npz, ``compress`` /
     ``decompress`` / ``roundtrip`` (``python -m sqz_tpu_torch``) with the
     torch engine on 1 MiB of texty, its exact-parse container equal to
     the native engine's, and ``range`` equal to slicing. Save and load
     MB/s, ratio and stages are printed. Between the load and mode lit, the
     distributed checkpoint: ``save_pytree`` / ``load_pytree`` of the
     same state over a mesh of 2 virtual shards of the card
     (``parallel/mesh.make_mesh``): the file must equal the mesh-less
     file byte for byte and every leaf come back bit for bit;
 14. the check tools (``sqz_tpu_torch.tools``) at their default sizes:
     ``check_dec`` (every block of 2 MiB of texty in 16 KiB blocks against
     the native decoder, then 100 seeded corrupt mutants through the
     decoder kernel under the reference's contract), ``check_enc`` (the
     op-stream and stats-fed encoders' payloads equal the native
     engine's), ``check_resident`` (8 MiB of the resident mix: lit equal
     to native, rle round trips, a restore with no error lane) and
     ``check_lz`` (32 MiB of texty: every device-LZ block round-trips,
     the ratio gap to the host fast parse at most 1.6 pp, the general
     restore with no bad lane), with their launches, the mutants' counts,
     the gap and each tool's MB/s printed;
 15. the mesh: phase 12's resident mix over meshes of 1, 2 and 4 virtual
     shards of ``cuda:0`` (a host thread and a stream a shard), in turns
     (1 2 4 4 2 1): ``compress_resident(mesh=)`` lit, rle and lz, each
     container equal to the mesh-less one, and ``decompress_resident(
     mesh=)`` (auto) of each, equal to the input, the cell assembly
     launched at least once a shard and mode; enc and dec MB/s and the
     launches of each shard count are printed;
 16. two processes on the one card (``python -m
     sqz_tpu_torch.parallel.dryrun``, gloo, a shard of ``cuda:0`` each):
     ``compress_resident(mesh=)`` rle of the resident mix, rank 0's
     container equal to the single-process one and rank 1's None, and
     the restore over the group on both ranks; beside it, one NCCL rank
     (world size 1: NCCL takes one rank a card) through the same run.
     Both workers of a run must exit 0.

 17. the decoder's payload packing on the card (``csrc/sqz4_pack.cu``):
     one ``load_pytree`` of phase 13's state saved with the checkpoint's
     defaults must launch it once a 512-lane group (45) and one
     ``decompress`` of 10^8 B of texty once (three groups in one
     launch), both round trips exact; then the kernel on the load's
     first and last groups (512 payloads of 64 KiB blocks) and on the
     decompress's three groups must equal its plain version and the
     native host packer word for word, with its CUDA-event time, its
     bound and the plain version's and the host packer's times
     (``python3 chip_smoke.py --pack`` runs only the build and this).
 18. the per-op model statistics on the card (``csrc/sqz4_model_stats.cu``,
     run after phase 11): one compress of 10^8 B of texty at 1 MiB
     blocks must launch them once (one group of 96 lanes) and never call
     the host's per-block walk (``sqz4_host.op_stats``), its round trip
     exact; then the kernels at that shape and at 512 x 64 KiB of the
     same text must equal the native walk and their plain version
     element for element, with their CUDA-event time, their bound and
     the plain version's and the host walk's times (``python3
     chip_smoke.py --model-stats`` runs only the build and this).
 19. the exact parse on the card (``csrc/sqz4_exact_parse.cu``): one
     compress of 10^8 B of texty at 1 MiB blocks must launch it once
     (one group of 96 lanes), its round trip exact; then the kernel at
     that shape, on the texty and on as many random bytes (a find a
     byte), must give the native planner's op words and counts word for
     word, with its CUDA-event time, its bound and the host planner's
     time (``python3 chip_smoke.py --exact-parse`` runs only the build
     and this).

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
PLAIN_WORKERS = 7   # plain versions checked at a shape side by side
ANCHOR_BLOCKS = 7   # blocks of one anchored phase's pattern (four of them)
# phase 11, the route above 64 KiB blocks: the main input at 128 KiB and
# 1 MiB blocks, two blocks of random bytes at 256 KiB, warm and anchored
# at 128 KiB, one 16 MiB block, and the kernels against their plain
# versions on the route's group at 128 KiB (256 lanes)
WIDE_BITS = (17, 20)
WIDE_RANDOM_BITS = 18
WIDE_WARM_BITS = 17
WIDE_ONE_BITS = 24
WIDE_PLAIN_BITS = 17
# phase 11's widest block: one block just over 2^27 bytes at blk_bits 28
# (the kernels' and the JAX package's limit), its native container made
# in a worker beside the card's round trip
HUGE_BITS = 28
HUGE_BYTES = (1 << 27) + 4096
HUGE_SEED = 5
STATS_BITS = 14   # the stats-fed encoder's full-size blocks (16 KiB)
# the synthetic streams' most ops a block, at 64 x 1 KiB and at the full
# shapes (kept short: the plain versions step once an op; the kernels take
# any model total below 2^32, phase 11 totals past 2^17)
SYNTH_OPS = {SMALL_BITS: 1 << 11, MAIN_BITS: 1 << 14}

# Roofs of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and the
# CUDA cores' rate (the fp32 rate outside the tensor cores; the coders'
# integer operations issue at no more than it).
HBM_BPS = 3.35e12
CORE_OPS = 67e12
# Integer operations of one coded symbol: the divide by the model total,
# two multiplies, adds, xor, the leading-zero count, shifts and a compare
# in the coder, and the model lookup and update around it.
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


def queued_events_ms(fn, n):
    """Mean device time of ``n`` calls of fn (after one warm call) queued
    behind a sleep of the stream, by CUDA events: the host enqueues them
    while the card sleeps, so a wrapper's host time, longer than a short
    kernel's, stays out of the figure."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # ~50 ms of the SM clock
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


# the token encoder built with its phase counters (scripts/tok_timeline.py)
TIMELINE = {}


def tok_timeline():
    """scripts/tok_timeline.py as a module."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import tok_timeline as tt
    return tt


def build():
    """The native runtime, the CUDA kernels and the token encoder with its
    phase counters, built at once."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.ops import _build
    t = time.perf_counter()
    errors = []

    def run(fn):
        try:
            fn(force=True)
        except BaseException as e:           # reported below
            errors.append(e)

    def clocks(force):
        TIMELINE.update(tok_timeline().build(
            [("clocks", str(_build.CSRC), [], True)]))

    threads = [threading.Thread(target=run, args=(fn,))
               for fn in (native.build, _build.build, clocks)]
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


def tok_symbols(toks):
    """Coded symbols of token rows (uint32 numpy): 2 a literal, 2 + nbits
    a match (flag, size, bits, nbits - 1 distance bits), 10 for the EOS
    token."""
    import numpy as np
    t = toks.astype(np.int64)
    live = t != 0
    match = live & ((t >> 8) & 1 == 1)
    eos = match & ((t & 0xFF) == 255)
    lit = live & ~match
    return int((2 * (t & 0xFF) * lit).sum()
               + (2 + ((t >> 9) & 0x1F))[match & ~eos].sum()
               + 10 * eos.sum())


def tok_literal_bytes(toks):
    """Bytes the literal tokens of token rows (uint32 numpy) cover."""
    import numpy as np
    t = toks.astype(np.int64)
    return int((t & 0xFF)[(t != 0) & ((t >> 8) & 1 == 0)].sum())


def compact_vs_plain(words, lens, n):
    """The compaction kernel on the first ``n`` lanes of an encoder's
    output (words [1, R, B], lens [1, 8, B] on the card) against its plain
    version and one torch call for the same concatenation
    (``torch.masked_select``): equal outputs, or AssertionError. Returns
    (max_abs_err, kernel ms (mean of 20 launches), plain ms, bound ms,
    bound_by, library ms)."""
    import torch
    from sqz_tpu_torch.ops import _build, sqz4_cuda, sqz4_ref
    flat = sqz4_cuda.compact_words(words, lens, n)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = sqz4_ref.compact_ref(words, lens, n)
    torch.cuda.synchronize()
    cplain = (time.perf_counter() - t) * 1e3
    cerr = max_abs_err([flat], [want])
    if cerr:
        raise AssertionError(f"compaction differs from its plain version "
                             f"(max_abs_err {cerr})")
    offsets = sqz4_ref.compact_offsets(lens, n, words.shape[1])
    out = torch.empty_like(flat)
    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.library()
    kms = mean_events_ms(lambda: lib.sqz4_compact_launch(
        words.data_ptr(), words.shape[2], offsets.data_ptr(), n,
        out.data_ptr(), sqz4_cuda.COMPACT_ROWS, stream), 20)
    if not torch.equal(out.view(torch.int32), flat.view(torch.int32)):
        raise AssertionError("timed compaction launches differ")
    # the library yardstick: one torch call for the same concatenation
    wc = offsets[1:] - offsets[:-1]
    mask = (torch.arange(words.shape[1], device=words.device)[None, :]
            < wc[:, None])
    cols = words[0].view(torch.int32).t()[:n]
    lib_out = torch.masked_select(cols, mask)
    if not torch.equal(lib_out.view(torch.int32), flat.view(torch.int32)):
        raise AssertionError("masked_select differs from the compaction")
    lms = mean_events_ms(lambda: torch.masked_select(cols, mask), 20)
    return (cerr, kms, cplain) + bound(
        2 * flat.numel() * 4 + offsets.numel() * 8, 0) + (lms,)


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
    import numpy as np
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
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
        + tlens_np.nbytes, tok_symbols(grp.toks.numpy().view(np.uint32))
        * OPS_PER_SYMBOL) + (None,)

    checks.update(seeded_vs_plain(data, blk_bits, win_bits, lanes, reps,
                                  pool, payloads[0]))

    # compaction of the token encoder's output (every lane)
    compact = compact_vs_plain(twords, tlens, len(grp.fit))

    checks.update(synthetic_vs_plain(lanes, SYNTH_OPS[blk_bits], reps,
                                     pool))
    checks["squeeze_bitpack"] = bitpack_vs_plain(data, blk_bits, win_bits,
                                                 lanes, reps, pool)
    if blk_bits == MAIN_BITS:   # the longest record columns
        from sqz_tpu_torch.utils import corpus
        checks["squeeze_bitpack_random"] = bitpack_vs_plain(
            corpus.random_bytes(len(data), seed=1), blk_bits, win_bits,
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


def seeded_vs_plain(data, blk_bits, win_bits, lanes, reps, pool, cold0):
    """The seeded modes against their plain versions (in workers of
    ``pool``, see PlainCheck): the warm device pass of ``data`` (exact
    parse; blocks 1+ start from block 0's final state, block 0, whose
    cold payload is ``cold0``, stays cold), whose payloads must equal the
    native seeded codec's; then its blocks 1+ through the seeded decoder,
    which must restore them. Returns {kernel: (PlainCheck, bound and
    library entries)}."""
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
    dev = torch.device("cuda")
    bs = 1 << blk_bits
    nb = len(data) // bs
    mw, sw, mx, seed = native.sqz4_plan_pack(
        data, 1 << win_bits, blk_bits, True, lanes,
        host.op_stream_cap(blk_bits), warm=True)
    rows = -(-int(mx) // 4)
    m, s = convert.encoder_inputs(mw, sw, rows, dev)
    col = convert.to_device(host.seed_column(seed), dev)
    cw = host.cap_words_for(bs + 2048 + bs // 4)
    enc = PlainCheck(pool, sqz4_cuda.encode_full, sqz4_ref.encode_full_ref,
                     (m, s, cw, col, 0), reps)
    words, lens = (convert.to_numpy(x) for x in enc.got)
    payloads = host.unpack_group_payloads(words, lens, nb)
    dictionary = data[:bs][-(1 << win_bits):]
    if payloads[0] != cold0 or any(
            payloads[b] != native.sqz4_compress_payload(
                data[b * bs:(b + 1) * bs], 1 << win_bits, seed=seed,
                dictionary=dictionary) for b in range(1, nb)):
        raise AssertionError("seeded encoder payloads differ from the "
                             "native seeded codec")
    out = {"sqz4_encode_seeded": (enc, bound(
        2 * m.numel() * 4 + col.numel() * 4 + int(lens[:, 0].sum())
        + lens.nbytes, coded_symbols(mw[:, :rows]) * OPS_PER_SYMBOL)
        + (None,))}

    warm, sizes = payloads[1:], [bs] * (nb - 1)
    plan = host.plan_decode_dispatch(nb - 1, blk_bits, lanes=lanes)
    pw = min(plan["Pw"], host.payload_rows(max(map(len, warm))))
    buf, meta = host.pack_decode_chunk(warm, sizes, lanes, plan["G"], pw,
                                       len(dictionary))
    pt, mt = convert.decoder_inputs(buf, meta, dev)
    dec = PlainCheck(pool, sqz4_cuda.decode, sqz4_ref.decode_ref,
                     (pt, mt, plan["t_max"], plan["lw"], plan["tw"],
                      plan["mw"], col), reps)
    outs = host.postprocess_decode(*[convert.to_numpy(x) for x in dec.got],
                                   warm, sizes, bs, seed=seed,
                                   dictionary=dictionary)
    if b"".join(outs) != data[bs:]:
        raise AssertionError("seeded decoder did not restore the blocks")
    cnt = convert.to_numpy(dec.got[3])
    out_bytes = int(cnt[:, 1].sum() + (cnt[:, 2].sum() + 7) // 8
                    + 4 * cnt[:, 3].sum()) + cnt.nbytes
    wsym = coded_symbols(mw[:, :rows]) - coded_symbols(mw[:1, :rows, :1])
    out["sqz4_decode_seeded"] = dec, bound(
        pt.numel() * 4 + mt.numel() * 4 + col.numel() * 4 + out_bytes,
        wsym * OPS_PER_SYMBOL) + (None,)
    return out


def synthetic_vs_plain(lanes, max_ops, reps, pool):
    """The op-stream and stats-fed encoders against their plain versions
    on synthetic streams of ``lanes`` blocks of up to ``max_ops`` ops
    (every op code and symbol, flushes and pads anywhere, mixed lengths)
    and a capacity of max_ops / 4 bytes, which the longest payloads
    overflow. Returns {name: (PlainCheck, bound and library entries)}."""
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_ref
    from sqz_tpu_torch.utils import synthetic
    dev = "cuda"
    cw = max_ops // 16
    m, s = (convert.to_device(a, dev)
            for a in synthetic.op_stream(lanes, max_ops, seed=41))
    enc = PlainCheck(pool, sqz4_cuda.encode_full, sqz4_ref.encode_full_ref,
                     (m, s, cw), reps)
    packed = [convert.to_device(a, dev)
              for a in synthetic.stats_stream(lanes, max_ops, seed=42)]
    st = PlainCheck(pool, sqz4_cuda.encode_stats, sqz4_ref.encode_stats_ref,
                    (*packed, cw), reps)
    out = {}
    for name, chk, nbytes, ops in (
            ("sqz4_encode/synthetic", enc, 2 * m.numel() * 4,
             coded_symbols(convert.to_numpy(m)) * OPS_PER_SYMBOL),
            ("sqz4_encode_stats/synthetic", st, 3 * packed[0].numel() * 4,
             int((packed[2] != 0).sum()) * OPS_PER_STAT)):
        lens = convert.to_numpy(chk.got[1])
        out[name] = chk, bound(nbytes + int(
            lens[:, 0].clip(max=4 * cw).sum()) + lens.nbytes, ops) + (None,)
    return out


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
    st = host.op_stream_stats(data, 1 << win_bits, blk_bits)
    packed = sqz4_cuda.pack_group_stats(st, "cuda", lanes)
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
    value, all fourteen in one launch (``probe.probes``, as
    ``run_probes`` runs them). Times are means of 20 launches: the
    kernel's over the 8 probes one torch call computes
    (``probe_library_calls``), one launch of the 8, beside the 8 library
    calls; the bound and the plain time over the same 8. The launch of
    all fourteen is timed and logged too."""
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import _build, probe
    dev = torch.device("cuda")
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    calls = probe_library_calls(dev)
    items = [(name, *probe.probe_tensors(name, dev)) for name in probe.PROBES]
    gots = dict(zip(probe.PROBES, probe.probes(items)))
    torch.cuda.synchronize()
    plain_ms = lib_ms = 0.0
    nbytes = 0
    for name, a, b in items:
        got = gots[name]
        t = time.perf_counter()
        want = probe.plain(name, a, b)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t) * 1e3
        if max_abs_err([got], [want]) or not (
                convert.to_numpy(got) == probe.expected(name)).all():
            raise AssertionError(f"probe {name} differs from its plain "
                                 f"version or its expected value")
        if name not in calls:
            continue
        if not (calls[name]().cpu().numpy() == probe.expected(name)).all():
            raise AssertionError(f"library call for {name} differs")
        lib_ms += mean_events_ms(calls[name], 20)
        plain_ms += p_ms
        nbytes += sum(x.numel() * x.element_size() for x in (a, b, got)
                      if x is not None)

    def one_launch(names):
        """Mean ms of one launch of the probes ``names`` (outputs checked
        against the batch above)."""
        its = [it for it in items if it[0] in names]
        outs = [torch.empty_like(gots[k]) for k, _a, _b in its]
        args = probe.launch_args(its, outs) + (probe.B, stream)
        if lib.probe_launch(*args):
            raise AssertionError("the timed probe launch failed")
        ms = mean_events_ms(lambda: lib.probe_launch(*args), 20)
        for (k, _a, _b), out in zip(its, outs):
            if not torch.equal(out.view(torch.int32),
                               gots[k].view(torch.int32)):
                raise AssertionError(f"timed probe {k} differs")
        return ms

    all_ms, kms = one_launch(set(probe.PROBES)), one_launch(set(calls))
    log(f"probes: one launch of all {len(probe.PROBES)} {all_ms:.4f} ms, "
        f"of the {len(calls)} with a library call {kms:.4f} ms (library "
        f"{lib_ms:.4f} ms over {len(calls)} calls)")
    return (0, kms, plain_ms) + bound(nbytes, 0) + (lib_ms,)


def sm_clock_under_load(fn):
    """(clocks.sm, clocks.max.sm) in MHz, read by nvidia-smi while fn runs
    back to back on the card."""
    import torch
    out = {}

    def query():
        out["smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout
    th = threading.Thread(target=query)
    th.start()
    while th.is_alive():
        fn()
        torch.cuda.synchronize()
    th.join()
    sm, mx = (float(x) for x in out["smi"].splitlines()[0].split(","))
    return sm, mx


def chain_figures(inputs, blk_bits, win_bits, reps):
    """The coders' chains: the op-stream encoder (exact parse), the decoder
    (on its payloads) and the token encoder (fast parse) timed by CUDA
    events on one group of each input of ``inputs`` ({name: bytes}), and
    the stats-fed encoder on the statistics of the texty input's first
    512 blocks of 2^STATS_BITS bytes, with ns and SM cycles per coded
    symbol (mean symbols a block; every launch holds one chain per block).
    The payloads must equal the native engine's for the same parse and
    the decoder must restore the blocks; no plain version runs here."""
    import numpy as np
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    dev = torch.device("cuda")
    bs = 1 << blk_bits
    cw = host.cap_words_for(bs + 2048)
    res = {}
    for name, data in inputs.items():
        nb = len(data) // bs
        mw, sw, mx = native.sqz4_plan_pack(data, 1 << win_bits, blk_bits,
                                           True, nb,
                                           host.op_stream_cap(blk_bits))
        rows = -(-int(mx) // 4)
        m, s = convert.encoder_inputs(mw, sw, rows, dev)
        words, lens = sqz4_cuda.encode_full(m, s, cw)
        payloads = host.unpack_group_payloads(
            convert.to_numpy(words), convert.to_numpy(lens), nb)
        if payloads != native.blocks_compress(data, 1, win_bits, blk_bits):
            raise AssertionError(f"{name}: encoder payloads differ from "
                                 f"native")
        ops = mw[:, :rows].astype(">u4").view(np.uint8)
        enc_sym = coded_symbols(mw[:, :rows]) / nb
        dec_sym = int((ops < 36).sum()) / nb
        timed = {"sqz4_encode": (lambda: sqz4_cuda.encode_full(m, s, cw),
                                 enc_sym)}

        plan = host.plan_decode_dispatch(nb, blk_bits, lanes=nb)
        pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
        buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, nb,
                                           plan["G"], pw)
        pt, mt = convert.decoder_inputs(buf, meta, dev)
        args = (pt, mt, plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
        got = sqz4_cuda.decode(*args)
        outs = host.postprocess_decode(*[convert.to_numpy(x) for x in got],
                                       payloads, [bs] * nb, bs)
        if b"".join(outs) != data:
            raise AssertionError(f"{name}: the decoder did not restore the "
                                 f"blocks")
        timed["sqz4_decode"] = (lambda: sqz4_cuda.decode(*args), dec_sym)

        grp = sqz4_cuda.plan_tok_group(data, blk_bits, 1 << win_bits, True)
        if grp.over:
            raise AssertionError(f"{name}: blocks over the token caps")
        toks = grp.toks.to(dev).view(torch.uint32)
        lits = grp.lits.to(dev)
        fast = native.blocks_compress(data, 1, win_bits, blk_bits,
                                      parse="fast")
        tok_sym = tok_symbols(grp.toks.numpy().view(np.uint32)) / nb
        tw, tl = sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw)
        tpay = host.unpack_group_payloads(convert.to_numpy(tw),
                                          convert.to_numpy(tl), nb)
        if any(tpay[i] != fast[b] for i, b in enumerate(grp.fit)):
            raise AssertionError(f"{name}: token encoder payloads differ "
                                 f"from the native fast parse")
        timed["sqz4_encode_tok"] = (
            lambda: sqz4_cuda.encode_tok(toks, lits, grp.t_max, cw), tok_sym)
        if name == "texty":
            timed["sqz4_encode_stats"] = stats_chain(data, win_bits)

        for key, (fn, sym) in timed.items():
            ms = events_ms(fn, reps)
            res[f"{key}/{name}"] = dict(ms=ms, symbols_per_block=sym,
                                        ns_per_symbol=ms * 1e6 / sym)
        res[f"sm_clock_MHz/{name}"] = sm_clock_under_load(
            timed["sqz4_encode"][0])
    for key, v in res.items():
        if key.startswith("sm_clock"):
            continue
        sm, mx = res["sm_clock_MHz/" + key.split("/")[1]]
        v["cycles_per_symbol"] = v["ns_per_symbol"] * sm / 1e3
        v["cycles_per_symbol_at_max_clock"] = v["ns_per_symbol"] * mx / 1e3
    log("chain figures (ms; symbols a block; ns and SM cycles a symbol, at "
        "the clock read under load and at the maximum clock): "
        + json.dumps(res))
    return res


def stats_chain(data, win_bits):
    """(launch, mean coded symbols a block) of the stats-fed encoder on the
    statistics of the first 512 blocks of 2^STATS_BITS bytes of ``data``;
    its payloads must equal the native engine's."""
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    part = data[:host.LANES << STATS_BITS]
    st = host.op_stream_stats(part, 1 << win_bits, STATS_BITS)
    packed = sqz4_cuda.pack_group_stats(st, "cuda")
    cw = host.cap_words_for((1 << STATS_BITS) + 2048)
    words, lens = sqz4_cuda.encode_stats(*packed, cw)
    if host.unpack_group_payloads(convert.to_numpy(words),
                                  convert.to_numpy(lens), host.LANES) != \
            native.blocks_compress(part, 1, win_bits, STATS_BITS):
        raise AssertionError("stats-fed encoder payloads differ from "
                             "native")
    return (lambda: sqz4_cuda.encode_stats(*packed, cw),
            int((st[2] != 0).sum()) / host.LANES)


def chain_inputs(texty=None):
    """The chain figures' inputs: one 512-block group of 64 KiB of the
    pseudo-text (``texty``, made here if None) and of random bytes (the
    literal-heavy mix)."""
    from sqz_tpu_torch.utils import corpus
    return {"texty": texty or corpus.texty(MAIN_BYTES, seed=1),
            "random": corpus.random_bytes(MAIN_BYTES, seed=1)}


def main_path():
    """Phase 4: the one-group main path through the public API."""
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
    log(f"one-group main path, 32 MiB in 64 KiB blocks: exact enc "
        f"{enc_s:.3f} s ({mb / enc_s:.1f} MB/s) dec {dec_s:.3f} s "
        f"({mb / dec_s:.1f} MB/s) ratio {len(blob) / len(data):.4f}; fast "
        f"enc {fenc_s:.3f} s ({mb / fenc_s:.1f} MB/s) dec {fdec_s:.3f} s "
        f"({mb / fdec_s:.1f} MB/s) ratio {len(fblob) / len(data):.4f}")
    log(f"launches over the one-group main path: {launches}")
    return data, blob, fblob, launches, dict(
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


def timed_call(fn, profiled=False):
    """(``fn()``'s result, wall seconds, card-busy ms or None) of one
    call; ``profiled``: the card's busy time (kernels and copies,
    torch.profiler) over the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not profiled:
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t, None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return out, wall, busy


def timed_compress(data, profiled=False, **kw):
    """``timed_call`` of one default ``compress`` (64 KiB blocks, ``kw``
    added)."""
    import sqz_tpu_torch
    return timed_call(lambda: sqz_tpu_torch.compress(
        data, blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS, **kw), profiled)


# the pipelined phase's runs, timed in turns (A B B A)
PIPE_ORDER = ("pipeline", "serial", "serial", "pipeline")


def pipelined_path():
    """Phase 5: 128 MiB (4 groups) through the defaults: the pipeline with
    the token and compaction kernels, against the serial path (the
    op-stream kernel in one launch, ``sqz4_cuda.encode_data_full``)."""
    import hashlib
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
    blob, _s, _b = timed_compress(data)
    t = time.perf_counter()
    out = sqz_tpu_torch.decompress(blob)
    dec_s = time.perf_counter() - t
    launches = {"sqz4_encode": sqz4_cuda.encode_full.launches,
                "sqz4_encode_tok": sqz4_cuda.encode_tok.launches,
                "sqz4_compact": sqz4_cuda.compact_words.launches,
                "sqz4_decode": sqz4_cuda.decode.launches}
    log(f"launches over the pipelined main path: {launches}")
    log(f"128 MiB container: {len(blob)} B, sha256 "
        f"{hashlib.sha256(blob).hexdigest()}")
    if out != data:
        raise AssertionError("pipelined round trip failed")
    if min(launches["sqz4_encode_tok"], launches["sqz4_compact"]) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    payloads = container.unpack(blob)[4]
    if native.blocks_decompress(payloads, len(data), 1, MAIN_BITS) != data:
        raise AssertionError("native engine cannot decode the pipelined "
                             "container")

    def serial():
        return sqz4_cuda.encode_data_full(
            data, MAIN_BITS, 1 << MAIN_WIN_BITS, True,
            (1 << MAIN_BITS) + 2048, parse="fast")

    runs = {"pipeline": (lambda: sqz_tpu_torch.compress(
                data, blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS), blob),
            "serial": (serial, payloads)}
    walls = {k: [] for k in runs}
    for name in PIPE_ORDER:
        fn, want = runs[name]
        other, wall, _b = timed_call(fn)
        if other != want:
            raise AssertionError(f"the {name} payloads differ from the "
                                 f"pipeline's container")
        walls[name].append(wall)
    busy = {k: timed_call(fn, profiled=True)[1:]
            for k, (fn, _w) in runs.items()}
    st = {}
    pipeline.encode_data_pipelined(data, MAIN_BITS, 1 << MAIN_WIN_BITS,
                                   True, (1 << MAIN_BITS) + 2048, stats=st)
    mb = len(data) / 1e6
    log("128 MiB encode wall (s), in turns "
        + " ".join(PIPE_ORDER) + ": " + json.dumps(
            {k: [round(w, 4) for w in v] for k, v in walls.items()}))
    log("128 MiB encode under torch.profiler (wall s, card busy ms, "
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
    _b, wall, busy = timed_compress(data, profiled=True, fmt="squeeze")
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
    if stats_launches < 1 or probe_launches != 1:
        raise AssertionError("a kernel was not launched (or the probes not "
                             f"in one launch): {stats_launches}, "
                             f"{probe_launches}")
    log(f"encode_groups, 512 x 16 KiB of statistics: {enc_s:.3f} s, "
        f"launches {stats_launches}; probes all equal, launches "
        f"{probe_launches}")
    return {"sqz4_encode_stats": stats_launches, "probe": probe_launches}


def warm_path(data, cold_blob):
    """Phase 9: sqz4 warm start (sqzt v2) on the 32 MiB input, exact and
    fast parse, against the native copy; the seeded kernels' launches
    counted over the run."""
    import sqz_tpu_torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.formats.constants import (SQZT_FORMAT_SQZ4,
                                                 warm_dictionary)
    from sqz_tpu_torch.ops import sqz4_cuda
    t = time.perf_counter()
    wpay, wfresh = native.blocks_compress(data, 1, MAIN_WIN_BITS, MAIN_BITS,
                                          warm=True)
    ref = container.pack(SQZT_FORMAT_SQZ4, MAIN_WIN_BITS, MAIN_BITS,
                         len(data), wpay, container.fnv1a64(data),
                         warm=True, fresh_mask=wfresh)
    log(f"sqz4 warm native reference: {time.perf_counter() - t:.1f} s")
    kw = dict(blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS, warm=True)
    sqz4_cuda.encode_full.seeded_launches = 0
    sqz4_cuda.decode.seeded_launches = 0
    runs = {}
    for parse in ("exact", "fast"):
        t = time.perf_counter()
        blob = sqz_tpu_torch.compress(data, parse=parse, **kw)
        enc_s = time.perf_counter() - t
        t = time.perf_counter()
        out = sqz_tpu_torch.decompress(blob)
        runs[parse] = (blob, enc_s, time.perf_counter() - t)
        if out != data:
            raise AssertionError(f"sqz4 warm {parse} round trip failed")
    launches = {"sqz4_encode_seeded": sqz4_cuda.encode_full.seeded_launches,
                "sqz4_decode_seeded": sqz4_cuda.decode.seeded_launches}
    log(f"launches over the sqz4 warm path: {launches}")
    if runs["exact"][0] != ref:
        raise AssertionError("sqz4 warm exact container differs from the "
                             "native copy's")
    fblob = runs["fast"][0]
    if native.blocks_decompress(container.unpack(fblob)[4], len(data), 1,
                                MAIN_BITS, fresh_mask=container.unpack(
                                    fblob)[6], win_bits=MAIN_WIN_BITS) \
            != data:
        raise AssertionError("native copy cannot decode the sqz4 warm "
                             "fast-parse container")
    if min(launches.values()) < 1:
        raise AssertionError(f"a seeded kernel was not launched: "
                             f"{launches}")
    mb = len(data) / 1e6
    log(f"sqz4 warm path, {len(data) >> 20} MiB in 64 KiB blocks: "
        + "; ".join(
        f"{k} enc {e:.3f} s ({mb / e:.1f} MB/s) dec {d:.3f} s "
        f"({mb / d:.1f} MB/s) ratio {len(b) / len(data):.4f}"
        for k, (b, e, d) in runs.items())
        + f"; cold exact ratio {len(cold_blob) / len(data):.4f}; warm "
        f"blocks {wfresh.count(False)} of {len(wfresh)}")
    # one run's stages of the seeded device pass and the seeded decode
    bs = 1 << MAIN_BITS
    enc_st, dec_st = {}, {}
    warm_p = sqz4_cuda.encode_data_full(
        data, MAIN_BITS, 1 << MAIN_WIN_BITS, True, bs + 2048, parse="exact",
        warm=True, stats=enc_st)
    _b0, seed = native.sqz4_decompress_payload(warm_p[0], bs,
                                               return_state=True)
    sqz4_cuda.decode_groups(warm_p[1:], [bs] * (len(warm_p) - 1), MAIN_BITS,
                            stats=dec_st, seed=seed, dictionary=
                            warm_dictionary(data[:bs], MAIN_WIN_BITS))
    log("sqz4 warm stages (s): seeded device pass " + json.dumps(
        {k: round(v, 4) for k, v in enc_st.items()}) + "; seeded decode of "
        "blocks 1+ " + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))
    return launches, {
        **{f"warm_{k}_enc_MBps": mb / e for k, (_, e, _) in runs.items()},
        **{f"warm_{k}_dec_MBps": mb / d for k, (_, _, d) in runs.items()},
        **{f"warm_{k}_ratio": len(b) / len(data)
           for k, (b, _, _) in runs.items()}}


def anchored_input():
    """Four turns of pseudo-text (two blocks), random bytes (one), runs
    (three) and pseudo-text of another seed (one), 64 KiB blocks: the v3
    planner anchors warm blocks on several fresh ones."""
    from sqz_tpu_torch.utils import corpus
    b = 1 << MAIN_BITS
    return b"".join(corpus.texty(2 * b, seed=10 + k)
                    + corpus.random_bytes(b, seed=20 + k)
                    + corpus.rle4(3 * b) + corpus.texty(b, seed=30 + k)
                    for k in range(4))


def anchored_path():
    """Phase 10: anchored warm start (sqzt v3), both formats: round trip,
    and one seeded decoder launch per anchor (sqz4)."""
    import sqz_tpu_torch
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import sqz4_cuda
    data = anchored_input()
    out = {}
    for fmt in ("sqz4", "squeeze"):
        t = time.perf_counter()
        blob = sqz_tpu_torch.compress(data, fmt=fmt, warm="anchors",
                                      blk_bits=MAIN_BITS,
                                      win_bits=MAIN_WIN_BITS)
        enc_s = time.perf_counter() - t
        *_, fresh, anch = container.unpack(blob)
        anchors = {a for a in container.resolve_anchors(fresh, anch)
                   if a is not None}
        sqz4_cuda.decode.seeded_launches = 0
        t = time.perf_counter()
        res = sqz_tpu_torch.decompress(blob)
        dec_s = time.perf_counter() - t
        seeded = sqz4_cuda.decode.seeded_launches
        if res != data:
            raise AssertionError(f"{fmt} anchored round trip failed")
        if len(anchors) < 2 or not any(anch):
            raise AssertionError(f"{fmt}: the planner chose one anchor")
        if fmt == "sqz4" and seeded != len(anchors):
            raise AssertionError(f"{seeded} seeded decoder launches for "
                                 f"{len(anchors)} anchors")
        log(f"{fmt} anchored, {len(data) / 2**20:.2f} MiB in 64 KiB blocks:"
            f" enc {enc_s:.3f} s dec {dec_s:.3f} s ratio "
            f"{len(blob) / len(data):.4f}; anchors {sorted(anchors)}, warm "
            f"blocks {fresh.count(False)} of {len(fresh)}, seeded decoder "
            f"launches {seeded}")
        out[f"{fmt}_anchors"] = len(anchors)
        out[f"{fmt}_anchored_ratio"] = len(blob) / len(data)
    return out


def wide_ref(data, blk_bits, warm=False):
    """The native copy's exact-parse container of ``data`` (cold, or warm
    sqzt v2)."""
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
    res = native.blocks_compress(data, 1, MAIN_WIN_BITS, blk_bits, warm=warm,
                                 parse="exact")
    payloads, fresh = res if warm else (res, None)
    return container.pack(SQZT_FORMAT_SQZ4, MAIN_WIN_BITS, blk_bits,
                          len(data), payloads, container.fnv1a64(data),
                          warm=warm, fresh_mask=fresh)


def wide_round_trip(data, blk_bits, engine="torch", **kw):
    """(container, enc s, dec s) of ``data`` at ``blk_bits`` through
    ``compress`` / ``decompress`` on ``engine``, exact parse; raises
    unless the bytes come back."""
    import sqz_tpu_torch
    kw = dict(blk_bits=blk_bits, win_bits=MAIN_WIN_BITS, parse="exact",
              engine=engine, **kw)
    t = time.perf_counter()
    blob = sqz_tpu_torch.compress(data, **kw)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    out = sqz_tpu_torch.decompress(blob, engine=engine)
    dec_s = time.perf_counter() - t
    if out != data:
        raise AssertionError(f"blk_bits {blk_bits} {engine} round trip "
                             f"failed")
    return blob, enc_s, dec_s


def wide_kernel_inputs(data, blk_bits):
    """The route's one group for ``data`` on the card (the route's
    ``group_lanes`` wide): the stats-fed encoder's inputs and capacity,
    the block sizes and the coded ops."""
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    bs = 1 << blk_bits
    sizes = [len(data[o:o + bs]) for o in range(0, len(data), bs)]
    cols = host.op_stream_stats(data, 1 << MAIN_WIN_BITS, blk_bits)
    inputs = sqz4_cuda.pack_group_stats(cols, "cuda",
                                        host.group_lanes(len(sizes)))
    return (inputs, host.cap_words_for(2 * max(sizes) + 4096), sizes,
            int((cols[2] != 0).sum()))


def wide_decode_inputs(payloads, sizes, blk_bits, lanes):
    """The decoder's inputs for one group of the route, sized from the
    largest block: (payload, meta, t_max, lw, tw, mw)."""
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_host as host
    plan = host.plan_decode_dispatch(len(payloads), blk_bits, lanes,
                                     max(sizes))
    pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
    buf, meta = host.pack_decode_chunk(payloads, sizes, lanes, plan["G"],
                                       pw)
    return convert.decoder_inputs(buf, meta, "cuda") + (
        plan["t_max"], plan["lw"], plan["tw"], plan["mw"])


def wide_kernels(data, blk_bits, pool=None):
    """Both kernels at the route's shapes for ``data`` (one group): the
    payloads equal the native copy's, the blocks restore. Returns per
    kernel (CUDA-event ms, bound ms, bound_by) and, with ``pool``, per
    kernel its PlainCheck against the plain version on the same inputs
    (in a worker of ``pool``)."""
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
    inputs, cw, sizes, coded = wide_kernel_inputs(data, blk_bits)
    lanes = inputs[0].shape[2]
    checks = {}
    if pool is not None:
        checks["sqz4_encode_stats"] = PlainCheck(
            pool, sqz4_cuda.encode_stats, sqz4_ref.encode_stats_ref,
            (*inputs, cw), 1)
    words, lens = sqz4_cuda.encode_stats(*inputs, cw)
    payloads = sqz4_cuda.fetch_payloads(words, lens, len(sizes))
    if payloads != native.blocks_compress(data, 1, MAIN_WIN_BITS, blk_bits):
        raise AssertionError(f"blk_bits {blk_bits}: stats-fed encoder "
                             f"payloads differ from native")
    enc_ms = events_ms(lambda: sqz4_cuda.encode_stats(*inputs, cw), REPS)
    lens_np = convert.to_numpy(lens)
    enc = (enc_ms,) + bound(3 * inputs[0].numel() * 4
                            + int(lens_np[0, 0].sum()) + lens_np.nbytes,
                            coded * OPS_PER_STAT)
    dargs = wide_decode_inputs(payloads, sizes, blk_bits, lanes)
    if pool is not None:
        checks["sqz4_decode"] = PlainCheck(pool, sqz4_cuda.decode,
                                           sqz4_ref.decode_ref, dargs, 1)
    res = sqz4_cuda.decode(*dargs)
    outs = host.postprocess_decode(*[convert.to_numpy(x) for x in res],
                                   payloads, sizes, max(sizes))
    if b"".join(outs) != data:
        raise AssertionError(f"blk_bits {blk_bits}: decoder kernel did not "
                             f"restore the blocks")
    dec_ms = events_ms(lambda: sqz4_cuda.decode(*dargs), REPS)
    cnt = convert.to_numpy(res[3])
    out_bytes = int(cnt[:, 1].sum() + (cnt[:, 2].sum() + 7) // 8
                    + 4 * cnt[:, 3].sum()) + cnt.nbytes
    dec = (dec_ms,) + bound(dargs[0].numel() * 4 + dargs[1].numel() * 4
                            + out_bytes, coded * OPS_PER_SYMBOL)
    return {"sqz4_encode_stats": enc, "sqz4_decode": dec}, checks


def wide_input():
    """4 MiB in 128 KiB blocks: four turns of pseudo-text (two blocks),
    random bytes (one), runs (three) and pseudo-text of another seed (one),
    then four blocks of pseudo-text: warm blocks for v2, several anchors
    for v3."""
    from sqz_tpu_torch.utils import corpus
    b = 1 << WIDE_WARM_BITS
    return b"".join(corpus.texty(2 * b, seed=10 + k)
                    + corpus.random_bytes(b, seed=20 + k)
                    + corpus.rle4(3 * b) + corpus.texty(b, seed=30 + k)
                    for k in range(4)) + corpus.texty(4 * b, seed=40)


def wide_path(data, pool):
    """Phase 11: sqz4 above 64 KiB blocks on the card (the reference's scan
    route: exact tokens and model statistics on the host, the stats-fed
    encoder, the decoder cold and seeded). Every container equals the
    native copy's, every round trip holds; the route's counter and both
    kernels' launch counts over the API calls are > 0, the seeded
    decoder's too. Returns (launches, e2e numbers, plain checks)."""
    import sqz_tpu_torch
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import engine, sqz4_cuda, sqz4_host as host
    from sqz_tpu_torch.utils import corpus
    t0 = time.perf_counter()
    reset_launches()
    engine.wide_blocks = host.host_decode.blocks = 0
    out, turns, checks = {}, {}, {}
    # 32 MiB of the pseudo-text at 128 KiB and 1 MiB blocks, card and
    # native engine in turns
    for bits in WIDE_BITS:
        ref = wide_ref(data, bits)
        runs = {"card": [], "native": []}
        for who in ("card", "native", "native", "card"):
            blob, enc_s, dec_s = wide_round_trip(
                data, bits, "native" if who == "native" else "torch")
            if blob != ref:
                raise AssertionError(f"blk_bits {bits} {who} container "
                                     f"differs from the native copy's")
            runs[who].append((enc_s, dec_s))
        turns[bits] = runs
    # two blocks of random bytes at 256 KiB: literal models past 2^17
    rnd = corpus.random_bytes(2 << WIDE_RANDOM_BITS, seed=3)
    if wide_round_trip(rnd, WIDE_RANDOM_BITS)[0] != wide_ref(
            rnd, WIDE_RANDOM_BITS):
        raise AssertionError("random bytes container differs from the "
                             "native copy's")
    # warm (v2) and anchored (v3) at 128 KiB blocks
    warm_in = wide_input()
    wblob, wenc, wdec = wide_round_trip(warm_in, WIDE_WARM_BITS, warm=True)
    if wblob != wide_ref(warm_in, WIDE_WARM_BITS, warm=True):
        raise AssertionError("warm container differs from the native "
                             "copy's")
    v3 = sqz_tpu_torch.compress(warm_in, engine="native",
                                blk_bits=WIDE_WARM_BITS,
                                win_bits=MAIN_WIN_BITS, warm="anchors")
    t = time.perf_counter()
    if sqz_tpu_torch.decompress(v3) != warm_in:
        raise AssertionError("anchored container round trip failed")
    v3dec = time.perf_counter() - t
    # one block of 16 MiB: one lane
    one = data[:1 << WIDE_ONE_BITS]
    oblob, oenc, odec = wide_round_trip(one, WIDE_ONE_BITS)
    if oblob != wide_ref(one, WIDE_ONE_BITS):
        raise AssertionError("one-block container differs from the native "
                             "copy's")
    _nblob, nenc, ndec = wide_round_trip(one, WIDE_ONE_BITS, "native")
    launches = read_launches()
    routed = engine.wide_blocks
    need = ("sqz4_encode_stats", "sqz4_decode", "sqz4_decode_seeded")
    if routed < 1 or any(launches.get(k, 0) < 1 for k in need):
        raise AssertionError(f"the route above 64 KiB did not run: blocks "
                             f"{routed}, launches {launches}")
    fresh = container.unpack(wblob)[6]
    anchors = sum(container.unpack(v3)[7] or [])
    log(f"wide route launches {launches}, blocks {routed}, host decodes "
        f"{host.host_decode.blocks}; warm blocks {fresh.count(False)} of "
        f"{len(fresh)}, v3 anchors {anchors}")
    mb = len(data) / 1e6
    for bits, runs in turns.items():
        log(f"sqz4 blk_bits {bits}, {len(data) >> 20} MiB, "
            f"{len(data) >> bits} lanes, in turns (card native native "
            f"card): " + "; ".join(
                f"{who} enc " + " ".join(f"{mb / e:.1f}" for e, _ in r)
                + " MB/s dec " + " ".join(f"{mb / d:.1f}" for _, d in r)
                + " MB/s" for who, r in runs.items()))
        for who, r in runs.items():
            out[f"wide{bits}_{who}_enc_MBps"] = mb / min(e for e, _ in r)
            out[f"wide{bits}_{who}_dec_MBps"] = mb / min(d for _, d in r)
        enc_st, dec_st = {}, {}
        bs = 1 << bits
        pays = sqz4_cuda.encode_data_stats(data, bits, 1 << MAIN_WIN_BITS,
                                           True, stats=enc_st)
        sqz4_cuda.decode_groups(pays, [bs] * len(pays), bits,
                                lanes=host.group_lanes(len(pays)),
                                stats=dec_st)
        log(f"blk_bits {bits} stages (s): encode " + json.dumps(
            {k: round(v, 4) for k, v in enc_st.items()}) + " decode "
            + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))
        timed, chk = wide_kernels(
            data, bits, pool if bits == WIDE_PLAIN_BITS else None)
        checks.update(chk)
        for k, (ms, bms, by) in timed.items():
            log(f"blk_bits {bits} {k}: {ms:.3f} ms, bound {bms:.4f} ms by "
                f"{by}")
            out[f"wide{bits}_{k}_ms"] = ms
    omb = len(one) / 1e6
    enc_st, dec_st = {}, {}
    pays = sqz4_cuda.encode_data_stats(one, WIDE_ONE_BITS, 1 << MAIN_WIN_BITS,
                                       True, stats=enc_st)
    sqz4_cuda.decode_groups(pays, [len(one)], WIDE_ONE_BITS,
                            lanes=host.group_lanes(1), stats=dec_st)
    log(f"sqz4 blk_bits {WIDE_ONE_BITS}, one block of {len(one) >> 20} MiB"
        f" (one lane): card enc {oenc:.3f} s ({omb / oenc:.2f} MB/s) dec "
        f"{odec:.3f} s ({omb / odec:.2f} MB/s); native enc {nenc:.3f} s "
        f"({omb / nenc:.2f} MB/s) dec {ndec:.3f} s ({omb / ndec:.2f} MB/s);"
        f" stages (s): encode " + json.dumps(
            {k: round(v, 4) for k, v in enc_st.items()}) + " decode "
        + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))
    wmb = len(warm_in) / 1e6
    log(f"sqz4 blk_bits {WIDE_WARM_BITS} warm, {len(warm_in) >> 20} MiB: "
        f"enc {wenc:.3f} s dec {wdec:.3f} s ratio "
        f"{len(wblob) / len(warm_in):.4f}; anchored dec {v3dec:.3f} s "
        f"({wmb / v3dec:.1f} MB/s)")
    out.update(wide1_card_enc_MBps=omb / oenc, wide1_card_dec_MBps=omb / odec,
               wide1_native_enc_MBps=omb / nenc,
               wide1_native_dec_MBps=omb / ndec)
    log(f"wide route phase: {time.perf_counter() - t0:.1f} s")
    return launches, out, checks


def huge_native(seed):
    """In a worker: (the native copy's exact container of the phase's one
    block, seconds)."""
    from sqz_tpu_torch.utils import corpus
    data = corpus.texty(HUGE_BYTES, seed=seed)
    t = time.perf_counter()
    blob = wide_ref(data, HUGE_BITS)
    return blob, time.perf_counter() - t


def huge_block_path(pool):
    """Phase 11's widest block: 2^27 + 4096 bytes of the pseudo-text in one
    block at blk_bits 28 through ``compress`` / ``decompress`` on the card
    (one lane of the route above 64 KiB), equal to the native copy's
    container, which a worker makes meanwhile; the route's counter and both
    kernels' launches > 0; a block above 2^28 bytes raises ValueError
    naming engine="native". Returns the e2e numbers."""
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch.ops import engine
    from sqz_tpu_torch.utils import corpus
    fut = pool.submit(huge_native, HUGE_SEED)
    data = corpus.texty(HUGE_BYTES, seed=HUGE_SEED)
    reset_launches()
    engine.wide_blocks = 0
    blob, enc_s, dec_s = wide_round_trip(data, HUGE_BITS)
    launches = read_launches()
    torch.cuda.empty_cache()
    if engine.wide_blocks < 1 or launches.get("sqz4_encode_stats", 0) < 1 \
            or launches.get("sqz4_decode", 0) < 1:
        raise AssertionError(f"blk_bits {HUGE_BITS}: blocks "
                             f"{engine.wide_blocks}, launches {launches}")
    try:
        sqz_tpu_torch.compress(bytes((1 << HUGE_BITS) + 1),
                               blk_bits=HUGE_BITS + 1,
                               win_bits=MAIN_WIN_BITS)
    except ValueError as e:
        if 'engine="native"' not in str(e):
            raise AssertionError(f"a block above 2^{HUGE_BITS}: {e}")
        log(f"a block of 2^{HUGE_BITS} + 1 bytes raises: {e}")
    else:
        raise AssertionError(f"a block above 2^{HUGE_BITS} bytes was coded")
    ref, native_s = fut.result()
    if blob != ref:
        raise AssertionError(f"blk_bits {HUGE_BITS} container differs from "
                             f"the native copy's")
    mb = len(data) / 1e6
    log(f"sqz4 blk_bits {HUGE_BITS}, one block of {len(data)} B: card enc "
        f"{enc_s:.3f} s ({mb / enc_s:.2f} MB/s) dec {dec_s:.3f} s "
        f"({mb / dec_s:.2f} MB/s), launches {launches}; the native copy's "
        f"container (a worker) {native_s:.3f} s, equal; ratio "
        f"{len(blob) / len(data):.4f}")
    return {"huge28_card_enc_MBps": mb / enc_s,
            "huge28_card_dec_MBps": mb / dec_s,
            "huge28_native_enc_s": native_s}


def ckpt_stream(dev, nbytes):
    """The first ``nbytes`` of the stream ``save_pytree`` codes for GPT-2
    small's AdamW state (phase 13's), on the card."""
    import torch
    from sqz_tpu_torch.utils import checkpoint
    state = gpt2_small_state(dev)
    stream = checkpoint.filtered_stream(state, device=dev)[0][:nbytes]
    stream = stream.clone()
    del state
    torch.cuda.empty_cache()
    return stream


def lit_skip_split(rows):
    """The coder's and the producer's split (tok_timeline.split) of one
    launch of the counting build on ``rows`` (toks, blocks, t_max,
    cap_words)."""
    import numpy as np
    tt = tok_timeline()
    lib = TIMELINE["clocks"]
    st = tt.clocks(lib, rows, lib.threads)
    return tt.split(st, np.arange(st.shape[0]))


def lit_skip_figures(pool, card, mix):
    """Phase 12's lit_skip figures at its two shapes, one 512-lane group of
    64 KiB blocks each: the checkpoint's first group (phase 13's stream)
    against its plain version (in a worker) and against the cold kernel
    on host-compacted literals, the first three groups in one launch (the
    save's launches) equal to one launch a group; then, on that group and
    on the resident mix's rle group (``mix``, a CUDA tensor), the coder
    warp's and the producer warp's split in SM cycles (the counting
    build), and ns and SM cycles a coded op of the longest lane. Returns
    (the checkpoint group's PlainCheck, its bound entries, figures)."""
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_ref
    tt = tok_timeline()
    dev = torch.device("cuda")
    groups = 3
    stream = ckpt_stream(dev, groups << (MAIN_BITS + 9))
    ck3 = tt.rle_rows(stream, groups)
    del stream
    toks, blocks = ck3[0][:1].contiguous(), ck3[1][:1].contiguous()
    ck1 = (toks, blocks, ck3[2], ck3[3])
    chk = PlainCheck(pool, sqz4_cuda.encode_tok, sqz4_ref.encode_tok_ref,
                     (toks, blocks, ck3[2], ck3[3], True), REPS)
    cold = sqz4_cuda.encode_tok(
        toks, sqz4_ref.skip_literal_rows(toks, blocks).to(dev), ck3[2],
        ck3[3])
    if max_abs_err(chk.got, cold):
        raise AssertionError("lit_skip differs from the cold mode on the "
                             "checkpoint group's compacted literals")
    # three groups a launch, as the save hands them over
    w3, l3 = sqz4_cuda.encode_tok(*ck3[:4], lit_skip=True)
    ms3 = events_ms(lambda: sqz4_cuda.encode_tok(*ck3[:4], lit_skip=True),
                    REPS)
    for g in range(groups):
        one = sqz4_cuda.encode_tok(ck3[0][g:g + 1].contiguous(),
                                   ck3[1][g:g + 1].contiguous(), ck3[2],
                                   ck3[3], lit_skip=True)
        if max_abs_err([w3[g:g + 1], l3[g:g + 1]], one):
            raise AssertionError(f"checkpoint group {g} differs between "
                                 f"one launch a group and three a launch")
    del w3, l3
    toks_np = convert.to_numpy(toks)
    lens_np = convert.to_numpy(chk.got[1])
    extra = bound(toks.numel() * 4 + tok_literal_bytes(toks_np)
                  + int(lens_np[:, 0].sum()) + lens_np.nbytes,
                  tok_symbols(toks_np) * OPS_PER_SYMBOL) + (None,)
    mix1 = tt.rle_rows(mix, 1)
    sm, mx = sm_clock_under_load(
        lambda: sqz4_cuda.encode_tok(*mix1[:4], lit_skip=True))
    fig = {"lit_skip_ckpt_group_ms": chk.ms,
           "lit_skip_ckpt_3groups_ms": ms3,
           "lit_skip_ckpt_ms_a_group_at_3": ms3 / groups}
    for name, rows in (("mix_rle", mix1), ("ckpt", ck1), ("ckpt_x3", ck3)):
        sp = lit_skip_split(rows)
        top = sp["longest"]
        c = top["coder"]
        ms = chk.ms if name == "ckpt" else ms3 if name == "ckpt_x3" else \
            events_ms(lambda: sqz4_cuda.encode_tok(*mix1[:4], lit_skip=True),
                      REPS)
        ns = ms * 1e6 / max(c["ops"], 1)
        fig.update({f"lit_skip_{name}_coder_wait_share":
                    c["wait"] / top["coder_total"],
                    f"lit_skip_{name}_coder_code_share":
                    c["code"] / top["coder_total"],
                    f"lit_skip_{name}_code_cycles_per_op":
                    top["code_cycles_per_op"],
                    f"lit_skip_{name}_producer_fill_cycles_per_op":
                    top["producer_fill_cycles_per_op"],
                    f"lit_skip_{name}_ns_per_op": ns,
                    f"lit_skip_{name}_cycles_per_op": ns * sm / 1e3})
        log(f"lit_skip split, {name} ({rows[0].shape[0]} x 512 lanes; the "
            f"longest lane, {int(c['ops'])} ops; {card}): coder wait "
            f"{100 * c['wait'] / top['coder_total']:.2f}% code "
            f"{100 * c['code'] / top['coder_total']:.2f}% hand "
            f"{100 * c['hand'] / top['coder_total']:.2f}%, "
            f"{top['code_cycles_per_op']:.1f} SM cycles a coded op in the "
            f"coder; producer fill {top['producer_fill_cycles_per_op']:.1f} "
            f"cycles an op; kernel {ms:.3f} ms, {ns:.1f} ns "
            f"({ns * sm / 1e3:.1f} cycles at {sm:.0f} MHz, max {mx:.0f}) a "
            f"coded op of the longest lane")
    log(f"lit_skip at the checkpoint's first group (512 x 64 KiB; {card}): "
        f"{chk.ms:.3f} ms, bound {extra[0]:.4f} ms by {extra[1]}; three "
        f"groups in one launch {ms3:.3f} ms ({ms3 / groups:.3f} ms a group)")
    return chk, extra, fig


def cell_check(pool, blob):
    """The cell assembly kernel against its plain version (in a worker of
    ``pool``, see PlainCheck) on the decoder's outputs of the first group
    of ``blob``'s payloads, as ``decompress_resident`` gives them to it.
    Returns (PlainCheck, bound and library entries); the kernel's time is
    the mean of 20 launches."""
    import numpy as np
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import resident, sqz4_host as host
    dev = torch.device("cuda")
    blk_bits, _osize, payloads, sizes = resident.unpack_cold_container(blob)
    bs, lanes = 1 << blk_bits, host.LANES
    dargs = resident.decoder_args(blk_bits, lanes)
    buf, plens, szs, _over = resident.pack_payload_group(
        payloads[:lanes], sizes[:lanes], dargs["Pw"], lanes)
    # int32 sizes: the plain version's worker takes u8 / i32 / u32 arrays
    szs_d = torch.from_numpy(szs.astype(np.int32)).to(dev)
    outs = resident.run_decoder(convert.to_device(buf, dev),
                                torch.from_numpy(plens).to(dev), szs_d,
                                dargs)
    args = (*outs, szs_d, bs)
    chk = PlainCheck(pool, resident.assemble_cells,
                     resident.assemble_cells_ref, args, REPS)
    chk.ms = mean_events_ms(lambda: resident.assemble_cells(*args), 20)
    # what the walk and the fill need: the literal words, the token-bit
    # words up to ntok, the match records, the counts and sizes in; the
    # blocks and flags out
    cnt = convert.to_numpy(outs[3])[0].astype(np.int64)
    nbytes = (4 * (-(-cnt[1] // 4)).sum() + 4 * (-(-cnt[2] // 32)).sum()
              + 4 * cnt[3].sum() + cnt.size * 4 + 4 * lanes
              + lanes * bs + lanes)
    return chk, bound(int(nbytes), 0) + (None,)


def resident_input():
    """resident-blk16-mix-32MiB: 512 blocks of 64 KiB (one group) of
    ``synthetic.resident_mix`` (sparse float32 weights, periodic content
    of periods 1..128, repeated cells, pseudo-text, random bytes; the last
    block a third long), standing for checkpoint and activation buffers."""
    from sqz_tpu_torch.utils import synthetic
    return synthetic.resident_mix(RESIDENT_BLOCKS, MAIN_BITS, seed=1)


def resident_path(card, texty, fblob, pool):
    """Phase 12: the resident paths on the resident mix, uploaded once as
    a CUDA tensor: ``compress_resident`` in modes lit, rle and lz, and
    ``decompress_resident`` (auto) of each container and of phase 4's
    fast-parse ``compress`` container of ``texty``, with the launches and
    the restore routes counted over that run; then the checks. Returns
    (launches, end-to-end figures, the lit_skip kernel's PlainCheck and
    its bound and library entries, the same for the cell assembly): the
    plain versions run in workers of ``pool`` at the rle path's full
    shape (the cell assembly's on the rle and the lz containers)."""
    import numpy as np
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import lzparse, resident, sqz4_cuda
    from sqz_tpu_torch.ops import sqz4_host as host, sqz4_ref
    dev = torch.device("cuda")
    bs = 1 << MAIN_BITS
    t = time.perf_counter()
    data = resident_input()
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    torch.cuda.synchronize()
    log(f"resident input, {len(data) / 2**20:.2f} MiB: "
        f"{time.perf_counter() - t:.1f} s")
    reset_launches()
    blobs, walls, routes, outs = {}, {}, {}, {}
    for mode in ("lit", "rle", "lz"):
        t = time.perf_counter()
        blobs[mode] = sqz_tpu_torch.compress_resident(x, blk_bits=MAIN_BITS,
                                                      mode=mode)
        walls[f"enc_{mode}"] = time.perf_counter() - t
    blobs["compress"] = fblob
    for name, blob in blobs.items():
        before = dict(resident.route_lanes)
        t = time.perf_counter()
        outs[name] = sqz_tpu_torch.decompress_resident(blob)
        torch.cuda.synchronize()
        walls[f"dec_{name}"] = time.perf_counter() - t
        routes[name] = {k: resident.route_lanes[k] - before[k]
                        for k in before}
    launches = {k: read_launches().get(k, 0) for k in (
        "sqz4_encode_tok", "sqz4_encode_tok_lit_skip", "sqz4_decode",
        "sqz4_compact", "sqz4_cell_assembly")}
    log(f"launches over the resident paths: {launches}; restore routes "
        f"(lanes): {json.dumps(routes)}")

    # the checks: round trips, the restored tensors, the routes
    nb = -(-len(data) // bs)
    for name, blob in blobs.items():
        want = texty if name == "compress" else data
        if name != "compress" and (
                sqz_tpu_torch.decompress(blob) != data
                or native.blocks_decompress(container.unpack(blob)[4],
                                            len(data), 1, MAIN_BITS) != data):
            raise AssertionError(f"resident {name} container does not "
                                 f"round-trip")
        out = outs[name]
        if not out.is_cuda or out.cpu().numpy().tobytes() != want:
            raise AssertionError(f"decompress_resident of the {name} "
                                 f"container differs from its input")
    blocks_of = {"lit": nb, "rle": nb, "lz": nb, "compress": len(texty) // bs}
    if any(r["host"] for r in routes.values()) or any(
            sum(r.values()) != blocks_of[k] for k, r in routes.items()):
        raise AssertionError(f"restore routes: {routes}")
    if routes["lit"]["cell"] != nb or routes["rle"]["cell"] != nb \
            or routes["compress"]["general"] != blocks_of["compress"] \
            or routes["lz"]["general"] < 1:
        raise AssertionError(f"restore routes: {routes}")
    # lz lanes without a match are cell-parsed, which "auto" restores by
    # the cell assembly; the general assembly restores every lane
    before = dict(resident.route_lanes)
    out = sqz_tpu_torch.decompress_resident(blobs["lz"], assembly="general")
    if out.cpu().numpy().tobytes() != data or \
            resident.route_lanes["general"] - before["general"] != nb:
        raise AssertionError("general assembly of the lz container")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the resident paths was not "
                             f"launched: {launches}")
    code, wb, bb, osize, payloads, csum, _f, _a = container.unpack(
        blobs["rle"])
    p = bytearray(payloads[CORRUPT_BLOCK])
    p[len(p) // 2] ^= 0xFF
    payloads[CORRUPT_BLOCK] = bytes(p)
    try:
        sqz_tpu_torch.decompress_resident(container.pack(
            code, wb, bb, osize, payloads, csum))
    except (ValueError, OSError) as e:
        log(f"resident restore rejects a corrupt block: {e}")
    else:
        raise AssertionError("decompress_resident took a corrupt payload")

    # the cell assembly on the rle and the lz containers' groups: its
    # flags give the routes above (every rle lane to the cell route, the
    # lz lanes with matches off the cell grid to the general one)
    cell = {m: cell_check(pool, blobs[m]) for m in ("rle", "lz")}
    flagged = {m: int(convert.to_numpy(c.got[1])[:nb].sum())
               for m, (c, _x) in cell.items()}
    if flagged["rle"] or nb - flagged["lz"] != routes["lz"]["cell"]:
        raise AssertionError(f"cell assembly flags {flagged} against the "
                             f"routes {routes}")
    cchk, cextra = cell["rle"]
    log(f"cell assembly kernel at {nb} blocks x {bs} B (the rle "
        f"container's group; {card}): {cchk.ms:.4f} ms (mean of 20), "
        f"bound {cextra[0]:.4f} ms by {cextra[1]}; the lz group "
        f"{cell['lz'][0].ms:.4f} ms, {flagged['lz']} lanes flagged")

    # one more run of each for its stages
    enc_st = {m: {} for m in ("lit", "rle", "lz")}
    for mode, st in enc_st.items():
        resident.encode_resident_blocks(x, MAIN_BITS, mode, stats=st)
    dec_st = {k: {} for k in blobs}
    for name, st in dec_st.items():
        resident.decompress_resident(blobs[name], stats=st)

    # the lit_skip kernel at the rle path's shape: against its plain
    # version (in a worker), and against the cold kernel on the same
    # tokens with the literals compacted on the host, rle and lz tokens
    blocks, lengths, _nb = resident._prep_blocks(x, MAIN_BITS, host.LANES,
                                                 dev)
    cw = resident.rle_group_args(MAIN_BITS)["cap_words"]
    toks, pairs = resident.rle_plan_device(
        blocks, lengths, resident.rle_group_args(MAIN_BITS)["Tt"])
    t_max = int(pairs.max())
    chk = PlainCheck(pool, sqz4_cuda.encode_tok, sqz4_ref.encode_tok_ref,
                     (toks, blocks[None], t_max, cw, True), REPS)
    words, lens = chk.got
    if host.unpack_group_payloads(convert.to_numpy(words),
                                  convert.to_numpy(lens), nb) != \
            container.unpack(blobs["rle"])[4]:
        raise AssertionError("lit_skip payloads differ from the rle "
                             "container's")
    lz_toks, lz_pairs, _d = lzparse.lz_plan_device(
        blocks, lengths, lzparse.lz_group_args(MAIN_BITS)["Tt"])
    for tk, tm in ((toks, t_max), (lz_toks, int(lz_pairs.max()))):
        skip = sqz4_cuda.encode_tok(tk, blocks[None], tm, cw, lit_skip=True)
        cold = sqz4_cuda.encode_tok(
            tk, sqz4_ref.skip_literal_rows(tk, blocks[None]).to(dev), tm, cw)
        if max_abs_err(skip, cold):
            raise AssertionError("lit_skip differs from the cold mode on "
                                 "host-compacted literals")
    # the compaction on the lit encode's payloads (the largest it meets)
    lwords, llens = resident.encode_literal_group(
        blocks, lengths, **resident.encode_group_args(MAIN_BITS))
    cerr, cms, cplain, cbound, cby, clib = compact_vs_plain(lwords, llens,
                                                            nb)
    log(f"compaction of the lit encode's payloads ({nb} lanes, "
        f"{int(convert.to_numpy(llens)[0, 0, :nb].sum())} B; {card}): "
        f"{cms:.4f} ms (plain {cplain:.1f} ms, bound {cbound:.4f} ms by "
        f"{cby}, err {cerr}, library {clib:.4f} ms)")
    del lwords, llens
    lens_np, toks_np = convert.to_numpy(lens), convert.to_numpy(toks)
    # the kernel reads only the bytes of the literal runs: matched spans
    # of the raw rows are skipped, never loaded
    extra = bound(toks.numel() * 4 + tok_literal_bytes(toks_np)
                  + int(lens_np[:, 0].sum()) + lens_np.nbytes,
                  tok_symbols(toks_np) * OPS_PER_SYMBOL) + (None,)
    log(f"lit_skip kernel at {nb} blocks x {bs} B (cell-parse tokens, "
        f"{t_max} pairs the longest lane; {card}): {chk.ms:.3f} ms, bound "
        f"{extra[0]:.4f} ms by {extra[1]}")

    mb = len(data) / 1e6
    fig = {}
    for name, blob in blobs.items():
        size = len(texty) if name == "compress" else len(data)
        if name != "compress":
            fig[f"resident_{name}_enc_MBps"] = mb / walls[f"enc_{name}"]
            fig[f"resident_{name}_ratio"] = len(blob) / size
        fig[f"resident_{name}_dec_MBps"] = size / 1e6 / walls[f"dec_{name}"]
    log(f"resident paths, {len(data) / 2**20:.2f} MiB in 64 KiB blocks "
        f"({card}): " + "; ".join(
            f"{m} enc {walls['enc_' + m]:.3f} s ({fig[f'resident_{m}_enc_MBps']:.1f}"
            f" MB/s) dec {walls['dec_' + m]:.3f} s "
            f"({fig[f'resident_{m}_dec_MBps']:.1f} MB/s) ratio "
            f"{fig[f'resident_{m}_ratio']:.4f}" for m in ("lit", "rle", "lz"))
        + f"; the texty compress() container dec {walls['dec_compress']:.3f}"
        f" s ({fig['resident_compress_dec_MBps']:.1f} MB/s)")
    log(f"resident stages (s, {card}): encode " + json.dumps(
        {m: {k: round(v, 4) for k, v in st.items()}
         for m, st in enc_st.items()}) + "; decode " + json.dumps(
        {m: {k: round(v, 4) for k, v in st.items()}
         for m, st in dec_st.items()}))
    return launches, fig, (chk, extra), cell, x


# phase 13: the training state of GPT-2 small (124M) at its published
# shapes (Radford et al. 2019; the Hugging Face ``gpt2`` config), and the
# AdamW settings of its usual reproductions
GPT2_SMALL = dict(n_layer=12, n_embd=768, n_head=12, n_positions=1024,
                  vocab_size=50257)
GPT2_PARAMS, GPT2_TENSORS = 124_439_808, 148
ADAMW = dict(lr=6e-4, betas=(0.9, 0.95), weight_decay=0.1)
ADAMW_STEPS = 3
CLI_BYTES = 1 << 20


def gpt2_small_state(dev):
    """ckpt-gpt2s-adamw-1.49GB: a dict of ``params`` (148 fp32 tensors in
    GPT-2's naming, an OrderedDict as ``state_dict()`` gives it; weights
    N(0, 0.02), LayerNorm weights 1 and biases 0 at initialisation),
    ``exp_avg`` and ``exp_avg_sq`` (AdamW's moments) and ``step`` (int64),
    after 3 AdamW steps on N(0, 1e-2) gradients; every value made on the
    card from ``torch.Generator`` seed 1."""
    from collections import OrderedDict
    import torch
    c = GPT2_SMALL
    E = c["n_embd"]
    g = torch.Generator(device=dev).manual_seed(1)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev) * 0.02

    def const(v, n):
        return torch.full((n,), float(v), device=dev)

    init = OrderedDict([("wte.weight", normal(c["vocab_size"], E)),
                        ("wpe.weight", normal(c["n_positions"], E))])
    for i in range(c["n_layer"]):
        for name, shape in (("ln_1", None), ("attn.c_attn", (E, 3 * E)),
                            ("attn.c_proj", (E, E)), ("ln_2", None),
                            ("mlp.c_fc", (E, 4 * E)),
                            ("mlp.c_proj", (4 * E, E))):
            w = const(1, E) if shape is None else normal(*shape)
            init[f"h.{i}.{name}.weight"] = w
            init[f"h.{i}.{name}.bias"] = const(0, w.shape[-1])
    init["ln_f.weight"], init["ln_f.bias"] = const(1, E), const(0, E)
    params = OrderedDict((k, torch.nn.Parameter(v)) for k, v in init.items())
    del init
    if len(params) != GPT2_TENSORS or sum(
            p.numel() for p in params.values()) != GPT2_PARAMS:
        raise AssertionError("GPT-2 small's parameter count")
    opt = torch.optim.AdamW(params.values(), **ADAMW)
    for _ in range(ADAMW_STEPS):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=g, device=dev) * 1e-2
        opt.step()
    for p in params.values():
        p.grad = None
    moments = [opt.state[p] for p in params.values()]
    return {"params": OrderedDict((k, p.detach())
                                  for k, p in params.items()),
            "exp_avg": OrderedDict((k, m["exp_avg"])
                                   for k, m in zip(params, moments)),
            "exp_avg_sq": OrderedDict((k, m["exp_avg_sq"])
                                      for k, m in zip(params, moments)),
            "step": torch.tensor(ADAMW_STEPS, dtype=torch.int64,
                                 device=dev)}


def leaves_equal(got, want):
    """Every leaf of ``got`` is a CUDA tensor equal to ``want``'s, in
    dtype, shape and bits, in the same tree structure."""
    import torch
    from sqz_tpu_torch.utils import checkpoint
    a, b = [], []
    if checkpoint._flatten(got, a) != checkpoint._flatten(want, b):
        return False
    return all(x.is_cuda and x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cli_on_the_card(work):
    """Phase 13's CLI checks, on the card: ckpt-save / ckpt-load of a
    small .npz, compress / decompress / roundtrip with the torch engine
    of 1 MiB of texty (its exact-parse container equal to the native
    engine's), and range equal to slicing."""
    import numpy as np
    from sqz_tpu_torch.__main__ import main as cli
    from sqz_tpu_torch.utils import corpus
    rng = np.random.default_rng(13)
    arrays = {"w": (rng.normal(size=(256, 64)) * 0.02).astype(np.float32),
              "b": np.zeros(64, np.float32),
              "ids": np.arange(1000, dtype=np.int32)}
    f = {k: os.path.join(work, k) for k in (
        "in.npz", "state.ckpt", "out.npz", "in.bin", "torch.sqzt",
        "native.sqzt", "back.bin", "span.bin")}
    np.savez(f["in.npz"], **arrays)
    if cli(["ckpt-save", f["in.npz"], f["state.ckpt"]]) or \
            cli(["ckpt-load", f["state.ckpt"], f["out.npz"]]):
        raise AssertionError("ckpt-save / ckpt-load failed")
    back = np.load(f["out.npz"])
    if sorted(back.files) != sorted(arrays) or not all(
            back[k].dtype == v.dtype and np.array_equal(back[k], v)
            for k, v in arrays.items()):
        raise AssertionError("ckpt-load does not restore the .npz")
    data = corpus.texty(CLI_BYTES, seed=3)
    with open(f["in.bin"], "wb") as fh:
        fh.write(data)
    os.environ["SQZ_PARSE"] = "exact"
    try:
        rc = (cli(["compress", f["in.bin"], f["torch.sqzt"], "--engine",
                   "torch"])
              or cli(["compress", f["in.bin"], f["native.sqzt"],
                      "--engine", "native", "--blocks"]))
    finally:
        del os.environ["SQZ_PARSE"]
    if rc or read(f["torch.sqzt"]) != read(f["native.sqzt"]):
        raise AssertionError("the torch engine's exact container differs "
                             "from the native engine's")
    if cli(["decompress", f["torch.sqzt"], f["back.bin"]]) or \
            read(f["back.bin"]) != data:
        raise AssertionError("decompress does not round-trip")
    res = subprocess.run([sys.executable, "-m", "sqz_tpu_torch",
                          "roundtrip", f["in.bin"], "--engine", "torch"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    log(res.stdout.strip())
    if res.returncode or "VERIFY FAILED" in res.stdout:
        raise AssertionError(f"python -m sqz_tpu_torch roundtrip: "
                             f"{res.stderr[-2000:]}")
    # one byte, a span over a block edge, a span of many blocks
    for start, length in ((0, 1), ((1 << MAIN_BITS) - 6, 12),
                          (CLI_BYTES // 4, CLI_BYTES // 2)):
        if cli(["range", f["torch.sqzt"], f"{start}:{length}", "--out",
                f["span.bin"]]) or \
                read(f["span.bin"]) != data[start:start + length]:
            raise AssertionError(f"range {start}:{length} differs")
    log("CLI on the card: ckpt-save, ckpt-load, compress, decompress, "
        "roundtrip and range agree")


def checkpoint_path(card):
    """Phase 13: ``save_pytree`` (mode rle) / ``load_pytree`` of GPT-2
    small's AdamW training state (1.49 GB) on the card, with the
    launches and the restore routes counted over that run; then the
    checks: every leaf back bit for bit, the container decoded by the
    native copy to the saved stream, mode lit on ``params`` (the cold
    token kernel), a corrupt payload byte rejected, and the CLI. Returns
    the end-to-end figures."""
    import tempfile
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch import native
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import resident, sqz4_cuda
    from sqz_tpu_torch.utils import checkpoint
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    state = gpt2_small_state(dev)
    torch.cuda.synchronize()
    log(f"GPT-2 small AdamW state on the card: "
        f"{time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory(prefix="sqz_ckpt_") as work:
        path = os.path.join(work, "gpt2s.sqzckpt")
        reset_launches()
        before = dict(resident.route_lanes)
        enc_st, dec_st = {}, {}
        t = time.perf_counter()
        info = checkpoint.save_pytree(state, path, mode="rle",
                                      stats=enc_st)
        save_s = time.perf_counter() - t
        t = time.perf_counter()
        back = checkpoint.load_pytree(path, stats=dec_st)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        launches = {k: read_launches().get(k, 0) for k in (
            "sqz4_encode_tok_lit_skip", "sqz4_compact", "sqz4_decode",
            "sqz4_cell_assembly")}
        routes = {k: resident.route_lanes[k] - before[k] for k in before}
        raw = info["raw_bytes"]
        log(f"launches over the checkpoint path: {launches}; restore "
            f"routes (lanes): {routes}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the checkpoint path was not "
                                 f"launched: {launches}")
        # an rle container is cell-parsed: every lane by the cell route
        if routes != {"cell": -(-raw >> MAIN_BITS), "general": 0,
                      "host": 0}:
            raise AssertionError(f"checkpoint restore routes: {routes}")
        if not leaves_equal(back, state):
            raise AssertionError("load_pytree differs from the saved state")
        del back
        mfig = mesh_checkpoint(card, state, path, work)
        # the container decodes on the native copy to the saved stream
        stream = checkpoint.filtered_stream(state, device=dev)[0]
        want = stream.cpu().numpy().tobytes()
        del stream
        _meta, blob = checkpoint.read_checkpoint(path)
        t = time.perf_counter()
        host = sqz_tpu_torch.decompress(blob, engine="native")
        native_s = time.perf_counter() - t
        if len(want) != raw or native.fnv1a64(host) != \
                native.fnv1a64(want) or host != want:
            raise AssertionError("the native copy decodes the container "
                                 "to another stream")
        del host, want, blob
        # mode lit on params: the cold token kernel
        cold = sqz4_cuda.encode_tok.launches
        lpath = os.path.join(work, "params.sqzckpt")
        t = time.perf_counter()
        linfo = checkpoint.save_pytree(state["params"], lpath, mode="lit")
        lsave_s = time.perf_counter() - t
        t = time.perf_counter()
        lback = checkpoint.load_pytree(lpath)
        torch.cuda.synchronize()
        lload_s = time.perf_counter() - t
        if sqz4_cuda.encode_tok.launches == cold or \
                not leaves_equal(lback, state["params"]):
            raise AssertionError("mode lit on params")
        del lback
        # a corrupt payload byte in the lit file's container
        _meta, blob = checkpoint.read_checkpoint(lpath)
        code, wb, bb, osize, payloads, csum, _f, _a = container.unpack(blob)
        p = bytearray(payloads[CORRUPT_BLOCK])
        p[len(p) // 2] ^= 0xFF
        payloads[CORRUPT_BLOCK] = bytes(p)
        with open(lpath, "rb") as fh:     # magic and metadata
            head = fh.read(os.path.getsize(lpath) - len(blob))
        with open(lpath, "wb") as fh:
            fh.write(head)
            fh.write(container.pack(code, wb, bb, osize, payloads, csum))
        del blob, payloads
        try:
            checkpoint.load_pytree(lpath)
        except (ValueError, OSError) as e:
            log(f"load_pytree rejects a corrupt block: {e}")
        else:
            raise AssertionError("load_pytree took a corrupt payload")
        cli_on_the_card(work)
    del state
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    fig = {"ckpt_save_MBps": raw / 1e6 / save_s,
           "ckpt_load_MBps": raw / 1e6 / load_s,
           "ckpt_ratio": info["ratio"],
           "ckpt_native_dec_MBps": raw / 1e6 / native_s,
           "ckpt_lit_params_save_MBps": linfo["raw_bytes"] / 1e6 / lsave_s,
           "ckpt_lit_params_load_MBps": linfo["raw_bytes"] / 1e6 / lload_s,
           "ckpt_lit_params_ratio": linfo["ratio"],
           "ckpt_phase_s": wall, **mfig}
    log(f"checkpoint, GPT-2 small AdamW state, {raw} B in "
        f"{-(-raw >> MAIN_BITS)} blocks of 64 KiB ({card}): save "
        f"{save_s:.3f} s ({fig['ckpt_save_MBps']:.1f} MB/s), load "
        f"{load_s:.3f} s ({fig['ckpt_load_MBps']:.1f} MB/s), ratio "
        f"{info['ratio']:.4f}; native decode of the container "
        f"{native_s:.3f} s; params in mode lit: save "
        f"{fig['ckpt_lit_params_save_MBps']:.1f} MB/s, load "
        f"{fig['ckpt_lit_params_load_MBps']:.1f} MB/s, ratio "
        f"{linfo['ratio']:.4f}; phase {wall:.1f} s")
    log(f"checkpoint stages (s, {card}): save " + json.dumps(
        {k: round(v, 4) for k, v in enc_st.items()}) + "; load "
        + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))
    return fig


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


RESIDENT_BLOCKS = 512   # phase 12: one group of 64 KiB blocks
RESIDENT_MODES = ("lit", "rle", "lz")
CKPT_SHARDS = 2          # phase 13's distributed checkpoint
TOOLS = ("check_dec", "check_enc", "check_resident", "check_lz")
MESH_TURNS = (1, 2, 4, 4, 2, 1)   # phase 15: virtual shards, in turns
PROCS_TIMEOUT = 600      # phase 16's workers

# the launch counters of the sliced phases: name -> (module of
# sqz_tpu_torch.ops, wrapper, attribute)
COUNTERS = {"sqz4_encode": ("sqz4_cuda", "encode_full", "launches"),
            "sqz4_encode_seeded": ("sqz4_cuda", "encode_full",
                                   "seeded_launches"),
            "sqz4_encode_stats": ("sqz4_cuda", "encode_stats", "launches"),
            "sqz4_encode_tok": ("sqz4_cuda", "encode_tok", "launches"),
            "sqz4_encode_tok_lit_skip": ("sqz4_cuda", "encode_tok",
                                         "lit_skip_launches"),
            "sqz4_decode": ("sqz4_cuda", "decode", "launches"),
            "sqz4_decode_seeded": ("sqz4_cuda", "decode", "seeded_launches"),
            "sqz4_compact": ("sqz4_cuda", "compact_words", "launches"),
            "sqz4_cell_assembly": ("resident", "assemble_cells",
                                   "launches"),
            "sqz4_pack": ("sqz4_cuda", "pack_payloads", "launches"),
            "sqz4_model_stats": ("sqz4_cuda", "model_stats", "launches"),
            "sqz4_exact_parse": ("sqz4_cuda", "exact_parse", "launches")}


def _counter(mod, fn):
    import importlib
    return getattr(importlib.import_module(f"sqz_tpu_torch.ops.{mod}"), fn)


def reset_launches():
    for mod, fn, attr in COUNTERS.values():
        setattr(_counter(mod, fn), attr, 0)


def read_launches() -> dict:
    """The launches since ``reset_launches`` of every kernel that ran."""
    got = {k: getattr(_counter(mod, fn), attr)
           for k, (mod, fn, attr) in COUNTERS.items()}
    return {k: v for k, v in got.items() if v}


TEXT_BYTES = 10 ** 8     # phase 17's text (enwik8's size)
PACK_REPS = 20           # phase 17's launches a timing


def pack_vs_plain(payloads, lanes, pw):
    """Phase 17's check of the payload packing kernel on one call's
    payloads (``lanes`` a group): the words equal the plain version's (on
    CPU copies) and the native host packer's, tolerance 0. Returns the
    kernel table's (err, ms, plain ms, bound ms, bound by, library ms) and
    the host packer's ms. The kernel's time is queued launches'
    (``queued_events_ms``); one launch timed alone carries the wrapper's
    host time, which is logged beside it."""
    import numpy as np
    import torch
    from sqz_tpu_torch import convert, native
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_ref
    dev = torch.device("cuda")
    G = -(-len(payloads) // lanes)
    data, offs, lens = sqz4_cuda.upload_payloads(payloads, G, lanes, dev)
    got = sqz4_cuda.pack_payloads(data, offs, lens, pw)
    ms = queued_events_ms(
        lambda: sqz4_cuda.pack_payloads(data, offs, lens, pw), PACK_REPS)
    launched_ms = events_ms(
        lambda: sqz4_cuda.pack_payloads(data, offs, lens, pw), REPS)
    cpu = [t.cpu() for t in (data, offs, lens)]
    t = time.perf_counter()
    want = sqz4_ref.pack_payloads_ref(*cpu, pw)
    plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    host = native.sqz4_pack_payloads(payloads, lanes, pw)
    host_ms = (time.perf_counter() - t) * 1e3
    host = np.concatenate([host, np.zeros((G - host.shape[0],)
                                          + host.shape[1:], np.uint32)])
    err = max_abs_err([got.cpu()], [want])
    if err or not np.array_equal(convert.to_numpy(got), host):
        raise AssertionError(f"payload pack at {G} x {pw} x {lanes}: the "
                             f"kernel differs (err {err})")
    # the payload bytes and the lanes' offsets and lengths read, every
    # word written
    b_ms, by = bound(data.numel() + 16 * offs.numel() + 4 * got.numel(), 0)
    log(f"payload pack at {G} x {pw} x {lanes}: {ms:.4f} ms a launch "
        f"queued, {launched_ms:.4f} ms one launch from the host")
    return (err, ms, plain_ms, b_ms, by, None), host_ms


def pack_path(card):
    """Phase 17: the payload packing kernel's launches over one
    ``load_pytree`` of GPT-2 small's state and one ``decompress`` of
    10^8 B of texty, then the kernel against its plain version and the
    host packer on their groups. Returns (the kernel table's entry at the
    load's first group, launches, figures)."""
    import tempfile
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch.formats import container
    from sqz_tpu_torch.ops import resident, sqz4_cuda, sqz4_host
    from sqz_tpu_torch.utils import checkpoint, corpus
    dev = torch.device("cuda")
    lanes = sqz4_host.LANES
    state = gpt2_small_state(dev)
    with tempfile.TemporaryDirectory(prefix="sqz_pack_") as work:
        path = os.path.join(work, "gpt2s.sqzckpt")
        checkpoint.save_pytree(state, path)
        reset_launches()
        back = checkpoint.load_pytree(path)
        torch.cuda.synchronize()
        load_launches = read_launches().get("sqz4_pack", 0)
        if not leaves_equal(back, state):
            raise AssertionError("load_pytree differs from the saved state")
        del back, state
        _meta, blob = checkpoint.read_checkpoint(path)
    blk_bits, _osize, payloads, sizes = resident.unpack_cold_container(blob)
    del blob
    groups = -(-len(payloads) // lanes)
    if load_launches != groups:
        raise AssertionError(f"payload pack launches over a load: "
                             f"{load_launches}, not one a group ({groups})")
    Pw = resident.decoder_args(blk_bits, lanes)["Pw"]
    fig, rows = {}, {}
    for name, g0 in (("first", 0), ("last", (groups - 1) * lanes)):
        fit, _pl, _sz, _over, pw = resident.fit_payload_group(
            payloads[g0:g0 + lanes], sizes[g0:g0 + lanes], Pw, lanes)
        rows[name], host_ms = pack_vs_plain(fit, lanes, pw)
        fig[f"pack_load_{name}_ms"] = rows[name][1]
        fig[f"pack_load_{name}_host_ms"] = host_ms
        log(f"payload pack, the load's {name} group ({lanes} lanes, pw "
            f"{pw}, {sum(map(len, fit))} B; {card}): kernel "
            f"{rows[name][1]:.4f} ms, bound {rows[name][3]:.4f} ms, plain "
            f"{rows[name][2]:.1f} ms, host packer {host_ms:.1f} ms")
    del payloads
    data = corpus.texty(TEXT_BYTES, seed=1)
    blob = sqz_tpu_torch.compress(data)
    reset_launches()
    back = sqz_tpu_torch.decompress(blob)
    text_launches = read_launches().get("sqz4_pack", 0)
    if back != data or text_launches != 1:
        raise AssertionError(f"decompress of {TEXT_BYTES} B: round trip "
                             f"{back == data}, {text_launches} pack launches")
    del back, data
    _c, _w, blk_bits, _o, payloads, _cs, _f, _a = container.unpack(blob)
    plan = sqz4_host.plan_decode_dispatch(len(payloads), blk_bits, lanes)
    pw = min(plan["Pw"], sqz4_host.payload_rows(max(map(len, payloads))))
    text, host_ms = pack_vs_plain(payloads, lanes, pw)
    fig.update(pack_text_ms=text[1], pack_text_host_ms=host_ms,
               pack_text_plain_ms=text[2], pack_text_bound_ms=text[3],
               pack_load_plain_ms=rows["first"][2],
               pack_load_bound_ms=rows["first"][3])
    log(f"payload pack, the decompress's {plan['G']} groups ({lanes} lanes,"
        f" pw {pw}, {sum(map(len, payloads))} B; {card}): kernel "
        f"{text[1]:.4f} ms, bound {text[3]:.4f} ms, plain {text[2]:.1f} ms,"
        f" host packer {host_ms:.1f} ms; launches: load {load_launches}, "
        f"decompress {text_launches}")
    return rows["first"], load_launches + text_launches, fig


MODEL_BITS = 20   # phase 18: the wide cell's blocks (10^8 B, 96 lanes)


def model_stats_vs_plain(pool, data, blk_bits):
    """Phase 18's check of the model statistics kernels on the exact
    parse of ``data`` at ``blk_bits``, one group of the route's
    ``group_lanes`` (as ``encode_data_stats`` uploads it): the statistics
    equal the native per-block walk's (``sqz4_host.op_stats``, timed) and
    the plain version's (in a worker of ``pool``, on CPU copies),
    tolerance 0. Returns the PlainCheck, the bound (ms, by: the op words
    read once and the statistics written once) and the host walk's ms."""
    import numpy as np
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
    streams = host.exact_op_streams(data, 1 << MAIN_WIN_BITS, blk_bits)
    mw, sw, mx, _ = streams
    rows = -(-mx // 4)
    m, s = (convert.to_device(w[:, :rows, 0], "cuda") for w in (mw, sw))
    n = m.shape[0]
    chk = PlainCheck(pool, sqz4_cuda.model_stats, sqz4_ref.model_stats_ref,
                     (m, s, host.group_lanes(n)), REPS)
    t = time.perf_counter()
    want = host.op_stats(streams)
    host_ms = (time.perf_counter() - t) * 1e3
    for got, w in zip(chk.got, want):
        by_lane = convert.to_numpy(got).transpose(0, 2, 1).reshape(
            -1, 4 * rows)
        if not np.array_equal(by_lane[:n], w) or by_lane[n:].any():
            raise AssertionError(f"model statistics at {n} x 2^{blk_bits}"
                                 f" B differ from the native walk")
    return (chk, bound(2 * m.numel() * 4 + 3 * chk.got[0].numel() * 4, 0),
            host_ms)


def model_stats_path(card, pool):
    """Phase 18: the model statistics kernels at the wide cell's shape
    (10^8 B of texty at 1 MiB blocks, 96 lanes) and at 512 x 64 KiB,
    against the native walk and their plain version; their launches over
    one wide compress of 10^8 B (one a group, and the host walk never
    called). Returns (the kernel table's entry at the wide cell's shape,
    launches, figures)."""
    import sqz_tpu_torch
    from sqz_tpu_torch.ops import sqz4_host as host
    from sqz_tpu_torch.utils import corpus
    text = corpus.texty(TEXT_BYTES, seed=1)
    kw = dict(blk_bits=MODEL_BITS, win_bits=MAIN_WIN_BITS)
    walk = host.op_stats

    def no_walk(*a, **k):
        raise AssertionError("the wide route called sqz4_host.op_stats")

    host.op_stats = no_walk
    try:
        reset_launches()
        blob = sqz_tpu_torch.compress(text, **kw)
        launches = read_launches().get("sqz4_model_stats", 0)
    finally:
        host.op_stats = walk
    groups = -(-len(text) // (host.LANES << MODEL_BITS))
    if launches != groups or sqz_tpu_torch.decompress(blob) != text:
        raise AssertionError(f"wide compress of {TEXT_BYTES} B: {launches} "
                             f"model statistics launches, not {groups}, or "
                             f"no round trip")
    fig, rows = {}, {}
    for name, data, bits in (("wide", text, MODEL_BITS),
                             ("main", text[:MAIN_BYTES], MAIN_BITS)):
        chk, (b_ms, by), host_ms = model_stats_vs_plain(pool, data, bits)
        err, ms, plain_ms = chk.result()
        rows[name] = (err, ms, plain_ms, b_ms, by, None)
        fig.update({f"model_stats_{name}_ms": ms,
                    f"model_stats_{name}_bound_ms": b_ms,
                    f"model_stats_{name}_plain_ms": plain_ms,
                    f"model_stats_{name}_host_ms": host_ms})
        log(f"model statistics, {chk.got[0].shape[2]} lanes x 2^{bits} B "
            f"of texty ({card}): kernels {ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({by}), plain {plain_ms:.1f} ms, the host walk "
            f"{host_ms:.1f} ms")
    return rows["wide"], launches, fig


def exact_parse_vs_native(card, name, data, blk_bits):
    """Phase 19's check of the exact parse kernel on ``data`` at
    ``blk_bits``, a lane a block, cold: its op words and counts equal the
    native planner's (``sqz4_host.exact_op_streams``, timed). Returns
    (the kernel's ms, best of REPS by CUDA events; the bound, ms and by:
    the bytes read once and both op word arrays written once; the host
    planner's ms)."""
    import numpy as np
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    window, bs = 1 << MAIN_WIN_BITS, 1 << blk_bits
    offs = list(range(0, len(data), bs))
    lens = [min(bs, len(data) - o) for o in offs]
    rows = host.op_stream_cap(blk_bits, len(data)) // 4
    flat = sqz4_cuda.upload_bytes(data, torch.device("cuda"))
    out = []

    def run():
        out[:] = sqz4_cuda.exact_parse(flat, offs, lens, window, True, rows)

    ms = events_ms(run, REPS)
    t = time.perf_counter()
    mw, sw, _mx, _ = host.exact_op_streams(data, window, blk_bits)
    host_ms = (time.perf_counter() - t) * 1e3
    m, s, counts = (convert.to_numpy(x) for x in out)
    want = (mw[:, :, 0].astype(">u4").view(np.uint8) != 0xFF).sum(1)
    if not (np.array_equal(m, mw[:, :, 0]) and np.array_equal(s, sw[:, :, 0])
            and counts.tolist() == want.tolist()):
        raise AssertionError(f"exact parse of {len(offs)} x 2^{blk_bits} B "
                             f"of {name} differs from the native planner")
    b_ms, by = bound(len(data) + 2 * m.size * 4, 0)
    log(f"exact parse, {len(offs)} lanes x 2^{blk_bits} B of {name} "
        f"({card}): kernel {ms:.3f} ms, bound {b_ms:.4f} ms ({by}), the "
        f"host planner {host_ms:.1f} ms; {int(counts.sum())} ops")
    return ms, b_ms, by, host_ms


def exact_parse_path(card):
    """Phase 19: the exact parse kernel's launches over one wide compress
    of 10^8 B of texty (one a group), then the kernel at that shape on the
    texty and on random bytes against the native planner. Returns (the
    kernel table's entry on the texty, launches, figures)."""
    import sqz_tpu_torch
    from sqz_tpu_torch.utils import corpus
    text = corpus.texty(TEXT_BYTES, seed=1)
    reset_launches()
    blob = sqz_tpu_torch.compress(text, blk_bits=MODEL_BITS,
                                  win_bits=MAIN_WIN_BITS)
    launches = read_launches().get("sqz4_exact_parse", 0)
    if launches != 1 or sqz_tpu_torch.decompress(blob) != text:
        raise AssertionError(f"wide compress of {TEXT_BYTES} B: {launches} "
                             f"exact parse launches, not 1, or no round "
                             f"trip")
    fig, row = {}, None
    for name, data in (("texty", text),
                       ("random", corpus.random_bytes(TEXT_BYTES, seed=2))):
        ms, b_ms, by, host_ms = exact_parse_vs_native(card, name, data,
                                                      MODEL_BITS)
        fig.update({f"exact_parse_{name}_ms": ms,
                    f"exact_parse_{name}_bound_ms": b_ms,
                    f"exact_parse_{name}_host_ms": host_ms})
        row = row or (0, ms, None, b_ms, by, None)
    return row, launches, fig


def mesh_checkpoint(card, state, path, work):
    """Phase 13's distributed leg: ``save_pytree`` / ``load_pytree`` of
    ``state`` over CKPT_SHARDS virtual shards of the card; the file must
    equal the mesh-less ``path`` and every leaf come back bit for bit."""
    import filecmp
    import torch
    from sqz_tpu_torch.parallel.mesh import make_mesh
    from sqz_tpu_torch.utils import checkpoint
    dev = torch.device("cuda", 0)
    mesh = make_mesh(CKPT_SHARDS, devices=[dev] * CKPT_SHARDS)
    mpath = os.path.join(work, "gpt2s_mesh.sqzckpt")
    reset_launches()
    t = time.perf_counter()
    info = checkpoint.save_pytree(state, mpath, mode="rle", mesh=mesh)
    save_s = time.perf_counter() - t
    if not filecmp.cmp(path, mpath, shallow=False):
        raise AssertionError("the mesh checkpoint file differs from the "
                             "mesh-less one")
    t = time.perf_counter()
    back = checkpoint.load_pytree(mpath, mesh=mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    launches = read_launches()
    if not leaves_equal(back, state):
        raise AssertionError("load_pytree over the mesh differs from the "
                             "saved state")
    del back
    os.remove(mpath)
    raw = info["raw_bytes"]
    fig = {f"ckpt_mesh{CKPT_SHARDS}_save_MBps": raw / 1e6 / save_s,
           f"ckpt_mesh{CKPT_SHARDS}_load_MBps": raw / 1e6 / load_s}
    log(f"distributed checkpoint over {CKPT_SHARDS} virtual shards "
        f"({card}): save {save_s:.3f} s "
        f"({fig[f'ckpt_mesh{CKPT_SHARDS}_save_MBps']:.1f} MB/s), file equal"
        f" to the mesh-less one; load {load_s:.3f} s "
        f"({fig[f'ckpt_mesh{CKPT_SHARDS}_load_MBps']:.1f} MB/s), every "
        f"leaf bit for bit; launches {launches}")
    if min(launches.get(k, 0) for k in ("sqz4_encode_tok_lit_skip",
                                        "sqz4_decode")) < CKPT_SHARDS:
        raise AssertionError(f"the mesh checkpoint's launches: {launches}")
    return fig


def tools_path(card):
    """Phase 14: the check tools at their default sizes, each with its
    kernels' launches counted over its run; the decoder must run at least
    once a mutant."""
    import importlib
    fig, launches, walls = {}, {}, {}
    for name in TOOLS:
        tool = importlib.import_module(f"sqz_tpu_torch.tools.{name}")
        reset_launches()
        rep = {}
        t = time.perf_counter()
        if tool.main([], rep):
            raise AssertionError(f"sqz_tpu_torch.tools.{name} failed")
        walls[name] = time.perf_counter() - t
        launches[name] = read_launches()
        fig.update(rep)
    if launches["check_dec"].get("sqz4_decode", 0) < fig["mutants"] + 1:
        raise AssertionError(f"the mutants did not all reach the decoder: "
                             f"{launches['check_dec']}")
    log(f"check tools ({card}): {fig['mutants']} mutants through the "
        f"decoder kernel: {fig['mutants_rejected']} rejected, "
        f"{fig['mutants_produced']} produced; LZ ratio gap "
        f"{fig['lz_gap_pp']:+.3f} pp (device {fig['lz_ratio']:.4f}, fast "
        f"parse {fig['lz_fast_ratio']:.4f}); MB/s: decode "
        f"{fig['dec_MBps']:.1f}, op-stream encode {fig['enc_MBps']:.1f}, "
        f"stats-fed {fig['enc_stats_MBps']:.1f}, resident lit "
        f"{fig['resident_lit_MBps']:.1f} rle {fig['resident_rle_MBps']:.1f} "
        f"restore {fig['resident_dec_MBps']:.1f}, device LZ "
        f"{fig['lz_MBps']:.1f}, general restore "
        f"{fig['lz_general_dec_MBps']:.1f}; walls (s) "
        + json.dumps({k: round(v, 2) for k, v in walls.items()})
        + f"; launches {json.dumps(launches)}")
    return {f"tool_{k}": v for k, v in fig.items()}


def mesh_path(card):
    """Phase 15: the resident mix over meshes of virtual shards of the
    card, in turns (MESH_TURNS): ``compress_resident(mesh=)`` per mode,
    each container equal to the mesh-less one, and ``decompress_resident(
    mesh=)`` of each, equal to the input. Returns the MB/s of each shard
    count's runs."""
    import torch
    import sqz_tpu_torch
    from sqz_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    data = resident_input()
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    want = {m: sqz_tpu_torch.compress_resident(x, blk_bits=MAIN_BITS,
                                               mode=m)
            for m in RESIDENT_MODES}
    mb = len(data) / 1e6
    runs = {}
    for n in MESH_TURNS:
        mesh = make_mesh(n, devices=[dev] * n)
        reset_launches()
        walls = {}
        for m in RESIDENT_MODES:
            t = time.perf_counter()
            blob = sqz_tpu_torch.compress_resident(x, blk_bits=MAIN_BITS,
                                                   mode=m, mesh=mesh)
            walls[f"enc_{m}"] = time.perf_counter() - t
            if blob != want[m]:
                raise AssertionError(f"the {m} container over {n} shards "
                                     f"differs from the mesh-less one")
        for m in RESIDENT_MODES:
            t = time.perf_counter()
            out = sqz_tpu_torch.decompress_resident(want[m], mesh=mesh)
            torch.cuda.synchronize()
            walls[f"dec_{m}"] = time.perf_counter() - t
            if not out.is_cuda or out.cpu().numpy().tobytes() != data:
                raise AssertionError(f"the {m} restore over {n} shards "
                                     f"differs from the input")
        launches = read_launches()
        if min(launches.get(k, 0) for k in ("sqz4_decode",
                                            "sqz4_cell_assembly")) < 3 * n:
            raise AssertionError(f"{n} shards: launches {launches}")
        runs.setdefault(n, []).append(walls)
        log(f"mesh of {n} virtual shards ({card}): " + "; ".join(
            f"{k} {v:.3f} s ({mb / v:.1f} MB/s)" for k, v in walls.items())
            + f"; launches {json.dumps(launches)}")
    return {f"mesh{n}_{k}_MBps_run{i}": mb / v
            for n, ws in runs.items() for i, w in enumerate(ws, 1)
            for k, v in w.items()}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def two_process_path(card):
    """Phase 16: the two-process run on the one card (gloo) and one NCCL
    rank beside it; rank 0's containers must equal the single-process
    container and every worker exit 0."""
    import tempfile
    import torch
    import sqz_tpu_torch
    data = resident_input()
    want = sqz_tpu_torch.compress_resident(
        torch.frombuffer(bytearray(data), dtype=torch.uint8).cuda(),
        blk_bits=MAIN_BITS, mode="rle")
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory(prefix="sqz_procs_") as work:
        procs = []
        t = time.perf_counter()
        try:
            for backend, world in (("gloo", 2), ("nccl", 1)):
                out = os.path.join(work, backend)
                os.mkdir(out)
                port = free_port()
                for rank in range(world):
                    procs.append((backend, rank, subprocess.Popen(
                        [sys.executable, "-m", "sqz_tpu_torch.parallel.dryrun",
                         "--rank", str(rank), "--world", str(world),
                         "--port", str(port), "--backend", backend,
                         "--device", "cuda:0", "--blocks",
                         str(RESIDENT_BLOCKS), "--blk-bits", str(MAIN_BITS),
                         "--out", out], cwd=ROOT, env=env,
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
            outs = [p.communicate(timeout=PROCS_TIMEOUT)[0]
                    for _b, _r, p in procs]
        finally:
            for _b, _r, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for (backend, rank, p), out in zip(procs, outs):
            tail = out.strip().splitlines()[-1:] if out.strip() else []
            log(f"{backend} rank {rank}: exit {p.returncode}; "
                + " ".join(tail))
            if p.returncode:
                raise AssertionError(f"{backend} rank {rank} failed:\n"
                                     f"{out[-3000:]}")
        for backend in ("gloo", "nccl"):
            if read(os.path.join(work, backend, "rle.sqzt")) != want:
                raise AssertionError(f"the {backend} run's container differs"
                                     f" from the single-process one")
    log(f"two processes on one card (gloo) and one NCCL rank ({card}): "
        f"containers equal to the single-process one; {wall:.1f} s with "
        f"the workers' start")
    return {"procs_wall_s": wall}

KERNELS = (   # name, source, the TPU kernel it replaces
    ("sqz4_encode", "sqz4_encode.cu", f"{PALLAS}:686"),
    ("sqz4_encode_seeded", "sqz4_encode.cu", f"{PALLAS}:686"),
    ("sqz4_decode", "sqz4_decode.cu", f"{PALLAS}:1705"),
    ("sqz4_decode_seeded", "sqz4_decode.cu", f"{PALLAS}:1705"),
    ("sqz4_encode_tok", "sqz4_encode_tok.cu", f"{PALLAS}:1127"),
    ("sqz4_encode_tok_lit_skip", "sqz4_encode_tok.cu",
     f"{PALLAS}:1127 (lit_skip=True)"),
    ("sqz4_compact", "sqz4_compact.cu", f"{PALLAS}:464"),
    ("squeeze_bitpack", "squeeze_bitpack.cu", f"{PALLAS}:1489"),
    ("sqz4_encode_stats", "sqz4_encode_stats.cu", f"{PALLAS}:281"),
    ("probe", "probe.cu", "tools/pallas_probe.py:13"),
    ("sqz4_cell_assembly", "sqz4_cell.cu",
     "sqz_tpu/ops/resident.py:422,498 (jax.lax.scan, not a Pallas kernel)"),
    ("sqz4_pack", "sqz4_pack.cu",
     "not a Pallas kernel: the host's sqz4_pack_payloads"),
    ("sqz4_model_stats", "sqz4_model_stats.cu",
     "not a Pallas kernel: the host loop of sqz_tpu/ops/sqz4_jax.py:367 "
     "stats_for_ops (native sqz4_model_stats a block)"),
    ("sqz4_exact_parse", "sqz4_exact_parse.cu",
     "not a Pallas kernel: the host's sqz4_plan_pack of the wide route "
     "(sqz_tpu/ops/sqz4_jax.py encode_blocks)"),
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
    if sys.argv[1:] == ["--chain"]:
        chain_figures(chain_inputs(), MAIN_BITS, MAIN_WIN_BITS, REPS)
        return 0
    if sys.argv[1:] == ["--pack"]:
        _row, _n, fig = pack_path(card)
        log(json.dumps({"card": card, **{k: round(v, 4)
                                         for k, v in fig.items()}}))
        return 0
    if sys.argv[1:] == ["--model-stats"]:
        with ProcessPoolExecutor(
                2, mp_context=multiprocessing.get_context("spawn")) as pool:
            _row, _n, fig = model_stats_path(card, pool)
        log(json.dumps({"card": card, **{k: round(v, 4)
                                         for k, v in fig.items()}}))
        return 0
    if sys.argv[1:] == ["--exact-parse"]:
        _row, _n, fig = exact_parse_path(card)
        log(json.dumps({"card": card, **{k: round(v, 4)
                                         for k, v in fig.items()}}))
        return 0
    from sqz_tpu_torch.ops import sqz4_host
    from sqz_tpu_torch.utils import corpus
    pool = ProcessPoolExecutor(
        PLAIN_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        kernels_vs_plain(corpus.texty(SMALL_BLOCKS << SMALL_BITS, seed=7),
                         SMALL_BITS, 10, SMALL_BLOCKS, 10, SMALL_BITS, pool)
        data, blob, fblob, launches, e2e = main_path()
        _pblob, plaunches, pe2e = pipelined_path()
        launches.update({k: plaunches[k]
                         for k in ("sqz4_encode_tok", "sqz4_compact")})
        launches["squeeze_bitpack"], se2e = squeeze_path(data)
        launches.update(stats_and_probe_paths(data))
        wlaunches, we2e = warm_path(data, blob)
        launches.update(wlaunches)
        we2e.update(anchored_path())
        _wlaunches, wide_e2e, wide_checks = wide_path(data, pool)
        we2e.update(wide_e2e)
        mrow, launches["sqz4_model_stats"], mfig = model_stats_path(card,
                                                                     pool)
        we2e.update(mfig)
        erow, launches["sqz4_exact_parse"], efig = exact_parse_path(card)
        we2e.update(efig)
        t = time.perf_counter()
        we2e.update(huge_block_path(pool))
        log(f"blk_bits {HUGE_BITS} phase: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        rlaunches, re2e, (rchk, rextra), cell, mix = resident_path(
            card, data, fblob, pool)
        kchk, kextra, kfig = lit_skip_figures(pool, card, mix)
        del mix
        we2e.update(kfig)
        for k in ("sqz4_encode_tok_lit_skip", "sqz4_cell_assembly"):
            launches[k] = rlaunches[k]
        we2e.update(re2e)
        log(f"resident paths: {time.perf_counter() - t:.1f} s")
        t = time.perf_counter()
        full = kernels_vs_plain(data, MAIN_BITS, MAIN_WIN_BITS,
                                sqz4_host.LANES, REPS, STATS_BITS, pool)
        full["sqz4_encode_tok_lit_skip"] = rchk.result() + rextra
        full["sqz4_model_stats"] = mrow
        full["sqz4_exact_parse"] = erow
        kres = kchk.result() + kextra
        we2e.update(lit_skip_ckpt_group_plain_ms=kres[2],
                    lit_skip_ckpt_group_bound_ms=kres[3])
        log(f"lit_skip at the checkpoint's first group equals its plain "
            f"version (plain {kres[2]:.1f} ms, err {kres[0]})")
        for k, chk in wide_checks.items():
            # the kernel's time is phase 11's: this one's events can
            # span the host's pickling of the inputs for the worker
            err, _ms, plain_ms = chk.result()
            lanes = chk.got[0].shape[2]
            we2e[f"wide{WIDE_PLAIN_BITS}x{lanes}_{k}_plain_ms"] = plain_ms
            log(f"blk_bits {WIDE_PLAIN_BITS}, {lanes} lanes: {k} equals "
                f"its plain version (plain {plain_ms:.1f} ms, err {err})")
        cres = {m: c.result() + x for m, (c, x) in cell.items()}
        full["sqz4_cell_assembly"] = cres["rle"]
        log(f"kernels vs plain at the full shapes: "
            f"{time.perf_counter() - t:.1f} s; lit_skip "
            f"{full['sqz4_encode_tok_lit_skip'][1]:.3f} ms (plain "
            f"{full['sqz4_encode_tok_lit_skip'][2]:.1f} ms); cell assembly "
            f"rle {cres['rle'][1]:.4f} ms (plain {cres['rle'][2]:.1f} ms), "
            f"lz {cres['lz'][1]:.4f} ms (plain {cres['lz'][2]:.1f} ms)")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    chain_figures(chain_inputs(data), MAIN_BITS, MAIN_WIN_BITS, REPS)
    stage_times(data)
    corrupt_rejected(blob)
    del data, blob, fblob
    we2e.update(checkpoint_path(card))
    we2e.update(tools_path(card))
    we2e.update(mesh_path(card))
    we2e.update(two_process_path(card))
    full["sqz4_pack"], launches["sqz4_pack"], pfig = pack_path(card)
    we2e.update(pfig)
    if any(m.split(".")[0] in ("jax", "sqz_tpu") for m in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    kernels = []
    shapes = {"sqz4_encode_stats":
              f"{sqz4_host.LANES} blocks x {1 << STATS_BITS} B",
              "sqz4_decode_seeded": f"{sqz4_host.LANES - 1} blocks x "
                                    f"{1 << MAIN_BITS} B (blocks 1+)",
              "sqz4_encode_tok_lit_skip": f"{RESIDENT_BLOCKS} blocks x "
                                          f"{1 << MAIN_BITS} B of the "
                                          f"resident mix, cell parse",
              "sqz4_cell_assembly": f"{RESIDENT_BLOCKS} blocks x "
                                    f"{1 << MAIN_BITS} B of the resident "
                                    f"mix, the rle container's group",
              "sqz4_pack": f"the first {sqz4_host.LANES} payloads of "
                           f"phase 17's checkpoint",
              "sqz4_model_stats": f"{TEXT_BYTES} B of texty at "
                                  f"2^{MODEL_BITS} B blocks, one group of "
                                  f"96 lanes",
              "sqz4_exact_parse": f"{TEXT_BYTES} B of texty at "
                                  f"2^{MODEL_BITS} B blocks, 96 lanes",
              "probe": "the 8 of the 14 probes one torch call computes, "
                       "in one launch, at the reference's inputs, [1, 128] "
                       "and [256, 128]"}
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
                                         {**e2e, **pe2e, **se2e,
                                          **we2e}.items()}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
