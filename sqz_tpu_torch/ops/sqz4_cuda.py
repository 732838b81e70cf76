"""sqz4 kernel wrappers and the whole-buffer device encode and decode.

``encode_full``, ``encode_tok``, ``encode_stats``, ``decode`` and
``compact_words`` launch the CUDA kernels (``csrc/``) for tensors on a
CUDA device and run the plain versions (``sqz4_ref``) for tensors on the
CPU; any other device raises. Each counts its kernel launches in its
``launches`` attribute; ``encode_full`` and ``decode`` count their seeded
(warm-start) launches apart, in ``seeded_launches``, and ``encode_tok``
its lit_skip launches (the resident paths) in ``lit_skip_launches``.

``encode_data_full``, ``encode_data_tok`` and ``decode_groups`` are the
main path around them: the native host planner -> op streams or tokens
-> encoder kernel -> payloads (downloaded trimmed, or compacted on the
card), and payloads -> decoder kernel -> token records -> native host
assembly. ``encode_groups`` codes per-op statistics computed on the host
(``native.sqz4_model_stats``) through the stats-fed encoder. Blocks ride
lanes of ``[groups, rows, lanes]`` arrays, as in the reference.
"""

from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from sqz_tpu_torch import convert, native
from sqz_tpu_torch.ops import sqz4_host as host
from sqz_tpu_torch.ops import launch, sqz4_ref

# Threads per CTA of the op-stream and the stats-fed encoders
# (csrc/sqz4_encode.cu, csrc/sqz4_encode_stats.cu): four blocks a CTA,
# each a coder warp beside a producer warp (statistics, reciprocals, byte
# placement), as the token encoder's; the launchers also take 32 (one
# warp doing both in turn) and 64-192. scripts/chain_variants.py times
# them (PERF.md).
ENC_THREADS = 256
STATS_THREADS = 256
# Threads per CTA (one block each) of the decoder: a warp whose lanes run
# the block's chain together (csrc/sqz4_decode.cu).
DECODE_THREADS = 32
# Threads per CTA of the token encoder (csrc/sqz4_encode_tok.cu): four
# blocks a CTA, each a coder warp beside a producer warp (token expansion,
# models, reciprocals, byte placement), one coder on each of an SM's
# schedulers. It measured fastest of 256, 64 and 32 (one warp doing both
# in turn); scripts/chain_variants.py times them (PERF.md).
TOK_THREADS = 256
# Rows of a compaction tile (csrc/sqz4_compact.cu: 32 lanes x this many
# rows staged in shared memory; the launcher takes 64 or 128, and 128
# measured faster: scripts/chain_variants.py, PERF.md).
COMPACT_ROWS = 128


# the largest sqz4 blocks the kernels code: a model total (at most 2^14
# from a warm seed, plus one a coded symbol) stays below 2^17, where their
# divider is exact (csrc/sqz4_div.cuh); the engine routes larger blocks
# to the native host codec
DEVICE_BLK_BITS = 16


def check_blk_bits(blk_bits: int):
    if blk_bits > DEVICE_BLK_BITS:
        raise ValueError("sqz4 device kernels support blk_bits <= 16")


def _seed_arg(seed, dev):
    """The seed column's pointer for a launch (None: cold), checked."""
    if seed is None:
        return None
    launch.check_tensor(seed, "seed", torch.int32, ndim=1)
    if seed.shape[0] != sqz4_ref.SEED_WORDS or seed.device != dev \
            or not seed.is_contiguous():
        raise ValueError(f"seed must be a contiguous [{sqz4_ref.SEED_WORDS}]"
                         f" int32 tensor on the kernel's device")
    return seed.data_ptr()


def encode_full(m_ops: torch.Tensor, s_ops: torch.Tensor, cap_words: int,
                seed: torch.Tensor = None, fresh_block: int = -1):
    """sqz4 encoder: m_ops / s_ops uint32 [G, T/4, B] (four big-endian u8
    micro-ops a word: 0 flag, 1 size, 2 byte, 3 bits, 4..35 distance bit,
    254 flush, others pad) -> (payload words uint32 [G, cap_words, B],
    big-endian bytes; lens int32 [G, 8, B], row 0 the byte length).
    ``seed`` (the seeded mode): the seed column, int32 [SEED_WORDS]
    (``sqz4_host.seed_column``), from which every block but
    ``fresh_block`` (counted g * B + b) starts its models."""
    launch.check_tensor(m_ops, "m_ops", torch.uint32)
    launch.check_tensor(s_ops, "s_ops", torch.uint32)
    if m_ops.shape != s_ops.shape:
        raise ValueError("m_ops and s_ops differ in shape")
    dev = launch.kernel_device(m_ops, s_ops)
    seed_ptr = _seed_arg(seed, dev)
    if dev.type == "cpu":
        return sqz4_ref.encode_full_ref(m_ops, s_ops, cap_words, seed,
                                        fresh_block)
    from sqz_tpu_torch.ops import _build
    G, TW, B = m_ops.shape
    words = launch.zeros((G, cap_words, B), torch.uint32, dev)
    lens = launch.zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_encode_launch(
            m_ops.data_ptr(), s_ops.data_ptr(), G, TW, B, words.data_ptr(),
            cap_words, lens.data_ptr(), seed_ptr, fresh_block, ENC_THREADS,
            stream)
    launch.launched(rc, "sqz4_encode")
    if seed is None:
        launch.count(encode_full)
    else:
        launch.count(encode_full, "seeded_launches")
    return words, lens


encode_full.launches = 0
encode_full.seeded_launches = 0


def decode(payload: torch.Tensor, meta: torch.Tensor, t_max: int, lw: int,
           tw: int, mw: int, seed: torch.Tensor = None):
    """sqz4 decoder: payload uint32 [G, Pw, B] (big-endian bytes), meta
    int32 [G, 8, B] (row 1 block sizes, row 2 dictionary length) ->
    (lit uint32 [G, lw, B], tok uint32 [G, tw, B], mrec uint32 [G, mw, B],
    counts int32 [G, 8, B]: optr, nlit, ntok, nmatch, err, steps, ovf,
    state). ``seed`` (the seeded mode): the seed column, int32
    [SEED_WORDS], from which every block starts its models."""
    launch.check_tensor(payload, "payload", torch.uint32)
    launch.check_tensor(meta, "meta", torch.int32)
    if meta.shape[0] != payload.shape[0] or meta.shape[2] != payload.shape[2]\
            or meta.shape[1] < 3:
        raise ValueError("meta must be [G, 8, B] beside payload [G, Pw, B]")
    dev = launch.kernel_device(payload, meta)
    seed_ptr = _seed_arg(seed, dev)
    if dev.type == "cpu":
        return sqz4_ref.decode_ref(payload, meta, t_max, lw, tw, mw, seed)
    from sqz_tpu_torch.ops import _build
    G, PW, B = payload.shape
    lit = launch.zeros((G, lw, B), torch.uint32, dev)
    tok = launch.zeros((G, tw, B), torch.uint32, dev)
    mrec = launch.zeros((G, mw, B), torch.uint32, dev)
    counts = launch.zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_decode_launch(
            payload.data_ptr(), meta.data_ptr(), G, PW, B, t_max,
            lit.data_ptr(), lw, tok.data_ptr(), tw, mrec.data_ptr(), mw,
            counts.data_ptr(), seed_ptr, DECODE_THREADS, stream)
    launch.launched(rc, "sqz4_decode")
    if seed is None:
        launch.count(decode)
    else:
        launch.count(decode, "seeded_launches")
    return lit, tok, mrec, counts


decode.launches = 0
decode.seeded_launches = 0


def encode_tok(toks: torch.Tensor, lits: torch.Tensor, t_max: int,
               cap_words: int, lit_skip: bool = False):
    """sqz4 token encoder: toks uint32 [G, B, Tt] (one token row per
    block, as ``native.sqz4_tok_plan`` emits them), lits uint8 [G, B, L]
    (each block's literal bytes), at most ``t_max`` op pairs a block ->
    (payload words uint32 [G, cap_words, B], lens int32 [G, 8, B]), the
    op-stream encoder's outputs for the same parse. ``lit_skip`` (the
    resident paths): lits holds the raw blocks and each match token skips
    the bytes it covers; its launches count in ``lit_skip_launches``."""
    launch.check_tensor(toks, "toks", torch.uint32)
    launch.check_tensor(lits, "lits", torch.uint8)
    if toks.shape[:2] != lits.shape[:2]:
        raise ValueError("toks and lits differ in groups or lanes")
    dev = launch.kernel_device(toks, lits)
    if dev.type == "cpu":
        return sqz4_ref.encode_tok_ref(toks, lits, t_max, cap_words,
                                       lit_skip)
    from sqz_tpu_torch.ops import _build
    G, B, TT = toks.shape
    words = launch.zeros((G, cap_words, B), torch.uint32, dev)
    lens = launch.zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_encode_tok_launch(
            toks.data_ptr(), TT, lits.data_ptr(), lits.shape[2], G, B, t_max,
            words.data_ptr(), cap_words, lens.data_ptr(), TOK_THREADS,
            int(lit_skip), stream)
    launch.launched(rc, "sqz4_encode_tok")
    if lit_skip:
        launch.count(encode_tok, "lit_skip_launches")
    else:
        launch.count(encode_tok)
    return words, lens


encode_tok.launches = 0
encode_tok.lit_skip_launches = 0


def encode_stats(start: torch.Tensor, size: torch.Tensor,
                 total: torch.Tensor, cap_words: int):
    """sqz4 stats-fed encoder: start / size / total uint32 [G, T, B], each
    op's coder statistics (total 0: a pad; size 0 with total != 0: a
    flush; anything else coded; totals below 2^17, where the kernel's
    divide is exact) -> (payload words uint32 [G, cap_words, B], lens
    int32 [G, 8, B]), as ``encode_full``'s."""
    for t, name in ((start, "start"), (size, "size"), (total, "total")):
        launch.check_tensor(t, name, torch.uint32)
    if not start.shape == size.shape == total.shape:
        raise ValueError("start, size and total differ in shape")
    dev = launch.kernel_device(start, size, total)
    if dev.type == "cpu":
        return sqz4_ref.encode_stats_ref(start, size, total, cap_words)
    from sqz_tpu_torch.ops import _build
    G, T, B = start.shape
    words = launch.zeros((G, cap_words, B), torch.uint32, dev)
    lens = launch.zeros((G, 8, B), torch.int32, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_encode_stats_launch(
            start.data_ptr(), size.data_ptr(), total.data_ptr(), G, T, B,
            words.data_ptr(), cap_words, lens.data_ptr(), STATS_THREADS,
            stream)
    launch.launched(rc, "sqz4_encode_stats")
    launch.count(encode_stats)
    return words, lens


encode_stats.launches = 0

# model totals must stay below this: the reference's stats-fed TPU
# encoder divides exactly only there (sqz4_pallas.py encode_groups)
STATS_TOTAL_LIMIT = 1 << 15


def pack_group_stats(arrs, lanes: int = host.LANES):
    """[NB, T] u32 stats -> [G, T, lanes] kernel layout (lanes past NB
    zero: zero totals are pads)."""
    nb, t = arrs[0].shape
    G = -(-nb // lanes)
    out = []
    for a in arrs:
        buf = np.zeros((G * lanes, t), dtype=np.uint32)
        buf[:nb] = a
        out.append(np.ascontiguousarray(
            buf.reshape(G, lanes, t).transpose(0, 2, 1)))
    return out


def encode_groups(start: np.ndarray, size: np.ndarray, total: np.ndarray,
                  cap: int, device="cuda", lanes: int = host.LANES):
    """Per-op statistics [NB, T] u32 each -> NB payload byte strings, the
    bytes the model-driven encoders give for the same op streams. Totals
    must stay below 2^15 (the reference's contract); ValueError
    otherwise."""
    if int(total.max(initial=0)) >= STATS_TOTAL_LIMIT:
        raise ValueError("totals exceed divider range (must stay below "
                         "2^15)")
    dev = torch.device(device)
    cap_words = host.cap_words_for(cap)
    st, sz, tt = (convert.to_device(a, dev) for a in pack_group_stats(
        (start, size, total), lanes))
    words, lens = encode_stats(st, sz, tt, cap_words)
    lens = convert.to_numpy(lens)
    if int(lens[:, 0].max(initial=0)) > cap_words * 4:
        raise ValueError("compressed block exceeded the output capacity")
    return host.unpack_group_payloads(
        convert.to_numpy(words[:, :host.trimmed_rows(lens)]), lens,
        start.shape[0])


def compact_words(words: torch.Tensor, lens: torch.Tensor, nb: int):
    """Payload compaction: words uint32 [1, R, B] (lane b's payload in the
    first rows of column b), lens int32 [1, 8, B] (row 0 byte lengths) ->
    uint32 [total]: the first ``nb`` lanes' payload words, lane after
    lane. The output size is read from the lengths (one small download)."""
    launch.check_tensor(words, "words", torch.uint32)
    launch.check_tensor(lens, "lens", torch.int32)
    _, R, B = words.shape
    if words.shape[0] != 1 or lens.shape != (1, 8, B) or not 0 <= nb <= B:
        raise ValueError("compaction takes words [1, R, B], lens [1, 8, B] "
                         "and 0 <= nb <= B")
    dev = launch.kernel_device(words, lens)
    if dev.type == "cpu":
        return sqz4_ref.compact_ref(words, lens, nb)
    from sqz_tpu_torch.ops import _build
    offsets = sqz4_ref.compact_offsets(lens, nb, R)
    out = torch.empty(int(offsets[-1]), dtype=torch.int32,
                      device=dev).view(torch.uint32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_compact_launch(
            words.data_ptr(), B, offsets.data_ptr(), nb, out.data_ptr(),
            COMPACT_ROWS, stream)
    launch.launched(rc, "sqz4_compact")
    launch.count(compact_words)
    return out


compact_words.launches = 0


def pack_ops_words(x8: torch.Tensor) -> torch.Tensor:
    """Op-stream relayout: [G, B, R] uint8 (one contiguous row per block,
    as ``native.sqz4_fast_plan`` emits them) -> the kernel's [G, R/4, B]
    uint32 layout, four big-endian ops a word."""
    G, B, R = x8.shape
    x = x8.to(torch.int64).reshape(G, B, R // 4, 4)
    w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) | x[..., 3]
    return sqz4_ref.to_u32(w.transpose(1, 2).contiguous())


def encode_data_full(data: bytes, blk_bits: int, window: int, lz: bool,
                     cap: int, parse: str = "auto", device="cuda",
                     lanes: int = host.LANES, stats: dict = None,
                     warm: bool = False):
    """Whole-buffer encode -> one payload per 2^blk_bits block.

    ``parse`` 'exact' plans with ``native.sqz4_plan_pack`` (payloads equal
    the native engine's); 'fast' (the 'auto' default, SQZ_PARSE overrides)
    with ``native.sqz4_fast_plan`` (SQZ_FAST_DEPTH hash-chain links) plus
    the device relayout. ``stats`` (optional dict) accumulates the stage
    times plan_s, upload_s, kernel_s and fetch_s.

    ``warm`` (sqzt v2, FORMAT.md §3.1; the seeded device pass of
    sqz4_pallas.encode_data_full): blocks 1+ match into block 0's tail and
    start their models from its rescaled final state, which the planner
    returns (the seeded kernel); block 0 stays cold. A seed that
    mismatches a block's content may expand it, so the capacity grows by a
    quarter block, and a block past it is coded again on the host codec,
    seeded the same way."""
    check_blk_bits(blk_bits)
    dev = torch.device(device)
    parse = host.parse_mode(parse)
    bs = 1 << blk_bits
    nb = max(1, -(-len(data) // bs))
    warm = warm and nb > 1
    tp_cap = host.op_stream_cap(blk_bits)
    st = launch.Stages(stats, dev)
    if parse == "fast":
        plan = native.sqz4_fast_plan(data, window, blk_bits, lz, tp_cap,
                                     warm=warm, depth=fast_depth())
        m8, s8, mx = plan[:3]
        rows = -(-int(mx) // 4)
        st.mark("plan_s")
        m_u8, s_u8 = convert.fast_plan_inputs(m8, s8, lanes, rows, dev)
        m_ops, s_ops = pack_ops_words(m_u8), pack_ops_words(s_u8)
    else:
        plan = native.sqz4_plan_pack(data, window, blk_bits, lz, lanes,
                                     tp_cap, warm=warm)
        mw, sw, mx = plan[:3]
        rows = -(-int(mx) // 4)
        st.mark("plan_s")
        m_ops, s_ops = convert.encoder_inputs(mw, sw, rows, dev)
    seed = plan[3] if warm else None
    seed_t = (convert.to_device(host.seed_column(seed), dev) if warm
              else None)
    st.mark("upload_s")
    cap_words = host.cap_words_for(cap + bs // 4 if warm else cap)
    words, lens = encode_full(m_ops, s_ops, cap_words, seed_t,
                              0 if warm else -1)
    lens = convert.to_numpy(lens)
    st.mark("kernel_s")
    over = np.nonzero(lens[:, 0].reshape(-1)[:nb] > cap_words * 4)[0]
    if over.size and not warm:
        raise ValueError("compressed block exceeded the output capacity")
    words = convert.to_numpy(words[:, :host.trimmed_rows(lens)])
    payloads = host.unpack_group_payloads(words, lens, nb)
    dictionary = data[:bs][-window:] if lz else b""
    for b in over.tolist():
        payloads[b] = native.sqz4_compress_payload(
            data[b * bs:(b + 1) * bs], window, lz=lz,
            seed=seed if b else None, dictionary=dictionary if b else b"")
    st.mark("fetch_s")
    return payloads


def fast_depth() -> int:
    """Hash-chain links of the fast parse: SQZ_FAST_DEPTH, default 32."""
    return int(os.environ.get("SQZ_FAST_DEPTH", "32"))


def fetch_mode() -> str:
    """How encoder payloads come to the host: SQZ_FETCH 'compact' (packed
    on the card first, the default) or 'trim' (the rectangle cut at the
    longest lane). Both give the same bytes."""
    mode = os.environ.get("SQZ_FETCH", "compact")
    if mode not in ("compact", "trim"):
        raise ValueError(f"SQZ_FETCH must be 'compact' or 'trim', not "
                         f"{mode!r}")
    return mode


def fetch_payloads(words, lens, nb: int, mode: str = "compact"):
    """The first ``nb`` payload byte strings of one group (words uint32
    [1, R, B], lens int32 [1, 8, B] on one device). ``mode`` 'compact'
    packs them on the device first so only payload bytes are downloaded
    (sqz4_pallas.py fetch_payloads_compact); 'trim' downloads the rows the
    longest payload fills. Raises if a payload outgrew the R rows."""
    lens_np = convert.to_numpy(lens)
    if int(lens_np[0, 0, :nb].max(initial=0)) > 4 * words.shape[1]:
        raise ValueError("compressed block exceeded the output capacity")
    if mode == "compact":
        buf = convert.to_numpy(compact_words(words, lens, nb)).astype(
            ">u4").tobytes()
        return [buf[s:s + n]
                for s, n in host.compact_byte_ranges(lens_np, nb)]
    return host.unpack_group_payloads(
        convert.to_numpy(words[:, :host.trimmed_rows(lens_np)]), lens_np, nb)


def collect_group(words, lens, nb: int, fetch: str, stats, t0: float):
    """Wait for a group's kernel (fence_s since ``t0``), then download its
    payloads (fetch_s)."""
    if words.is_cuda:
        torch.cuda.current_stream(words.device).synchronize()
    t = add_stage(stats, "fence_s", t0)
    out = fetch_payloads(words, lens, nb, fetch)
    add_stage(stats, "fetch_s", t)
    return out


class TokGroup(NamedTuple):
    """One group's token-transport plan (``plan_tok_group``): its block
    count, the blocks that fit the caps in lane order and those over them,
    the pair budget, and the slabs toks [1, len(fit), rows] and lits
    [1, len(fit), bytes] as int32 / uint8 host tensors."""
    nb: int
    fit: list
    over: list
    t_max: int
    toks: torch.Tensor
    lits: torch.Tensor


def plan_tok_group(chunk: bytes, blk_bits: int, window: int, lz: bool,
                   tok_cap: int = None, pin: bool = False) -> TokGroup:
    """Plan one group on the host: ``native.sqz4_tok_plan`` (fast parse),
    the straggler sort and the slabs, in pinned memory if ``pin`` (for
    asynchronous uploads). ``tok_cap`` overrides the token cap."""
    dflt_tok, lit_cap = host.tok_caps(blk_bits)
    toks, lits, counts, _mx = native.sqz4_tok_plan(
        chunk, window, blk_bits, lz, tok_cap or dflt_tok, lit_cap,
        depth=fast_depth())
    fit, over, rows, lbytes, t_max = host.tok_group_slab(counts)
    tt = torch.empty((1, len(fit), rows), dtype=torch.int32, pin_memory=pin)
    lt = torch.empty((1, len(fit), lbytes), dtype=torch.uint8,
                     pin_memory=pin)
    tt.numpy()[0] = toks[fit, :rows].view(np.int32)
    lt.numpy()[0] = lits[fit, :lbytes]
    return TokGroup(counts.shape[0], fit, over, t_max, tt, lt)


def add_stage(stats, key, t0):
    """Add the seconds since ``t0`` to ``stats[key]``; returns now."""
    now = time.perf_counter()
    if stats is not None:
        stats[key] = stats.get(key, 0.0) + now - t0
    return now


def encode_tok_group(grp: TokGroup, chunk: bytes, blk_bits: int,
                     window: int, lz: bool, cap: int, device="cuda",
                     fetch: str = "compact", stats: dict = None):
    """One planned group on ``device``: upload (asynchronous from pinned
    memory), the token kernel, the lengths (the fence), the payloads by
    ``fetch``; blocks over the token caps re-route through the op-stream
    kernel (sqz4_pallas.py:1476-1483). ``stats`` accumulates dispatch_s,
    fence_s and fetch_s. Returns the group's payloads in block order."""
    dev = torch.device(device)
    payloads = [None] * grp.nb
    if grp.fit:
        t = time.perf_counter()
        toks = grp.toks.to(dev, non_blocking=True).view(torch.uint32)
        lits = grp.lits.to(dev, non_blocking=True)
        words, lens = encode_tok(toks, lits, grp.t_max,
                                 host.cap_words_for(cap))
        t = add_stage(stats, "dispatch_s", t)
        for b, p in zip(grp.fit, collect_group(words, lens, len(grp.fit),
                                               fetch, stats, t)):
            payloads[b] = p
    if grp.over:
        bs = 1 << blk_bits
        sub = encode_data_full(
            b"".join(chunk[b * bs:(b + 1) * bs] for b in grp.over),
            blk_bits, window, lz, cap, parse="fast", device=dev)
        for b, p in zip(grp.over, sub):
            payloads[b] = p
    return payloads


def encode_data_tok(data: bytes, blk_bits: int, window: int, lz: bool,
                    cap: int, device="cuda", tok_cap: int = None):
    """Whole-buffer encode through the token kernel (fast parse), every
    fitting block in one launch; payloads equal ``encode_data_full``'s
    with ``parse="fast"`` (sqz4_pallas.py encode_data_tok)."""
    check_blk_bits(blk_bits)
    dev = torch.device(device)
    grp = plan_tok_group(data, blk_bits, window, lz, tok_cap,
                         pin=dev.type == "cuda")
    return encode_tok_group(grp, data, blk_bits, window, lz, cap, dev,
                            fetch_mode())


def fetch_decode_host(lit, tok, mrec, counts):
    """Download one decode call's record streams trimmed to the rows the
    counts say are used, transposed on the device to [G, lanes, rows]."""
    cnt = convert.to_numpy(counts)

    def rows(used, t):
        return max(1, min(t.shape[1], int(used)))

    def lane_major(t, r):
        return convert.to_numpy(t[:, :r, :].transpose(1, 2))

    lr = rows((cnt[:, 1].max(initial=0) + 3) // 4, lit)
    tr = rows((cnt[:, 2].max(initial=0) + 31) // 32, tok)
    mr = rows(cnt[:, 3].max(initial=0), mrec)
    return (lane_major(lit, lr), lane_major(tok, tr), lane_major(mrec, mr),
            cnt)


def decode_groups(payloads, sizes, blk_bits: int, device="cuda",
                  lanes: int = host.LANES, block_ids=None,
                  stats: dict = None, seed=None, dictionary: bytes = b""):
    """Payload byte strings + original sizes -> decoded blocks.

    ``seed`` / ``dictionary`` (sqzt v2 and v3 warm start, FORMAT.md §3.1):
    the model seed (u32[610], the anchor's final state) and the shared
    preset history every block of the call was coded with (the seeded
    kernel). Raises ValueError naming the caller's block index
    (``block_ids``, default positions) for a corrupt block. Payloads too
    long for the decoder buffer decode on the host codec, seeded the same
    way. ``stats`` (optional dict) accumulates pack_s, upload_s, kernel_s,
    fetch_s and assemble_s."""
    check_blk_bits(blk_bits)
    nb = len(payloads)
    if nb == 0:
        return []
    dev = torch.device(device)
    ids = list(block_ids) if block_ids is not None else list(range(nb))
    cap = 4 * host.plan_decode_dispatch(nb, blk_bits, lanes)["Pw"]
    outs = [None] * nb
    order = [b for b in range(nb) if len(payloads[b]) <= cap]
    for b in set(range(nb)) - set(order):
        outs[b] = host.host_decode(payloads[b], sizes[b], seed, dictionary)
    if not order:
        return outs
    plan = host.plan_decode_dispatch(len(order), blk_bits, lanes)
    pls = [payloads[b] for b in order]
    szs = [sizes[b] for b in order]
    # only the rows the longest payload fills are packed and uploaded: the
    # decoder reads bytes past its buffer as zeros, as it does the padding
    pw = min(plan["Pw"], host.payload_rows(max(map(len, pls))))
    st = launch.Stages(stats, dev)
    buf, meta = host.pack_decode_chunk(pls, szs, lanes, plan["G"], pw,
                                       len(dictionary))
    st.mark("pack_s")
    payload_t, meta_t = convert.decoder_inputs(buf, meta, dev)
    seed_t = (convert.to_device(host.seed_column(seed), dev)
              if seed is not None else None)
    st.mark("upload_s")
    res = decode(payload_t, meta_t, plan["t_max"], plan["lw"], plan["tw"],
                 plan["mw"], seed_t)
    st.mark("kernel_s")
    lt, tt, mt, cnt = fetch_decode_host(*res)
    st.mark("fetch_s")
    dec = host.postprocess_decode(lt, tt, mt, cnt, pls, szs,
                                  1 << blk_bits,
                                  block_ids=[ids[b] for b in order],
                                  transposed=True, seed=seed,
                                  dictionary=dictionary)
    st.mark("assemble_s")
    for pos, b in enumerate(order):
        outs[b] = dec[pos]
    return outs
