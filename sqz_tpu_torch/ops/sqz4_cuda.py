"""sqz4 kernel wrappers and the whole-buffer device encode and decode.

``encode_full``, ``encode_tok``, ``encode_stats``, ``model_stats``,
``exact_parse``, ``decode``, ``compact_words`` and ``pack_payloads``
launch the CUDA kernels (``csrc/``) for tensors on a CUDA device and run
the plain versions (``sqz4_ref``) for tensors on the CPU, but for
``exact_parse``, which runs the native planner there; any other device
raises.
Each counts its kernel launches in its ``launches`` attribute;
``encode_full`` and ``decode`` count their seeded (warm-start) launches
apart, in ``seeded_launches``, and ``encode_tok`` its lit_skip launches
(the resident paths) in ``lit_skip_launches``.

``plan_tok_group`` / ``encode_tok_group`` (the token transport) and
``collect_group`` are the pipeline's (``ops/pipeline.py``) steps of a
group: the native host planner -> tokens or op streams -> encoder kernel
-> payloads compacted on the card (``fetch_payloads``).
``encode_data_full`` is the whole-buffer encode through the op-stream
kernel in one launch (payloads downloaded trimmed), which the warm
containers' seeded pass and the reroute of blocks over the token caps
take. ``decode_groups`` is the decode: payloads (one upload, packed into
the decoder's words on the card) -> decoder kernel -> token records ->
native host assembly.
``encode_groups`` codes per-op statistics computed on the host
(``native.sqz4_model_stats``) through the stats-fed encoder, and
``encode_data_stats`` is the route above 64 KiB blocks around it (the
reference's scan route: the exact parse and the per-op statistics from
it on the card, one launch each a group of ``sqz4_host.group_lanes``
blocks); its decode is ``decode_groups`` at that group width. Blocks
ride lanes of ``[groups, rows, lanes]`` arrays, as in the reference.
"""

from __future__ import annotations

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
# Threads per CTA of the token encoder (csrc/sqz4_encode_tok.cu): one
# gang, four producer warps (token expansion, models, reciprocals, byte
# placement), one a block, and a coder warp whose lanes code the four
# blocks side by side (csrc/sqz4_pair.cuh); three gangs fit an SM. At one
# block a scheduler it runs as the pairs of four warps a CTA before it
# did; at three it has 2.1-2.4x their throughput (scripts/tok_timeline.py,
# PERF.md).
TOK_THREADS = 160
# Rows of a compaction tile (csrc/sqz4_compact.cu: 32 lanes x this many
# rows staged in shared memory; the launcher takes 64 or 128, and 128
# measured faster: scripts/chain_variants.py, PERF.md).
COMPACT_ROWS = 128


# The widest block the kernels take (csrc/sqz4_div.cuh kMaxBlockBits),
# the JAX package's own (its scan decoder's int32 step budget): the
# decoder's step budget t_max = 9 * bs + 64 is unsigned 32-bit, below
# 2^32 there; its counts and the coders' row indices and byte counts are
# int32, below 2^30. A model total starts at most at 2^14 (a warm seed)
# and grows by one a coded symbol, at most bs + 1 of them a block, so
# every total stays below 2^29, inside the range where the divider is
# exact (every divisor below 2^32).
MAX_BLOCK_BITS = 28
# The engine's 64 KiB main path (the op-stream, token and pipelined
# encoders, the reference's Pallas path) takes blocks up to 2^16 bytes;
# above, sqzt containers take the stats-fed route (``encode_data_stats``,
# the reference's scan route).
MAIN_BLK_BITS = 16


def check_main_blk_bits(blk_bits: int):
    """The op-stream and token paths take the reference's Pallas range."""
    if blk_bits > MAIN_BLK_BITS:
        raise ValueError(f"the op-stream and token paths take blk_bits <= "
                         f"{MAIN_BLK_BITS}; larger blocks take "
                         f"encode_data_stats")


def check_block_bytes(nbytes: int):
    """Raise for a block wider than the kernels take (MAX_BLOCK_BITS)."""
    if nbytes > 1 << MAX_BLOCK_BITS:
        raise ValueError(f"sqz4 blocks of {nbytes} bytes exceed the "
                         f"kernels' 2^{MAX_BLOCK_BITS}; such containers "
                         f"take engine=\"native\"")


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
    [SEED_WORDS], from which every block starts its models. Blocks of up
    to 2^MAX_BLOCK_BITS bytes, any model total they reach (the divider is
    exact below 2^32); match records keep ``len << 16 | dist``, the
    distance bounded by the window."""
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
    flush; anything else coded; any total below 2^32, where the kernel's
    divide is exact, so any block up to 2^MAX_BLOCK_BITS bytes; T below
    2^31 rows, G * T * B past 2^31 elements) -> (payload words uint32
    [G, cap_words, B], lens int32 [G, 8, B]), as ``encode_full``'s."""
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


def pack_group_stats(arrs, dev, lanes: int = host.LANES):
    """(start, size, total) u32 [NB, T] each -> the stats-fed encoder's
    inputs, uint32 [G, T, lanes] on ``dev``: uploaded as they are and
    laid out lane-minor there (lanes past NB zero: zero totals are
    pads)."""
    nb, t = arrs[0].shape
    rows = convert.to_device(np.stack(arrs), dev).view(torch.int32)
    out = torch.zeros((3, -(-nb // lanes), t, lanes), dtype=torch.int32,
                      device=dev)
    for g in range(out.shape[1]):
        part = rows[:, g * lanes:(g + 1) * lanes]
        out[:, g, :, :part.shape[1]] = part.transpose(1, 2)
    return tuple(c.view(torch.uint32) for c in out)


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
    st, sz, tt = pack_group_stats((start, size, total), dev, lanes)
    words, lens = encode_stats(st, sz, tt, cap_words)
    lens = convert.to_numpy(lens)
    if int(lens[:, 0].max(initial=0)) > cap_words * 4:
        raise ValueError("compressed block exceeded the output capacity")
    return host.unpack_group_payloads(
        convert.to_numpy(words[:, :host.trimmed_rows(lens)]), lens,
        start.shape[0])


def model_stats(m_words: torch.Tensor, s_words: torch.Tensor, lanes: int,
                seed: torch.Tensor = None):
    """Per-op coder statistics of packed op streams: m_words / s_words
    uint32 [n, rows], block i's ops in row i (four big-endian u8 ops a
    word, as ``exact_parse`` gives them), ``seed`` None
    (cold) or the seed column, int32 [SEED_WORDS]
    (``sqz4_host.seed_column``), from which every block starts -> (start,
    size, total) uint32 [G, 4 * rows, lanes], ``encode_stats``' inputs:
    block i on lane i % lanes of group i // lanes, each op's statistics
    before its model's update, a flush (0, 0, 1), a pad and every lane
    past n (0, 0, 0), as ``sqz4_host.op_stats`` gives them. The kernels
    (``csrc/sqz4_model_stats.cu``: each chunk's counts, each chunk's base
    state summed here, each chunk's statistics) for tensors on the card,
    the plain version (``sqz4_ref.model_stats_ref``) for tensors on the
    CPU; a call counts once in ``model_stats.launches``."""
    launch.check_tensor(m_words, "m_words", torch.uint32, ndim=2)
    launch.check_tensor(s_words, "s_words", torch.uint32, ndim=2)
    if m_words.shape != s_words.shape or lanes < 1:
        raise ValueError("model statistics take m_words and s_words of one "
                         "[n, rows] shape and lanes >= 1")
    dev = launch.kernel_device(m_words, s_words)
    _seed_arg(seed, dev)
    if dev.type == "cpu":
        return sqz4_ref.model_stats_ref(m_words, s_words, lanes, seed)
    from sqz_tpu_torch.ops import _build
    n, rows = m_words.shape
    chunks = -(-4 * rows // sqz4_ref.MODEL_CHUNK_OPS)
    hist = torch.empty((n, chunks, sqz4_ref.SEED_WORDS), dtype=torch.int32,
                       device=dev)
    out = launch.zeros((3, -(-n // lanes), 4 * rows, lanes), torch.uint32,
                       dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch.launched(lib.sqz4_model_hist_launch(
            m_words.data_ptr(), s_words.data_ptr(), n, rows,
            hist.data_ptr(), stream), "sqz4_model_hist")
        base = sqz4_ref.chunk_bases(hist, seed)
        launch.launched(lib.sqz4_model_stats_launch(
            m_words.data_ptr(), s_words.data_ptr(), n, rows, lanes,
            base.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), stream), "sqz4_model_stats")
    launch.count(model_stats)
    return out[0], out[1], out[2]


model_stats.launches = 0


def exact_parse(data: torch.Tensor, offsets, lengths, window: int,
                lz: bool, rows: int, warm: bool = False):
    """The exact greedy parse of each lane's bytes as op streams: data
    uint8 [N], lane b its bytes ``data[offsets[b]:offsets[b] +
    lengths[b]]`` (host integers) -> (m_words, s_words uint32 [n, rows],
    lane b's ops in row b, four big-endian ops a word, pads m 0xFF and
    s 0; counts int64 [n], each lane's ops, past ``4 * rows`` where its
    row overflowed), the native planner's (``native.sqz4_plan_pack``)
    words. ``warm`` (sqzt v2, FORMAT.md §3.1; with ``lz`` and more than
    one lane): lanes 1+ match into lane 0's last min(its length,
    ``window``) bytes, as the warm pass's blocks 1+ into block 0's tail.
    The kernel (``csrc/sqz4_exact_parse.cu``, a CTA a lane) for a tensor
    on the card, counted in ``exact_parse.launches``; on the CPU the
    native planner itself (``sqz4_host.exact_op_streams``), which takes
    lanes of 2^k bytes back to back, the last shorter (ValueError
    otherwise)."""
    launch.check_tensor(data, "data", torch.uint8, ndim=1)
    offs, lens = [int(o) for o in offsets], [int(x) for x in lengths]
    n = len(offs)
    if not n or len(lens) != n or rows < 1 or not 2 <= window <= 1 << 16 \
            or any(o < 0 or x < 0 or o + x > data.shape[0]
                   for o, x in zip(offs, lens)):
        raise ValueError("the exact parse takes lanes inside the data, "
                         "rows >= 1 and a window of 2 to 2^16 bytes")
    dev = launch.kernel_device(data)
    if dev.type == "cpu":
        return _exact_parse_host(data, offs, lens, window, lz, rows, warm)
    from sqz_tpu_torch.ops import _build
    hist = min(lens[0], window) if warm and lz and n > 1 else 0
    lay = torch.tensor(offs + lens, dtype=torch.int64).to(dev)
    m = torch.empty((n, rows), dtype=torch.int32, device=dev)
    s = torch.empty_like(m)
    counts = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_exact_parse_launch(
            data.data_ptr(), lay.data_ptr(), n, offs[0] + lens[0] - hist,
            hist, window, int(lz), rows, m.data_ptr(), s.data_ptr(),
            counts.data_ptr(), stream)
    launch.launched(rc, "sqz4_exact_parse")
    launch.count(exact_parse)
    return m.view(torch.uint32), s.view(torch.uint32), counts


exact_parse.launches = 0


def _exact_parse_host(data, offs, lens, window, lz, rows, warm):
    """``exact_parse`` on the CPU: the lanes joined, one native planner
    call, its words cut or padded to ``rows``."""
    n = len(offs)
    bs = lens[0] if n > 1 else 1 << max(lens[0] - 1, 1).bit_length()
    if bs < 1 or bs & (bs - 1) or any(x != bs for x in lens[:-1]) \
            or lens[-1] > bs:
        raise ValueError("the host planner takes lanes of 2^k bytes back "
                         "to back, the last shorter")
    flat = data.numpy()
    chunk = b"".join(flat[o:o + x].tobytes() for o, x in zip(offs, lens))
    mw, sw, _, _ = host.exact_op_streams(chunk, window, bs.bit_length() - 1,
                                         lz, warm)
    have = min(rows, mw.shape[1])
    m = np.full((n, rows), 0xFFFFFFFF, np.uint32)
    s = np.zeros((n, rows), np.uint32)
    m[:, :have], s[:, :have] = mw[:, :have, 0], sw[:, :have, 0]
    counts = (mw[:, :, 0].astype(">u4").view(np.uint8) != 0xFF).sum(1)
    return (convert.to_device(m, data.device),
            convert.to_device(s, data.device),
            torch.from_numpy(counts.astype(np.int64)))


def upload_bytes(data: bytes, dev) -> torch.Tensor:
    """``data`` as uint8 [len(data)] on ``dev``: one host copy (into
    pinned memory for the card) and an asynchronous upload."""
    staged = torch.empty(len(data), dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    staged.numpy()[:] = np.frombuffer(data, np.uint8)
    return staged.to(dev, non_blocking=True) if dev.type == "cuda" \
        else staged


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


def pack_payloads(data: torch.Tensor, offsets: torch.Tensor,
                  lengths: torch.Tensor, pw: int):
    """The decoder's payload words: data uint8 [n] (payloads back to
    back), offsets and lengths int64 [G, lanes] (lane b of group g holds
    data[off:off + len]) -> uint32 [G, pw, lanes], each lane's bytes as
    big-endian words, zero past them. A lane longer than 4 * pw bytes, or
    outside the data, gets an all-zero column, as an empty lane. The
    kernel (``csrc/sqz4_pack.cu``) for tensors on the card, its plain
    version (``sqz4_ref.pack_payloads_ref``) for tensors on the CPU; its
    launches count in ``pack_payloads.launches``."""
    launch.check_tensor(data, "data", torch.uint8, ndim=1)
    launch.check_tensor(offsets, "offsets", torch.int64, ndim=2)
    launch.check_tensor(lengths, "lengths", torch.int64, ndim=2)
    if offsets.shape != lengths.shape or pw < 1:
        raise ValueError("payload packing takes offsets and lengths of one "
                         "[G, lanes] shape and pw >= 1")
    dev = launch.kernel_device(data, offsets, lengths)
    if dev.type == "cpu":
        return sqz4_ref.pack_payloads_ref(data, offsets, lengths, pw)
    from sqz_tpu_torch.ops import _build
    G, lanes = offsets.shape
    out = torch.empty((G, pw, lanes), dtype=torch.int32,
                      device=dev).view(torch.uint32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.library().sqz4_pack_launch(
            data.data_ptr(), data.shape[0], offsets.data_ptr(),
            lengths.data_ptr(), G, lanes, pw, out.data_ptr(), stream)
    launch.launched(rc, "sqz4_pack")
    launch.count(pack_payloads)
    return out


pack_payloads.launches = 0


def upload_payloads(payloads, groups: int, lanes: int, dev):
    """Payload byte strings, ``payloads[g * lanes + b]`` on lane b of group
    g (lanes past the list empty) -> ``pack_payloads``' inputs on ``dev``:
    the bytes joined back to back by one host copy (into pinned memory
    for the card, uploaded asynchronously), offsets and lengths."""
    lens = np.zeros(groups * lanes, np.int64)
    lens[:len(payloads)] = [len(p) for p in payloads]
    offs = np.zeros_like(lens)
    np.cumsum(lens[:-1], out=offs[1:])
    staged = torch.empty(int(lens.sum()), dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    flat = staged.numpy()
    for p, o in zip(payloads, offs.tolist()):
        flat[o:o + len(p)] = np.frombuffer(p, np.uint8)
    lay = torch.from_numpy(np.stack([offs, lens]).reshape(2, groups, lanes))
    if dev.type != "cuda":
        return staged, lay[0], lay[1]
    lay = lay.to(dev)
    return staged.to(dev, non_blocking=True), lay[0], lay[1]


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
    with ``native.sqz4_fast_plan`` plus the device relayout. ``stats``
    (optional dict) accumulates the stage times plan_s, upload_s,
    kernel_s and fetch_s.

    ``warm`` (sqzt v2, FORMAT.md §3.1; the seeded device pass of
    sqz4_pallas.encode_data_full): blocks 1+ match into block 0's tail and
    start their models from its rescaled final state, which the planner
    returns (the seeded kernel); block 0 stays cold. A seed that
    mismatches a block's content may expand it, so the capacity grows by a
    quarter block, and a block past it is coded again on the host codec,
    seeded the same way."""
    check_main_blk_bits(blk_bits)
    dev = torch.device(device)
    parse = host.parse_mode(parse)
    bs = 1 << blk_bits
    nb = max(1, -(-len(data) // bs))
    warm = warm and nb > 1
    tp_cap = host.op_stream_cap(blk_bits)
    st = launch.Stages("encode", stats, dev)
    with st.stage("plan"):
        if parse == "fast":
            plan = native.sqz4_fast_plan(data, window, blk_bits, lz, tp_cap,
                                         warm=warm)
        else:
            plan = native.sqz4_plan_pack(data, window, blk_bits, lz, lanes,
                                         tp_cap, warm=warm)
    # fast: a row of ops a block (u8); exact: the kernel's words
    m, s, mx = plan[:3]
    rows = -(-int(mx) // 4)
    with st.stage("upload"):
        if parse == "fast":
            m_u8, s_u8 = convert.fast_plan_inputs(m, s, lanes, rows, dev)
            m_ops, s_ops = pack_ops_words(m_u8), pack_ops_words(s_u8)
        else:
            m_ops, s_ops = convert.encoder_inputs(m, s, rows, dev)
        seed = plan[3] if warm else None
        seed_t = (convert.to_device(host.seed_column(seed), dev) if warm
                  else None)
    cap_words = host.cap_words_for(cap + bs // 4 if warm else cap)
    with st.stage("kernel"):
        words, lens = encode_full(m_ops, s_ops, cap_words, seed_t,
                                  0 if warm else -1)
        lens = convert.to_numpy(lens)
    over = np.nonzero(lens[:, 0].reshape(-1)[:nb] > cap_words * 4)[0]
    if over.size and not warm:
        raise ValueError("compressed block exceeded the output capacity")
    with st.stage("fetch"):
        words = convert.to_numpy(words[:, :host.trimmed_rows(lens)])
        payloads = host.unpack_group_payloads(words, lens, nb)
        dictionary = data[:bs][-window:] if lz else b""
        for b in over.tolist():
            payloads[b] = native.sqz4_compress_payload(
                data[b * bs:(b + 1) * bs], window, lz=lz,
                seed=seed if b else None,
                dictionary=dictionary if b else b"")
    return payloads


def fetch_payloads(words, lens, nb: int):
    """The first ``nb`` payload byte strings of one group (words uint32
    [1, R, B], lens int32 [1, 8, B] on one device), packed on the device
    first so only payload bytes are downloaded (``compact_words``;
    sqz4_pallas.py fetch_payloads_compact). Raises if a payload outgrew
    the R rows."""
    lens_np = convert.to_numpy(lens)
    if int(lens_np[0, 0, :nb].max(initial=0)) > 4 * words.shape[1]:
        raise ValueError("compressed block exceeded the output capacity")
    buf = convert.to_numpy(compact_words(words, lens, nb)).astype(
        ">u4").tobytes()
    return [buf[s:s + n] for s, n in host.compact_byte_ranges(lens_np, nb)]


def collect_group(words, lens, nb: int, st: launch.Stages):
    """Wait for a group's kernel (the stage ``fence`` of ``st``), then
    download its payloads (``fetch_payloads``)."""
    with st.stage("fence"):
        if words.is_cuda:
            torch.cuda.current_stream(words.device).synchronize()
    with st.stage("fetch"):
        return fetch_payloads(words, lens, nb)


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
        chunk, window, blk_bits, lz, tok_cap or dflt_tok, lit_cap)
    fit, over, rows, lbytes, t_max = host.tok_group_slab(counts)
    tt = torch.empty((1, len(fit), rows), dtype=torch.int32, pin_memory=pin)
    lt = torch.empty((1, len(fit), lbytes), dtype=torch.uint8,
                     pin_memory=pin)
    tt.numpy()[0] = toks[fit, :rows].view(np.int32)
    lt.numpy()[0] = lits[fit, :lbytes]
    return TokGroup(counts.shape[0], fit, over, t_max, tt, lt)


def encode_tok_group(grp: TokGroup, chunk: bytes, blk_bits: int,
                     window: int, lz: bool, cap: int, device,
                     st: launch.Stages):
    """One planned group on ``device``: upload (asynchronous from pinned
    memory), the token kernel, the lengths (the fence), the payloads
    (``collect_group``); blocks over the token caps re-route through the
    op-stream kernel (sqz4_pallas.py:1476-1483). ``st`` (the pipeline's
    stages) times and names dispatch, fence and fetch. Returns the
    group's payloads in block order."""
    dev = torch.device(device)
    payloads = [None] * grp.nb
    if grp.fit:
        with st.stage("dispatch"):
            toks = grp.toks.to(dev, non_blocking=True).view(torch.uint32)
            lits = grp.lits.to(dev, non_blocking=True)
            words, lens = encode_tok(toks, lits, grp.t_max,
                                     host.cap_words_for(cap))
        for b, p in zip(grp.fit, collect_group(words, lens, len(grp.fit),
                                               st)):
            payloads[b] = p
    if grp.over:
        bs = 1 << blk_bits
        sub = encode_data_full(
            b"".join(chunk[b * bs:(b + 1) * bs] for b in grp.over),
            blk_bits, window, lz, cap, parse="fast", device=dev)
        for b, p in zip(grp.over, sub):
            payloads[b] = p
    return payloads


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
    """Payload byte strings + original sizes -> decoded blocks, every
    group of ``lanes`` blocks in one launch, the buffers sized from the
    largest block (``plan_decode_dispatch``).

    ``seed`` / ``dictionary`` (sqzt v2 and v3 warm start, FORMAT.md §3.1):
    the model seed (u32[610], the anchor's final state) and the shared
    preset history every block of the call was coded with (the seeded
    kernel). Raises ValueError naming the caller's block index
    (``block_ids``, default positions) for a corrupt block. Payloads too
    long for the decoder buffer decode on the host codec, seeded the same
    way (``sqz4_host.host_decode``, counted). ``stats`` (optional dict)
    accumulates pack_s, upload_s, kernel_s, fetch_s and assemble_s."""
    nb = len(payloads)
    if nb == 0:
        return []
    largest = max(sizes)
    check_block_bytes(largest)
    dev = torch.device(device)
    ids = list(block_ids) if block_ids is not None else list(range(nb))
    cap = 4 * host.plan_decode_dispatch(nb, blk_bits, lanes, largest)["Pw"]
    outs = [None] * nb
    order = [b for b in range(nb) if len(payloads[b]) <= cap]
    for b in set(range(nb)) - set(order):
        outs[b] = host.host_decode(payloads[b], sizes[b], seed, dictionary)
    if not order:
        return outs
    plan = host.plan_decode_dispatch(len(order), blk_bits, lanes, largest)
    pls = [payloads[b] for b in order]
    szs = [sizes[b] for b in order]
    # only the rows the longest payload fills are packed: the decoder
    # reads bytes past its buffer as zeros, as it does the padding
    pw = min(plan["Pw"], host.payload_rows(max(map(len, pls))))
    st = launch.Stages("decode", stats, dev)
    with st.stage("upload"):
        data, offs, lens = upload_payloads(pls, plan["G"], lanes, dev)
        meta_t = convert.to_device(host.decode_meta(
            pls, szs, lanes, plan["G"], pw, len(dictionary)), dev)
        seed_t = (convert.to_device(host.seed_column(seed), dev)
                  if seed is not None else None)
    with st.stage("pack"):
        payload_t = pack_payloads(data, offs, lens, pw)
    with st.stage("kernel"):
        res = decode(payload_t, meta_t, plan["t_max"], plan["lw"],
                     plan["tw"], plan["mw"], seed_t)
    with st.stage("fetch"):
        lt, tt, mt, cnt = fetch_decode_host(*res)
    with st.stage("assemble"):
        dec = host.postprocess_decode(lt, tt, mt, cnt, pls, szs,
                                      host.block_bytes(blk_bits, largest),
                                      block_ids=[ids[b] for b in order],
                                      transposed=True, seed=seed,
                                      dictionary=dictionary)
    for pos, b in enumerate(order):
        outs[b] = dec[pos]
    return outs


def encode_data_stats(data: bytes, blk_bits: int, window: int, lz: bool,
                      warm: bool = False, blocks=None, device="cuda",
                      stats: dict = None):
    """Whole-buffer encode through the stats-fed encoder -> one payload a
    block: the reference's scan route (sqz4_jax.encode_blocks), which the
    engine takes above 64 KiB blocks. The bytes go up as one range; each
    group of ``sqz4_host.group_lanes`` blocks is parsed exactly
    (``exact_parse``: the kernel on the card, a CTA a block), its per-op
    model statistics computed from the op words (``model_stats``) and
    coded in one launch; payloads equal the native engine's exact parse.
    The capacity is the reference's, twice the largest block plus 4096
    bytes (ValueError past it).

    ``warm`` (sqzt v2, FORMAT.md §3.1): the seeded pass, in which blocks
    match into block 0's tail and start their models from its rescaled
    final state (sqz4_jax.seed_from_tokens; ``sqz4_host.seed_from_ops``
    of block 0's ops, which each group parses first). ``blocks``: the
    indices of the blocks to code (default all; the warm pass codes the
    warm gate's candidates, which are not block 0). ``stats`` (optional
    dict) accumulates the stage times plan_s (the bytes' upload, the
    exact parse, its op count's fetch), upload_s (the warm seed column),
    model_s (the per-op statistics, ``model_stats``), kernel_s and
    fetch_s."""
    dev = torch.device(device)
    bs = 1 << blk_bits
    nb = max(1, -(-len(data) // bs))
    idx = list(range(nb)) if blocks is None else list(blocks)
    largest = min(bs, len(data))
    check_block_bytes(largest)
    cap_words = host.cap_words_for(2 * largest + 4096)
    rows = host.op_stream_cap(blk_bits, len(data)) // 4
    lanes = host.group_lanes(len(idx))
    st = launch.Stages("encode", stats, dev)
    payloads, data_t = [], None
    for g0 in range(0, len(idx), lanes):
        grp = idx[g0:g0 + lanes]
        with st.stage("plan"):
            if data_t is None:
                data_t = upload_bytes(data, dev)
            # block 0 of the warm pass is parsed for its tail and seed only
            own = ([0] if warm else []) + grp
            m, s, counts = exact_parse(
                data_t, [b * bs for b in own],
                [min(bs, len(data) - b * bs) for b in own], window, lz, rows,
                warm)
            mx = int(counts.max())
            if mx > 4 * rows:
                raise ValueError("a block's op stream exceeded its rows")
            first, used = int(warm), -(-mx // 4)
            m_t, s_t = (w.view(torch.int32)[first:, :used].contiguous()
                        .view(torch.uint32) for w in (m, s))
            seed = (host.seed_from_ops(
                *(convert.to_numpy(w[0, :used]) for w in (m, s)),
                int(counts[0])) if warm else None)
        with st.stage("upload"):
            seed_t = (convert.to_device(host.seed_column(seed), dev)
                      if warm else None)
        with st.stage("model"):
            cols = model_stats(m_t, s_t, lanes, seed_t)
            if warm:   # up to the last op of any block: pads code nothing
                used = (cols[2].view(torch.int32) != 0).any(2).any(0)
                last = used.nonzero()
                t = int(last.max()) + 1 if last.numel() else 1
                cols = tuple(c[:, :t] for c in cols)
        with st.stage("kernel"):
            words, lens = encode_stats(*cols, cap_words)
        with st.stage("fetch"):
            payloads += fetch_payloads(words, lens, len(grp))
    return payloads
