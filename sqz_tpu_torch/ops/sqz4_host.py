"""Host-side glue of the sqz4 device path (numpy, no torch, no JAX).

Ports of the numpy helpers that live inside ``sqz_tpu/ops/sqz4_pallas.py``
and ``sqz_tpu/ops/pipeline.py`` (which cannot be imported without JAX):
the parse policy, the token transport's caps and group slabs, the decode
dispatch plan, payload packing for the decoder, payload unpacking for the
encoder, and the host stage after the decoder. Array layouts are the
reference's: ``[groups, rows, lanes]``, one block per lane.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from sqz_tpu_torch import native

LANES = 512   # blocks per group: the lane axis of the kernels' arrays


def parse_mode(parse: str = "auto") -> str:
    """Resolve the sqzt-path parse policy: 'fast' (bounded approximate
    matcher, the throughput default) or 'exact' (reference-semantics
    matcher). SQZ_PARSE overrides; 'auto' = fast."""
    env = os.environ.get("SQZ_PARSE")
    if env in ("fast", "exact"):
        return env
    return "fast" if parse == "auto" else parse


def op_stream_cap(blk_bits: int, largest: int = None) -> int:
    """Ops per block the planners may write: 5/2 ops per byte plus the EOS
    and flush tail, a multiple of 4 (four ops pack into one word), for
    blocks of 2^blk_bits bytes, or of ``largest`` bytes where it is
    smaller (the largest block of the call)."""
    return -(-(5 * block_bytes(blk_bits, largest) // 2 + 64) // 4) * 4


def block_bytes(blk_bits: int, largest: int = None) -> int:
    """The block size buffers are sized from: 2^blk_bits, or the call's
    ``largest`` block where it is smaller (a short container at a large
    ``blk_bits`` allocates for its bytes, not for 2^blk_bits)."""
    bs = 1 << blk_bits
    return bs if largest is None else min(bs, max(int(largest), 1))


def group_lanes(nblocks: int) -> int:
    """Lanes a group of the route above 64 KiB blocks: ``min(LANES,
    nblocks)`` rounded up to 32, so that one group's host plan and card
    buffers (a few times its blocks' bytes each) stay near its data."""
    return -(-min(LANES, max(nblocks, 1)) // 32) * 32


OP_FLUSH = 254   # the flush micro-op


def op_stream_stats(data: bytes, window: int, blk_bits: int,
                    lz: bool = True, warm: bool = False):
    """The stats-fed encoder's input for ``data`` (the reference's scan
    route, sqz4_jax.encode_blocks and stats_for_ops): every block's
    exact-parse op stream (``exact_op_streams``) turned into per-op coder
    statistics (``op_stats``). ``warm`` (sqzt v2, FORMAT.md §3.1): blocks
    1+ match into block 0's tail and start their models from its rescaled
    final state, which the planner returns; block 0 stays cold. Returns
    (start, size, total), each u32 [nblocks, T]: a flush as (0, 0, 1),
    since the model stats give it (0, 0, 0), which the encoder reads as a
    pad; pads (0, 0, 0)."""
    return op_stats(exact_op_streams(data, window, blk_bits, lz, warm))


def exact_op_streams(data: bytes, window: int, blk_bits: int,
                     lz: bool = True, warm: bool = False):
    """Every block's exact-parse op stream (``native.sqz4_plan_pack``, one
    block a row), as ``op_stream_stats`` takes it: (m_words, s_words
    [nblocks, R, 1] u32, the longest stream's ops, the warm seed or None
    where the pass is cold)."""
    nb = max(1, -(-len(data) // (1 << blk_bits)))
    warm = warm and nb > 1
    # one block shorter than 2^blk_bits plans at the bits that hold it:
    # the planner reserves room for a whole block
    bits = min(blk_bits, max(len(data) - 1, 1).bit_length())
    plan = native.sqz4_plan_pack(data, window, bits, lz, 1,
                                 op_stream_cap(bits, len(data)), warm=warm)
    return plan[0], plan[1], int(plan[2]), plan[3] if warm else None


SEED_LIMIT = 1 << 14   # a seeded model's total after the capture rescale


def seed_from_ops(m_words: np.ndarray, s_words: np.ndarray,
                  count: int) -> np.ndarray:
    """The warm seed, u32[610] (literal[2], size[256], byte[256],
    bits[32], dist0[32], dist1[32]), from block 0's first ``count`` ops,
    packed four big-endian ops a u32 word: every count 1, one more a coded
    op, then each model's counts halved, rounding up, until its total is
    at most 2^14 (the native planner's seed4_from_ops; FORMAT.md §3.1)."""
    m, s = (np.asarray(w, np.uint32).astype(">u4").view(np.uint8)[:count]
            .astype(np.int64) for w in (m_words, s_words))
    slot = np.select([m == 0, m == 1, m == 2, m == 3, (m >= 4) & (m < 36)],
                     [s, 2 + s, 258 + s, 514 + s, 546 + 32 * s + m - 4],
                     native.SEED4_WORDS)
    f = 1 + np.bincount(slot, minlength=native.SEED4_WORDS + 1)[
        :native.SEED4_WORDS]
    models = [slice(0, 2), slice(2, 258), slice(258, 514), slice(514, 546)]
    models += [[546 + b, 578 + b] for b in range(32)]
    for k in models:
        g = f[k]
        while g.sum() > SEED_LIMIT:
            g = (g + 1) >> 1   # a count is at least 1: none reaches 0
        f[k] = g
    return f.astype(np.uint32)


def op_stats(streams):
    """``exact_op_streams``' op streams -> the per-op coder statistics
    (start, size, total) of ``op_stream_stats``, one
    ``native.sqz4_model_stats`` call a block, and the flush marks."""
    mw, sw, mx, seed = streams
    nb, rows = mw.shape[0], -(-mx // 4)
    out = np.zeros((3, nb, rows * 4), np.uint32)
    for b in range(nb):
        m = mw[b, :rows, 0].astype(">u4").view(np.uint8)
        s = sw[b, :rows, 0].astype(">u4").view(np.uint8)
        out[:, b] = native.sqz4_model_stats(
            m, s, seed=seed if b else None)
        out[2, b, m == OP_FLUSH] = 1
    return out[0], out[1], out[2]


def cap_words_for(cap: int) -> int:
    """Encoder output rows for a payload byte capacity (32-row multiple,
    as the reference sizes them)."""
    return (-(-(cap + 3) // 4) + 31) // 32 * 32


def tok_caps(blk_bits: int):
    """(tok_cap, lit_cap): tokens and literal bytes a block may plan into
    for the token transport (sqz4_pallas.py:1434-1435); a block whose
    parse needs more takes the op-stream path."""
    bs = 1 << blk_bits
    return min(-(-(2 * bs // 3 + 96) // 32) * 32, 1 << 14), max(bs, 128)


def tok_group_slab(counts: np.ndarray):
    """Sizing of one group's token slab from ``native.sqz4_tok_plan``'s
    counts (n_tok, n_lit, n_pairs per block; n_pairs < 0: over the caps).

    Returns (fit, over, rows, lit_bytes, t_max): the blocks that fit,
    sorted by pair count (the reference's straggler sort, pipeline.py:
    106-109), so lane i codes block fit[i]; the blocks over the caps; the
    slab's token rows and literal bytes per lane (the longest fitting
    block's, at least 1); and the pair budget (the longest block's)."""
    fit = sorted(np.nonzero(counts[:, 2] >= 0)[0].tolist(),
                 key=lambda b: int(counts[b, 2]))
    over = np.nonzero(counts[:, 2] < 0)[0].tolist()
    if not fit:
        return fit, over, 1, 1, 0
    cf = counts[fit]
    return (fit, over, max(1, int(cf[:, 0].max())),
            max(1, int(cf[:, 1].max())), int(cf[:, 2].max()))


def compact_byte_ranges(lens: np.ndarray, nb: int):
    """[(start, length)] of each of the first ``nb`` lanes' payload bytes
    in the compacted buffer: lane b's words follow lane b-1's."""
    blen = lens[0, 0, :nb].astype(np.int64)
    starts = np.zeros(nb, np.int64)
    starts[1:] = np.cumsum((blen[:-1] + 3) // 4) * 4
    return list(zip(starts.tolist(), blen.tolist()))


def unpack_group_payloads(words: np.ndarray, lens: np.ndarray, nb: int):
    """words [G, R, B] u32 (big-endian bytes), lens [G, 8, B] -> the first
    ``nb`` lanes' payload byte strings, lane-major block order."""
    lanes = words.shape[2]
    payloads = []
    for b in range(nb):
        g, lane = divmod(b, lanes)
        n = int(lens[g, 0, lane])
        payloads.append(
            words[g, :(n + 3) // 4, lane].astype(">u4").tobytes()[:n])
    return payloads


def trimmed_rows(lens: np.ndarray) -> int:
    """Output rows the longest payload uses: only these are downloaded."""
    return (int(lens[:, 0].max(initial=0)) + 3) // 4


def payload_rows(nbytes: int) -> int:
    """Decoder buffer rows (32-row multiple) that hold ``nbytes``."""
    return max(32, ((nbytes + 3) // 4 + 31) // 32 * 32)


def plan_decode_dispatch(nb: int, blk_bits: int, lanes: int = LANES,
                         largest: int = None):
    """Decoder buffer dimensions for ``nb`` blocks of 2^blk_bits bytes, or
    of ``largest`` bytes where that is smaller (the largest block of the
    call): groups ``G``, payload rows ``Pw`` (words), record rows ``lw`` /
    ``tw`` / ``mw`` and the step budget ``t_max`` (the hang guard: a
    valid block needs fewer steps). Without ``largest``, the values of
    sqz4_pallas.plan_decode_dispatch."""
    bs = block_bytes(blk_bits, largest)
    cap = bs + 4096
    return dict(
        lanes=lanes,
        G=-(-nb // lanes),
        Pw=-(-cap // 4 + 31) // 32 * 32,
        lw=max(bs // 4, 32),
        tw=(-(-bs // 32) + 1 + 31) // 32 * 32,
        mw=max(bs // 4, 64),
        t_max=9 * bs + 64,
    )


def seed_column(seed) -> np.ndarray:
    """An sqz4 model seed (u32[610] counts: literal[2], size[256],
    byte[256], bits[32], dist0[32], dist1[32], FORMAT.md §3.1) -> the
    seeded kernels' column, int32[610] (csrc/sqz4_chain.cuh kSeed*; the
    reference's sqz4_pallas._enc_seed_table column): the byte, size and
    bits models' inclusive running sums, the literal counts, the
    distance-bit counts of 0, then of 1."""
    f = np.asarray(seed, dtype=np.int64)
    col = np.zeros(610, np.int32)
    col[0:256] = np.cumsum(f[258:514])
    col[256:512] = np.cumsum(f[2:258])
    col[512:544] = np.cumsum(f[514:546])
    col[544:546] = f[0:2]
    col[546:610] = f[546:610]
    return col


def decode_meta(payloads, sizes, lanes: int, groups: int, pw: int,
                dlen: int = 0) -> np.ndarray:
    """The decoder's [groups, 8, lanes] i32 meta for payloads of at most
    ``4 * pw`` bytes (ValueError past it): rows payload length, original
    size, dictionary length ``dlen``."""
    meta = np.zeros((groups, 8, lanes), dtype=np.int32)
    for i, p in enumerate(payloads):
        if len(p) > 4 * pw:
            raise ValueError(f"payload {i} ({len(p)} bytes) exceeds the "
                             f"decoder buffer ({4 * pw} bytes)")
        g, lane = divmod(i, lanes)
        meta[g, 0, lane] = len(p)
        meta[g, 1, lane] = sizes[i]
        meta[g, 2, lane] = dlen
    return meta


def pack_decode_chunk(payloads, sizes, lanes: int, groups: int, pw: int,
                      dlen: int = 0):
    """Payload bytes -> ([groups, pw, lanes] big-endian u32 words, zero
    padded; [groups, 8, lanes] i32 meta: rows payload length, original
    size, dictionary length ``dlen`` (0: cold blocks))."""
    meta = decode_meta(payloads, sizes, lanes, groups, pw, dlen)
    buf = native.sqz4_pack_payloads(payloads, lanes, pw)
    if buf.shape[0] < groups:
        buf = np.concatenate(
            [buf, np.zeros((groups - buf.shape[0],) + buf.shape[1:],
                           np.uint32)])
    return buf, meta


def postprocess_decode(lit, tok, mrec, counts, payloads, sizes, bs,
                       block_ids=None, transposed: bool = False, seed=None,
                       dictionary: bytes = b""):
    """Decoder records -> per-block output bytes (lane-major block order).

    Raises ValueError naming the block for an error lane or a block that
    produced the wrong length; lanes whose match records overflowed the
    record buffer (counts row 6) decode on the host codec instead, as the
    reference does. ``transposed``: lit/tok/mrec are [g, lanes, W];
    default is the kernel layout [g, W, lanes]. ``seed`` / ``dictionary``:
    the warm start the blocks were decoded with (the assembly reads
    matches into the dictionary; the host codec is seeded too)."""
    nb = len(payloads)
    if transposed:
        g, lanes = lit.shape[0], lit.shape[1]
        litb = lit.reshape(g * lanes, -1)[:nb]
        tokb = tok.reshape(g * lanes, -1)[:nb]
        mrecb = mrec.reshape(g * lanes, -1)[:nb]
    else:
        g, lanes = lit.shape[0], lit.shape[2]
        litb, tokb, mrecb = (
            np.ascontiguousarray(a.transpose(0, 2, 1).reshape(g * lanes, -1))
            [:nb] for a in (lit, tok, mrec))
    litu8 = litb.astype(">u4").view(np.uint8).reshape(nb, -1)
    cnt = counts.transpose(0, 2, 1).reshape(g * lanes, 8)[:nb]
    optr, ntoks, err, ovf = cnt[:, 0], cnt[:, 2], cnt[:, 4], cnt[:, 6]
    szs = np.asarray(sizes, dtype=np.int64)
    ids = list(block_ids) if block_ids is not None else list(range(nb))
    bad = np.nonzero(err * (1 - ovf))[0]
    if bad.size:
        raise ValueError(
            f"corrupt sqz4 block(s) {[ids[b] for b in bad]} "
            f"(codes {err[bad].tolist()})")
    short = np.nonzero((optr != szs) & (ovf == 0))[0]
    if short.size:
        raise ValueError(f"block {ids[short[0]]}: produced "
                         f"{optr[short[0]]} of {szs[short[0]]}")
    outs: list = [None] * nb
    for b in np.nonzero(ovf)[0]:
        outs[b] = host_decode(payloads[b], sizes[b], seed, dictionary)
    live = np.nonzero(ovf == 0)[0]
    if live.size:
        asm = native.assemble_blocks(
            tokb[live], litu8[live], mrecb[live],
            ntoks[live].astype(np.int64), szs[live], bs,
            dictionary=dictionary)
        for i, b in enumerate(live):
            outs[b] = asm[i, :sizes[b]].tobytes()
    return outs


def host_decode(payload: bytes, size: int, seed=None,
                dictionary: bytes = b"") -> bytes:
    """One payload through the native host codec (warm: ``seed`` and
    ``dictionary`` as the device pass takes them): the reference's one
    host decode beside its decoder kernel, for a payload longer than the
    decoder buffer and for a lane whose match records overflowed. Counted
    in ``host_decode.blocks``."""
    with _host_decode_lock:
        host_decode.blocks += 1
    return native.sqz4_decompress_payload(payload, size, seed=seed,
                                          dictionary=dictionary)


host_decode.blocks = 0
_host_decode_lock = threading.Lock()
