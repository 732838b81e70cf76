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


def op_stream_cap(blk_bits: int) -> int:
    """Ops per block the planners may write: 5/2 ops per byte plus the EOS
    and flush tail, a multiple of 4 (four ops pack into one word)."""
    return -(-(5 * (1 << blk_bits) // 2 + 64) // 4) * 4


OP_FLUSH = 254   # the flush micro-op


def op_stream_stats(data: bytes, window: int, blk_bits: int,
                    lanes: int = LANES):
    """The stats-fed encoder's input for ``data``: every block's exact-parse
    LZ op stream (``native.sqz4_plan_pack``) turned into per-op coder
    statistics (``native.sqz4_model_stats``). Returns (start, size, total),
    each u32 [nblocks, T]: a flush as (0, 0, 1), since the model stats
    give it (0, 0, 0), which the encoder reads as a pad; pads (0, 0, 0)."""
    nb = max(1, -(-len(data) // (1 << blk_bits)))
    mw, sw, mx = native.sqz4_plan_pack(data, window, blk_bits, True, lanes,
                                       op_stream_cap(blk_bits))
    rows = -(-int(mx) // 4)
    out = np.zeros((3, nb, rows * 4), np.uint32)
    for b in range(nb):
        g, lane = divmod(b, lanes)
        m = mw[g, :rows, lane].astype(">u4").view(np.uint8)
        s = sw[g, :rows, lane].astype(">u4").view(np.uint8)
        out[:, b] = native.sqz4_model_stats(m, s)
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


def plan_decode_dispatch(nb: int, blk_bits: int, lanes: int = LANES):
    """Decoder buffer dimensions for ``nb`` blocks of 2^blk_bits bytes:
    groups ``G``, payload rows ``Pw`` (words), record rows ``lw`` / ``tw``
    / ``mw`` and the step budget ``t_max`` (the hang guard: a valid block
    needs fewer steps). Same values as sqz4_pallas.plan_decode_dispatch."""
    bs = 1 << blk_bits
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


def pack_decode_chunk(payloads, sizes, lanes: int, groups: int, pw: int):
    """Payload bytes -> ([groups, pw, lanes] big-endian u32 words, zero
    padded; [groups, 8, lanes] i32 meta: rows payload length, original
    size, dictionary length (0: cold blocks))."""
    meta = np.zeros((groups, 8, lanes), dtype=np.int32)
    for i, p in enumerate(payloads):
        if len(p) > 4 * pw:
            raise ValueError(f"payload {i} ({len(p)} bytes) exceeds the "
                             f"decoder buffer ({4 * pw} bytes)")
        g, lane = divmod(i, lanes)
        meta[g, 0, lane] = len(p)
        meta[g, 1, lane] = sizes[i]
    buf = native.sqz4_pack_payloads(payloads, lanes, pw)
    if buf.shape[0] < groups:
        buf = np.concatenate(
            [buf, np.zeros((groups - buf.shape[0],) + buf.shape[1:],
                           np.uint32)])
    return buf, meta


def postprocess_decode(lit, tok, mrec, counts, payloads, sizes, bs,
                       block_ids=None, transposed: bool = False):
    """Decoder records -> per-block output bytes (lane-major block order).

    Raises ValueError naming the block for an error lane or a block that
    produced the wrong length; lanes whose match records overflowed the
    record buffer (counts row 6) decode on the host codec instead, as the
    reference does. ``transposed``: lit/tok/mrec are [g, lanes, W];
    default is the kernel layout [g, W, lanes]."""
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
        outs[b] = host_decode(payloads[b], sizes[b])
    live = np.nonzero(ovf == 0)[0]
    if live.size:
        asm = native.assemble_blocks(
            tokb[live], litu8[live], mrecb[live],
            ntoks[live].astype(np.int64), szs[live], bs)
        for i, b in enumerate(live):
            outs[b] = asm[i, :sizes[b]].tobytes()
    return outs


def host_decode(payload: bytes, size: int) -> bytes:
    """One payload through the native host codec."""
    return native.sqz4_decompress_payload(payload, size)
