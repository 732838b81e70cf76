"""Host-side glue of the sqz4 device path (numpy, no torch, no JAX).

Ports of the numpy helpers that live inside ``sqz_tpu/ops/sqz4_pallas.py``
(which cannot be imported without JAX): the parse policy, the decode
dispatch plan, payload packing for the decoder, payload unpacking for the
encoder, and the host stage after the decoder. Array layouts are the
reference's: ``[groups, rows, lanes]``, one block per lane.
"""

from __future__ import annotations

import os

import numpy as np

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


def cap_words_for(cap: int) -> int:
    """Encoder output rows for a payload byte capacity (32-row multiple,
    as the reference sizes them)."""
    return (-(-(cap + 3) // 4) + 31) // 32 * 32


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
    from sqz_tpu import native
    meta = np.zeros((groups, 8, lanes), dtype=np.int32)
    for i, p in enumerate(payloads):
        if len(p) > 4 * pw:
            raise ValueError(f"payload {i} ({len(p)} bytes) exceeds the "
                             f"decoder buffer ({4 * pw} bytes)")
        g, lane = divmod(i, lanes)
        meta[g, 0, lane] = len(p)
        meta[g, 1, lane] = sizes[i]
    if native.available():
        buf = native.sqz4_pack_payloads(payloads, lanes, pw)
        if buf.shape[0] < groups:
            buf = np.concatenate(
                [buf, np.zeros((groups - buf.shape[0],) + buf.shape[1:],
                               np.uint32)])
        return buf, meta
    buf = np.zeros((groups, pw, lanes), dtype=np.uint32)
    for i, p in enumerate(payloads):
        g, lane = divmod(i, lanes)
        w = np.frombuffer(p.ljust(-(-len(p) // 4) * 4, b"\0"), dtype=">u4")
        buf[g, :len(w), lane] = w
    return buf, meta


def assemble_tokens_numpy(tok_bits: np.ndarray, lits: bytes,
                          mrecs: np.ndarray, ntok: int, size: int) -> bytes:
    """Reference reconstruction of one block from the decoder's records."""
    out = bytearray()
    li = 0
    mi = 0
    for tix in range(ntok):
        if (int(tok_bits[tix >> 5]) >> (tix & 31)) & 1:
            rec = int(mrecs[mi])
            mi += 1
            length, dist = rec >> 16, rec & 0xFFFF
            for _ in range(length):
                out.append(out[-dist])
        else:
            out.append(lits[li])
            li += 1
    if len(out) != size:
        raise ValueError(f"records produce {len(out)} of {size} bytes")
    return bytes(out)


def postprocess_decode(lit, tok, mrec, counts, payloads, sizes, bs,
                       block_ids=None, transposed: bool = False):
    """Decoder records -> per-block output bytes (lane-major block order).

    Raises ValueError naming the block for an error lane or a block that
    produced the wrong length; lanes whose match records overflowed the
    record buffer (counts row 6) decode on the host codec instead, as the
    reference does. ``transposed``: lit/tok/mrec are [g, lanes, W];
    default is the kernel layout [g, W, lanes]."""
    from sqz_tpu import native
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
    if live.size and native.available():
        asm = native.assemble_blocks(
            tokb[live], litu8[live], mrecb[live],
            ntoks[live].astype(np.int64), szs[live], bs)
        for i, b in enumerate(live):
            outs[b] = asm[i, :sizes[b]].tobytes()
    else:
        for b in live:
            outs[b] = assemble_tokens_numpy(
                tokb[b], litu8[b].tobytes(), mrecb[b], int(ntoks[b]),
                sizes[b])
    return outs


def host_decode(payload: bytes, size: int) -> bytes:
    """One payload through the host codec (native, else the oracle)."""
    from sqz_tpu import native
    if native.available():
        return native.sqz4_decompress_payload(payload, size)
    from sqz_tpu.oracle.sqz4 import sqz4_decode_payload
    return sqz4_decode_payload(payload, size)
