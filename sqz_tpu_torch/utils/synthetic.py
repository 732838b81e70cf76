"""Seeded synthetic inputs of the sqz4 encoders that reach every input
case, where a parse of real data reaches only some: every op code and
symbol of an op stream, flushes and pads anywhere, blocks of mixed
lengths; token rows over raw blocks for the token encoder's lit_skip
mode (``skip_tokens``); and ``resident_mix``, buffers whose cell parse
reaches every cell token kind. Used by the tests and ``chip_smoke.py`` to hold the
encoder kernels against their plain versions.

Blocks ride lanes of ``[groups, rows, lanes]`` uint32 arrays, as the
encoders take them. A block codes at most ``max_ops`` ops (any count
below 2^31 codes; its model totals stay far below the divider's 2^32).
"""

from __future__ import annotations

import numpy as np

FLUSH, PAD = 254, 255


def _lengths(rng, nb: int, max_ops: int) -> np.ndarray:
    """Per-block op counts: empty, short and full blocks, the rest
    uniform."""
    n = rng.integers(0, max_ops + 1, nb)
    n[::7] = max_ops
    n[3::11] = rng.integers(0, 40, n[3::11].size)
    n[5::13] = 0
    return n


def op_codes(rng, shape) -> tuple:
    """(models, symbols) uint8 of random ops: 88% coded (flag, size, byte
    and bits 12% each, the 32 distance bits the rest), 2% flushes, 10%
    pads (36..253 and 255); half the symbols from 0..7, so a window holds
    equal symbols, half from 0..255 (bits symbols past 31, binary symbols
    past 1)."""
    u = rng.random(shape)
    m = np.where(u < 0.48, rng.integers(0, 4, shape),
                 rng.integers(4, 36, shape))
    m = np.where(u >= 0.88, FLUSH, m)
    pads = rng.integers(36, 255, shape)
    m = np.where(u >= 0.90, np.where(pads == FLUSH, PAD, pads), m)
    s = np.where(rng.random(shape) < 0.5, rng.integers(0, 8, shape),
                 rng.integers(0, 256, shape))
    return m.astype(np.uint8), s.astype(np.uint8)


def pack_words(ops: np.ndarray, lanes: int) -> np.ndarray:
    """[NB, T] uint8 ops (T a multiple of 4) -> [G, T/4, lanes] uint32,
    four big-endian ops a word; lanes past NB hold pads."""
    nb, t = ops.shape
    g = -(-nb // lanes)
    buf = np.full((g * lanes, t), PAD, np.uint8)
    buf[:nb] = ops
    words = buf.reshape(g * lanes, t // 4, 4).astype(np.uint32)
    words = ((words[..., 0] << 24) | (words[..., 1] << 16)
             | (words[..., 2] << 8) | words[..., 3])
    return np.ascontiguousarray(
        words.reshape(g, lanes, t // 4).transpose(0, 2, 1))


def op_stream(nb: int, max_ops: int, seed: int, lanes: int = None):
    """Op streams of ``nb`` blocks (``encode_full``'s m_ops, s_ops): each
    block ``op_codes`` up to its length, then pads; every third block ends
    with the eight flushes of a real stream. Returns uint32 [G, T/4,
    lanes] each (lanes default nb)."""
    rng = np.random.default_rng(seed)
    lanes = lanes or nb
    t = max(4, -(-(max_ops + 8) // 4) * 4)
    m, s = op_codes(rng, (nb, t))
    n = _lengths(rng, nb, max_ops)
    live = np.arange(t)[None, :] < n[:, None]
    m = np.where(live, m, PAD).astype(np.uint8)
    for b in range(0, nb, 3):
        m[b, n[b]:n[b] + 8] = FLUSH
    return pack_words(m, lanes), pack_words(s, lanes)


def one_model(op: int, reps: int, seed: int):
    """One block: ``reps`` ops of one model in a row (symbols 0..7 and
    0..255), then the eight flushes. Returns m_ops, s_ops uint32 [1, T/4,
    1]."""
    rng = np.random.default_rng(seed)
    t = -(-(reps + 8) // 4) * 4
    m = np.full((1, t), PAD, np.uint8)
    m[0, :reps] = op
    m[0, reps:reps + 8] = FLUSH
    s = np.where(rng.random((1, t)) < 0.5, rng.integers(0, 8, (1, t)),
                 rng.integers(0, 256, (1, t))).astype(np.uint8)
    return pack_words(m, 1), pack_words(s, 1)


def planned_streams(lengths, seed: int, model: int = None):
    """Op streams of ``len(lengths)`` blocks with the given op counts, as
    the exact planner lays them out (``sqz4_host.exact_op_streams``, the
    model statistics' input): ``op_codes`` with the symbols a planner
    writes (bits up to 31, binary ones 0 or 1), every coded op of
    ``model`` where it is given, pads past each block's count. Returns
    m_words, s_words uint32 [nb, T/4], block b's ops in row b."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths)
    t = max(4, -(-int(lengths.max()) // 4) * 4)
    m, s = op_codes(rng, (lengths.size, t))
    if model is not None:
        m = np.where(m < 36, model, m)
    binary = (m == 0) | ((m >= 4) & (m < 36))
    s = np.where(m == 3, np.minimum(s, 31), np.where(binary, s != 0, s))
    m = np.where(np.arange(t)[None, :] < lengths[:, None], m, PAD)
    return tuple(pack_words(x.astype(np.uint8), lengths.size)[0].T.copy()
                 for x in (m, s))


def stats_stream(nb: int, max_rows: int, seed: int, lanes: int = None):
    """Statistics of ``nb`` blocks (``encode_stats``'s start, size,
    total): per row 10% pads (total 0), 3% flushes (size 0), the rest a
    coded interval [start, start + size) of a total below 2^15 (as
    ``encode_groups`` allows), half of them below 64; rows past a block's
    length are pads. Returns uint32 [G, T, lanes] each (lanes default
    nb)."""
    rng = np.random.default_rng(seed)
    lanes = lanes or nb
    t = max(1, max_rows)
    shape = (nb, t)
    total = np.where(rng.random(shape) < 0.5, rng.integers(1, 64, shape),
                     rng.integers(1, 1 << 15, shape))
    start = rng.integers(0, total)
    size = rng.integers(1, total - start + 1)
    u = rng.random(shape)
    size = np.where(u < 0.03, 0, size)
    total = np.where((u >= 0.03) & (u < 0.13), 0, total)
    n = _lengths(rng, nb, max_rows)
    total = np.where(np.arange(t)[None, :] < n[:, None], total, 0)
    g = -(-nb // lanes)
    out = []
    for a in (start, size, total):
        buf = np.zeros((g * lanes, t), np.uint32)
        buf[:nb] = a
        out.append(np.ascontiguousarray(
            buf.reshape(g, lanes, t).transpose(0, 2, 1)))
    return out


CELL = 128   # the resident cell parse's cell (ops/resident.py)


def resident_mix(nb: int, blk_bits: int, seed: int, tail: int = None):
    """``nb`` blocks of 2^blk_bits bytes (blk_bits >= 7) standing for
    checkpoint and activation buffers, five kinds in turn: sparse float32
    weights (about half their 128-byte cells zero, so isolated zero cells
    sit among nonzero ones); periodic content (periods 1, 2, 4, ..., 128
    in turn); cells that repeat earlier cells of the block within 255
    cells; pseudo-text; random bytes. The last block is cut to ``tail``
    bytes (default a third of a block). Returns bytes."""
    from sqz_tpu_torch.utils import corpus
    rng = np.random.default_rng(seed)
    bs = 1 << blk_bits
    nc = bs // CELL
    out = []
    for b in range(nb):
        kind = b % 5
        if kind == 0:
            w = rng.standard_normal(bs // 4).astype(np.float32)
            w.reshape(nc, CELL // 4)[rng.random(nc) < 0.5] = 0
            out.append(w.tobytes())
        elif kind == 1:
            period = 1 << (b // 5 % 8)
            pat = rng.integers(0, 256, period, dtype=np.uint8)
            out.append(np.tile(pat, bs // period).tobytes())
        elif kind == 2:
            cells = rng.integers(0, 256, (nc, CELL), dtype=np.uint8)
            for c in range(4, nc):
                if rng.random() < 0.7:
                    cells[c] = cells[c - int(rng.integers(1, min(c, 255)
                                                          + 1))]
            out.append(cells.tobytes())
        elif kind == 3:
            out.append(corpus.texty(bs, seed=seed + b))
        else:
            out.append(rng.integers(0, 256, bs, dtype=np.uint8).tobytes())
    data = b"".join(out)
    return data[:len(data) - bs + (bs // 3 if tail is None else tail)]


# lane 0 of skip_tokens: (0, n) a literal run, (1, len, dist) a match. A
# literal run, then a match whose drain outlasts its coding (a wait of six
# pairs), literals up to byte 255, a jump across the 256-byte chunk edge
# of the encoder's literal window, jumps over three more chunks with no
# literal between, a match whose coding outlasts its drain, a short one
_SKIP_LANE0 = ((0, 5), (1, 254, 1), (0, 250), (1, 200, 3), (1, 254, 7),
               (1, 254, 100), (1, 254, 4), (0, 20), (1, 128, 128),
               (1, 2, 3), (0, 1), (1, 33, 9000))


def _match_token(length: int, dist: int) -> int:
    return length | (1 << 8) | (dist.bit_length() << 9) | (dist << 16)


def skip_tokens(nb: int, blk_bits: int, seed: int):
    """Token rows over raw blocks for the token encoder's lit_skip mode:
    (toks uint32 [nb, Tt], raw uint8 [nb, 2^blk_bits], pairs int64 [nb],
    the op pairs each row takes). Lane 0 follows ``_SKIP_LANE0``, then
    random tokens; every lane random literal runs (1..255) and matches
    (len 2..254, distances up to the position), every fifth lane a block a
    third of the full size, and EOS. A match takes max(coding pairs,
    ceil(len / 32)) pairs, a literal one, EOS and its flushes five."""
    rng = np.random.default_rng(seed)
    bs = 1 << blk_bits
    raw = rng.integers(0, 256, (nb, bs), dtype=np.uint8)
    rows, pairs = [], np.zeros(nb, np.int64)
    for lane in range(nb):
        n = bs // 3 if lane % 5 == 4 else bs
        fixed = list(_SKIP_LANE0) if lane == 0 else []
        toks, pos = [], 0
        while pos < n:
            spec = fixed.pop(0) if fixed else (
                (0, int(rng.integers(1, 256))) if rng.random() < 0.4 else
                (1, int(rng.integers(2, 255)), int(rng.integers(1, 1 << 15))))
            k = min(spec[1], n - pos)
            if spec[0] == 0 or pos == 0 or k < 2:
                toks.append(k)
                pairs[lane] += k
            else:
                dist = min(spec[2], pos)
                toks.append(_match_token(k, dist))
                nd = max(dist.bit_length() - 1, 0)
                pairs[lane] += max(2 + nd // 2, -(-k // 32))
            pos += k
        rows.append(toks + [0x1FF])
        pairs[lane] += 5
    tt = max(map(len, rows)) + 1
    out = np.zeros((nb, tt), np.uint32)
    for lane, toks in enumerate(rows):
        out[lane, :len(toks)] = toks
    return out, raw, pairs
