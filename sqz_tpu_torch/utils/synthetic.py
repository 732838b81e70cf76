"""Seeded synthetic inputs of the sqz4 encoders that reach every input
case, where a parse of real data reaches only some: every op code and
symbol of an op stream, flushes and pads anywhere, blocks of mixed
lengths. Used by the tests and ``chip_smoke.py`` to hold the encoder
kernels against their plain versions.

Blocks ride lanes of ``[groups, rows, lanes]`` uint32 arrays, as the
encoders take them. A block codes at most ``max_ops`` ops (keep it at
2^16 or less: the kernels' model totals then stay below 2^17).
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
