"""Pseudo-text from a seed: a frozen, vectorised copy of the program's
``utils.corpus.texty`` (words of a twelve-word list, each followed by a
space), giving the same bytes for the same ``n`` and seed, at 10^8
bytes in a few seconds.
"""

from __future__ import annotations

import numpy as np

WORDS = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
         b"dog", b"compression", b"squeeze", b"window", b"huffman"]


def texty(n: int, seed: int, words=WORDS, chunk: int = 1 << 22) -> bytes:
    """``n`` bytes: the words drawn by ``numpy.random.default_rng(seed)``
    in one call of ``n // 4 + 1`` draws, joined with spaces, cut at
    ``n``. Every word and its space take >= 4 bytes, so the draws cover
    ``n``."""
    spaced = [w + b" " for w in words]
    table = np.frombuffer(b"".join(spaced), np.uint8)
    lens = np.array([len(w) for w in spaced], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.random.default_rng(seed % (1 << 64)).integers(
        0, len(words), size=n // 4 + 1)
    out = np.empty(n, np.uint8)
    at = 0
    for c in range(0, idx.size, chunk):
        if at >= n:
            break
        w = idx[c:c + chunk]
        wl = lens[w]
        ends = np.cumsum(wl)
        k = min(int(ends[-1]), n - at)
        first = ends - wl                      # each word's first byte
        src = np.repeat(starts[w] - first, wl)[:k] + np.arange(k)
        out[at:at + k] = table[src]
        at += k
    return out.tobytes()


def make(cfg: dict, seed: int, device) -> bytes:
    """The configuration's buffer: ``cfg["bytes"]`` of texty."""
    return texty(cfg["bytes"], seed)
