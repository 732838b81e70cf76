"""Synthetic inputs: the generators of ``sqz_tpu/utils/corpus.py``, copied.

Each returns the reference generator's bytes for the same arguments;
``texty`` draws its words in one vectorized call (the same draws as the
reference's one-at-a-time loop), so 128 MiB take seconds.
"""

from __future__ import annotations

import numpy as np

WORDS = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over", b"lazy",
         b"dog", b"compression", b"squeeze", b"window", b"huffman"]


def zeros(n: int = 4096) -> bytes:
    return b"\x00" * n


def rle4(n: int = 4096) -> bytes:
    """4-byte repeating pattern — stresses overlapped backrefs."""
    return (b"\x01\x02\x03\x04" * ((n + 3) // 4))[:n]


def hello() -> bytes:
    return b"Hello World Hello.World Hello World"


def random_bytes(n: int, seed: int = 0) -> bytes:
    """Incompressible stress input."""
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def texty(n: int, seed: int = 0) -> bytes:
    """Compressible pseudo-text with repeated words, separated by spaces.
    Every word and its space take >= 4 bytes, so n // 4 + 1 words cover
    n bytes."""
    idx = np.random.default_rng(seed).integers(0, len(WORDS), size=n // 4 + 1)
    spaced = [w + b" " for w in WORDS]
    return b"".join([spaced[i] for i in idx.tolist()])[:n]
