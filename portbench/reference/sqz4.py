"""A plain decoder of one sqz4 block payload (FORMAT.md §2): the 64-bit
adaptive range coder over per-symbol frequency models, and the token
grammar literal / match / end of stream.

Written for the benchmark's check, apart from the program under test: it
imports nothing of it. The models keep their cumulative frequencies in a
Fenwick tree, so a symbol costs a few dozen Python steps and a literal
block of 64 KiB decodes in about a second.
"""

from __future__ import annotations

MASK = (1 << 64) - 1
FREQ_CAP = 1 << 56      # a model stops counting at this total
MIN_LEN, MAX_LEN, EOS = 2, 254, 0xFF


class DecodeError(ValueError):
    """The payload is not a valid sqz4 block of the size asked for."""


class _Model:
    """An adaptive model over ``n`` symbols, each starting at frequency
    1, in a Fenwick tree over the next power of two."""

    __slots__ = ("freq", "tree", "total", "top")

    def __init__(self, n: int):
        top = 1 << (n - 1).bit_length()
        self.freq = [1] * n + [0] * (top - n)
        self.tree = [0] * (top + 1)
        for i in range(1, top + 1):
            self.tree[i] += self.freq[i - 1]
            j = i + (i & -i)
            if j <= top:
                self.tree[j] += self.tree[i]
        self.total = n
        self.top = top


def decode_block(payload: bytes, size: int) -> bytes:
    """One block's payload -> its ``size`` bytes; DecodeError where the
    stream breaks the format or does not make exactly ``size`` bytes."""
    data = payload
    n_in = len(data)
    pos = 0
    code = 0
    for _ in range(8):
        code = (code << 8) | (data[pos] if pos < n_in else 0)
        pos += 1
    low, rng = 0, MASK
    literal = _Model(2)
    sizes = _Model(256)
    byte = _Model(256)
    bits = _Model(32)
    dist = [_Model(2) for _ in range(32)]
    out = bytearray()

    def decode(m: _Model) -> int:
        nonlocal low, rng, code, pos
        total = m.total
        if rng < total:
            for _ in range(2):
                code = ((code << 8) | (data[pos] if pos < n_in else 0)) & MASK
                pos += 1
                low = (low << 8) & MASK
            rng = MASK - low
        r = rng // total
        cum = ((code - low) & MASK) // r
        if cum >= total:
            raise DecodeError("range coder: cumulative count past the total")
        tree = m.tree
        at, rem, step = 0, cum, m.top
        while step:
            nxt = at + step
            if tree[nxt] <= rem:
                at = nxt
                rem -= tree[nxt]
            step >>= 1
        low = (low + (cum - rem) * r) & MASK
        rng = (r * m.freq[at]) & MASK
        if total < FREQ_CAP:
            m.freq[at] += 1
            m.total = total + 1
            i = at + 1
            while i <= m.top:
                tree[i] += 1
                i += i & -i
        while (low >> 56) == (((low + rng) & MASK) >> 56):
            code = ((code << 8) | (data[pos] if pos < n_in else 0)) & MASK
            pos += 1
            low = (low << 8) & MASK
            rng = (rng << 8) & MASK
        return at

    while True:
        if decode(literal):
            if len(out) >= size:
                raise DecodeError("literal past the block's size")
            out.append(decode(byte))
            continue
        length = decode(sizes)
        if length == EOS:
            break
        if not MIN_LEN <= length <= MAX_LEN:
            raise DecodeError(f"match length {length} outside the format")
        nbits = decode(bits)
        d = 0
        for b in range(nbits - 1):
            d |= decode(dist[b]) << b
        if nbits > 0:
            d |= 1 << (nbits - 1)
        if d == 0 or d > len(out):
            raise DecodeError(f"match distance {d} outside the output")
        if len(out) + length > size:
            raise DecodeError("match past the block's size")
        if d >= length:
            start = len(out) - d
            out += out[start:start + length]
        else:
            unit = bytes(out[-d:])
            out += (unit * (length // d + 1))[:length]
    if len(out) != size:
        raise DecodeError(f"block made {len(out)} bytes, not {size}")
    return bytes(out)


def block_differs(job) -> int:
    """1 where ``job`` = (payload, the bytes it has to make) does not
    decode to them, else 0; a worker process's step."""
    payload, want = job
    try:
        return int(decode_block(payload, len(want)) != want)
    except DecodeError:
        return 1
