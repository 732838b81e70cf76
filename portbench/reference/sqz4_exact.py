"""A plain encoder of one sqz4 block with the exact parse (FORMAT.md §2.4
and its match policy, §1.5), whose payload a container made with
``parse="exact"`` has to hold byte for byte.

The parse: at each position ``i`` of the block, the longest match of 2 to
``min(254, bytes left)`` bytes that starts at some ``j`` in
``[i - window + 1, i - 1]`` (it may run past ``i``), the smallest
distance ``i - j`` among the longest; a match of at most 3 bytes whose
distance takes more than 3 bits is a literal; else a literal. The coder:
the 64-bit range coder over the adaptive models of §2.2-2.3.

Written for the benchmark's check, apart from the program under test and
from ``portbench.reference.sqz4`` (the decoder): it imports neither. The
longest match is searched with ``bytes.rfind`` (the latest start of a
given prefix is its smallest distance; a prefix that does not occur has
no longer extension that does), a few searches a token, so a block of 64
KiB of text takes about a second.
"""

from __future__ import annotations

MASK = (1 << 64) - 1
FREQ_CAP = 1 << 56
MIN_LEN, MAX_LEN, EOS = 2, 254, 0xFF


def longest_match(block: bytes, i: int, window: int):
    """(length, distance) of the longest match at ``i``, smallest distance
    among the longest; (0, 0) where no 2 bytes match."""
    cap = min(MAX_LEN, len(block) - i)
    if cap < MIN_LEN:
        return 0, 0
    lo = max(0, i - window + 1)

    def latest(length):
        # the largest j in [lo, i - 1] with block[j:j+length] equal to
        # block[i:i+length]; -1 where there is none
        return block.rfind(block[i:i + length], lo, i - 1 + length)

    j = latest(MIN_LEN)
    if j < 0:
        return 0, 0
    good, bad, step = MIN_LEN, cap + 1, 1
    while good + step < bad:                     # gallop up
        k = latest(good + step)
        if k < 0:
            bad = good + step
            break
        good, j = good + step, k
        step *= 2
    while bad - good > 1:                        # then halve
        mid = (good + bad) // 2
        k = latest(mid)
        if k < 0:
            bad = mid
        else:
            good, j = mid, k
    return good, i - j


def exact_tokens(block: bytes, window: int) -> list:
    """The exact parse of ``block``: ("lit", byte) and ("match", length,
    distance) in order."""
    out, i = [], 0
    while i < len(block):
        length, dist = longest_match(block, i, window)
        if length and length <= 3 and dist.bit_length() > 3:
            length = 0
        if length:
            out.append(("match", length, dist))
            i += length
        else:
            out.append(("lit", block[i]))
            i += 1
    return out


class _Model:
    """Frequencies of ``n`` symbols, each starting at 1, with the
    cumulative counts in a Fenwick tree."""

    __slots__ = ("freq", "tree", "total")

    def __init__(self, n: int):
        self.freq = [1] * n
        self.tree = [0] * (n + 1)
        for k in range(1, n + 1):
            self.tree[k] += 1
            up = k + (k & -k)
            if up <= n:
                self.tree[up] += self.tree[k]
        self.total = n

    def below(self, sym: int) -> int:
        s, k = 0, sym
        while k:
            s += self.tree[k]
            k -= k & -k
        return s

    def add(self, sym: int):
        if self.total >= FREQ_CAP:
            return
        self.freq[sym] += 1
        self.total += 1
        k, n = sym + 1, len(self.freq)
        while k <= n:
            self.tree[k] += 1
            k += k & -k


def encode_tokens(tokens) -> bytes:
    """The payload of ``tokens`` and the end of stream, by §2.3-2.4."""
    low, rng = 0, MASK
    out = bytearray()
    literal, sizes, byte, bits = _Model(2), _Model(256), _Model(256), \
        _Model(32)
    dist = [_Model(2) for _ in range(32)]

    def code(m: _Model, sym: int):
        nonlocal low, rng
        total = m.total
        r = rng // total
        low = (low + m.below(sym) * r) & MASK
        rng = (r * m.freq[sym]) & MASK
        m.add(sym)
        while (low >> 56) == (((low + rng) & MASK) >> 56):
            out.append(low >> 56)
            low = (low << 8) & MASK
            rng = (rng << 8) & MASK
        if rng < total + 1:
            for _ in range(2):
                out.append(low >> 56)
                low = (low << 8) & MASK
            rng = MASK - low

    for tok in tokens:
        if tok[0] == "lit":
            code(literal, 1)
            code(byte, tok[1])
            continue
        _, length, d = tok
        nbits = d.bit_length()
        code(literal, 0)
        code(sizes, length)
        code(bits, nbits)
        for b in range(nbits - 1):               # the top bit is implicit
            code(dist[b], (d >> b) & 1)
    code(literal, 0)
    code(sizes, EOS)
    for _ in range(8):
        out.append(low >> 56)
        low = (low << 8) & MASK
    return bytes(out)


def encode_block(block: bytes, window: int) -> bytes:
    """The exact-parse payload of one block."""
    return encode_tokens(exact_tokens(block, window))


def block_differs(job) -> int:
    """1 where ``job`` = (payload, the block's bytes, window) is not the
    exact-parse payload of the block, else 0; a worker process's step."""
    payload, block, window = job
    return int(encode_block(block, window) != payload)
