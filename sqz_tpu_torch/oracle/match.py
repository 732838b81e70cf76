"""Exact greedy LZ77 match finder — scalar oracle (FORMAT.md §1.5, §2.4).

Result-equivalent to the reference's brute-force backward window scan
(attic/map_experiment/squeeze.h:340-358; the analogous disabled HEAD path is
src/sqz.c:637-654): for a query position ``i`` it returns the longest match
of length in [min_len, cap] against any j in [i-window+1, i-1], smallest
distance on ties, where cap = min(max_len, bytes-i). Overlapping matches
(dist < length) are allowed.

Implementation: hash chains keyed by the exact min_len-gram. Any match of
length >= min_len shares the gram, so walking the gram's chain nearest-first
visits exactly the candidates the brute-force scan could select, in the same
order; keeping strictly-longer matches reproduces the tie-break, and the walk
stops early once the cap is reached (no later candidate can win strictly).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Tuple


class MatchFinder:
    def __init__(self, data: bytes, window: int, min_len: int, max_len: int) -> None:
        self.data = data
        self.window = window
        self.min_len = min_len
        self.max_len = max_len
        self._chains: dict[bytes, list[int]] = defaultdict(list)
        self._inserted = 0  # positions [0, _inserted) are in the chains

    def _advance_to(self, i: int) -> None:
        data, g = self.data, self.min_len
        while self._inserted < i:
            p = self._inserted
            if p + g <= len(data):
                self._chains[data[p:p + g]].append(p)
            self._inserted += 1

    def find(self, i: int) -> Tuple[int, int]:
        """Best (length, distance) at position i, or (0, 0)."""
        data = self.data
        n = len(data) - i
        cap = min(self.max_len, n)
        if cap < self.min_len:
            return (0, 0)
        self._advance_to(i)
        chain = self._chains.get(data[i:i + self.min_len])
        if not chain:
            return (0, 0)
        lo = i - self.window + 1  # smallest admissible j (dist <= window-1)
        best_len = 0
        best_dist = 0
        for j in reversed(chain):  # nearest (smallest distance) first
            if j < lo:
                break
            # a strictly longer match must also agree at offset best_len —
            # one compare rejects most candidates, decisions unchanged
            if best_len and data[j + best_len] != data[i + best_len]:
                continue
            k = self.min_len  # gram already matched exactly
            while k < cap and data[j + k] == data[i + k]:
                k += 1
            if k > best_len:
                best_len = k
                best_dist = i - j
                if k == cap:  # strictly-longer is impossible: done
                    break
        return (best_len, best_dist)


def greedy_tokens(data: bytes, window: int, min_len: int, max_len: int,
                  reject=None, dictionary: bytes = b"") -> list:
    """Greedy parse into tokens: ('lit', byte) | ('match', length, dist).

    ``reject(length, dist) -> bool`` optionally demotes a candidate match to a
    literal (the sqz4 short-far rejection rule, src/sqz.c:678-685).

    ``dictionary``: preset history (sqzt v2 warm start, FORMAT.md §3.1) —
    matches may reach back into it (dist > position-in-data), still capped
    by the window. The parse starts at the first data byte.
    """
    buf = dictionary + data if dictionary else data
    mf = MatchFinder(buf, window, min_len, max_len)
    tokens = []
    i = len(dictionary)
    while i < len(buf):
        length, dist = mf.find(i)
        if length >= min_len and reject is not None and reject(length, dist):
            length = 0
        if length >= min_len:
            tokens.append(("match", length, dist))
            i += length
        else:
            tokens.append(("lit", buf[i]))
            i += 1
    return tokens
