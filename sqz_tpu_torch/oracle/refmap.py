"""Reference hash-map dictionary — faithful scalar replica (COMPONENTS #4/#5).

Replicates the reference's open-addressing match dictionary exactly:
``map_put`` / ``map_get`` / ``map_best`` / ``map_remove`` / ``map_clear``
(src/sqz.c:66-186). At reference HEAD this machinery is doubly dead —
``sqz_compress`` force-clears the map (src/sqz.c:591) AND discards
``map_best`` results (best_size is re-zeroed at src/sqz.c:656-657) — so no
reachable stream depends on it; this module exists to close the component
inventory with *behavioral* parity, differentially tested against the
reference's own static functions (tests/tools/map_harness.c compiles the
unmodified src/sqz.c and scripts these entry points directly).

Semantics pinned (each checked by the differential):
  * FNV-1a 64-bit over the keyed bytes (src/sqz.c:48-64).
  * Linear probing; probe stops at an EMPTY slot (bytes == 0) and walks
    through tombstones (bytes == -1) — tombstoned slots are never reused
    for insertion (src/sqz.c:103-133: the insert probe has the same stop
    condition as lookup).
  * ``map_put`` is a no-op once the table is >= 75% full (counting live
    entries only); a put of an already-present string updates the stored
    position to the nearer (current) occurrence and does NOT bump counters.
  * ``map_best`` walks prefix lengths 3,4,5,... accumulating the hash
    incrementally; an entry found at distance >= window is tombstoned
    (lazy eviction); the walk stops at the first miss. The best (longest)
    hit is then extended byte-by-byte up to ``sqz_max_len`` (254) past the
    current position, and an extended match is re-inserted at the current
    position with the extended length (src/sqz.c:135-180).
    The reference's length-walk index ``i`` is a ``uint8_t``; a walk that
    survived 254 consecutive hits would wrap and drive an assert-failing
    length-1 lookup — unreachable for real tables (it needs every prefix
    length 3..256 resident and matching), so this replica raises instead.

``refmap_tokens`` is the opt-in parse mode built on it: the token sequence
``sqz_compress`` would produce were its map results wired into the emitted
tokens (src/sqz.c:620-737 with best := map_best's result and the disabled
literal bootstrap puts at src/sqz.c:724-729 enabled — without them the map
path, whose puts all sit behind a prior map hit, can never populate the
table). Every emitted match is a verbatim prior substring (``map_get``
memcmp-verifies), so streams stay FORMAT.md §2.4-valid for any decoder.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

_FNV_INIT = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1

SQZ_MIN_LEN = 2
SQZ_MAX_LEN = 254


def _hash_byte(h: int, b: int) -> int:
    return ((h ^ b) * _FNV_PRIME) & _MASK64


def _hash(data: bytes, off: int, n: int) -> int:
    h = _FNV_INIT
    for b in data[off:off + n]:
        h = _hash_byte(h, b)
    return h


class RefMap:
    """Open-addressing dictionary over positions in one ``data`` buffer.

    Entries store (position, hash, length); ``bytes == 0`` empty,
    ``bytes == -1`` tombstone — the reference stores raw pointers, this
    replica stores offsets into ``data`` (same arithmetic, same results).
    """

    def __init__(self, data: bytes, n: int) -> None:
        assert 16 < n < (1 << 32), "map_init bounds (src/sqz.c:67)"
        self.data = data
        self.n = n
        self.e_off: List[int] = [0] * n
        self.e_hash: List[int] = [0] * n
        self.e_bytes: List[int] = [0] * n
        self.entries = 0
        self.max_chain = 0
        self.max_bytes = 0

    def clear(self) -> None:
        self.e_off = [0] * self.n
        self.e_hash = [0] * self.n
        self.e_bytes = [0] * self.n
        self.entries = 0
        self.max_chain = 0
        self.max_bytes = 0

    def get_hashed(self, h: int, off: int, b: int) -> int:
        assert b >= 2
        d = self.data
        i = h % self.n
        while self.e_bytes[i] != 0:
            if (self.e_bytes[i] == b and self.e_hash[i] == h
                    and d[self.e_off[i]:self.e_off[i] + b] == d[off:off + b]):
                return i
            i = (i + 1) % self.n
        return -1

    def get(self, off: int, b: int) -> int:
        return self.get_hashed(_hash(self.data, off, b), off, b)

    def remove(self, i: int) -> None:
        assert self.e_bytes[i] > 0 and self.entries > 0
        self.e_bytes[i] = -1
        self.e_off[i] = 0
        self.entries -= 1

    def put(self, off: int, b: int) -> int:
        assert 2 <= b
        if self.entries >= self.n * 3 // 4:
            return -1
        d = self.data
        h = _hash(d, off, b)
        i = h % self.n
        chain = 0
        while self.e_bytes[i] != 0:
            if (self.e_bytes[i] == b and self.e_hash[i] == h
                    and d[self.e_off[i]:self.e_off[i] + b] == d[off:off + b]):
                assert off >= self.e_off[i]
                self.e_off[i] = off   # update to the nearer occurrence
                return i
            chain += 1
            i = (i + 1) % self.n
        if chain > self.max_chain:
            self.max_chain = chain
        if b > self.max_bytes:
            self.max_bytes = b
        self.e_off[i] = off
        self.e_hash[i] = h
        self.e_bytes[i] = b
        self.entries += 1
        return i

    def best(self, off: int, nbytes: int, window: int) -> Tuple[int, int]:
        """(distance, size) of the best stored match at ``off``, or (0, 0)."""
        d = self.data
        size = 0
        dist = 0
        best = -1
        if nbytes >= SQZ_MIN_LEN:
            b = min(nbytes, (1 << 32) - 1)
            h = _hash_byte(_FNV_INIT, d[off])
            h = _hash_byte(h, d[off + 1])
            i = 2
            while i < b - 1:
                h = _hash_byte(h, d[off + i])
                r = self.get_hashed(h, off, i + 1)
                if r != -1 and off - self.e_off[r] >= window:
                    self.remove(r)
                elif r != -1:
                    best = r
                else:
                    break
                i += 1
                if i > 0xFF:   # uint8_t wrap (see module docstring)
                    raise RuntimeError("map_best length walk exceeded 255")
        if best >= 0:
            dist = off - self.e_off[best]
            assert dist < window
            b0 = self.e_bytes[best]
            p0 = self.e_off[best] + b0
            p1 = off + b0
            pe = off + nbytes
            ex = b0
            while p1 < pe and d[p0] == d[p1] and ex < SQZ_MAX_LEN:
                ex += 1
                p0 += 1
                p1 += 1
            size = ex
            if ex != b0:
                self.put(off, ex)
        return dist, size


def refmap_tokens(data: bytes, window: int, map_n: int = 1 << 16,
                  refmap: Optional[RefMap] = None,
                  ) -> Iterator[Tuple]:
    """The map-wired ``sqz_compress`` parse (see module docstring).

    Yields the oracle token tuples ('lit', byte) | ('match', length, dist).
    ``map_n`` sizes the table (probe order and the 75% fill cutoff depend
    on it — the differential pins several sizes); ``refmap`` lets a caller
    share one table across calls the way the reference shares ``struct
    sqz.map`` across ``sqz_compress`` calls without re-init.
    """
    m = refmap if refmap is not None else RefMap(data, map_n)
    n = len(data)
    i = 0
    while i < n:
        dist, size = m.best(i, n - i, window) if m.n > 0 else (0, 0)
        # reject rule (src/sqz.c:678-685) on the map result
        bits = dist.bit_length()
        if size <= 3 and bits > 3:
            size = 0
            dist = 0
        if size >= SQZ_MIN_LEN:
            yield ("match", size, dist)
            m.put(i, size)             # src/sqz.c:699
            i += size
        else:
            yield ("lit", data[i])
            # bootstrap puts (src/sqz.c:724-729, the disabled block)
            if m.n > 0 and i >= SQZ_MIN_LEN:
                for ln in (2, 3, 4):
                    if i + ln - 1 < n:
                        m.put(i, ln)
            i += 1
