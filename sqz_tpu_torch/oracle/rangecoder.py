"""64-bit adaptive range coder — scalar oracle (FORMAT.md §2.2-§2.3).

Semantics pinned to reference src/sqz.c:398-548. The reference keeps the
cumulative frequencies in a Fenwick tree as a CPU optimization; the format
only depends on the exact integer values of (start, size, total), so this
oracle keeps plain frequency arrays and computes prefix sums directly.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
FREQ_CAP = 1 << 56  # pm_update total cap (src/sqz.c:467)


class ProbModel:
    """Adaptive per-symbol frequency model over 256 slots (src/sqz.c:447-472)."""

    __slots__ = ("freq",)

    def __init__(self, n: int) -> None:
        self.freq = [1 if i < n else 0 for i in range(256)]

    def set_freqs(self, freqs) -> None:
        """Warm-start from a frequency snapshot (sqzt v2, FORMAT.md §3)."""
        n = len(freqs)
        self.freq = [int(freqs[i]) if i < n else 0 for i in range(256)]

    def total(self) -> int:
        return sum(self.freq)

    def start(self, sym: int) -> int:
        return sum(self.freq[:sym])

    def update(self, sym: int, inc: int = 1) -> None:
        if self.total() < FREQ_CAP:
            self.freq[sym] += inc

    def index_of(self, cum: int) -> int:
        """Largest prefix position: the symbol whose [start, start+size) holds cum.

        Mirrors ft_index_of + pm_index_of (src/sqz.c:431-457): returns -1 when
        ``cum`` lands past the total or in a zero-frequency hole.
        """
        if cum >= self.total():
            return -1
        acc = 0
        for s in range(256):
            acc += self.freq[s]
            if cum < acc:
                return s if self.freq[s] > 0 else -1
        return -1


class RangeEncoder:
    __slots__ = ("low", "range", "out", "error")

    def __init__(self) -> None:
        self.low = 0
        self.range = MASK64
        self.out = bytearray()
        self.error = 0

    def _emit(self) -> None:
        self.out.append((self.low >> 56) & 0xFF)
        self.low = (self.low << 8) & MASK64
        self.range = (self.range << 8) & MASK64

    def encode(self, pm: ProbModel, sym: int) -> None:
        total = pm.total()
        start = pm.start(sym)
        size = pm.freq[sym]
        self.range //= total
        self.low = (self.low + start * self.range) & MASK64
        self.range = (self.range * size) & MASK64
        pm.update(sym, 1)
        while (self.low >> 56) == (((self.low + self.range) & MASK64) >> 56):
            self._emit()
        if self.range < total + 1:
            self._emit()
            self._emit()
            self.range = MASK64 - self.low

    def flush(self) -> None:
        for _ in range(8):
            self.range = MASK64
            self._emit()

    def getvalue(self) -> bytes:
        return bytes(self.out)


class RangeDecoder:
    __slots__ = ("low", "range", "code", "data", "pos", "error")

    def __init__(self, data: bytes) -> None:
        self.low = 0
        self.range = MASK64
        self.code = 0
        self.data = data
        self.pos = 0
        self.error = 0
        for _ in range(8):  # prime (src/sqz.c:794-797)
            self.code = ((self.code << 8) + self._next_byte()) & MASK64

    def _next_byte(self) -> int:
        if self.pos < len(self.data):
            b = self.data[self.pos]
            self.pos += 1
            return b
        return 0  # reference I/O callback reads past end yield harness zeros/errors

    def _consume(self) -> None:
        self.code = ((self.code << 8) + self._next_byte()) & MASK64
        self.low = (self.low << 8) & MASK64
        self.range = (self.range << 8) & MASK64

    def decode(self, pm: ProbModel) -> int:
        total = pm.total()
        if total < 1:
            self.error = 22  # EINVAL
            return 0
        if self.range < total:
            self._consume()
            self._consume()
            self.range = MASK64 - self.low
        cum = ((self.code - self.low) & MASK64) // (self.range // total)
        sym = pm.index_of(cum)
        if sym < 0 or pm.freq[sym] == 0:
            self.error = 84  # EILSEQ
            return 0
        start = pm.start(sym)
        size = pm.freq[sym]
        self.range //= total
        self.low = (self.low + start * self.range) & MASK64
        self.range = (self.range * size) & MASK64
        pm.update(sym, 1)
        while (self.low >> 56) == (((self.low + self.range) & MASK64) >> 56):
            self._consume()
        return sym
