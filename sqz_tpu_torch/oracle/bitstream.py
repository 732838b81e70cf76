"""Bit-serial stream with 64-bit word buffering (FORMAT.md §1.1).

Semantics pinned to reference attic/map_experiment/bitstream.h: bits enter a
64-bit shift register MSB-ward (``b64 = (b64 << 1) | bit``); full words are
flushed big-endian (first bit written = bit 7 of the first byte); multi-bit
values are written/read least-significant bit first; ``flush`` zero-pads to a
64-bit boundary, so streams are a multiple of 8 bytes.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self) -> None:
        self._out = bytearray()
        self._b64 = 0
        self._nbits = 0

    def write_bit(self, bit: int) -> None:
        self._b64 = ((self._b64 << 1) | (bit & 1)) & 0xFFFFFFFFFFFFFFFF
        self._nbits += 1
        if self._nbits == 64:
            self._out += self._b64.to_bytes(8, "big")
            self._b64 = 0
            self._nbits = 0

    def write_bits(self, value: int, nbits: int) -> None:
        """Write the nbits low bits of value, LSB first (bitstream.h:55-63)."""
        assert 0 < nbits <= 64
        for _ in range(nbits):
            self.write_bit(value & 1)
            value >>= 1

    def flush(self) -> None:
        """Zero-pad to the next 64-bit boundary (bitstream.h:112-114)."""
        while self._nbits > 0:
            self.write_bit(0)

    def getvalue(self) -> bytes:
        return bytes(self._out)

    @property
    def bit_position(self) -> int:
        return len(self._out) * 8 + self._nbits


class BitReader:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0       # byte position of the next word load
        self._b64 = 0
        self._nbits = 0

    def read_bit(self) -> int:
        if self._nbits == 0:
            if self._pos + 8 > len(self._data):
                raise EOFError("bitstream exhausted")
            self._b64 = int.from_bytes(self._data[self._pos:self._pos + 8], "big")
            self._pos += 8
            self._nbits = 64
        bit = (self._b64 >> 63) & 1
        self._b64 = (self._b64 << 1) & 0xFFFFFFFFFFFFFFFF
        self._nbits -= 1
        return bit

    def read_bits(self, nbits: int) -> int:
        """Read nbits, assembling LSB first (bitstream.h:95-103)."""
        assert 0 < nbits <= 64
        value = 0
        for b in range(nbits):
            value |= self.read_bit() << b
        return value
