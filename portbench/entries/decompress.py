"""``decompress(blob)`` of the container that set-up made with
``compress`` at the configuration's codec settings.

Besides every output, the check hands the program's own decode two
corrupt copies of that container, drawn from the seed: one with a bit of
a payload flipped, one with a bit of the stored checksum flipped. The
configuration guarantees the checksum, so the first must not come back
as other bytes than the input and the second must not come back at
all."""

from __future__ import annotations

import random
import struct

from portbench import faults
from portbench.entries import common
from portbench.reference import sqzt as ref_sqzt


def checksum_at(blob: bytes) -> int:
    """Where the container's stored checksum lies: past the header and
    the length table."""
    (nblocks,) = struct.unpack_from("<Q", blob, 24)
    return ref_sqzt.HEADER + 8 * nblocks


def corrupted(blob: bytes, rng: random.Random):
    """(the container with one payload bit flipped, the container with one
    bit of its stored checksum flipped)."""
    at = checksum_at(blob)
    payload = bytearray(blob)
    payload[rng.randrange(at + 8, len(blob))] ^= 1 << rng.randrange(8)
    checksum = bytearray(blob)
    checksum[at + rng.randrange(8)] ^= 1 << rng.randrange(8)
    return bytes(payload), bytes(checksum)


def without_checksum(blob: bytes) -> bytes:
    """The container with its checksum flag and field taken out."""
    at = checksum_at(blob)
    out = bytearray(blob[:at] + blob[at + 8:])
    out[11] &= ~ref_sqzt.FLAG_CHECKSUM
    return bytes(out)


class Entry(common.Entry):

    def setup(self):
        self.sqz, _ = common.program()
        self.data = self.ctx.inputs
        self.blob = self.sqz.compress(self.data, device=self.ctx.device,
                                      **self.kw)
        self.call(None)

    def call(self, stats):
        return self.decode(self.blob)

    def decode(self, blob):
        return self.sqz.decompress(blob, device=self.ctx.device)

    def in_bytes(self, out):
        return len(self.data)

    def sizes(self, kept):
        return dict(raw=len(self.data), payload=common.payload_total(
            self.blob, self.kw, len(self.data)))

    def check(self, kept):
        checks = {"bytes_differing": sum(
            common.bytes_differing(out, self.data) for out in kept)}
        checks.update(common.check_containers(self.ctx, [self.blob],
                                              self.data, self.kw))
        payload, checksum = corrupted(self.blob,
                                      random.Random(self.ctx.seed + 2))
        checks["corrupt_payload_accepted"] = int(
            self._accepts(payload, self.data))
        checks["corrupt_checksum_accepted"] = int(
            self._accepts(checksum, None))
        return checks

    def _accepts(self, blob, allowed) -> bool:
        """Whether the program's decode returns from ``blob`` with other
        bytes than ``allowed`` (any bytes, where that is None)."""
        try:
            out = self.decode(blob)
        except (ValueError, OSError, RuntimeError):
            return False
        return allowed is None or out != allowed

    def broken(self, out, fault):
        return faults.break_bytes(out, fault)


class Control(Entry):
    """The decode with the checksum's verification left out: the flag
    and the stored checksum taken off each container before the
    program decodes it."""

    def decode(self, blob):
        return super().decode(without_checksum(blob))
