"""``compress(data)`` of one host buffer, at the configuration's codec
settings."""

from __future__ import annotations

from portbench import faults
from portbench.entries import common


class Entry(common.Entry):
    def setup(self):
        self.sqz, _ = common.program()
        self.data = self.ctx.inputs
        self.call(None)

    def call(self, stats):
        return self.sqz.compress(self.data, device=self.ctx.device,
                                 **self.kw)

    def in_bytes(self, out):
        return len(self.data)

    def stored_bytes(self, out):
        return len(out)

    def sizes(self, kept):
        return dict(raw=len(self.data), payload=common.payload_total(
            kept[-1], self.kw, len(self.data)))

    def check(self, kept):
        checks = common.check_containers(self.ctx, kept, self.data, self.kw)
        differing = 0
        for blob in kept:
            try:
                back = self.sqz.decompress(blob, device=self.ctx.device)
            except (ValueError, OSError, RuntimeError):
                differing += len(self.data)
                continue
            differing += common.bytes_differing(back, self.data)
        checks["roundtrip_bytes_differing"] = differing
        return checks

    def broken(self, blob, fault):
        return faults.break_bytes(blob, fault)


class Control(Entry):
    """The program's own path without the checksum that the configuration
    guarantees."""

    def call(self, stats):
        return self.sqz.compress(self.data, device=self.ctx.device,
                                 **dict(self.kw, checksum=False))
