"""``save_pytree(state, path)`` of the training state on the card. Each
call writes its file into a memory file of its own (``memfd_create``),
so the window writes nothing to disk and the check reads what the
window's calls wrote."""

from __future__ import annotations

import os

from portbench import faults
from portbench.entries import common


class Entry(common.Entry):
    takes_stats = True

    def setup(self):
        _, self.ckpt = common.program()
        self.state = self.ctx.inputs
        self.raw = common.ref_ckpt_bytes(self.state)
        self.drop(self.call(None))

    def call(self, stats):
        return self.save(self.state, stats)

    def save(self, state, stats):
        fd = os.memfd_create("portbench-save")
        self.ckpt.save_pytree(state, f"/proc/self/fd/{fd}",
                              device=self.ctx.device, stats=stats,
                              **self.kw)
        return fd

    def in_bytes(self, out):
        return self.raw

    def stored_bytes(self, out):
        return os.fstat(out).st_size

    def sizes(self, kept):
        return dict(raw=self.raw, payload=common.file_payload_total(
            common.read_fd(kept[-1]), self.kw, self.raw))

    def drop(self, fd):
        os.close(fd)

    def check(self, kept):
        files = [common.read_fd(fd) for fd in kept]
        return common.check_files(self.ctx, files, self.state, self.kw,
                                  [f"/proc/self/fd/{fd}" for fd in kept])

    def broken(self, fd, fault):
        data = faults.break_bytes(common.read_fd(fd), fault)
        os.ftruncate(fd, 0)
        os.pwrite(fd, data, 0)
        return fd


class Control(Entry):
    """The program's save of the state rounded to bfloat16, the precision
    below the configuration's float32."""

    def setup(self):
        self.rounded = faults.bf16_rounded(self.ctx.inputs)
        super().setup()

    def call(self, stats):
        return self.save(self.rounded, stats)
