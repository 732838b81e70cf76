"""``load_pytree(path)`` of a file that set-up saved, the restored
tensors on the card. The file lies in a memory file (``memfd_create``),
as a file just written lies in the page cache, so no run writes it to
disk or reads it back while the disk flushes it."""

from __future__ import annotations

import os

from portbench import faults
from portbench.entries import common
from portbench.reference import checkpoint as ref_ckpt

SAVE_KEYS = ("blk_bits", "mode", "shuffle", "delta")


class Entry(common.Entry):
    takes_stats = True

    def setup(self):
        _, self.ckpt = common.program()
        self.state = self.ctx.inputs
        self.raw = common.ref_ckpt_bytes(self.state)
        self.fd = os.memfd_create("portbench-load")
        self.path = f"/proc/self/fd/{self.fd}"
        self.ckpt.save_pytree(self.state, self.path, device=self.ctx.device,
                              **{k: v for k, v in self.kw.items()
                                 if k in SAVE_KEYS})
        self.call(None)

    def call(self, stats):
        tree = self.ckpt.load_pytree(self.path, device=self.ctx.device,
                                     stats=stats)
        common.sync(self.ctx.device)
        return tree

    def in_bytes(self, out):
        return self.raw

    def sizes(self, kept):
        return dict(raw=self.raw, payload=common.file_payload_total(
            common.read_fd(self.fd), self.kw, self.raw))

    def check(self, kept):
        checks = {"leaves_malformed": 0, "leaf_bytes_differing": 0}
        for tree in kept:
            malformed, differing = ref_ckpt.trees_differ(tree, self.state)
            checks["leaves_malformed"] += malformed
            checks["leaf_bytes_differing"] += differing
        checks.update(common.check_files(
            self.ctx, [common.read_fd(self.fd)], self.state, self.kw))
        return checks

    def broken(self, tree, fault):
        return faults.break_tree(tree, fault)

    def close(self):
        if getattr(self, "fd", None) is not None:
            os.close(self.fd)
            self.fd = None


class Control(Entry):
    """The reference's restore in the precision below the configuration's
    float32: every float leaf of the state rounded to bfloat16."""

    def call(self, stats):
        return faults.bf16_rounded(self.state)
