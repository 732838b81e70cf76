"""A plain reader of the checkpoint file and the filters it states,
apart from the program under test.

The file (the program's documented layout): magic ``SQZCKPT1``, a u32
metadata length, a pickle of builtins (``tree``, ``leaves``,
``blk_bits``), then one sqzt container of the filtered stream: every
leaf's bytes in tree order, each multi-byte leaf of more than one
element shuffled into byte planes, each leaf of more than one byte
delta-coded mod 256. ``expected`` works the tree, the leaves' metadata
and the stream out again from the tensors the benchmark made.
"""

from __future__ import annotations

import io
import pickle
import struct
from collections import OrderedDict

import torch

MAGIC = b"SQZCKPT1"


def flatten(tree, leaves: list):
    """JAX's leaf order (a dict's keys sorted, an OrderedDict in order, a
    list or tuple in order) and the structure the file records."""
    if tree is None:
        return ("none",)
    if isinstance(tree, OrderedDict):
        keys = tuple(tree)
        return ("odict", keys, tuple(flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(flatten(c, leaves) for c in tree))
    leaves.append(tree)
    return ("leaf",)


def leaf_stream(x: torch.Tensor, shuffle: bool, delta: bool):
    """A tensor -> (its filtered bytes, the shuffle's item size or 1,
    whether delta applies)."""
    item = x.element_size()
    flat = x.detach().contiguous().reshape(-1)
    by = flat.view(torch.uint8) if flat.dtype != torch.bool \
        else flat.to(torch.uint8)
    shuf = item if shuffle and item > 1 and flat.numel() > 1 else 1
    if shuf > 1:
        by = by.reshape(-1, item).t().reshape(-1)
    use_delta = delta and by.numel() > 1
    if use_delta:
        by = torch.diff(by, prepend=by.new_zeros(1))   # wraps mod 256
    return by, shuf, use_delta


def expected(tree, shuffle: bool = True, delta: bool = True):
    """(structure, leaves' metadata, the filtered stream on the leaves'
    device) that a file of ``tree`` has to hold."""
    leaves: list = []
    structure = flatten(tree, leaves)
    metas, parts, off = [], [], 0
    for x in leaves:
        by, shuf, use_delta = leaf_stream(x, shuffle, delta)
        n = int(by.numel())
        metas.append(dict(shape=tuple(x.shape),
                          dtype=str(x.dtype).removeprefix("torch."),
                          nbytes=n, offset=off, shuffle=shuf,
                          delta=use_delta))
        parts.append(by)
        off += n
    return structure, metas, torch.cat(parts) if parts else None


class _Builtins(pickle.Unpickler):
    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"{module}.{name} is not a builtin")


def read(data: bytes):
    """The file's bytes -> (metadata dict, container bytes); ValueError
    where the layout is broken."""
    if data[:8] != MAGIC:
        raise ValueError("no checkpoint magic")
    (n,) = struct.unpack_from("<I", data, 8)
    try:
        meta = _Builtins(io.BytesIO(data[12:12 + n])).load()
    except (pickle.UnpicklingError, EOFError) as e:
        raise ValueError(f"metadata does not unpickle: {e}") from e
    if not isinstance(meta, dict):
        raise ValueError("metadata is not a dict")
    return meta, data[12 + n:]


def meta_fields_bad(meta: dict, structure, metas, blk_bits: int) -> int:
    """How many of the metadata's fields differ from the expected ones:
    the tree, ``blk_bits``, and each leaf's record."""
    bad = (meta.get("tree") != structure) + (meta.get("blk_bits") != blk_bits)
    got = meta.get("leaves")
    if not isinstance(got, list) or len(got) != len(metas):
        return bad + len(metas)
    for g, w in zip(got, metas):
        if not isinstance(g, dict):
            bad += 1
            continue
        g = dict(g, shape=tuple(g.get("shape", ())),
                 delta=bool(g.get("delta")))
        bad += any(g.get(k) != v for k, v in w.items())
    return bad


def trees_differ(got, want):
    """(leaves whose structure, dtype, shape or device differ, bytes that
    differ in the leaves that match) between two trees of tensors."""
    a, b = [], []
    if flatten(got, a) != flatten(want, b) or len(a) != len(b):
        return max(len(b), 1), 0
    malformed, differing = 0, 0
    for x, y in zip(a, b):
        if not isinstance(x, torch.Tensor) or x.dtype != y.dtype \
                or x.shape != y.shape or x.device != y.device:
            malformed += 1
            continue
        if x.numel():
            xb = x.contiguous().reshape(-1).view(torch.uint8) \
                if x.dtype != torch.bool else x.reshape(-1).to(torch.uint8)
            yb = y.contiguous().reshape(-1).view(torch.uint8) \
                if y.dtype != torch.bool else y.reshape(-1).to(torch.uint8)
            differing += int((xb != yb).sum())
    return malformed, differing
