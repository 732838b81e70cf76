"""Checkpoint trees of tensors through the device-resident codec: the port
of ``sqz_tpu/utils/checkpoint.py`` (``save_pytree`` / ``load_pytree``).

A tree of tensors on the card (model and optimizer state) compresses
without the host touching the data: each leaf is viewed as bytes on the
card, filtered there (byte-plane shuffle, byte delta), and every leaf's
stream is concatenated into one, which the resident encoder codes
(``ops/resident.py``: the cell parse and the token kernel); only payload
bytes come back to be written. Restore mirrors it: payload bytes upload
once, the decoder and the assembly rebuild the stream on the card, and
each leaf is unfiltered and viewed back as its dtype and shape.

File layout, the reference's: magic ``SQZCKPT1``, a u32 metadata length,
a pickled metadata dict, then ONE sqzt container of the concatenated
stream. The metadata's ``leaves`` (shape, dtype name, nbytes, offset,
shuffle, delta) and ``blk_bits`` are the reference's, so the container
and ``leaves`` equal ``sqz_tpu``'s for the same tree. The reference keeps
its JAX tree definition under ``treedef``; the port keeps its own tree
structure, made of builtin containers and scalars only, under ``tree``,
and reads the metadata with an unpickler that admits nothing else.

Leaves are flattened in JAX's order, which fixes the stream order and so
the container bytes: a ``dict``'s keys sorted, an ``OrderedDict`` (a
``state_dict()``) in insertion order, a ``list`` or ``tuple`` in order
(a namedtuple restores as a plain tuple), ``None`` an empty subtree.
Anything else is a leaf: a tensor, a numpy array or a scalar
(``torch.as_tensor``), uploaded to ``device`` first.
"""

from __future__ import annotations

import io
import pickle
import struct
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.formats.constants import SQZT_FORMAT_SQZ4
from sqz_tpu_torch.ops.launch import resolve_device

MAGIC = b"SQZCKPT1"


def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves`` in JAX's order; return its
    structure as nested tuples of builtins."""
    if tree is None:
        return ("none",)
    if isinstance(tree, OrderedDict):
        keys = tuple(tree)
        return ("odict", keys, tuple(_flatten(tree[k], leaves)
                                     for k in keys))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], leaves)
                                    for k in keys))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return (kind, tuple(_flatten(c, leaves) for c in tree))
    leaves.append(tree)
    return ("leaf",)


def _unflatten(node, leaves):
    """Rebuild a structure of ``_flatten`` from an iterator of leaves."""
    kind = node[0]
    if kind == "leaf":
        return next(leaves)
    if kind == "none":
        return None
    if kind in ("dict", "odict"):
        vals = [_unflatten(c, leaves) for c in node[2]]
        return (OrderedDict if kind == "odict" else dict)(zip(node[1], vals))
    if kind in ("list", "tuple"):
        vals = [_unflatten(c, leaves) for c in node[1]]
        return vals if kind == "list" else tuple(vals)
    raise ValueError(f"unknown tree node {kind!r} in checkpoint metadata")


def _as_tensor(leaf, dev) -> torch.Tensor:
    if isinstance(leaf, (np.ndarray, np.generic)):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return torch.as_tensor(leaf).to(dev)


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype string (numpy's name: "float32", "bfloat16",
    "bool")."""
    return str(dtype).removeprefix("torch.")


def _dtype_of(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"checkpoint leaf of unknown dtype {name!r}")
    return dtype


def leaf_bytes(x: torch.Tensor, shuffle: bool):
    """A tensor of any dtype -> (1-D uint8 tensor on its device, the
    itemsize the shuffle used, 1 for none). ``shuffle``: byte-plane
    transposition (the blosc trick): for multi-byte dtypes with more than
    one element, plane k holds every element's k-th byte, so the
    repetitive sign and exponent bytes of float data form runs the cell
    parse catches. ``bool`` is taken as ``uint8``."""
    if x.dtype == torch.uint8:
        return x.reshape(-1), 1
    if x.dtype == torch.bool:
        return x.reshape(-1).to(torch.uint8), 1
    itemsize = x.element_size()
    # reshape first: view(uint8) needs a contiguous tensor of >= 1 dim
    by = x.contiguous().reshape(-1).view(torch.uint8).reshape(-1, itemsize)
    if shuffle and itemsize > 1 and by.shape[0] > 1:
        return by.t().reshape(-1), itemsize
    return by.reshape(-1), 1


def byte_delta(flat: torch.Tensor) -> torch.Tensor:
    """Byte-wise delta, wrapping mod 256: after the shuffle, slowly
    varying planes (float exponents of smooth data) become zero runs."""
    return flat - torch.cat([flat.new_zeros(1), flat[:-1]])


def byte_undelta(flat: torch.Tensor) -> torch.Tensor:
    """The inverse of ``byte_delta``: a cumulative sum mod 256. The int32
    sum wraps past 2^31 on large leaves and stays exact mod 256 (256
    divides 2^32), at half an int64 sum's memory; ``& 255`` keeps the low
    byte of a negative wrapped sum as well."""
    return (torch.cumsum(flat, 0, dtype=torch.int32) & 255).to(torch.uint8)


def _restore_leaf(stream: torch.Tensor, m: dict, dev) -> torch.Tensor:
    dtype = _dtype_of(m["dtype"])
    if m["nbytes"] == 0:
        return torch.zeros(m["shape"], dtype=dtype, device=dev)
    flat = stream[m["offset"]:m["offset"] + m["nbytes"]]
    shuf = m.get("shuffle", 1)
    if m.get("delta"):
        flat = byte_undelta(flat)
    elif shuf == 1:
        flat = flat.clone()   # own storage, aligned for the dtype view
    if shuf > 1:                      # undo the byte-plane transpose
        flat = flat.reshape(shuf, -1).t().reshape(-1)
    if dtype == torch.uint8:
        return flat.reshape(m["shape"])
    if dtype == torch.bool:
        return (flat != 0).reshape(m["shape"])
    return flat.view(dtype).reshape(m["shape"])


class _BuiltinsOnly(pickle.Unpickler):
    """Unpickles the metadata ``save_pytree`` writes: containers and
    scalars, which need no class lookup. Any class raises, before its
    module is imported."""

    def find_class(self, module, name):
        raise ValueError(
            f"checkpoint metadata names {module}.{name}, not a builtin: "
            f"the file was not written by sqz_tpu_torch (a file of the "
            f"JAX package keeps a JAX tree definition; restore it with "
            f"sqz_tpu.utils.checkpoint.load_pytree)")


def filtered_stream(tree, shuffle: bool = True, delta: bool = True,
                    device="cuda"):
    """The stream ``save_pytree`` codes: (every leaf's filtered bytes
    concatenated, a 1-D uint8 tensor on ``device``; the ``leaves``
    metadata; the tree structure)."""
    dev = torch.device(device)
    leaves: list = []
    structure = _flatten(tree, leaves)
    metas, streams, off = [], [], 0
    for leaf in leaves:
        x = _as_tensor(leaf, dev)
        flat, shuf = leaf_bytes(x, shuffle)
        use_delta = bool(delta) and flat.numel() > 1
        if use_delta:
            flat = byte_delta(flat)
        nbytes = int(flat.numel())
        metas.append(dict(shape=tuple(x.shape), dtype=dtype_name(x.dtype),
                          nbytes=nbytes, offset=off, shuffle=shuf,
                          delta=use_delta))
        if nbytes:
            streams.append(flat)
        off += nbytes
    stream = (torch.cat(streams) if streams
              else torch.zeros(0, dtype=torch.uint8, device=dev))
    return stream, metas, structure


def save_pytree(tree, path, blk_bits: int = 16, mode: str = "rle",
                shuffle: bool = True, delta: bool = True, mesh=None,
                lanes: int = None, device="cuda",
                stats: dict = None) -> dict:
    """Compress a tree of tensors to ``path`` through the resident encoder
    on ``device`` (``mode`` 'lit' or 'rle', blocks of 2^``blk_bits``
    bytes, ``lanes`` blocks a launch, None for the path's default).
    ``shuffle`` and ``delta`` filter each leaf's bytes first (see
    ``leaf_bytes``, ``byte_delta``). ``stats`` accumulates the encoder's
    stage times (``encode_resident_blocks``). Returns raw and compressed
    sizes and their ratio.

    ``mesh`` (a ``parallel.mesh.Mesh``; the distributed checkpoint): the
    stream is built on the mesh's first local device, and every shard
    parses and codes its own blocks (``stats`` is not kept). In a
    multi-process mesh only rank 0 writes the file (None elsewhere)."""
    from sqz_tpu_torch.ops import resident
    if not 1 <= blk_bits <= 16:
        raise ValueError("resident paths support blk_bits 1..16 "
                         "(the sqz4 device kernels' range)")
    dev = _device(device, mesh)
    stream, metas, structure = filtered_stream(tree, shuffle, delta, dev)
    raw = int(stream.numel())
    if mesh is not None:
        from sqz_tpu_torch.parallel.shard import encode_resident_sharded
        payloads = encode_resident_sharded(stream, blk_bits, mesh, mode,
                                           lanes)
    else:
        payloads = resident.encode_resident_blocks(stream, blk_bits, mode,
                                                   lanes=lanes, device=dev,
                                                   stats=stats)
    del stream
    if payloads is None:                    # not rank 0 of the mesh
        return None
    blob = sqzt.pack(SQZT_FORMAT_SQZ4, 15, blk_bits, raw, payloads, None)
    meta = pickle.dumps(dict(tree=structure, leaves=metas,
                             blk_bits=blk_bits))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(meta)))
        f.write(meta)
        f.write(blob)
    return dict(raw_bytes=raw, compressed_bytes=len(blob),
                ratio=len(blob) / raw if raw else 0.0)


def _device(device, mesh):
    """The device of the stream and the leaves: the mesh's first local
    device under a mesh (TypeError for anything but a Mesh), else
    ``device``."""
    if mesh is None:
        return resolve_device(device)
    from sqz_tpu_torch.parallel.mesh import check_mesh
    return check_mesh(mesh).devices[0]


def read_checkpoint(path):
    """``path`` -> (metadata dict, sqzt container bytes), the metadata
    read with builtins only."""
    data = Path(path).read_bytes()
    if data[:8] != MAGIC:
        raise ValueError("not a sqz-tpu checkpoint")
    (mlen,) = struct.unpack("<I", data[8:12])
    meta = _BuiltinsOnly(io.BytesIO(data[12:12 + mlen])).load()
    if not isinstance(meta, dict) or "tree" not in meta:
        raise ValueError("checkpoint metadata holds no tree structure "
                         "(not written by sqz_tpu_torch)")
    return meta, data[12 + mlen:]


def load_pytree(path, mesh=None, lanes: int = None, device="cuda",
                stats: dict = None):
    """Restore a tree saved by ``save_pytree`` into tensors on ``device``:
    the container decodes through the resident restore
    (``decompress_resident``), and each leaf is unfiltered and viewed
    back there. ``stats`` accumulates the restore's stage times. A file
    written by the JAX package raises ValueError. ``mesh``: every shard
    restores its own blocks (``stats`` is not kept), and the leaves come
    back on the mesh's first local device, on every rank."""
    from sqz_tpu_torch.ops import resident
    dev = _device(device, mesh)
    meta, blob = read_checkpoint(path)
    if mesh is not None:
        from sqz_tpu_torch.parallel.shard import decompress_resident_sharded
        stream = decompress_resident_sharded(blob, mesh, lanes)
    else:
        stream = resident.decompress_resident(blob, lanes=lanes, device=dev,
                                              stats=stats)
    del blob
    leaves = [_restore_leaf(stream, m, dev) for m in meta["leaves"]]
    return _unflatten(meta["tree"], iter(leaves))
