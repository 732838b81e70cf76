"""A plain reader of the ``sqzt`` block container (FORMAT.md §3) and its
FNV-1a64 checksum, apart from the program under test.

``read`` parses the header, the length table, the checksum and the
payloads, and counts every field that breaks the format or differs from
what the caller expects. ``fnv1a64`` works the checksum out on the card
in plain PyTorch (``fnv1a64_plain`` is the one-byte-at-a-time definition
the tests hold it against).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

MAGIC = b"sqzTPU01"
HEADER = 32
FLAG_CHECKSUM, FLAG_WARM, FLAG_ANCHORS = 1, 2, 4
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = 0x100000001B3
MASK = (1 << 64) - 1


def read(blob: bytes, expect: dict):
    """``blob`` -> (a dict of fields, [payload bytes], the count of
    fields that break the format or differ from ``expect``).

    ``expect`` holds ``fmt``, ``win_bits``, ``blk_bits``, ``flags`` and
    ``size`` (the original size); ``checksum`` too where flags bit 0 is
    set. A container that cannot be parsed at all counts one bad field
    and no payloads."""
    if len(blob) < HEADER or blob[:8] != MAGIC:
        return {}, [], 1
    fmt, win, blk, flags = blob[8], blob[9], blob[10], blob[11]
    osize, nblocks = struct.unpack_from("<QQ", blob, 16)
    fields = dict(fmt=fmt, win_bits=win, blk_bits=blk, flags=flags,
                  size=osize, blocks=nblocks)
    bad = sum(fields[k] != expect[k] for k in
              ("fmt", "win_bits", "blk_bits", "flags", "size"))
    bad += blob[12:16] != b"\0" * 4
    if nblocks != max(1, -(-osize // (1 << blk))):
        return fields, [], bad + 1
    off = HEADER + 8 * nblocks
    if off > len(blob):
        return fields, [], bad + 1
    lens = struct.unpack_from(f"<{nblocks}Q", blob, HEADER)
    if flags & FLAG_CHECKSUM:
        fields["checksum"] = struct.unpack_from("<Q", blob, off)[0]
        off += 8
        bad += fields["checksum"] != expect.get("checksum")
    if flags & (FLAG_WARM | FLAG_ANCHORS):
        return fields, [], bad + 1      # the cells' containers are cold
    if off + sum(lens) != len(blob):
        return fields, [], bad + 1
    payloads = []
    for n in lens:
        payloads.append(blob[off:off + n])
        off += n
    return fields, payloads, bad


def block_sizes(size: int, blk_bits: int, nblocks: int):
    bs = 1 << blk_bits
    return [max(0, min(bs, size - b * bs)) for b in range(nblocks)]


def fnv1a64_plain(data: bytes) -> int:
    """FNV-1a64 by its definition: for each byte, h = (h ^ byte) * prime
    mod 2^64."""
    h = FNV_OFFSET
    for b in data:
        h = ((h ^ b) * FNV_PRIME) & MASK
    return h


def _low_table():
    """T[x] = (x * prime) mod 256: the low byte of a product depends only
    on the low bytes."""
    return (np.arange(256) * (FNV_PRIME & 255)) & 255


def fnv1a64(data: bytes, device="cuda", chunk: int = 2048) -> int:
    """FNV-1a64 of ``data``, equal to ``fnv1a64_plain``, in about a second
    for 10^8 bytes on the card.

    h ^ b = h + e with e = (l ^ b) - l, where l is h's low byte, and the
    low byte follows its own chain l' = T[l ^ b]. So once every l is
    known, h_n = prime^n h_0 + sum_i prime^(n-i) e_i mod 2^64, a sum that
    vectorises. The chain of l is found by pairs of bytes (a table of 2^24
    entries): every chunk of ``chunk`` pairs maps all 256 start values
    at once on the card, the chunks' maps compose on the host, and a
    second pass fills each chunk from its start."""
    a = np.frombuffer(data, np.uint8)
    n = a.size
    T = _low_table()
    pair_tab = T[T[np.arange(256)[:, None, None] ^ np.arange(256)[None, :, None]]
                 ^ np.arange(256)[None, None, :]].reshape(-1)
    m = n // 2
    C = m // chunk
    low_even = np.empty(m + 1, np.int64)    # l before byte 2j
    low_even[0] = FNV_OFFSET & 255
    if C:
        dev = torch.device(device)
        tab = torch.from_numpy(pair_tab.astype(np.int64)).to(dev)
        ev = torch.from_numpy(a[:2 * C * chunk].copy()).to(dev).long()
        pairs = ((ev[0::2] << 8) | ev[1::2]).view(C, chunk)
        s = torch.arange(256, device=dev).expand(C, 256).contiguous()
        for k in range(chunk):
            s = tab[(s << 16) | pairs[:, k:k + 1]]
        maps = s.cpu().numpy()
        starts = np.empty(C, np.int64)
        st = int(low_even[0])
        for c in range(C):
            starts[c] = st
            st = int(maps[c, st])
        cur = torch.from_numpy(starts).to(dev)
        fill = torch.empty((C, chunk), dtype=torch.long, device=dev)
        for k in range(chunk):
            cur = tab[(cur << 16) | pairs[:, k]]
            fill[:, k] = cur
        low_even[1:C * chunk + 1] = fill.reshape(-1).cpu().numpy()
    st = int(low_even[C * chunk])
    for j in range(C * chunk, m):
        st = int(pair_tab[(st << 16) | (int(a[2 * j]) << 8) | int(a[2 * j + 1])])
        low_even[j + 1] = st
    low = np.empty(n + 1, np.int64)
    low[0::2] = low_even[:n // 2 + 1]
    low[1::2] = T[low[0:n:2][:(n + 1) // 2] ^ a[0::2]]
    e = ((low[:n] ^ a) - low[:n]).astype(np.uint64)   # wraps mod 2^64
    total = 0
    width = 1 << 16
    pw = np.full(width, FNV_PRIME, np.uint64)
    pw[0] = 1
    with np.errstate(over="ignore"):
        pw = np.multiply.accumulate(pw)             # prime^0 .. prime^(w-1)
        step = int(pw[-1]) * FNV_PRIME & MASK       # prime^w
        scale = FNV_PRIME                           # prime^(1 + w j)
        for end in range(n, 0, -width):
            seg = e[max(0, end - width):end][::-1]  # weights prime^1, ^2 ..
            s = int((seg * pw[:seg.size]).sum(dtype=np.uint64))
            total = (total + s * scale) & MASK
            scale = scale * step & MASK
    return (pow(FNV_PRIME, n, 1 << 64) * FNV_OFFSET + total) & MASK
