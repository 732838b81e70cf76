"""``sqzt`` block container (FORMAT.md §3) — framing only, engine-agnostic.

The port's copy of ``sqz_tpu/formats/container.py``: the same framing
and validation, with the checksum through the port's native runtime.

Splits data into fixed 2^blk_bits blocks, each independently coded with fresh
model state, so blocks encode/decode in parallel on any engine. Per-block
payloads carry no headers; this container records the format, window, block
size, original size, the per-block compressed lengths, and (flags bit 0) an
FNV-1a64 checksum of the original data appended after the length table —
the integrity hook the reference accumulates on every io byte but never
verifies (reference inc/rt/fileio.h:120-129); decompress verifies it.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

from sqz_tpu_torch.formats.constants import (
    SQZT_MAGIC, SQZT_HEADER_BYTES,
    SQZT_FORMAT_SQUEEZE, SQZT_FORMAT_SQZ4,
)

FLAG_CHECKSUM = 1
# sqzt v2 (FORMAT.md §3.1): blocks 1+ were coded with models warm-started
# from block 0's final (rescaled) state; block 0 itself is always fresh, so
# the decoder re-derives the seed from block 0 — no bytes stored.
FLAG_WARM = 2
# sqzt v3 (FORMAT.md §3.2): anchored warm start. Valid only with FLAG_WARM.
# A second bitmap (same size as the fresh bitmap) follows it: bit b set on
# a WARM block means its seed/dictionary anchor is the nearest previous
# FRESH block instead of block 0. Bits on fresh blocks MUST be 0 (one
# canonical encoding per choice; decoders reject non-canonical bitmaps).
FLAG_ANCHORS = 4

def fnv1a64(data: bytes) -> int:
    """FNV-1a64 (reference map_hash_init/map_prime64, src/sqz.c:44-64),
    through the port's native runtime."""
    from sqz_tpu_torch import native
    return native.fnv1a64(data)


def split_blocks(data: bytes, blk_bits: int) -> List[bytes]:
    bs = 1 << blk_bits
    return [data[o:o + bs] for o in range(0, len(data), bs)] or [b""]


def _bitmap(bits: List[bool]) -> bytes:
    bm = bytearray((len(bits) + 7) // 8)
    for b, v in enumerate(bits):
        if v:
            bm[b >> 3] |= 1 << (b & 7)
    return bytes(bm)


def _bitmap_padding_set(bm: bytes, n: int) -> bool:
    """True when any bit past position n-1 is set — non-canonical (the
    format has one canonical encoding per choice, FORMAT.md §3)."""
    if n & 7:
        if bm[n >> 3] >> (n & 7):
            return True
    return False


def pack(fmt: int, win_bits: int, blk_bits: int, original_size: int,
         block_payloads: List[bytes],
         checksum: Optional[int] = None, warm: bool = False,
         fresh_mask: Optional[List[bool]] = None,
         anchor_mask: Optional[List[bool]] = None) -> bytes:
    """``warm`` containers carry a fresh-bitmap after the checksum:
    bit b set = block b was coded FRESH (the encoder picks per block
    whichever of fresh/warm coded smaller; block 0 is always fresh).
    ``anchor_mask`` (v3, FORMAT.md §3.2) adds the per-warm-block anchor
    choice bitmap; an all-zero mask packs as a plain v2 container."""
    # real raises, not asserts: pack() is semi-public and must not emit
    # malformed containers under python -O
    if fmt not in (SQZT_FORMAT_SQUEEZE, SQZT_FORMAT_SQZ4):
        raise ValueError(f"bad sqzt format code {fmt}")
    if anchor_mask is not None and not any(anchor_mask):
        anchor_mask = None   # canonical: v3 flag only when an anchor differs
    flags = (FLAG_CHECKSUM if checksum is not None else 0) \
        | (FLAG_WARM if warm else 0) \
        | (FLAG_ANCHORS if (warm and anchor_mask is not None) else 0)
    head = struct.pack(
        "<8sBBBB4xQQ", SQZT_MAGIC, fmt, win_bits, blk_bits, flags,
        original_size, len(block_payloads))
    assert len(head) == SQZT_HEADER_BYTES
    table = b"".join(struct.pack("<Q", len(p)) for p in block_payloads)
    tail = struct.pack("<Q", checksum) if checksum is not None else b""
    if warm:
        n = len(block_payloads)
        if fresh_mask is None:
            fresh_mask = [True] + [False] * (n - 1)
        if len(fresh_mask) != n or not fresh_mask[0]:
            raise ValueError("fresh mask must cover every block with "
                             "block 0 fresh")
        tail += _bitmap(fresh_mask)
        if anchor_mask is not None:
            if len(anchor_mask) != n or any(
                    a and f for a, f in zip(anchor_mask, fresh_mask)):
                raise ValueError("anchor mask must cover every block and "
                                 "only mark warm blocks")
            tail += _bitmap(anchor_mask)
    return head + table + tail + b"".join(block_payloads)


def unpack(blob: bytes) -> Tuple[int, int, int, int, List[bytes],
                                 Optional[int], "Optional[List[bool]]",
                                 "Optional[List[bool]]"]:
    """Returns (fmt, win_bits, blk_bits, original_size, payloads, checksum,
    fresh_mask, anchor_mask). fresh_mask is None for cold containers; for
    warm (v2+) containers it lists, per block, whether it was coded fresh.
    anchor_mask is None unless FLAG_ANCHORS (v3): bit b set on a warm block
    selects the nearest-previous-fresh anchor over block 0."""
    if len(blob) < SQZT_HEADER_BYTES:
        raise ValueError("truncated sqzt header")
    magic, fmt, win_bits, blk_bits, flags, osize, nblocks = struct.unpack_from(
        "<8sBBBB4xQQ", blob, 0)
    if magic != SQZT_MAGIC:
        raise ValueError("bad sqzt magic")
    # unpack() is THE untrusted-input validation point: the header fields
    # flow into native code (1 << blk_bits block offsets, win_bits-sized
    # dictionaries), so range-check everything here
    if fmt not in (SQZT_FORMAT_SQUEEZE, SQZT_FORMAT_SQZ4):
        raise ValueError(f"bad sqzt format code {fmt}")
    if not 10 <= win_bits <= 15:
        raise ValueError(f"bad sqzt win_bits {win_bits}")
    if not 1 <= blk_bits <= 40:
        raise ValueError(f"bad sqzt blk_bits {blk_bits}")
    if flags & ~(FLAG_CHECKSUM | FLAG_WARM | FLAG_ANCHORS):
        raise ValueError(f"unsupported sqzt flags 0x{flags:02x}")
    if blob[12:16] != b"\0\0\0\0":
        raise ValueError("nonzero reserved sqzt header bytes")
    if nblocks != max(1, -(-osize // (1 << blk_bits))):
        raise ValueError("sqzt block count does not match original size")
    off = SQZT_HEADER_BYTES
    if off + 8 * nblocks > len(blob):
        raise ValueError("truncated sqzt length table")
    sizes = struct.unpack_from(f"<{nblocks}Q", blob, off)
    off += 8 * nblocks
    checksum = None
    if flags & FLAG_CHECKSUM:
        if off + 8 > len(blob):
            raise ValueError("truncated sqzt checksum")
        checksum = struct.unpack_from("<Q", blob, off)[0]
        off += 8
    fresh_mask = None
    anchor_mask = None
    if flags & FLAG_ANCHORS and not flags & FLAG_WARM:
        raise ValueError("anchor flag without warm flag")
    if flags & FLAG_WARM:
        nbm = (nblocks + 7) // 8
        if off + nbm > len(blob):
            raise ValueError("truncated sqzt fresh bitmap")
        bm = blob[off:off + nbm]
        off += nbm
        if _bitmap_padding_set(bm, nblocks):
            raise ValueError("nonzero padding bits in sqzt fresh bitmap")
        fresh_mask = [bool(bm[b >> 3] >> (b & 7) & 1) for b in range(nblocks)]
        if not fresh_mask or not fresh_mask[0]:
            raise ValueError("warm container: block 0 must be fresh")
        if flags & FLAG_ANCHORS:
            if off + nbm > len(blob):
                raise ValueError("truncated sqzt anchor bitmap")
            am = blob[off:off + nbm]
            off += nbm
            if _bitmap_padding_set(am, nblocks):
                raise ValueError("nonzero padding bits in sqzt anchor bitmap")
            anchor_mask = [bool(am[b >> 3] >> (b & 7) & 1)
                           for b in range(nblocks)]
            if any(a and f for a, f in zip(anchor_mask, fresh_mask)):
                raise ValueError("anchor bit set on a fresh block")
            if not any(anchor_mask):
                raise ValueError("anchor flag with an all-zero anchor "
                                 "bitmap (canonical form is v2)")
    payloads = []
    for s in sizes:
        if off + s > len(blob):
            raise ValueError("truncated sqzt payload")
        payloads.append(blob[off:off + s])
        off += s
    if off != len(blob):
        raise ValueError(f"container size mismatch: {off} != {len(blob)}")
    return (fmt, win_bits, blk_bits, osize, payloads, checksum, fresh_mask,
            anchor_mask)



def resolve_anchors(fresh_mask: List[bool],
                    anchor_mask: Optional[List[bool]]):
    """Per-block anchor indices (FORMAT.md §3.2): None for fresh blocks;
    for warm blocks, 0 (v2 semantics) or — when the anchor bit is set —
    the index of the nearest previous fresh block."""
    out = []
    last_fresh = 0
    for b, fresh in enumerate(fresh_mask):
        if fresh:
            out.append(None)
            last_fresh = b
        else:
            use_near = anchor_mask is not None and anchor_mask[b]
            out.append(last_fresh if use_near else 0)
    return out
