"""The wire-format constants the port uses: the sqz4, warm-gate and sqzt
sections of ``sqz_tpu/formats/constants.py`` (FORMAT.md §2-§3), copied."""

import numpy as np

SQZ4_MAGIC = b"squeeze4"       # container magic (reference test.c:41)

# Warm-start gate (sqzt v2 encoder policy): the per-block fresh/warm pick
# costs a second encode pass, so the seeded pass only runs for blocks the
# gate marks as candidates: tail blocks (model seeding alone helps short
# blocks), plus blocks whose first WARM_GATE_PROBE bytes share at least
# WARM_GATE_MIN_HITS 4-grams with the shared dictionary. The native C++
# executor mirrors this exact hash and bitset.
WARM_GATE_PROBE = 2048
WARM_GATE_MIN_HITS = 32
WARM_GATE_HASH_MUL = 2654435761     # Knuth multiplicative hash
WARM_GATE_BITS = 16                 # 2^16-entry membership bitset


def _gram_hashes(b: np.ndarray) -> np.ndarray:
    """The gate's hash of every 4-gram of the u8 array ``b``."""
    g = (b[:-3].astype(np.uint32)
         | (b[1:-2].astype(np.uint32) << 8)
         | (b[2:-1].astype(np.uint32) << 16)
         | (b[3:].astype(np.uint32) << 24))
    return (g * np.uint32(WARM_GATE_HASH_MUL)) >> np.uint32(
        32 - WARM_GATE_BITS)


def warm_gate_mask(parts, dictionary: bytes):
    """Per-block seeded-pass candidacy under the warm gate. parts[0] is
    never a candidate (it is always coded fresh)."""
    full = max((len(p) for p in parts), default=0)
    gate = [False] * len(parts)
    if len(parts) < 2:
        return gate
    bitset = np.zeros(1 << WARM_GATE_BITS, np.bool_)
    d = np.frombuffer(dictionary, np.uint8)
    if d.size >= 4:
        bitset[_gram_hashes(d)] = True
    set_bits = int(bitset.sum())
    for i, p in enumerate(parts[1:], start=1):
        if len(p) < full:
            gate[i] = True          # tail block
            continue
        b = np.frombuffer(p[:WARM_GATE_PROBE], np.uint8)
        if b.size < 4:
            gate[i] = True
            continue
        # the threshold rides above the bitset's expected false-positive
        # hits (density x probes), so an unrelated block fails even under
        # a dense 32 KiB dictionary
        expected = set_bits * (b.size - 3) >> WARM_GATE_BITS
        gate[i] = int(bitset[_gram_hashes(b)].sum()) >= (expected
                                                       + WARM_GATE_MIN_HITS)
    return gate


def warm_dictionary(block0: bytes, win_bits: int) -> bytes:
    """Shared preset history for warm blocks 1+ (FORMAT.md §3.1): the last
    min(2^win_bits, len(block 0)) bytes of block 0 (``sqz_tpu/api.py``'s
    ``_warm_dictionary``)."""
    return block0[-(1 << win_bits):]


SQZT_MAGIC = b"sqzTPU01"
SQZT_FORMAT_SQUEEZE = 0
SQZT_FORMAT_SQZ4 = 1
SQZT_HEADER_BYTES = 32         # magic + fmt/win/blk/reserved + size + nblocks
