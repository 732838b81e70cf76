"""The wire-format constants the port uses, copied from
``sqz_tpu/formats/constants.py`` (FORMAT.md §1-§3): the squeeze tables
and limits, the sqz4 parse limits and short-far rule, the warm gate and
the sqzt framing.

The DEFLATE-like base/extra-bit tables reproduce the reference values
(reference attic/map_experiment/squeeze.h:29-79); the inverse index maps are
built with the same boundary recurrence (squeeze.h:151-172).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------- squeeze --

SQUEEZE_MIN_WIN_BITS = 10
SQUEEZE_MAX_WIN_BITS = 15

SQUEEZE_LEN_MIN = 3
SQUEEZE_LEN_MAX = 257          # encoder match cap (squeeze.h:15, :347)

SQUEEZE_SYM_MIN = 257          # first length symbol in the lit tree
SQUEEZE_SYM_MAX = 284          # last length symbol
SQUEEZE_LIT_NYT = 285          # lit-tree escape symbol
SQUEEZE_POS_MAX = 29           # last distance code
SQUEEZE_POS_NYT = 30           # pos-tree escape symbol

SQUEEZE_LIT_TERMINALS = 512    # lit tree leaf count (power of two)
SQUEEZE_POS_TERMINALS = 32     # pos tree leaf count

# Length codes 0..28 <-> lit-tree symbols 257..285; lengths 3..258.
LEN_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10,
     11, 13, 15, 17,
     19, 23, 27, 31,
     35, 43, 51, 59,
     67, 83, 99, 115,
     131, 163, 195, 227, 258], dtype=np.int32)

LEN_XB = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1,
     2, 2, 2, 2,
     3, 3, 3, 3,
     4, 4, 4, 4,
     5, 5, 5, 5, 0], dtype=np.int32)

# Distance codes 0..29; distances 1..32768.
POS_BASE = np.array(
    [1, 2, 3, 4,
     5, 7,
     9, 13,
     17, 25,
     33, 49,
     65, 97,
     129, 193,
     257, 385,
     513, 769,
     1025, 1537,
     2049, 3073,
     4097, 6145,
     8193, 12289,
     16385, 24577], dtype=np.int32)

POS_XB = np.array(
    [0, 0, 0, 0,
     1, 1,
     2, 2,
     3, 3,
     4, 4,
     5, 5,
     6, 6,
     7, 7,
     8, 8,
     9, 9,
     10, 10,
     11, 11,
     12, 12,
     13, 13], dtype=np.int32)


def build_len_index() -> np.ndarray:
    """len -> length code, for len in 0..284 (valid from 3).

    Boundary recurrence per reference squeeze.h:151-161: the code index
    advances when ``len == base[j] + (1 << xb[j])``. Length 258 therefore
    maps to code 27 (base 227 + 31 extra), and code 28 is unreachable —
    the encoder caps matches at 257 anyway.
    """
    idx = np.zeros(SQUEEZE_SYM_MAX + 1, dtype=np.int32)
    j = 0
    boundary = int(LEN_BASE[j]) + (1 << int(LEN_XB[j]))
    for length in range(SQUEEZE_LEN_MIN, SQUEEZE_SYM_MAX + 1):
        if length == boundary:
            j += 1
            boundary = int(LEN_BASE[j]) + (1 << int(LEN_XB[j]))
        idx[length] = j
    return idx


def build_pos_index() -> np.ndarray:
    """dist -> distance code, for dist in 0..32767 (valid from 1)."""
    idx = np.zeros(1 << 15, dtype=np.int32)
    j = 0
    boundary = int(POS_BASE[j]) + (1 << int(POS_XB[j]))
    for dist in range(1 << 15):
        if dist == boundary:
            j += 1
            boundary = int(POS_BASE[j]) + (1 << int(POS_XB[j]))
        idx[dist] = j
    return idx


# ------------------------------------------------------------------- sqz4 --

SQZ4_MIN_LEN = 2               # reference src/sqz.c:29
SQZ4_MAX_LEN = 254             # reference src/sqz.c:30

# Short-far reject rule (reference src/sqz.c:678-685): a candidate match is
# demoted to a literal when it is short AND far — the coded cost of the
# distance bits would exceed the literal cost. SINGLE SOURCE OF TRUTH:
# engine tokenizers, stats counters, and the native C++ tokenizer all follow
# this rule; tests/test_matcher_differential.py asserts the native tokenizer
# agrees with it symbol-for-symbol.
SQZ4_REJECT_MAX_LEN = 3        # reject only matches of length <= 3 ...
SQZ4_REJECT_MAX_BITS = 3       # ... whose distance needs > 3 bits


def sqz4_reject_short_far(length: int, dist: int) -> bool:
    """True when the sqz4 parse demotes this (length, dist) match to a
    literal (src/sqz.c:678-685)."""
    return (length <= SQZ4_REJECT_MAX_LEN
            and dist.bit_length() > SQZ4_REJECT_MAX_BITS)


SQZ4_EOS = 0xFF                # pm_size end-of-stream marker
SQZ4_MAGIC = b"squeeze4"       # container magic (reference test.c:41)
SQZ4_FREQ_CAP = 1 << 56        # pm_update total cap (src/sqz.c:467)

# Model layout: one row per probability model, 36 rows total
# (reference sqz_init, src/sqz.c:550-565); the sqz4 kernels' micro-op
# codes are these row numbers.
PM_LITERAL = 0                 # n=2   literal/backref flag
PM_SIZE = 1                    # n=256 match length (+0xFF EOS)
PM_BYTE = 2                    # n=256 literal bytes
PM_BITS = 3                    # n=32  distance bit-length
PM_DIST0 = 4                   # n=2 each, 32 rows: per-bit distance models
PM_ROWS = 36                   # PM_DIST0 + 32
PM_SYMS = np.array([2, 256, 256, 32] + [2] * 32, dtype=np.int32)

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
