"""Compression telemetry — the reference's SQUEEZE_MAP_STATS equivalent
(src/sqz.c:567-588, 744-790; squeeze.h:397-408): per-model Shannon entropies,
literal/backref byte ratios, match-length and distance-bit histograms.
Computed from token streams / model tables, engine-agnostic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, Sequence

import numpy as np


def shannon_entropy(freq: Sequence[int], skip_singletons: bool = True) -> float:
    """Bits/symbol. The reference ignores freq<=1 slots (src/sqz.c:571-587)."""
    f = np.asarray(freq, dtype=np.float64)
    if skip_singletons:
        f = np.where(f > 1, f, 0.0)
    total = f.sum()
    if total <= 0:
        return 0.0
    p = f[f > 0] / total
    return float(-(p * np.log2(p)).sum())


@dataclass
class TokenStats:
    literal_bytes: int = 0
    backref_bytes: int = 0
    n_literals: int = 0
    n_matches: int = 0
    size_histogram: Dict[int, int] = field(default_factory=dict)
    distance_bits_histogram: Dict[int, int] = field(default_factory=dict)
    byte_freq: np.ndarray = field(
        default_factory=lambda: np.zeros(256, dtype=np.int64))

    @property
    def literal_percent(self) -> float:
        total = self.literal_bytes + self.backref_bytes
        return 100.0 * self.literal_bytes / total if total else 0.0

    @property
    def backref_percent(self) -> float:
        total = self.literal_bytes + self.backref_bytes
        return 100.0 * self.backref_bytes / total if total else 0.0

    def literal_entropy(self) -> float:
        return shannon_entropy(self.byte_freq)

    def report(self) -> str:
        lines = [
            f"literals: {self.literal_percent:.2f}% "
            f"back references: {self.backref_percent:.2f}%",
            f"literal byte entropy: {self.literal_entropy():.2f} bits",
            f"tokens: {self.n_literals} literals, {self.n_matches} matches",
        ]
        if self.distance_bits_histogram:
            total = sum(self.distance_bits_histogram.values())
            cum = 0.0
            for b in sorted(self.distance_bits_histogram):
                p = 100.0 * self.distance_bits_histogram[b] / total
                cum += p
                lines.append(f"distance_bits[{b:2d}]: {p:7.3f}% {cum:7.3f}%")
        return "\n".join(lines)


def sqz4_model_report(tokens: Iterable) -> str:
    """Per-model Shannon entropies of the 36 live sqz4 models plus the
    dist-bit sum — the full SQUEEZE_MAP_STATS breadth (src/sqz.c:744-790).
    Model final freqs = init + per-op update counts, derived directly from
    the token stream (updates are +1 per coded symbol)."""
    lit = np.ones(2, np.int64)
    size = np.ones(256, np.int64)
    byte = np.ones(256, np.int64)
    bits = np.ones(32, np.int64)
    dist = np.ones((32, 2), np.int64)
    for tok in tokens:
        if tok[0] == "lit":
            lit[1] += 1
            byte[tok[1]] += 1
        else:
            _, length, d = tok
            lit[0] += 1
            size[length] += 1
            nb = int(d).bit_length()
            bits[nb] += 1
            for b in range(nb - 1):
                dist[b, (d >> b) & 1] += 1
    lit[0] += 1       # EOS flag
    size[0xFF] += 1   # EOS size symbol
    dent = [shannon_entropy(dist[b]) for b in range(32)]
    # reference prints every dist model then their sum (src/sqz.c:744-790)
    upto = 1 + max([b for b in range(32) if dent[b] > 0], default=0)
    parts = " ".join(f"{dent[b]:.2f}" for b in range(upto))
    return ("entropies: lit: {:.2f} byte: {:.2f} size: {:.2f} bits: {:.2f} "
            "dist bits: {} sum: {:.2f}").format(
        shannon_entropy(lit), shannon_entropy(byte),
        shannon_entropy(size), shannon_entropy(bits),
        parts, sum(dent))


def count_rejections(data: bytes, window: int) -> int:
    """Matches demoted to literals by the sqz4 short-far rule
    (src/sqz.c:678-685) — the reference's `rejections` counter.

    Counted DURING a reject-enabled parse (as the reference does): a
    rejected match emits one literal and re-parses from the next byte, so
    counting demotable tokens on a rejection-free parse would see a
    different candidate stream."""
    from sqz_tpu_torch.formats.constants import (
        SQZ4_MIN_LEN, SQZ4_MAX_LEN, sqz4_reject_short_far)
    from sqz_tpu_torch.oracle.match import greedy_tokens
    n = 0

    def reject(length, dist):
        nonlocal n
        if sqz4_reject_short_far(length, dist):
            n += 1
            return True
        return False

    greedy_tokens(data, window, SQZ4_MIN_LEN, SQZ4_MAX_LEN, reject=reject)
    return n


def analyze_tokens(tokens: Iterable) -> TokenStats:
    st = TokenStats()
    for tok in tokens:
        if tok[0] == "lit":
            st.n_literals += 1
            st.literal_bytes += 1
            st.byte_freq[tok[1]] += 1
        else:
            _, length, dist = tok
            st.n_matches += 1
            st.backref_bytes += length
            st.size_histogram[length] = st.size_histogram.get(length, 0) + 1
            bits = int(dist).bit_length()
            st.distance_bits_histogram[bits] = (
                st.distance_bits_histogram.get(bits, 0) + 1)
    return st
