"""Resident restore of general sqz4 streams, the port of
``sqz_tpu/ops/lz_restore.py``.

The decoder kernel leaves the LZ copies undone: it gives a dense literal
stream, one match/literal bit a decoded token, and the match records
(len << 16 | dist) in order. The cell assembly (``resident.py``) places
only cell-parsed streams; this one places any spec-valid stream (the
device LZ parse of ``ops/lzparse.py``, the host parsers' streams) on the
card, with no host byte assembly:

1. Match destinations: a stable sort of the token axis by match ordinal
   gives each match's token index; dst[m] = (token index - m) +
   exclusive_cumsum(len)[m].
2. Literal placement: covered[p] (inside a match) from two boundary
   scatters (+1 at dst, -1 at dst + len, invalid matches parked at column
   bs) and a cumsum; an uncovered p reads literal p - covered_before(p).
3. Matches by pointer doubling: a covered p maps to its periodic source
   dst - dist + ((p - dst) mod dist) (the overlapped-copy semantics),
   collapsed over a run of constant dist to the run's start, which
   always lies before p; src = src[src] doubles the resolved depth a
   round, until every chain lands on a literal (at most 20 rounds).

Every step is exact for any spec-valid stream; lanes are flagged bad for
kernel errors or overflows and for streams that fail the structural
checks (dist 0, dist > dst, a size mismatch): corrupt containers, which
the host codec then rejects with its error. The reference splits a group
into 64-lane programs for the TPU sort's compile time; here one group is
one pass, with the same bytes and flags.
"""

from __future__ import annotations

import torch

from sqz_tpu_torch.ops import launch
from sqz_tpu_torch.ops.resident import (SPANS, _cols, run_decoder,
                                        words_to_bytes)

I64 = torch.int64
MAX_ROUNDS = 20   # pointer-doubling rounds: depth up to 2^20 > any block


def _cumsum_excl(x):
    return x.cumsum(1) - x


def _assemble_stage(litw, tokw, mrecw, counts, sizes, T: int, MW: int,
                    bs: int):
    """The general assembly of one decoded group: litw / tokw / mrecw [B,
    LW | TW | MWfull] int64 u32 words, counts [B, 8], sizes [B] ->
    ([B, bs] u8 blocks, [B] bad). T: the token bits read, MW: the match
    records read."""
    B = tokw.shape[0]
    dev = tokw.device
    ntok, nmatch = counts[:, 2], counts[:, 3]

    # token bits, LSB-first
    w = tokw[:, :-(-T // 32)]
    sh = torch.arange(32, dtype=I64, device=dev)
    bits = ((w[:, :, None] >> sh) & 1).reshape(B, -1)[:, :T]
    t_i = torch.arange(T, dtype=I64, device=dev)[None, :]
    bits = torch.where(t_i < ntok[:, None], bits, torch.zeros_like(bits))

    # match token indices: a stable sort by match ordinal (non-matches
    # after every match)
    mkey = torch.where(bits == 1, bits.cumsum(1) - 1,
                       torch.full_like(bits, T + 1))
    mpos = torch.sort(mkey, dim=1, stable=True).indices[:, :MW]

    # match records, in match order
    m_i = torch.arange(MW, dtype=I64, device=dev)[None, :]
    mvalid = m_i < nmatch[:, None]
    rec = mrecw[:, :MW]
    zero = torch.zeros_like(rec)
    mlen = torch.where(mvalid, (rec >> 16) & 0xFFFF, zero)
    mdist = torch.where(mvalid, rec & 0xFFFF, zero)
    dst = torch.where(mvalid, (mpos - m_i) + _cumsum_excl(mlen), zero)

    # structural checks (corrupt containers go to the host codec)
    bad = bits.sum(1) != nmatch
    bad = bad | (((ntok - nmatch) + mlen.sum(1)) != sizes)
    bad = bad | (mvalid & ((mdist == 0) | (mdist > dst)
                           | (dst + mlen > sizes[:, None]))).any(1)
    bad = bad | (counts[:, 0] != sizes)
    bad = bad | (counts[:, 4] != 0) | (counts[:, 6] != 0)

    # covered[p] from boundary deltas; invalid matches (and any dst past
    # the block, which the reference's scatter drops) park at column bs
    park = torch.full_like(dst, bs)
    dpark = torch.where(mvalid, dst.clamp(max=bs), park)
    epark = torch.where(mvalid, (dst + mlen).clamp(max=bs), park)
    one = mvalid.to(I64)
    delta = torch.zeros((B, bs + 1), dtype=I64, device=dev)
    delta.scatter_add_(1, dpark, one)
    delta.scatter_add_(1, epark, -one)
    cov = delta[:, :bs].cumsum(1) > 0

    # literal placement: uncovered p reads literal p - covered_before(p)
    p_i = torch.arange(bs, dtype=I64, device=dev)[None, :]
    lby = words_to_bytes(litw)
    litidx = (p_i - _cumsum_excl(cov.to(I64))).clamp(0, lby.shape[1] - 1)
    out0 = lby.gather(1, litidx)

    # each position's covering match (the last dst <= p; spans are
    # disjoint): its dist, carried forward from its dst column
    dd = torch.zeros((B, bs + 1), dtype=I64, device=dev).scatter_(
        1, dpark, torch.where(mvalid, mdist, zero))[:, :bs]
    at = torch.zeros((B, bs + 1), dtype=torch.bool, device=dev).scatter_(
        1, dpark, mvalid)[:, :bs]
    last = torch.where(at, p_i, torch.full_like(p_i, -1)).cummax(1).values
    distv = torch.where(last >= 0, dd.gather(1, last.clamp(min=0)),
                        torch.zeros_like(last)).clamp(min=1)
    # run collapse: out[p] == out[p - d] across a covered stretch of
    # constant dist d, so such a stretch maps straight past its chained
    # matches to before its start
    prev_cov = torch.nn.functional.pad(cov[:, :-1], (1, 0))
    prev_d = torch.nn.functional.pad(distv[:, :-1], (1, 0))
    newrun = cov & (~prev_cov | (prev_d != distv))
    rs = torch.where(newrun, p_i, torch.full_like(p_i, -1)).cummax(1).values
    src = torch.where(cov, rs - distv + (p_i - rs) % distv,
                      p_i.expand(B, bs)).clamp(0, bs - 1)

    # pointer doubling until every chain lands on a literal
    for _ in range(MAX_ROUNDS):
        if not bool(cov.gather(1, src).any()):
            break
        src = src.gather(1, src)
    # a chain still on a covered position can only come from a corrupt
    # record set: flag it, so the cap never mis-decodes silently
    bad = bad | cov.gather(1, src).any(1)
    out = out0.gather(1, src)
    out = torch.where(p_i < sizes[:, None], out, torch.zeros_like(out))
    return out.to(torch.uint8), bad


def token_bits_read(counts, tw: int) -> int:
    """The token bits the assembly reads: the decoder's worst case,
    trimmed to a power-of-two bucket of the group's longest token stream
    (one small read of the counts; LZ streams carry ~bs/4 tokens)."""
    max_ntok = int(counts[0, 2].max())
    return min(tw * 32, max(1024, 1 << (max_ntok + 1).bit_length()))


def decode_lz_group(buf, plens, sizes, dargs: dict, bs: int,
                    st: launch.Stages = SPANS):
    """Resident decode of any sqz4 payloads: the decoder kernel, then the
    general assembly. Same contract as ``resident.decode_rle_group``:
    ([B, bs] u8 blocks, counts [1, 8, B], bad [B]); ``st`` times and names
    the stages kernel and general."""
    with st.stage("kernel"):
        lit, tok, mrec, counts = run_decoder(buf, plens, sizes, dargs)
    with st.stage("general"):
        T = token_bits_read(counts, dargs["tw"])
        blocks, bad = _assemble_stage(_cols(lit), _cols(tok), _cols(mrec),
                                      _cols(counts), sizes, T,
                                      min(dargs["mw"], T), bs)
    return blocks, counts, bad
