"""Plain PyTorch versions of the sqz4 kernels.

The coders run every block of the call in lock-step, one coder op
(op-stream and stats-fed encoders), one op pair (token encoder) or one
token step (decoder) per Python iteration, with the same inputs and
outputs as their CUDA kernels (``csrc/sqz4_encode.cu``,
``csrc/sqz4_encode_stats.cu``, ``csrc/sqz4_encode_tok.cu``,
``csrc/sqz4_decode.cu``) and as the reference's Pallas launchers; the
compaction is a concatenation (``csrc/sqz4_compact.cu``), the decoder's
payload packing a copy a lane and a shift (``csrc/sqz4_pack.cu``), the
exact parse a find a token over the whole window
(``csrc/sqz4_exact_parse.cu``), the per-op model statistics a window of
ops at a time, every block side by side (``csrc/sqz4_model_stats.cu``). They run on any device; the
wrappers in ``sqz4_cuda`` use them for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.

A u64 coder register is an int64 tensor holding the same 64 bits: add,
subtract, multiply and left shift wrap identically, and the helpers below
supply the unsigned compare, divide and byte count.

The op-stream encoder and the decoder also run seeded (sqzt v2 and v3
warm start, FORMAT.md §3.1): their models start from a seed column, int32
[SEED_WORDS] in the kernels' csum form (``sqz4_host.seed_column``),
instead of fresh counts.
"""

from __future__ import annotations

import torch

I64 = torch.int64
MIN64 = -(1 << 63)
M32 = 0xFFFFFFFF

# decoder states and error codes (sqz4_pallas.py:1647-1648)
ST_FLAG, ST_BYTE, ST_SIZE, ST_BITS, ST_DIST, ST_DONE, ST_ERR = range(7)
E_ILSEQ, E_SIZE, E_BITS, E_DIST, E_OVERRUN = 1, 2, 3, 4, 5
MOP_FLUSH = 254
SEED_WORDS = 610   # the seed column (csrc/sqz4_chain.cuh kSeed*)


def _start_counts(n: int, dev, seed=None, cold_lane: int = -1):
    """Each lane's starting model counts, int64 [n, SEED_WORDS] in the seed
    column's form: ``seed``'s (int32 [SEED_WORDS]) where it is given,
    fresh (every count 1) where it is None and on lane ``cold_lane``."""
    cold = torch.ones(SEED_WORDS, dtype=I64, device=dev)
    cold[0:256] = torch.arange(1, 257, device=dev)
    cold[256:512] = torch.arange(1, 257, device=dev)
    cold[512:544] = torch.arange(1, 33, device=dev)
    if seed is None:
        return cold.repeat(n, 1)
    if seed.shape != (SEED_WORDS,):
        raise ValueError(f"seed must be [{SEED_WORDS}] int32")
    tab = seed.to(device=dev, dtype=I64).repeat(n, 1)
    if 0 <= cold_lane < n:
        tab[cold_lane] = cold
    return tab


def _models(tab):
    """(byte csum, size csum, bits csum, dist freq0, dist freq1, literal
    freq0, literal freq1) of starting counts ``tab`` [n, SEED_WORDS]."""
    return (tab[:, 0:256].clone(), tab[:, 256:512].clone(),
            tab[:, 512:544].clone(), tab[:, 546:578].clone(),
            tab[:, 578:610].clone(), tab[:, 544].clone(),
            tab[:, 545].clone())


def _ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ MIN64) < (b ^ MIN64)


def _udiv_small(a, d):
    """u64 a // d for 1 <= d < 2^31, by 32-bit halves."""
    hi = (a >> 32) & M32
    qh = hi // d
    ql = (((hi - qh * d) << 32) | (a & M32)) // d
    return (qh << 32) | ql


def _udiv(a, d):
    """u64 a // d for 1 <= d < 2^63: floor(a / 2) // d doubled, then one
    remainder test (the remainder is below 2 d)."""
    q = (((a >> 1) & ~MIN64) // d) << 1
    return q + (~_ult(a - q * d, d)).to(I64)


def _shl(x, s):
    """x << s for per-lane s >= 0 (0 once s >= 64)."""
    return torch.where(s >= 64, torch.zeros_like(x),
                       torch.bitwise_left_shift(x, s.clamp(max=63)))


# 2^(64-8k) for k = 1..7, then 1, biased as _ult biases (u64 ^ 2^63)
_LZB_THR = torch.tensor([(1 << (64 - 8 * k)) - (1 << 63) for k in range(1, 8)]
                        + [1 - (1 << 63)], dtype=I64)


def _lead_zero_bytes(x):
    """Leading zero bytes of u64 x (8 for 0): x < 2^(64-8k) for k = 1..8."""
    return ((x ^ MIN64)[:, None] < _LZB_THR.to(x.device)).sum(1)


def _lanes(t, rows):
    """[G, rows, B] (u32 / i32) -> [rows, G*B] int64 (lane n = g * B + b)."""
    g, _, b = t.shape
    x = t.view(torch.int32).to(I64)
    if t.dtype == torch.uint32:
        x = x & M32
    return x.permute(1, 0, 2).reshape(rows, g * b)


def _from_lanes(x, g, b):
    """[N, rows] int64 lane-major -> [G, rows, B] (low 32 bits)."""
    return x.reshape(g, b, -1).permute(0, 2, 1).contiguous()


def to_u32(x):
    """int64 holding u32 values -> uint32 tensor of the same shape."""
    x = x & M32
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(
        torch.int32).view(torch.uint32)


class _Coder:
    """Per-lane range encoders (coder registers, models, output bytes) for
    N lanes in lock-step; ``code`` takes one micro-op per lane, as the
    op-stream encoder's producer and coder warps do together
    (csrc/sqz4_encode.cu). The models start cold, or from ``seed`` on every
    lane but ``cold_lane`` (``_start_counts``)."""

    def __init__(self, n: int, cap_words: int, dev, seed=None,
                 cold_lane: int = -1):
        self.iota256 = torch.arange(256, dtype=I64, device=dev)[None, :]
        self.iota32 = torch.arange(32, dtype=I64, device=dev)[None, :]
        (self.cb, self.cs, self.bits, self.d0, self.d1, self.lit0,
         self.lit1) = _models(_start_counts(n, dev, seed, cold_lane))
        self.low = torch.zeros(n, dtype=I64, device=dev)
        self.rng = torch.full((n,), -1, dtype=I64, device=dev)
        self.cap = cap_words * 4
        self.out = torch.zeros(n, self.cap + 1, dtype=I64,
                               device=dev)   # + trash column
        self.pos = torch.zeros(n, dtype=I64, device=dev)
        self.rows = torch.arange(n, device=dev)
        self.k8 = torch.arange(8, dtype=I64, device=dev)[None, :]
        self.cap_words = cap_words

    def code(self, m, s):
        """One micro-op a lane: m 0 flag, 1 size, 2 byte, 3 bits, 4..35
        distance bit, 254 flush, others pad; s its symbol (int64 [N])."""
        rows, iota256, iota32 = self.rows, self.iota256, self.iota32
        zero = torch.zeros_like(self.low)
        is_flag, is_size, is_byte, is_bits = m == 0, m == 1, m == 2, m == 3
        is_dist = (m >= 4) & (m < 36)
        is256 = is_byte | is_size
        active = m < 36
        flush = m == MOP_FLUSH
        sb = torch.where(is_bits, s.clamp(max=31), (s != 0).to(I64))
        s256 = torch.where(is256, s, zero)
        bitp = torch.where(is_dist, m - 4, zero)

        tab = torch.where(is_byte[:, None], self.cb, self.cs)
        at256 = tab[rows, s256]
        st256 = torch.where(s256 > 0, tab[rows, (s256 - 1).clamp(min=0)],
                            zero)
        sbit = torch.where(is_bits, sb, zero)
        at32 = self.bits[rows, sbit]
        st32 = torch.where(sbit > 0, self.bits[rows, (sbit - 1).clamp(min=0)],
                           zero)
        f0 = torch.where(is_flag, self.lit0, self.d0[rows, bitp])
        f1 = torch.where(is_flag, self.lit1, self.d1[rows, bitp])
        one = sb == 1
        start = torch.where(is256, st256, torch.where(
            is_bits, st32, torch.where(one, f0, zero)))
        size = torch.where(is256, at256 - st256, torch.where(
            is_bits, at32 - st32, torch.where(one, f1, f0)))
        total = torch.where(is256, tab[:, 255], torch.where(
            is_bits, self.bits[:, 31], f0 + f1))

        # adaptive update, strictly after reading the statistics
        self.cb += (is_byte[:, None] & (iota256 >= s256[:, None])).to(I64)
        self.cs += (is_size[:, None] & (iota256 >= s256[:, None])).to(I64)
        self.bits += (is_bits[:, None] & (iota32 >= sbit[:, None])).to(I64)
        self.lit0 += (is_flag & ~one).to(I64)
        self.lit1 += (is_flag & one).to(I64)
        hit = is_dist[:, None] & (iota32 == bitp[:, None])
        self.d0 += (hit & ~one[:, None]).to(I64)
        self.d1 += (hit & one[:, None]).to(I64)

        self.code_stats(start, size, total, active, flush)

    def code_stats(self, start, size, total, active, flush):
        """The coder half of a step (csrc/sqz4_chain.cuh ChainCoder::code
        and flush): on lanes ``active``, narrow to
        [start, start + size) of total, renormalize with the underflow
        escape and emit the settled bytes; on lanes ``flush``, emit the
        top byte. Other lanes code nothing. int64 [N] each."""
        low, rng = self.low, self.rng
        q = _udiv_small(rng, torch.where(active, total, 1))
        low = torch.where(active, low + start * q, low)
        rng = torch.where(active, size * q, rng)
        pre = low
        cnt = torch.where(active, _lead_zero_bytes(low ^ (low + rng)), 0)
        low = _shl(low, 8 * cnt)
        rng = _shl(rng, 8 * cnt)
        uf = active & _ult(rng, total + 1)
        if bool(uf.any()):   # rare: two more bytes, re-inflate
            low = torch.where(uf, _shl(pre, 8 * cnt + 16), low)
            rng = torch.where(uf, ~low, rng)
            cnt = cnt + 2 * uf.to(I64)
        cnt = torch.where(flush, 1, cnt)
        low = torch.where(flush, pre << 8, low)
        self.low, self.rng = low, rng

        # emission: the top min(cnt, 8) bytes of pre; bytes past 8 are 0
        if not bool(cnt.any()):   # most ops settle no byte
            return
        k8, pos, cap = self.k8, self.pos, self.cap
        byte = (pre[:, None] >> (56 - 8 * k8)) & 0xFF
        col = torch.where((k8 < cnt[:, None]) & (pos[:, None] + k8 < cap),
                          pos[:, None] + k8, cap)
        self.out.scatter_(1, col, byte)
        self.pos = pos + cnt

    def result(self, g: int, b: int):
        """(words uint32 [G, cap_words, B], lens int32 [G, 8, B])."""
        n = self.out.shape[0]
        w = self.out[:, :self.cap].reshape(n, self.cap_words, 4)
        words = ((w[..., 0] << 24) | (w[..., 1] << 16) | (w[..., 2] << 8)
                 | w[..., 3])
        lens = torch.zeros(n, 8, dtype=I64, device=words.device)
        lens[:, 0] = self.pos
        return (to_u32(_from_lanes(words, g, b)),
                _from_lanes(lens, g, b).to(torch.int32))


def encode_stats_ref(start, size, total, cap_words: int):
    """start / size / total: uint32 [G, T, B], each op's coder statistics
    (total 0 a pad, size 0 with total != 0 a flush). Returns (words uint32
    [G, cap_words, B], lens int32 [G, 8, B]), as csrc/sqz4_encode_stats.cu
    and the reference's stats-fed Pallas encoder do."""
    G, T, B = start.shape
    st, sz, tt = (_lanes(a, T) for a in (start, size, total))
    coder = _Coder(G * B, cap_words, start.device)
    act, flush = (tt != 0) & (sz != 0), (tt != 0) & (sz == 0)
    for t in range(T):
        coder.code_stats(st[t], sz[t], tt[t], act[t], flush[t])
    return coder.result(G, B)


def encode_full_ref(m_ops, s_ops, cap_words: int, seed=None,
                    fresh_block: int = -1):
    """m_ops / s_ops: uint32 [G, T/4, B] (four big-endian u8 ops a word);
    ``seed``: None (cold) or the seed column, int32 [SEED_WORDS], every
    block but ``fresh_block`` (counted g * B + b) starting warm from it.
    Returns (words uint32 [G, cap_words, B], lens int32 [G, 8, B])."""
    G, TW, B = m_ops.shape
    dev = m_ops.device
    N = G * B
    shifts = torch.tensor([24, 16, 8, 0], dtype=I64, device=dev)
    mops = ((_lanes(m_ops, TW)[:, None, :] >> shifts[None, :, None]) & 0xFF
            ).reshape(TW * 4, N)
    sops = ((_lanes(s_ops, TW)[:, None, :] >> shifts[None, :, None]) & 0xFF
            ).reshape(TW * 4, N)
    coder = _Coder(N, cap_words, dev, seed, fresh_block)
    for t in range(TW * 4):
        coder.code(mops[t], sops[t])
    return coder.result(G, B)


TOK_DONE = M32   # a lane's token after its last pair
MOP_PAD = 255


def encode_tok_ref(toks, lits, t_max: int, cap_words: int,
                   lit_skip: bool = False):
    """toks: uint32 [G, B, Tt] (one token row per block, as
    ``native.sqz4_tok_plan`` emits them); lits: uint8 [G, B, L] (each
    block's literal bytes). Expands the tokens into coder op pairs with
    the kernels' (token, phase) machine, one pair a step for ``t_max``
    steps (csrc/sqz4_encode_tok.cu). ``lit_skip``: lits holds the raw
    blocks, and a match token (not EOS) drains the ``len`` bytes it
    covers at 32 a pair from the pair that fetches it, the lane waiting
    in phase 15 (PAD pairs) until the drain is done (sqz4_pallas.py
    :1219-1290). Returns (words uint32 [G, cap_words, B], lens int32
    [G, 8, B])."""
    G, B, TT = toks.shape
    L = lits.shape[2]
    dev = toks.device
    N = G * B
    tk = toks.reshape(N, TT).view(torch.int32).to(I64) & M32
    tk = torch.cat([tk, torch.zeros(N, 1, dtype=I64, device=dev)], 1)
    lt = torch.cat([lits.reshape(N, L).to(I64),
                    torch.zeros(N, 1, dtype=I64, device=dev)], 1)
    rows = torch.arange(N, device=dev)
    zero = torch.zeros(N, dtype=I64, device=dev)
    tok, phase, run, tidx, lidx, skip = zero, zero, zero, zero, zero, zero
    coder = _Coder(N, cap_words, dev)
    pad = zero + MOP_PAD
    for _ in range(t_max):
        # fetch the next token on lanes that consumed theirs
        need = tok == 0
        fetched = torch.where(need, tk[rows, tidx.clamp(max=TT)], tok)
        tok = torch.where(need & (fetched == 0), zero + TOK_DONE, fetched)
        tidx = tidx + need.to(I64)
        phase = torch.where(need, zero, phase)
        done = tok == TOK_DONE
        if bool(done.all()):
            break
        isflush = (phase >= 16) & ~done
        ismatch = (((tok >> 8) & 1) == 1) & ~done & ~isflush
        cnt_len = tok & 0xFF
        nb = (tok >> 9) & 0x1F
        dist = (tok >> 16) & 0x7FFF
        eos = ismatch & (cnt_len == 255)
        islit = ~done & ~isflush & ~ismatch
        run = torch.where(need & islit, cnt_len, run)
        if lit_skip:   # a fetched match token owes cnt_len raw bytes
            skip = torch.where(need & ismatch & ~eos, cnt_len, skip)
        lbyte = lt[rows, lidx.clamp(max=L)]

        # expand (token, phase) -> the pair (m1, s1), (m2, s2)
        p0 = ismatch & (phase == 0)
        p1 = ismatch & (phase == 1)
        pk = ismatch & (phase >= 2)
        if lit_skip:
            pk = pk & (phase < 15)
        k1 = (2 * phase - 3).clamp(min=0)
        k2 = (2 * phase - 2).clamp(min=0)
        flush = zero + MOP_FLUSH
        m1 = torch.where(islit | p0, zero, torch.where(
            p1, zero + 3, torch.where(pk, 4 + k1, torch.where(
                isflush, flush, pad))))
        s1 = torch.where(islit, zero + 1, torch.where(
            p1, nb, torch.where(pk, (dist >> k1) & 1, zero)))
        m2 = torch.where(islit, zero + 2, torch.where(
            p0, zero + 1, torch.where(p1 & (nb >= 2), zero + 4, torch.where(
                pk & (k2 <= nb - 2), 4 + k2, torch.where(
                    isflush, flush, pad)))))
        s2 = torch.where(islit, lbyte, torch.where(
            p0, cnt_len, torch.where(p1, dist & 1, torch.where(
                pk, (dist >> k2) & 1, zero))))

        # advance the expansion state
        litlast = islit & (run == 1)
        run = torch.where(islit, run - 1, run)
        lidx = lidx + islit.to(I64)
        adv = (p1 & (nb <= 2)) | (pk & (k2 >= nb - 2))
        nxt = torch.where(p0, torch.where(eos, zero + 16, zero + 1), phase)
        nxt = torch.where(((p1 | pk) & ~adv) | isflush, phase + 1, nxt)
        fin = adv & ~eos
        if lit_skip:
            drain = skip.clamp(max=32)
            lidx = lidx + drain   # match lanes read no literal this pair
            skip = skip - drain
            wait = (adv | (ismatch & (phase == 15))) & (skip > 0)
            nxt = torch.where(wait, zero + 15, nxt)
            fin = (adv | (ismatch & (phase == 15))) & ~wait & ~eos
        tok = torch.where(litlast | fin, zero, tok)
        tok = torch.where(isflush & (nxt >= 20), zero + TOK_DONE, tok)
        phase = nxt

        coder.code(m1, s1)
        coder.code(m2, s2)
    return coder.result(G, B)


def skip_literal_rows(toks, lits):
    """The literal rows the cold token encoder takes for lit_skip's
    tokens: toks uint32 [G, B, Tt] over the raw blocks lits uint8 [G, B,
    L] -> uint8 [G, B, L'] (on the CPU), each row with the spans its match
    tokens (up to EOS) cover cut out. The cold mode codes on these rows
    what lit_skip codes on the raw ones."""
    G, B, TT = toks.shape
    tk = (toks.reshape(G * B, TT).view(torch.int32).to(I64) & M32).cpu()
    raw = lits.reshape(G * B, -1).cpu()
    rows = []
    for t, blk in zip(tk, raw):
        t = t[:int(torch.nonzero(t == 0)[0]) if (t == 0).any() else TT]
        n, ism = t & 0xFF, (t >> 8) & 1
        eos = torch.nonzero((ism == 1) & (n == 255))
        if eos.numel():
            n, ism = n[:int(eos[0])], ism[:int(eos[0])]
        keep = torch.repeat_interleave(ism == 0, n)
        rows.append(blk[:keep.numel()][keep])
    out = torch.zeros((G * B, max([1] + [r.numel() for r in rows])),
                      dtype=torch.uint8)
    for i, r in enumerate(rows):
        out[i, :r.numel()] = r
    return out.reshape(G, B, -1)


def compact_offsets(lens, nb: int, rows: int):
    """Word offsets int64 [nb + 1] of the first ``nb`` lanes' payloads in
    the compacted buffer (lens int32 [1, 8, B], row 0 the byte lengths;
    each lane's word count capped at ``rows``); the last is the total."""
    wc = ((lens[0, 0, :nb].to(I64) + 3) // 4).clamp(0, rows)
    return torch.cat([torch.zeros(1, dtype=I64, device=lens.device),
                      torch.cumsum(wc, 0)])


def compact_ref(words, lens, nb: int):
    """words uint32 [1, R, B], lens int32 [1, 8, B] -> uint32 [total]: the
    first ``nb`` lanes' payload words, lane after lane (the kernel's
    output, csrc/sqz4_compact.cu)."""
    _, R, B = words.shape
    off = compact_offsets(lens, nb, R).tolist()
    cols = words[0].view(torch.int32).t()
    return torch.cat([cols[b, :off[b + 1] - off[b]] for b in range(nb)]
                     or [cols.new_zeros(0)]).view(torch.uint32)


def pack_payloads_ref(data, offsets, lengths, pw: int):
    """data uint8 [n] (payloads back to back), offsets / lengths int64
    [G, lanes] -> uint32 [G, pw, lanes]: lane b of group g holds bytes
    data[off:off + len] as big-endian words, zero past them; a lane longer
    than 4 * pw bytes or outside the data is all zeros (the kernel's
    output, csrc/sqz4_pack.cu)."""
    G, lanes = offsets.shape
    n = data.shape[0]
    cols = torch.zeros((G * lanes, 4 * pw), dtype=torch.uint8,
                       device=data.device)
    for i, (o, ln) in enumerate(zip(offsets.reshape(-1).tolist(),
                                    lengths.reshape(-1).tolist())):
        if 0 < ln <= 4 * pw and 0 <= o <= n - ln:
            cols[i, :ln] = data[o:o + ln]
    out = []
    for g in range(G):
        x = cols[g * lanes:(g + 1) * lanes].to(I64).reshape(lanes, pw, 4)
        w = (x[..., 0] << 24) | (x[..., 1] << 16) | (x[..., 2] << 8) \
            | x[..., 3]
        out.append(to_u32(w.t()))
    return torch.stack(out)


# the exact parse's match lengths (csrc/sqz4_exact_parse.cu)
MIN_MATCH, MAX_MATCH = 2, 254
EOS_OPS = ((0, 0), (1, 0xFF)) + ((MOP_FLUSH, 0),) * 8


def exact_find(x, i: int, window: int):
    """The longest match at position i of the stream x (int64 [n]) among
    every j in [max(0, i - window + 1), i), of at least 2 bytes, capped at
    min(254, n - i), the nearest of the longest: the key (length << 16) |
    (j - lo) of every candidate, all at once, and its max. Returns
    (length, distance); length 0: none."""
    n = x.shape[0]
    cap = min(MAX_MATCH, n - i)
    lo = max(0, i - window + 1)
    if cap < MIN_MATCH or i == lo:
        return 0, 0
    alive = torch.ones(i - lo, dtype=torch.bool, device=x.device)
    length = torch.zeros(i - lo, dtype=I64, device=x.device)
    for k in range(cap):
        alive &= x[lo + k:i + k] == x[i + k]
        if not bool(alive.any()):
            break
        length += alive
    key = torch.where(length >= MIN_MATCH, (length << 16)
                      | torch.arange(i - lo, device=x.device), 0)
    best = int(key.max())
    return best >> 16, i - lo - (best & 0xFFFF)


def exact_parse_ref(data, offsets, lengths, window: int, lz: bool,
                    rows: int, warm: bool = False):
    """data uint8 [N], lane b its bytes data[offsets[b]:offsets[b] +
    lengths[b]] -> (m_words, s_words uint32 [n, rows], counts int64 [n]),
    the kernel's output (csrc/sqz4_exact_parse.cu; ``warm`` as
    ``sqz4_cuda.exact_parse`` has it): each lane's greedy walk, a find a
    token (``exact_find``); a match of 3 bytes or fewer whose distance
    needs more than 3 bits a literal; a match's ops 0,0 / 1,len / 3,nbits
    / 4+k,bit k (k < nbits - 1), a literal's 0,1 / 2,byte, the stream's
    end 0,0 / 1,0xFF and eight flushes; four ops a big-endian word, pads m
    0xFF and s 0; a row cut at ``rows`` words, its count the whole
    stream's."""
    x = data.to(I64)
    n = len(offsets)
    hist = x[:0]
    if warm and lz and n > 1:
        end = int(offsets[0]) + int(lengths[0])
        hist = x[end - min(int(lengths[0]), window):end]
    m = torch.full((n, 4 * rows), 0xFF, dtype=I64)
    s = torch.zeros((n, 4 * rows), dtype=I64)
    counts = []
    for b, (o, ln) in enumerate(zip(offsets, lengths)):
        start = hist.shape[0] if b else 0
        stream = torch.cat([hist[:start], x[int(o):int(o) + int(ln)]])
        ops, i = [], start
        while i < stream.shape[0]:
            length, dist = exact_find(stream, i, window) if lz else (0, 0)
            nbits = dist.bit_length()
            if length >= MIN_MATCH and not (length <= 3 and nbits > 3):
                ops += [(0, 0), (1, length), (3, nbits)]
                ops += [(4 + k, (dist >> k) & 1) for k in range(nbits - 1)]
                i += length
            else:
                ops += [(0, 1), (2, int(stream[i]))]
                i += 1
        ops += EOS_OPS
        counts.append(len(ops))
        kept = torch.tensor(ops[:4 * rows], dtype=I64).reshape(-1, 2)
        m[b, :kept.shape[0]], s[b, :kept.shape[0]] = kept[:, 0], kept[:, 1]
    words = []
    for t in (m, s):
        q = t.reshape(n, rows, 4)
        words.append(to_u32((q[..., 0] << 24) | (q[..., 1] << 16)
                            | (q[..., 2] << 8) | q[..., 3]))
    return words[0], words[1], torch.tensor(counts, dtype=I64)


# ops of a chunk of the model statistics kernel (csrc/sqz4_model_stats.cu
# kChunkOps)
MODEL_CHUNK_OPS = 1 << 13
# the seed column's running-sum segments: byte, size and bits models
_SEGMENTS = ((0, 256), (256, 512), (512, 544))


def chunk_bases(hist, seed=None):
    """Each chunk's starting models, int32 [n, chunks, SEED_WORDS] in the
    seed column's form, from each chunk's counts ``hist`` in the same form
    and shape: the blocks' starting column (cold, or ``seed``'s) plus the
    sum over the block's earlier chunks (the step between the model
    statistics kernel's passes)."""
    start = _start_counts(1, hist.device, seed)[0].to(torch.int32)
    return torch.cumsum(hist, 1, dtype=torch.int32) - hist + start


def _model_of(m, s):
    """Packed op codes m and symbols s (int64) -> (coded, the model 0..35,
    the op's seed-column count slot 0..609; pads and flushes model 36 and
    slot 610)."""
    coded = m < 36
    bits = s.clamp(max=31)
    slot = torch.where(m == 2, s, torch.where(
        m == 1, 256 + s, torch.where(
            m == 3, 512 + bits, torch.where(
                m == 0, 544 + (s != 0).to(I64),
                torch.where(s != 0, 578, 546) + m - 4))))
    return coded, torch.where(coded, m, 36), torch.where(coded, slot, 610)


def model_stats_ref(m_words, s_words, lanes: int, seed=None):
    """m_words / s_words: uint32 [n, rows], block i's ops in row i (four
    big-endian u8 ops a word); ``seed``: None (cold) or the seed column,
    int32 [SEED_WORDS], from which every block starts. Returns (start,
    size, total) uint32 [G, 4 * rows, lanes]: each op's statistics before
    its model's update (block i on lane i % lanes of group i // lanes), a
    flush (0, 0, 1), a pad and every lane past n (0, 0, 0), as
    csrc/sqz4_model_stats.cu and ``sqz4_host.op_stats`` give them. The
    blocks step side by side a window of ops at a time (128 ops for up to
    8 blocks, else 32: the fastest on the CPU): the models' counts at the
    window's start plus each op's earlier ops in the window."""
    n, rows = m_words.shape
    window = 128 if n <= 8 else 32
    dev = m_words.device
    T = 4 * rows
    shifts = torch.tensor([24, 16, 8, 0], dtype=I64, device=dev)

    def ops(w):
        return ((w.view(torch.int32).to(I64)[:, :, None] >> shifts)
                & 0xFF).reshape(n, T)

    m, s = ops(m_words), ops(s_words)
    coded, model, slot = _model_of(m, s)
    sym = torch.where((m == 1) | (m == 2), s, torch.where(
        m == 3, s.clamp(max=31), (s != 0).to(I64)))
    key = model * 256 + sym
    # the counts, a trash slot for pads: the column's running sums undone
    cnt = torch.zeros((n, SEED_WORDS + 1), dtype=I64, device=dev)
    cnt[:, :SEED_WORDS] = _start_counts(n, dev, seed)
    for lo, hi in _SEGMENTS:
        cnt[:, lo + 1:hi] -= cnt[:, lo:hi - 1].clone()
    out = torch.zeros((3, n, T), dtype=I64, device=dev)
    later = torch.ones((window, window), dtype=torch.bool,
                       device=dev).tril(-1)   # [i, j]: j before i
    for o in range(0, T, window):
        mo, ko, so = (x[:, o:o + window] for x in (model, key, slot))
        w = mo.shape[1]
        # each slot's counts below it in its model, each model's total
        below = torch.zeros_like(cnt)
        for lo, hi in _SEGMENTS:
            below[:, lo:hi] = cnt[:, lo:hi].cumsum(1) - cnt[:, lo:hi]
        below[:, 545] = cnt[:, 544]
        below[:, 578:610] = cnt[:, 546:578]
        tot = torch.stack(
            [cnt[:, 544] + cnt[:, 545], cnt[:, 256:512].sum(1),
             cnt[:, 0:256].sum(1), cnt[:, 512:544].sum(1)], 1)
        tot = torch.cat([tot, cnt[:, 546:578] + cnt[:, 578:610],
                         torch.zeros((n, 1), dtype=I64, device=dev)], 1)
        same = (mo[:, :, None] == mo[:, None, :]) & later[:w, :w] \
            & (mo < 36)[:, None, :]
        lt = (same & (ko[:, None, :] < ko[:, :, None])).sum(2)
        eq = (same & (ko[:, None, :] == ko[:, :, None])).sum(2)
        c = coded[:, o:o + w]
        out[0, :, o:o + w] = torch.where(c, below.gather(1, so) + lt, 0)
        out[1, :, o:o + w] = torch.where(c, cnt.gather(1, so) + eq, 0)
        out[2, :, o:o + w] = torch.where(
            c, tot.gather(1, mo) + same.sum(2),
            (m[:, o:o + w] == MOP_FLUSH).to(I64))
        cnt.scatter_add_(1, so, torch.ones_like(so))
    G = -(-n // lanes)
    full = torch.zeros((3, G * lanes, T), dtype=I64, device=dev)
    full[:, :n] = out
    cols = full.reshape(3, G, lanes, T).transpose(2, 3)
    return tuple(to_u32(c.contiguous()) for c in cols)


class _Stream:
    """Per-lane payload byte streams (zeros past the buffer) and the
    coder registers of the range decoder, as int64 u64 bit patterns."""

    def __init__(self, payload):
        G, PW, B = payload.shape
        dev = payload.device
        N = G * B
        shifts = torch.tensor([24, 16, 8, 0], dtype=I64, device=dev)
        w = _lanes(payload, PW).t()                              # [N, PW]
        self.buf = torch.cat([((w[:, :, None] >> shifts) & 0xFF).reshape(
            N, PW * 4), torch.zeros(N, 1, dtype=I64, device=dev)], 1)
        self.end = PW * 4
        self.k8 = torch.arange(8, dtype=I64, device=dev)[None, :]
        self.sh8 = 56 - 8 * self.k8
        self.pos = torch.zeros(N, dtype=I64, device=dev)
        self.low = torch.zeros(N, dtype=I64, device=dev)
        self.rng = torch.full((N,), -1, dtype=I64, device=dev)
        self.code = self.take(torch.full((N,), 8, dtype=I64, device=dev))
        self.rd = torch.zeros_like(self.low)

    def take(self, k):
        """The next k (0..8) bytes of each lane, big-endian, right-aligned."""
        idx = (self.pos[:, None] + self.k8).clamp(max=self.end)
        b = torch.gather(self.buf, 1, idx) << self.sh8
        w = b.sum(1)   # disjoint byte fields: the sum is their OR
        s = (64 - 8 * k).clamp(max=63)
        mask = torch.where(k >= 8, torch.full_like(k, -1),
                           torch.bitwise_left_shift(torch.ones_like(k), 8 * k)
                           - 1)
        self.pos = self.pos + k
        return (w >> s) & mask

    def front(self, total, act):
        """Underflow escape, divide and the saturated cumulative count of
        the next symbol on lanes ``act``. Returns (cum, bad)."""
        tot = torch.where(act, total, 1)
        uf = act & _ult(self.rng, tot)
        if bool(uf.any()):   # rare: consume two bytes, re-inflate
            two = self.take(2 * uf.to(I64))
            self.code = torch.where(uf, (self.code << 16) | two, self.code)
            self.low = torch.where(uf, self.low << 16, self.low)
            self.rng = torch.where(uf, ~self.low, self.rng)
        rd = _udiv_small(self.rng, tot)
        self.rd = rd
        diff = self.code - self.low
        bad = act & ~_ult(diff, tot * rd)
        # a total is at least 2, so rd < 2^63; where bad (or rd is 0 after
        # an escape), the count saturates at the last symbol
        cum = torch.where(bad, tot - 1, _udiv(diff, rd.clamp(min=1)))
        return cum, bad

    def back(self, start, size, act):
        """Narrow the interval on lanes ``act`` and renormalize."""
        zero = torch.zeros_like(start)
        self.low = torch.where(act, self.low + start * self.rd, self.low)
        self.rng = torch.where(act, size * self.rd, self.rng)
        cnt = torch.where(act, _lead_zero_bytes(self.low ^ (self.low
                                                            + self.rng)),
                          zero)
        if not bool(cnt.any()):   # most ops settle no byte
            return
        nxt = self.take(cnt)
        full = cnt >= 8
        sh = (8 * cnt).clamp(max=63)
        self.code = torch.where(full, nxt, (self.code << sh) | nxt)
        self.low = torch.where(full, zero, self.low << sh)
        self.rng = torch.where(full, zero, self.rng << sh)


def decode_ref(payload, meta, t_max: int, lw: int, tw: int, mw: int,
               seed=None):
    """payload: uint32 [G, Pw, B] (big-endian bytes); meta: int32 [G, 8, B]
    (row 1 sizes, row 2 dictionary length); ``seed``: None (cold) or the
    seed column, int32 [SEED_WORDS], every block starting warm from it.
    Returns (lit uint32 [G, lw, B], tok uint32 [G, tw, B], mrec uint32
    [G, mw, B], counts int32 [G, 8, B]) with the kernel's step grammar:
    op 1 flag | bits | distance bit, op 2 byte | size | distance bit |
    nothing."""
    G, _, B = payload.shape
    dev = payload.device
    N = G * B
    st = _Stream(payload)
    sizes = _lanes(meta[:, 1:2], 1)[0]
    dlen = _lanes(meta[:, 2:3], 1)[0]
    iota256 = torch.arange(256, dtype=I64, device=dev)[None, :]
    iota32 = torch.arange(32, dtype=I64, device=dev)[None, :]
    cb, cs, bits, d0, d1, lit0, lit1 = _models(_start_counts(N, dev, seed))
    zero = torch.zeros(N, dtype=I64, device=dev)
    state = zero + ST_FLAG
    psize, pbits, pdist, bitpos = zero, zero, zero, zero
    optr, nlit, ntok, nmatch, err, steps = zero, zero, zero, zero, zero, zero
    rows = torch.arange(N, device=dev)
    litb = torch.zeros(N, lw * 4 + 1, dtype=I64, device=dev)
    tokb = torch.zeros(N, tw * 32 + 1, dtype=I64, device=dev)
    mrecb = torch.zeros(N, mw + 1, dtype=I64, device=dev)

    def put(buf, idx, val, on, n):
        col = torch.where(on & (idx < n), idx, n)
        buf.scatter_(1, col[:, None], torch.where(on, val, zero)[:, None])

    for _ in range(t_max):
        act1 = state < ST_DONE
        if not bool(act1.any()):
            break
        # ---- op 1: flag | bits | distance bit
        o1_flag = state == ST_FLAG
        o1_bits = state == ST_BITS
        o1_dist = act1 & ~o1_flag & ~o1_bits
        bp = bitpos.clamp(0, 31)
        f0, f1 = d0[rows, bp], d1[rows, bp]
        bin0 = torch.where(o1_flag, lit0, f0)
        bin1 = torch.where(o1_flag, lit1, f1)
        total1 = torch.where(o1_bits, bits[:, 31], bin0 + bin1)
        cum1, bad1 = st.front(total1, act1)
        sym32 = (bits <= cum1[:, None]).sum(1).clamp(max=31)
        start32 = torch.where(sym32 > 0,
                              bits[rows, (sym32 - 1).clamp(min=0)], zero)
        symb = (cum1 >= bin0).to(I64)
        sym1 = torch.where(o1_bits, sym32, symb)
        start1 = torch.where(o1_bits, start32, symb * bin0)
        size1 = torch.where(o1_bits, bits[rows, sym32] - start32,
                            torch.where(symb == 1, bin1, bin0))
        st.back(start1, size1, act1)
        bits += (o1_bits[:, None] & (iota32 >= sym1[:, None])).to(I64)
        lit0 = lit0 + (o1_flag & (sym1 == 0)).to(I64)
        lit1 = lit1 + (o1_flag & (sym1 == 1)).to(I64)
        hit = o1_dist[:, None] & (iota32 == bp[:, None])
        d0 += (hit & (sym1 == 0)[:, None]).to(I64)
        d1 += (hit & (sym1 == 1)[:, None]).to(I64)
        bad_bits = o1_bits & (sym1 == 0)
        pbits = torch.where(o1_bits, sym1, pbits)
        pdist = torch.where(o1_bits, zero, pdist)
        bitpos = torch.where(o1_bits, zero, bitpos)
        pdist = torch.where(o1_dist, pdist | (sym1 << bp), pdist)
        bitpos = bitpos + o1_dist.to(I64)
        done1 = (o1_bits & (sym1 == 1)) | (o1_dist & (bitpos == pbits - 1))
        ok1 = act1 & ~bad1
        emit1 = ok1 & done1
        o2_byte = ok1 & o1_flag & (sym1 == 1)
        o2_size = ok1 & o1_flag & (sym1 == 0)
        o2_dist = ok1 & ~bad_bits & ~o1_flag & ~done1
        is256 = o2_byte | o2_size
        act2 = is256 | o2_dist

        # ---- op 2: byte | size | distance bit | nothing
        bp = bitpos.clamp(0, 31)
        f0, f1 = d0[rows, bp], d1[rows, bp]
        tab = torch.where(o2_byte[:, None], cb, cs)
        total2 = torch.where(is256, tab[:, 255], f0 + f1)
        cum2, bad2 = st.front(total2, act2)
        sym256 = (tab <= cum2[:, None]).sum(1).clamp(max=255)
        start256 = torch.where(sym256 > 0,
                               tab[rows, (sym256 - 1).clamp(min=0)], zero)
        symb = (cum2 >= f0).to(I64)
        sym2 = torch.where(is256, sym256, symb)
        start2 = torch.where(is256, start256, symb * f0)
        size2 = torch.where(is256, tab[rows, sym256] - start256,
                            torch.where(symb == 1, f1, f0))
        st.back(start2, size2, act2)
        up = iota256 >= sym2[:, None]
        cb += (o2_byte[:, None] & up).to(I64)
        cs += (o2_size[:, None] & up).to(I64)
        hit = o2_dist[:, None] & (iota32 == bp[:, None])
        d0 += (hit & (sym2 == 0)[:, None]).to(I64)
        d1 += (hit & (sym2 == 1)[:, None]).to(I64)

        # ---- token outputs
        lit_over = o2_byte & (optr >= sizes)
        put(litb, nlit, sym2, o2_byte, lw * 4)
        nlit = nlit + o2_byte.to(I64)
        optr = optr + o2_byte.to(I64)
        eos = o2_size & (sym2 == 255)
        bad_size = o2_size & ~eos & ((sym2 < 2) | (sym2 > 254))
        psize = torch.where(o2_size & ~eos, sym2, psize)
        pdist = torch.where(o2_dist, pdist | (sym2 << bp), pdist)
        bitpos = bitpos + o2_dist.to(I64)
        done2 = o2_dist & (bitpos == pbits - 1) & ~bad2
        emit = emit1 | done2
        dist = pdist | torch.where(
            emit, torch.bitwise_left_shift(zero + 1, (pbits - 1).clamp(0)),
            zero)
        bad_dist = emit & (dist > optr + dlen)
        over = emit & (optr + psize > sizes)
        emit_ok = emit & ~bad_dist & ~over
        put(mrecb, nmatch, (psize << 16) | dist, emit_ok, mw)
        nmatch = nmatch + emit_ok.to(I64)
        optr = optr + torch.where(emit_ok, psize, zero)
        put(tokb, ntok, zero + 1, emit_ok, tw * 32)
        ntok = ntok + (o2_byte | emit_ok).to(I64)

        # ---- next state and errors
        nstate = torch.where(o2_byte, ST_FLAG, state)
        nstate = torch.where(o2_size, torch.where(eos, ST_DONE, ST_BITS),
                             nstate)
        nstate = torch.where(o2_dist, torch.where(done2, ST_FLAG, ST_DIST),
                             nstate)
        nstate = torch.where(emit1, ST_FLAG, nstate)
        newerr = torch.where(bad1 | bad2, E_ILSEQ,
                 torch.where(bad_size, E_SIZE,
                 torch.where(bad_bits, E_BITS,
                 torch.where(bad_dist, E_DIST,
                 torch.where(lit_over | over, E_OVERRUN, zero)))))
        err = torch.where(act1 & (err == 0) & (newerr > 0), newerr, err)
        nstate = torch.where(newerr > 0, ST_ERR, nstate)
        state = torch.where(act1, nstate, state)
        steps = steps + act1.to(I64)

    lit = litb[:, :lw * 4].reshape(N, lw, 4)
    lit = (lit[..., 0] << 24) | (lit[..., 1] << 16) | (lit[..., 2] << 8) \
        | lit[..., 3]
    tok = (tokb[:, :tw * 32].reshape(N, tw, 32)
           << torch.arange(32, dtype=I64, device=dev)).sum(2)
    counts = torch.stack([
        optr, nlit, ntok, nmatch,
        torch.where((err == 0) & (state < ST_DONE), zero + E_ILSEQ, err),
        steps, (nmatch > mw).to(I64), state], 1)
    return (to_u32(_from_lanes(lit, G, B)),
            to_u32(_from_lanes(tok, G, B)),
            to_u32(_from_lanes(mrecb[:, :mw], G, B)),
            _from_lanes(counts, G, B).to(torch.int32))
