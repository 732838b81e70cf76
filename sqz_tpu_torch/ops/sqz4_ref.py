"""Plain PyTorch versions of the sqz4 kernels.

The coders run every block of the call in lock-step, one coder op
(op-stream and stats-fed encoders), one op pair (token encoder) or one
token step (decoder) per Python iteration, with the same inputs and
outputs as their CUDA kernels (``csrc/sqz4_encode.cu``,
``csrc/sqz4_encode_stats.cu``, ``csrc/sqz4_encode_tok.cu``,
``csrc/sqz4_decode.cu``) and as the reference's Pallas launchers; the
compaction is a concatenation (``csrc/sqz4_compact.cu``). They run on
any device; the wrappers in ``sqz4_cuda`` use them for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.

A u64 coder register is an int64 tensor holding the same 64 bits: add,
subtract, multiply and left shift wrap identically, and the helpers below
supply the unsigned compare, divide and byte count.
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


def _ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ MIN64) < (b ^ MIN64)


def _udiv_small(a, d):
    """u64 a // d for 1 <= d < 2^31, by 32-bit halves."""
    hi = (a >> 32) & M32
    qh = hi // d
    ql = (((hi - qh * d) << 32) | (a & M32)) // d
    return (qh << 32) | ql


def _shl(x, s):
    """x << s for per-lane s >= 0 (0 once s >= 64)."""
    return torch.where(s >= 64, torch.zeros_like(x),
                       torch.bitwise_left_shift(x, s.clamp(max=63)))


def _u64_to_f64(x):
    f = x.to(torch.float64)
    return torch.where(x < 0, f + 2.0 ** 64, f)


def _lead_zero_bytes(x):
    """Leading zero bytes of u64 x (8 for 0): x < 2^(64-8k) for k = 1..8."""
    thr = torch.tensor([1 << (64 - 8 * k) for k in range(1, 8)] + [1],
                       dtype=I64, device=x.device)
    return _ult(x[:, None], thr[None, :]).sum(1)


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
    kernels' shared coder step does (csrc/sqz4_coder.cuh Encoder::code)."""

    def __init__(self, n: int, cap_words: int, dev):
        self.iota256 = torch.arange(256, dtype=I64, device=dev)[None, :]
        self.iota32 = torch.arange(32, dtype=I64, device=dev)[None, :]
        self.cb = (self.iota256 + 1).repeat(n, 1)
        self.cs = self.cb.clone()
        self.bits = (self.iota32 + 1).repeat(n, 1)
        self.d0 = torch.ones(n, 32, dtype=I64, device=dev)
        self.d1 = torch.ones_like(self.d0)
        self.lit0 = torch.ones(n, dtype=I64, device=dev)
        self.lit1 = torch.ones_like(self.lit0)
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
        """The coder half of a step (csrc/sqz4_coder.cuh
        Encoder::code_stats and flush): on lanes ``active``, narrow to
        [start, start + size) of total, renormalize with the underflow
        escape and emit the settled bytes; on lanes ``flush``, emit the
        top byte. Other lanes code nothing. int64 [N] each."""
        low, rng = self.low, self.rng
        zero = torch.zeros_like(low)
        q = _udiv_small(rng, torch.where(active, total, zero + 1))
        low = torch.where(active, low + start * q, low)
        rng = torch.where(active, size * q, rng)
        pre = low
        cnt = torch.where(active, _lead_zero_bytes(low ^ (low + rng)), zero)
        low = _shl(low, 8 * cnt)
        rng = _shl(rng, 8 * cnt)
        uf = active & _ult(rng, total + 1)
        low = torch.where(uf, _shl(pre, 8 * cnt + 16), low)
        rng = torch.where(uf, ~low, rng)
        cnt = cnt + 2 * uf.to(I64)
        cnt = torch.where(flush, zero + 1, cnt)
        self.low = torch.where(flush, pre << 8, low)
        self.rng = rng

        # emission: the top min(cnt, 8) bytes of pre; bytes past 8 are 0
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
    for t in range(T):
        coded = tt[t] != 0
        coder.code_stats(st[t], sz[t], tt[t], coded & (sz[t] != 0),
                         coded & (sz[t] == 0))
    return coder.result(G, B)


def encode_full_ref(m_ops, s_ops, cap_words: int):
    """m_ops / s_ops: uint32 [G, T/4, B] (four big-endian u8 ops a word).
    Returns (words uint32 [G, cap_words, B], lens int32 [G, 8, B])."""
    G, TW, B = m_ops.shape
    dev = m_ops.device
    N = G * B
    shifts = torch.tensor([24, 16, 8, 0], dtype=I64, device=dev)
    mops = ((_lanes(m_ops, TW)[:, None, :] >> shifts[None, :, None]) & 0xFF
            ).reshape(TW * 4, N)
    sops = ((_lanes(s_ops, TW)[:, None, :] >> shifts[None, :, None]) & 0xFF
            ).reshape(TW * 4, N)
    coder = _Coder(N, cap_words, dev)
    for t in range(TW * 4):
        coder.code(mops[t], sops[t])
    return coder.result(G, B)


TOK_DONE = M32   # a lane's token after its last pair
MOP_PAD = 255


def encode_tok_ref(toks, lits, t_max: int, cap_words: int):
    """toks: uint32 [G, B, Tt] (one token row per block, as
    ``native.sqz4_tok_plan`` emits them); lits: uint8 [G, B, L] (each
    block's literal bytes). Expands the tokens into coder op pairs with
    the kernels' (token, phase) machine, one pair a step for ``t_max``
    steps (csrc/sqz4_encode_tok.cu). Returns (words uint32
    [G, cap_words, B], lens int32 [G, 8, B])."""
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
    tok, phase, run, tidx, lidx = zero, zero, zero, zero, zero
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
        lbyte = lt[rows, lidx.clamp(max=L)]

        # expand (token, phase) -> the pair (m1, s1), (m2, s2)
        p0 = ismatch & (phase == 0)
        p1 = ismatch & (phase == 1)
        pk = ismatch & (phase >= 2)
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
        tok = torch.where(litlast | (adv & ~eos), zero, tok)
        tok = torch.where(isflush & (nxt >= 20), zero + TOK_DONE, tok)
        phase = nxt

        coder.code(m1, s1)
        coder.code(m2, s2)
    return coder.result(G, B)


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
        self.pos = torch.zeros(N, dtype=I64, device=dev)
        self.low = torch.zeros(N, dtype=I64, device=dev)
        self.rng = torch.full((N,), -1, dtype=I64, device=dev)
        self.code = self.take(torch.full((N,), 8, dtype=I64, device=dev))
        self.rd = torch.zeros_like(self.low)

    def take(self, k):
        """The next k (0..8) bytes of each lane, big-endian, right-aligned."""
        idx = (self.pos[:, None] + self.k8).clamp(max=self.end)
        b = torch.gather(self.buf, 1, idx) << (56 - 8 * self.k8)
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
        one = torch.ones_like(total)
        tot = torch.where(act, total, one)
        uf = act & _ult(self.rng, tot)
        two = self.take(2 * uf.to(I64))
        self.code = torch.where(uf, (self.code << 16) | two, self.code)
        self.low = torch.where(uf, self.low << 16, self.low)
        self.rng = torch.where(uf, ~self.low, self.rng)
        rd = _udiv_small(self.rng, tot)
        self.rd = rd
        diff = self.code - self.low
        bad = act & ~_ult(diff, tot * rd)
        est = torch.floor(_u64_to_f64(diff)
                          / _u64_to_f64(rd).clamp(min=1.0))
        c0 = torch.minimum(torch.maximum(est - 2, torch.zeros_like(est)),
                           (tot - 1).to(torch.float64)).to(I64)
        cum = c0
        for k in range(1, 5):
            take = ((c0 + k) < tot) & ~_ult(diff, c0 * rd + k * rd)
            cum = torch.where(take, c0 + k, cum)
        return cum, bad

    def back(self, start, size, act):
        """Narrow the interval on lanes ``act`` and renormalize."""
        zero = torch.zeros_like(start)
        self.low = torch.where(act, self.low + start * self.rd, self.low)
        self.rng = torch.where(act, size * self.rd, self.rng)
        cnt = torch.where(act, _lead_zero_bytes(self.low ^ (self.low
                                                            + self.rng)),
                          zero)
        nxt = self.take(cnt)
        full = cnt >= 8
        sh = (8 * cnt).clamp(max=63)
        self.code = torch.where(full, nxt, (self.code << sh) | nxt)
        self.low = torch.where(full, zero, self.low << sh)
        self.rng = torch.where(full, zero, self.rng << sh)


def decode_ref(payload, meta, t_max: int, lw: int, tw: int, mw: int):
    """payload: uint32 [G, Pw, B] (big-endian bytes); meta: int32 [G, 8, B]
    (row 1 sizes, row 2 dictionary length). Returns (lit uint32 [G, lw, B],
    tok uint32 [G, tw, B], mrec uint32 [G, mw, B], counts int32 [G, 8, B])
    with the kernel's step grammar: op 1 flag | bits | distance bit, op 2
    byte | size | distance bit | nothing."""
    G, _, B = payload.shape
    dev = payload.device
    N = G * B
    st = _Stream(payload)
    sizes = _lanes(meta[:, 1:2], 1)[0]
    dlen = _lanes(meta[:, 2:3], 1)[0]
    iota256 = torch.arange(256, dtype=I64, device=dev)[None, :]
    iota32 = torch.arange(32, dtype=I64, device=dev)[None, :]
    cb = (iota256 + 1).repeat(N, 1)
    cs = cb.clone()
    bits = (iota32 + 1).repeat(N, 1)
    d0 = torch.ones(N, 32, dtype=I64, device=dev)
    d1 = torch.ones_like(d0)
    zero = torch.zeros(N, dtype=I64, device=dev)
    lit0, lit1 = zero + 1, zero + 1
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
        start1 = torch.where(o1_bits, start32,
                             torch.where(symb == 1, bin0, zero))
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
        start2 = torch.where(is256, start256,
                             torch.where(symb == 1, f0, zero))
        size2 = torch.where(is256, tab[rows, sym256] - start256,
                            torch.where(symb == 1, f1, f0))
        st.back(start2, size2, act2)
        cb += (o2_byte[:, None] & (iota256 >= sym2[:, None])).to(I64)
        cs += (o2_size[:, None] & (iota256 >= sym2[:, None])).to(I64)
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
        nstate = torch.where(o2_byte, zero + ST_FLAG, state)
        nstate = torch.where(o2_size, torch.where(eos, zero + ST_DONE,
                                                  zero + ST_BITS), nstate)
        nstate = torch.where(o2_dist, torch.where(done2, zero + ST_FLAG,
                                                  zero + ST_DIST), nstate)
        nstate = torch.where(emit1, zero + ST_FLAG, nstate)
        newerr = torch.where(bad1 | bad2, zero + E_ILSEQ,
                 torch.where(bad_size, zero + E_SIZE,
                 torch.where(bad_bits, zero + E_BITS,
                 torch.where(bad_dist, zero + E_DIST,
                 torch.where(lit_over | over, zero + E_OVERRUN, zero)))))
        err = torch.where(act1 & (err == 0) & (newerr > 0), newerr, err)
        nstate = torch.where(newerr > 0, zero + ST_ERR, nstate)
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
