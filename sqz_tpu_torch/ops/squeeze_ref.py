"""Plain PyTorch version of the squeeze bit-packer.

Same inputs and outputs as the CUDA kernel (``csrc/squeeze_bitpack.cu``)
and the reference's Pallas launcher (``sqz4_pallas._bitpack_pallas``):
write records uint32 ``[G, T, B]`` -> payload words uint32
``[G, cap_words, B]`` and lengths int32 ``[G, 8, B]``. Every lane steps
through its records in lock-step, one record row per iteration, with the
kernel's 32-bit arithmetic (a u32 is an int64 tensor holding it). It runs
on any device; ``squeeze_cuda.bitpack`` uses it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch

from sqz_tpu_torch.ops.sqz4_ref import I64, M32, _from_lanes, _lanes, to_u32

VALUE_MASK = 0x1FFFFFF   # the low 25 bits of a record: its bit-reversed value


def bitpack_ref(ops, cap_words: int):
    """ops: uint32 [G, T, B] write records (bit count ``w >> 25``, 0 a pad;
    the value in the low 25 bits, appended MSB-first at the lane's running
    bit offset). Returns (words uint32 [G, cap_words, B], big-endian
    payload bytes, zero past each payload; lens int32 [G, 8, B], row 0 the
    payload byte length ceil(bits / 64) * 8)."""
    G, T, B = ops.shape
    dev = ops.device
    n = G * B
    recs = _lanes(ops, T)                                   # [T, N]
    zero = torch.zeros(n, dtype=I64, device=dev)
    ah, al, bitcnt, wpos = zero, zero, zero, zero
    out = torch.zeros(n, cap_words + 1, dtype=I64, device=dev)  # + trash
    rows = torch.arange(n, device=dev)
    trash = zero + cap_words

    def store(pos, val, on):
        col = torch.where(on & (pos < cap_words), pos, trash)
        out[rows, col] = torch.where(on, val, out[rows, col])

    for t in range(T):
        w = recs[t]
        nb = w >> 25
        val = w & VALUE_MASK
        # the 64-bit left shift of val by 64 - bitcnt - nb (a u32, so it
        # wraps as the reference's does), on the accumulator's two halves
        s = (64 - bitcnt - nb) & M32
        s1 = s & 31
        big = s >= 32
        live = nb > 0
        sh_h = torch.where(big, (val << s1) & M32, (val >> 1) >> (31 - s1))
        sh_l = torch.where(big, zero, (val << s1) & M32)
        ah = torch.where(live, ah | sh_h, ah)
        al = torch.where(live, al | sh_l, al)
        bitcnt = (bitcnt + nb) & M32
        # spill one 32-bit word when the high half is full
        spill = bitcnt >= 32
        store(wpos, ah, spill)
        wpos = wpos + spill.to(I64)
        ah = torch.where(spill, al, ah)
        al = torch.where(spill, zero, al)
        bitcnt = bitcnt - 32 * spill.to(I64)
    # the reference's flush pads the final 64-bit word with zeros: both
    # accumulator halves are written, the high one zero if it holds no bit
    every = torch.ones(n, dtype=torch.bool, device=dev)
    store(wpos, torch.where(bitcnt > 0, ah, zero), every)
    store(wpos + 1, al, every)
    bits = ((wpos << 5) + bitcnt) & M32
    lens = torch.zeros(n, 8, dtype=I64, device=dev)
    lens[:, 0] = ((((bits + 63) & M32) >> 6) << 3) & M32
    return (to_u32(_from_lanes(out[:, :cap_words], G, B)),
            to_u32(_from_lanes(lens, G, B)).view(torch.int32))
