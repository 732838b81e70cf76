"""Outputs broken on purpose, for the entries' controls and the faults
the check has to catch: ``unchanged`` (the output as it was before the
call: zeros), ``half`` (the second half of the output left out: zeros)
and ``altered`` (one byte flipped in the middle)."""

from __future__ import annotations

import torch

from portbench.reference import checkpoint as ref_ckpt

FAULTS = ("unchanged", "half", "altered")


def map_leaves(tree, fn):
    if isinstance(tree, dict):
        return type(tree)((k, map_leaves(v, fn)) for k, v in tree.items())
    return fn(tree)


def bf16_rounded(tree):
    """Every floating leaf rounded to bfloat16 and back."""
    return map_leaves(tree, lambda x: x.to(torch.bfloat16).to(x.dtype)
                      if x.is_floating_point() else x)


def break_bytes(b: bytes, fault: str) -> bytes:
    n = len(b)
    if fault == "unchanged":
        return bytes(n)
    if fault == "half":
        return b[:n // 2] + bytes(n - n // 2)
    out = bytearray(b)
    out[n // 2] ^= 0x5A
    return bytes(out)


def break_tree(tree, fault: str):
    leaves: list = []
    ref_ckpt.flatten(tree, leaves)
    broken = {}
    for i, x in enumerate(leaves):
        if fault == "unchanged" or (fault == "half" and i >= len(leaves) // 2):
            broken[id(x)] = torch.zeros_like(x)
    if fault == "altered":
        x = leaves[len(leaves) // 2].clone()
        x.reshape(-1).view(torch.uint8)[0] ^= 0x5A
        broken[id(leaves[len(leaves) // 2])] = x
    return map_leaves(tree, lambda x: broken.get(id(x), x))
