#!/usr/bin/env python3
"""Estimate the checkpoint's ratio on the host, with no card: the
filtered stream of a GPT-2-shaped AdamW training state (the widths of
GPT-2 small, ``--layers`` of its 12 layers and a ``--vocab``-row token
embedding, so that it fits a host's memory and minutes) coded per 64 KiB
block by the native copy, literal-only and with the fast LZ parse.

The resident encode's rle mode adds cell matches to the literal-only
coding, so the two figures bracket what ``save_pytree`` writes for such
a state. Run from the root of a checkout:

    python3 scripts/ckpt_ratio_estimate.py [--layers 1] [--vocab 8192]

It prints, for ``params``, ``exp_avg`` and ``exp_avg_sq``, the stream
bytes and the two ratios (a ratio only: no time is measured).
"""

import argparse
import os
import sys
from collections import OrderedDict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from sqz_tpu_torch import native  # noqa: E402
from sqz_tpu_torch.utils import checkpoint  # noqa: E402

N_EMBD, N_POSITIONS = 768, 1024   # GPT-2 small


def gpt2_state(layers: int, vocab: int, seed: int = 1):
    """GPT-2's parameters at initialisation (N(0, 0.02) weights,
    LayerNorm weights 1, biases 0) and AdamW's moments after 3 steps
    (lr 6e-4, betas 0.9 / 0.95, weight decay 0.1) on N(0, 1e-2)
    gradients."""
    g = torch.Generator().manual_seed(seed)
    E = N_EMBD

    def normal(*shape):
        return torch.randn(shape, generator=g) * 0.02

    init = OrderedDict([("wte.weight", normal(vocab, E)),
                        ("wpe.weight", normal(N_POSITIONS, E))])
    for i in range(layers):
        for name, shape in (("ln_1", None), ("attn.c_attn", (E, 3 * E)),
                            ("attn.c_proj", (E, E)), ("ln_2", None),
                            ("mlp.c_fc", (E, 4 * E)),
                            ("mlp.c_proj", (4 * E, E))):
            w = torch.ones(E) if shape is None else normal(*shape)
            init[f"h.{i}.{name}.weight"] = w
            init[f"h.{i}.{name}.bias"] = torch.zeros(w.shape[-1])
    init["ln_f.weight"], init["ln_f.bias"] = torch.ones(E), torch.zeros(E)
    params = OrderedDict((k, torch.nn.Parameter(v)) for k, v in init.items())
    opt = torch.optim.AdamW(params.values(), lr=6e-4, betas=(0.9, 0.95),
                            weight_decay=0.1)
    for _ in range(3):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=g) * 1e-2
        opt.step()
    moments = [opt.state[p] for p in params.values()]
    return {"params": OrderedDict((k, p.detach())
                                  for k, p in params.items()),
            "exp_avg": OrderedDict((k, m["exp_avg"])
                                   for k, m in zip(params, moments)),
            "exp_avg_sq": OrderedDict((k, m["exp_avg_sq"])
                                      for k, m in zip(params, moments))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=8192)
    args = ap.parse_args()
    state = gpt2_state(args.layers, args.vocab)
    for name, tree in state.items():
        stream = checkpoint.filtered_stream(tree, device="cpu")[0]
        data = stream.numpy().tobytes()
        lit = native.blocks_compress(data, 1, 15, 16, lz=False)
        lz = native.blocks_compress(data, 1, 15, 16, parse="fast")
        print(f"{name}: {len(data)} B, literal-only "
              f"{sum(map(len, lit)) / len(data):.4f}, fast LZ "
              f"{sum(map(len, lz)) / len(data):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
