"""The training state of a GPT-2 shaped model under AdamW, made on the
card from a seed: a frozen copy of the state ``chip_smoke.py`` checkpoints
(``gpt2_small_state``), sized by the configuration and seeded by the run.

``params`` holds the model's tensors in GPT-2's naming (an OrderedDict,
as ``state_dict()`` gives it): weights N(0, ``init_std``), LayerNorm
weights 1 and biases 0. AdamW then takes ``steps`` steps on gradients
N(0, ``grad_std``), and ``exp_avg``, ``exp_avg_sq`` and ``step`` are its
state. The random values come from one ``torch.Generator`` on the card in
a few large draws (one for every weight, one a step for every
gradient), each cut into the tensors' views.
"""

from __future__ import annotations

from collections import OrderedDict

import torch


def shapes(model: dict):
    """GPT-2's tensors: (name, shape, initial value: None for a normal
    draw, else the constant)."""
    E, L = model["n_embd"], model["n_layer"]
    out = [("wte.weight", (model["vocab_size"], E), None),
           ("wpe.weight", (model["n_positions"], E), None)]
    for i in range(L):
        for name, shape in (("ln_1", None), ("attn.c_attn", (E, 3 * E)),
                            ("attn.c_proj", (E, E)), ("ln_2", None),
                            ("mlp.c_fc", (E, 4 * E)),
                            ("mlp.c_proj", (4 * E, E))):
            if shape is None:
                out.append((f"h.{i}.{name}.weight", (E,), 1.0))
                out.append((f"h.{i}.{name}.bias", (E,), 0.0))
            else:
                out.append((f"h.{i}.{name}.weight", shape, None))
                out.append((f"h.{i}.{name}.bias", (shape[-1],), 0.0))
    out += [("ln_f.weight", (E,), 1.0), ("ln_f.bias", (E,), 0.0)]
    return out


def _split(flat, spec):
    views, at = [], 0
    for _, shape, _ in spec:
        n = 1
        for s in shape:
            n *= s
        views.append(flat[at:at + n].view(shape))
        at += n
    return views


def make(cfg: dict, seed: int, device) -> dict:
    """The state of ``cfg``'s ``model`` after ``adamw["steps"]`` steps,
    made on ``device`` from ``seed``."""
    spec = shapes(cfg["model"])
    opt_cfg = cfg["adamw"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed % (1 << 64))
    total = sum(torch.Size(s).numel() for _, s, _ in spec)
    flat = torch.randn(total, generator=g, device=dev)
    flat *= cfg["init_std"]
    for view, (_, _, const) in zip(_split(flat, spec), spec):
        if const is not None:
            view.fill_(const)
    params = OrderedDict(
        (name, torch.nn.Parameter(v))
        for (name, _, _), v in zip(spec, _split(flat, spec)))
    opt = torch.optim.AdamW(params.values(), lr=opt_cfg["lr"],
                            betas=tuple(opt_cfg["betas"]),
                            weight_decay=opt_cfg["weight_decay"])
    for _ in range(opt_cfg["steps"]):
        grads = torch.randn(total, generator=g, device=dev)
        grads *= cfg["grad_std"]
        for p, gv in zip(params.values(), _split(grads, spec)):
            p.grad = gv
        opt.step()
    for p in params.values():
        p.grad = None
    moments = [opt.state[p] for p in params.values()]
    return {"params": OrderedDict((k, p.detach())
                                  for k, p in params.items()),
            "exp_avg": OrderedDict((k, m["exp_avg"])
                                   for k, m in zip(params, moments)),
            "exp_avg_sq": OrderedDict((k, m["exp_avg_sq"])
                                      for k, m in zip(params, moments)),
            "step": torch.tensor(opt_cfg["steps"], dtype=torch.int64,
                                 device=dev)}

