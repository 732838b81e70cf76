"""Small configurations of the benchmark's cells, for runs on the CPU
through the plain versions of the program (a Python step per coder
operation: a few KiB at most)."""

import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def tiny_config(config: str) -> dict:
    with open(ROOT / "portbench" / "configs" / f"{config}.json") as f:
        cfg = json.load(f)
    if cfg["input"] == "train_state":
        cfg["model"] = dict(n_layer=1, n_embd=8, n_head=1, n_positions=4,
                            vocab_size=8)
        cfg["codec"]["blk_bits"] = 9
    else:
        cfg["bytes"] = 3000
        cfg["codec"].update(blk_bits=10, win_bits=10)
    return cfg


@pytest.fixture
def tiny():
    return tiny_config
