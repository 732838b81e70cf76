"""The plain reference: it round-trips the program's tiny containers of
both configurations' kinds, works the checksum and the checkpoint's
filtered stream out as the program does, and imports nothing of the
program or of JAX."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.inputs import train_state
from portbench.inputs.texty import texty
from portbench.reference import checkpoint as ref_ckpt
from portbench.reference import sqz4 as ref_sqz4
from portbench.reference import sqzt as ref_sqzt

ROOT = Path(__file__).resolve().parents[2]


def _decode_all(blob, expect):
    fields, payloads, bad = ref_sqzt.read(blob, expect)
    sizes = ref_sqzt.block_sizes(fields["size"], fields["blk_bits"],
                                 fields["blocks"])
    return bad, b"".join(ref_sqz4.decode_block(p, n)
                         for p, n in zip(payloads, sizes))


@pytest.mark.parametrize("n", [0, 1, 1000, 5000])
def test_text_containers_round_trip(n):
    import sqz_tpu_torch
    data = texty(n, seed=n + 3)
    blob = sqz_tpu_torch.compress(data, blk_bits=10, win_bits=10,
                                  device="cpu")
    bad, back = _decode_all(blob, dict(
        fmt=1, win_bits=10, blk_bits=10, flags=1, size=n,
        checksum=ref_sqzt.fnv1a64_plain(data)))
    assert bad == 0 and back == data


def test_checkpoint_file_round_trips(tmp_path):
    from sqz_tpu_torch.utils import checkpoint
    cfg = dict(model=dict(n_layer=1, n_embd=8, n_head=1, n_positions=4,
                          vocab_size=8), init_std=0.02, grad_std=0.01,
               adamw=dict(lr=6e-4, betas=[0.9, 0.95], weight_decay=0.1,
                          steps=3))
    state = train_state.make(cfg, 5, "cpu")
    path = tmp_path / "s.ckpt"
    checkpoint.save_pytree(state, path, blk_bits=9, device="cpu")
    meta, blob = ref_ckpt.read(path.read_bytes())
    structure, metas, stream = ref_ckpt.expected(state)
    assert ref_ckpt.meta_fields_bad(meta, structure, metas, 9) == 0
    prog_stream, prog_metas, _ = checkpoint.filtered_stream(state,
                                                             device="cpu")
    assert torch.equal(prog_stream, stream)
    bad, back = _decode_all(blob, dict(fmt=1, win_bits=15, blk_bits=9,
                                       flags=0, size=stream.numel()))
    assert bad == 0 and back == stream.numpy().tobytes()


def test_broken_containers_are_caught():
    import sqz_tpu_torch
    data = texty(3000, seed=1)
    blob = bytearray(sqz_tpu_torch.compress(data, blk_bits=10, win_bits=10,
                                            device="cpu"))
    expect = dict(fmt=1, win_bits=10, blk_bits=10, flags=1, size=3000,
                  checksum=ref_sqzt.fnv1a64_plain(data))
    _, payloads, bad = ref_sqzt.read(bytes(blob), expect)
    assert bad == 0
    blob[-5] ^= 0x40                      # a payload byte
    _, payloads, _ = ref_sqzt.read(bytes(blob), expect)
    with pytest.raises(ref_sqz4.DecodeError):
        got = ref_sqz4.decode_block(payloads[-1], 3000 - 2048)
        assert got == data[2048:]
        raise ref_sqz4.DecodeError("decoded, but to other bytes")
    blob[20] ^= 1                         # the original size
    assert ref_sqzt.read(bytes(blob), expect)[2] > 0


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4097, 2 * 2 * 16 * 3 + 7, 20001])
def test_fnv1a64_equals_its_definition(n):
    data = os.urandom(n)
    assert ref_sqzt.fnv1a64(data, device="cpu", chunk=16) == \
        ref_sqzt.fnv1a64_plain(data)


def test_fnv1a64_equals_the_programs():
    from sqz_tpu_torch.formats import container
    data = texty(70001, seed=9)
    assert ref_sqzt.fnv1a64(data, device="cpu", chunk=64) == \
        container.fnv1a64(data)


def test_trees_differ_counts():
    a = {"w": torch.arange(6, dtype=torch.float32), "s": torch.tensor(3)}
    b = {"w": a["w"].clone(), "s": a["s"].clone()}
    assert ref_ckpt.trees_differ(b, a) == (0, 0)
    b["w"][2] = -1.0
    assert ref_ckpt.trees_differ(b, a) == (0, 2)   # 2.0 -> -1.0: 2 bytes
    b["s"] = b["s"].to(torch.int32)
    assert ref_ckpt.trees_differ(b, a)[0] == 1
    assert ref_ckpt.trees_differ({"w": a["w"]}, a)[0] >= 1


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.sqz4, "
            "portbench.reference.sqzt, portbench.reference.checkpoint; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = set(out.split())
    assert not tops & {"jax", "jaxlib", "flax", "sqz_tpu", "sqz_tpu_torch"}


def test_texty_matches_the_programs_generator():
    from sqz_tpu_torch.utils import corpus
    for n, seed in ((0, 1), (7, 2), (4097, 3), (50001, 2 ** 33 + 5)):
        assert texty(n, seed) == corpus.texty(n, seed)
        assert texty(n, seed, chunk=5) == corpus.texty(n, seed)


def test_gpt2_small_sizes():
    spec = train_state.shapes(dict(n_layer=12, n_embd=768, n_head=12,
                                   n_positions=1024, vocab_size=50257))
    params = sum(int(np.prod(s)) for _, s, _ in spec)
    assert len(spec) == 148 and params == 124_439_808
    # params, exp_avg and exp_avg_sq in float32, and the int64 step
    assert 3 * 4 * params + 8 == 1_493_277_704


def test_train_state_is_made_from_the_seed():
    cfg = dict(model=dict(n_layer=2, n_embd=8, n_head=1, n_positions=4,
                          vocab_size=8), init_std=0.02, grad_std=0.01,
               adamw=dict(lr=6e-4, betas=[0.9, 0.95], weight_decay=0.1,
                          steps=3))
    a, b, c = (train_state.make(cfg, s, "cpu") for s in (2 ** 33, 2 ** 33, 4))
    assert ref_ckpt.trees_differ(a, b) == (0, 0)
    assert ref_ckpt.trees_differ(a, c)[1] > 0
    leaves = []
    ref_ckpt.flatten(a, leaves)
    assert len(leaves) == 3 * len(train_state.shapes(cfg["model"])) + 1
    assert int(a["step"]) == 3
    ln = a["params"]["h.0.ln_1.weight"]
    assert ln.shape == (8,) and not torch.equal(ln, torch.ones(8))
