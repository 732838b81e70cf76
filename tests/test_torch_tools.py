"""The port's check tools (``sqz_tpu_torch/tools``) on the CPU, at tiny
sizes (the plain versions): each passes on the port and fails, with exit
code 1, on a fault planted in what it checks; the decoder's mutants are
the reference tool's kinds, each held to its contract."""

import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sqz_tpu_torch import native
from sqz_tpu_torch.ops import sqz4_cuda
from sqz_tpu_torch.tools import check_dec, check_enc, check_lz
from sqz_tpu_torch.tools import check_resident
from sqz_tpu_torch.utils import corpus

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def test_check_dec_passes_and_counts_its_mutants():
    rep = {}
    assert check_dec.main(["--bytes", "4096", "--blk-bits", "10",
                           "--mutants", "8", *CPU], rep) == 0
    assert rep["dec_blocks"] == 4 and rep["mutants"] == 8
    assert rep["mutants_rejected"] + rep["mutants_produced"] == 8


def test_check_dec_fails_on_a_wrong_decode(monkeypatch, capsys):
    real = sqz4_cuda.decode_groups

    def wrong(payloads, sizes, blk_bits, **kw):
        out = real(payloads, sizes, blk_bits, **kw)
        return [b"\0" + o[1:] for o in out]
    monkeypatch.setattr(sqz4_cuda, "decode_groups", wrong)
    assert check_dec.main(["--bytes", "2048", "--blk-bits", "10",
                           "--mutants", "0", *CPU]) == 1
    assert "FAILED" in capsys.readouterr().out


def test_mutants_hold_the_contract_and_fail_a_lax_decoder(monkeypatch):
    data = corpus.texty(2048, seed=1)
    parts = [data[:1024], data[1024:]]
    payloads = [native.sqz4_compress_payload(p, 1 << 15) for p in parts]
    assert check_dec.check_mutants(payloads, parts, 10, 6,
                                   torch.device("cpu")) == (6, 0)
    # a decoder that produces a short block whatever it is given breaks
    # the contract at the first mutant, whether the native decoder
    # produces (other bytes) or rejects (then only the block's length
    # may come out)

    def lax(pls, sizes, blk_bits, **kw):
        return [b"\0" * (sizes[0] - 1)]
    monkeypatch.setattr(sqz4_cuda, "decode_groups", lax)
    with pytest.raises(check_dec.CheckFailed, match="mutant 0"):
        check_dec.check_mutants(payloads, parts, 10, 6, torch.device("cpu"))


def test_mutant_kinds_are_the_references():
    rng = random.Random(7)
    p = bytes(range(40))
    flip = check_dec.mutate(p, 0, rng)
    assert len(flip) == 40 and bin(int.from_bytes(flip, "big")
                                   ^ int.from_bytes(p, "big")).count("1") == 1
    sub = check_dec.mutate(p, 1, rng)
    assert len(sub) == 40 and sum(a != b for a, b in zip(sub, p)) <= 1
    cut = check_dec.mutate(p, 2, rng)
    assert 1 <= len(cut) < 39 and p.startswith(cut)
    zero = check_dec.mutate(p, 3, rng)
    changed = [k for k in range(40) if zero[k] != p[k]]
    assert len(zero) == 40 and changed
    assert max(changed) - min(changed) < 8
    assert all(zero[k] == 0 for k in changed)


def test_check_enc_passes_and_fails_on_a_wrong_payload(monkeypatch):
    args = ["--bytes", "1500", "--blk-bits", "9", *CPU]
    rep = {}
    assert check_enc.main(args, rep) == 0 and rep["enc_blocks"] == 3
    real = sqz4_cuda.encode_groups
    monkeypatch.setattr(sqz4_cuda, "encode_groups",
                        lambda *a, **k: [p[:-1] for p in real(*a, **k)])
    assert check_enc.main(args) == 1


def test_check_resident_passes():
    rep = {}
    assert check_resident.main(["--bytes", "2048", "--blk-bits", "9",
                                *CPU], rep) == 0
    assert 0 < rep["resident_rle_ratio"] <= rep["resident_lit_ratio"]


def test_check_resident_fails_on_a_lost_restore(monkeypatch):
    from sqz_tpu_torch.ops import resident
    real = resident.decompress_resident
    monkeypatch.setattr(resident, "decompress_resident",
                        lambda *a, **k: real(*a, **k)[1:])
    assert check_resident.main(["--bytes", "1024", "--blk-bits", "9",
                                *CPU]) == 1


def test_check_lz_passes_and_holds_its_bar(monkeypatch):
    args = ["--bytes", "3072", "--blk-bits", "10", *CPU]
    rep = {}
    assert check_lz.main(args, rep) == 0
    assert rep["lz_gap_pp"] <= check_lz.MAX_GAP_PP == 1.6
    monkeypatch.setattr(check_lz, "MAX_GAP_PP", rep["lz_gap_pp"] - 0.01)
    assert check_lz.main(args) == 1


@pytest.mark.parametrize("tool", ["check_dec", "check_enc",
                                  "check_resident", "check_lz"])
def test_tools_run_as_modules_and_default_to_the_card(tool):
    res = subprocess.run([sys.executable, "-m", f"sqz_tpu_torch.tools.{tool}",
                          "--help"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and "--device" in res.stdout
    if not torch.cuda.is_available():
        res = subprocess.run([sys.executable, "-m",
                              f"sqz_tpu_torch.tools.{tool}", "--bytes",
                              "1024"], cwd=ROOT, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
