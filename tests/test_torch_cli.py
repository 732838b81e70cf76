"""The port's command line (``python -m sqz_tpu_torch``) against the JAX
package's (``python -m sqz_tpu``): every subcommand on ``--device cpu``,
the same containers, ranges, checkpoints and telemetry."""

import numpy as np
import pytest
import torch

import sqz_tpu
from sqz_tpu.__main__ import main as ref_main
from sqz_tpu.utils import corpus
from sqz_tpu_torch.__main__ import main
from sqz_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
CPU = ["--device", "cpu"]
SMALL = ["--blk-bits", "10", "--win-bits", "10"]


def _write(tmp_path, name, data: bytes):
    p = tmp_path / name
    p.write_bytes(data)
    return str(p)


def test_cli_resident_compress_roundtrip(tmp_path):
    """The reference's case (tests/test_resident.py): a resident rle
    container round-trips through compress / decompress, and equals the
    reference's."""
    data = bytes(400) + corpus.texty(500, seed=21)
    src = _write(tmp_path, "in.bin", data)
    dst, back = str(tmp_path / "out.sqzt"), tmp_path / "back.bin"
    assert main(["compress", src, dst, "--resident", "rle", "--blk-bits",
                 "10", *CPU]) == 0
    assert main(["decompress", dst, str(back), *CPU]) == 0
    assert back.read_bytes() == data
    blob = open(dst, "rb").read()
    assert blob == sqz_tpu.compress_resident(data, blk_bits=10, mode="rle",
                                             checksum=True, interpret=True)
    assert sqz_tpu.decompress(blob, engine="native") == data


def test_torch_engine_exact_container_equals_native(tmp_path, monkeypatch,
                                                    capsys):
    data = corpus.texty(3000, seed=5)
    src = _write(tmp_path, "in.bin", data)
    monkeypatch.setenv("SQZ_PARSE", "exact")
    out = {}
    for engine in ("torch", "native", "oracle"):
        out[engine] = str(tmp_path / f"{engine}.sqzt")
        assert main(["compress", src, out[engine], "--engine", engine,
                     "--blocks", *SMALL, *CPU]) == 0
    blobs = {k: open(v, "rb").read() for k, v in out.items()}
    assert blobs["torch"] == blobs["native"] == blobs["oracle"]
    ref = str(tmp_path / "ref.sqzt")
    assert ref_main(["compress", src, ref, "--format", "sqz4", "--engine",
                     "native", "--blocks", *SMALL]) == 0
    assert open(ref, "rb").read() == blobs["native"]
    back = tmp_path / "back.bin"
    assert main(["decompress", out["native"], str(back), *CPU]) == 0
    assert back.read_bytes() == data
    assert "->" in capsys.readouterr().out


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_raw_streams_on_the_host_engines(tmp_path, fmt):
    data = corpus.texty(2000, seed=6) + corpus.rle4(500)
    src = _write(tmp_path, "in.bin", data)
    for engine in ("native", "oracle"):
        dst = str(tmp_path / f"{engine}.raw")
        assert main(["compress", src, dst, "--format", fmt, "--engine",
                     engine, "--win-bits", "10"]) == 0
        ref = str(tmp_path / f"{engine}.ref")
        assert ref_main(["compress", src, ref, "--format", fmt, "--engine",
                         engine, "--win-bits", "10"]) == 0
        assert open(dst, "rb").read() == open(ref, "rb").read()
        back = tmp_path / "back.bin"
        assert main(["decompress", ref, str(back), "--engine", engine]) == 0
        assert back.read_bytes() == data


@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_roundtrip_stats_equal_the_reference(tmp_path, capsys, fmt):
    """roundtrip --stats prints the reference's telemetry line for line
    (the timing line aside)."""
    src = _write(tmp_path, "in.bin", corpus.texty(4000, seed=7))
    args = ["roundtrip", src, "--stats", "--format", fmt, "--engine",
            "native", "--win-bits", "10"]
    assert main(args) == 0
    got = capsys.readouterr().out.splitlines()
    assert ref_main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert [x for x in got if not x.startswith("bps:")] == \
        [x for x in want if not x.startswith("bps:")]
    assert len(got) > 5 and got[0].startswith("bps:")
    if fmt == "sqz4":
        assert got[-1].startswith("rejections:")


def test_roundtrip_on_the_torch_engine_and_missing_files(tmp_path, capsys):
    src = _write(tmp_path, "in.bin", corpus.texty(2500, seed=8))
    assert main(["roundtrip", src, str(tmp_path / "nope.bin"), *SMALL,
                 *CPU]) == 0
    out = capsys.readouterr().out
    assert "VERIFY FAILED" not in out and "skip (missing)" in out


def test_range_equals_slicing(tmp_path, capsys):
    data = corpus.texty(5000, seed=9)
    blob = sqz_tpu.compress(data, fmt="sqz4", engine="native", blocks=True,
                            blk_bits=10, win_bits=10, warm=True)
    src = _write(tmp_path, "in.sqzt", blob)
    for engine in ("native", "oracle"):
        for start, length in ((0, 5000), (1020, 10), (3000, 1500)):
            out = tmp_path / "span.bin"
            assert main(["range", src, f"{start}:{length}", "--engine",
                         engine, "--out", str(out)]) == 0
            assert out.read_bytes() == data[start:start + length]
    capsys.readouterr()
    assert main(["range", src, "7:9"]) == 0
    assert capsys.readouterr().out == data[7:16].decode()


def test_ckpt_save_and_load_equal_the_reference(tmp_path, monkeypatch,
                                                capsys):
    rng = np.random.default_rng(4)
    arrays = {"w": (rng.normal(size=(24, 8)) * 0.02).astype(np.float32),
              "ids": np.arange(60, dtype=np.int32),
              "b": np.zeros(40, np.float32)}
    src = str(tmp_path / "state.npz")
    np.savez(src, **arrays)
    dst, ref = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    assert main(["ckpt-save", src, dst, "--blk-bits", "9", *CPU]) == 0
    assert "%" in capsys.readouterr().out
    monkeypatch.setenv("SQZ_RESIDENT_INTERPRET", "1")
    assert ref_main(["ckpt-save", src, ref, "--blk-bits", "9"]) == 0
    pmeta, pblob = ckpt.read_checkpoint(dst)
    raw = open(ref, "rb").read()
    assert raw.endswith(pblob)
    back = str(tmp_path / "back")
    assert main(["ckpt-load", dst, back, *CPU]) == 0
    loaded = np.load(back + ".npz")
    assert sorted(loaded.files) == sorted(arrays)
    for k, v in arrays.items():
        assert loaded[k].dtype == v.dtype
        assert np.array_equal(loaded[k], v)
    one = str(tmp_path / "one.npy")
    np.save(one, arrays["ids"])
    assert main(["ckpt-save", one, dst, "--mode", "lit", "--no-shuffle",
                 "--no-delta", *CPU]) == 0
    assert main(["ckpt-load", dst, back + ".npz", *CPU]) == 0
    assert np.array_equal(np.load(back + ".npz")["arr_0"], arrays["ids"])


def test_ckpt_load_refuses_bfloat16_and_non_dict_trees(tmp_path, capsys):
    p = str(tmp_path / "bf.ckpt")
    ckpt.save_pytree({"ok": torch.arange(4, dtype=torch.int32),
                      "half": torch.ones(8, dtype=torch.bfloat16)}, p,
                     blk_bits=8, device="cpu")
    with pytest.raises(ValueError, match="'half'"):
        main(["ckpt-load", p, str(tmp_path / "out.npz"), *CPU])
    ckpt.save_pytree([torch.arange(3)], p, blk_bits=8, device="cpu")
    assert main(["ckpt-load", p, str(tmp_path / "out.npz"), *CPU]) == 1
    assert "dict-of-arrays" in capsys.readouterr().err


def test_cuda_default_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    src = _write(tmp_path, "in.bin", b"abc" * 100)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["compress", src, str(tmp_path / "o.sqzt")])
    npz = str(tmp_path / "a.npz")
    np.savez(npz, a=np.arange(5))
    with pytest.raises(RuntimeError, match="cuda"):
        main(["ckpt-save", npz, str(tmp_path / "a.ckpt")])
