"""The port's host engines (``native``, the C++ copy; ``oracle``, the
pure-Python copy) and ``decompress_range`` against the JAX package's own:
the same containers byte for byte in both formats, raw and sqzt (cold,
warm v2, anchored v3), each side decoding the other's, and the same
bytes from every range."""

import pytest

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu.utils import corpus

ENGINES = ["native", "oracle"]


def _data(n: int = 5000) -> bytes:
    # text, runs, zeros and random bytes, so blocks differ in kind
    return (corpus.texty(n // 2, seed=4) + corpus.rle4(n // 5)
            + corpus.zeros(n // 10) + corpus.random_bytes(n // 5, seed=2)
            )[:n]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
@pytest.mark.parametrize("blocks,warm", [(False, False), (True, False),
                                         (True, True), (True, "anchors")],
                         ids=["raw", "cold", "v2", "v3"])
def test_containers_equal_the_reference(engine, fmt, blocks, warm):
    data = _data()
    kw = dict(fmt=fmt, engine=engine, win_bits=10, blocks=blocks,
              blk_bits=10, warm=warm)
    got = sqz_tpu_torch.compress(data, **kw)
    assert got == sqz_tpu.compress(data, **kw)
    assert sqz_tpu_torch.decompress(got, engine=engine) == data
    assert sqz_tpu.decompress(got, engine=engine) == data


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
def test_containers_of_the_reference_decode(engine, fmt):
    """Containers the reference's other engine wrote (native <-> oracle)
    decode on the port's engine, the literal-only raw sqz4 stream too."""
    data = _data(3000)
    other = "oracle" if engine == "native" else "native"
    for kw in (dict(blocks=False), dict(blocks=True, blk_bits=9),
               dict(blocks=True, blk_bits=9, warm=True),
               dict(blocks=True, blk_bits=9, warm="anchors")):
        blob = sqz_tpu.compress(data, fmt=fmt, engine=other, win_bits=10,
                                **kw)
        assert sqz_tpu_torch.decompress(blob, engine=engine) == data, kw
    if fmt == "sqz4":
        blob = sqz_tpu.compress(data, fmt=fmt, engine=other, lz=False)
        assert sqz_tpu_torch.decompress(blob, engine=engine) == data
        assert sqz_tpu_torch.compress(data, fmt=fmt, engine=engine,
                                      lz=False, blocks=False) == blob


@pytest.mark.parametrize("n", [0, 1, 1024, 6 * 1024])
def test_sizes_and_block_edges_equal_the_reference(n):
    data = _data(n)
    for fmt in ("sqz4", "squeeze"):
        for blocks in (False, True):
            kw = dict(fmt=fmt, engine="native", win_bits=10, blocks=blocks,
                      blk_bits=10)
            got = sqz_tpu_torch.compress(data, **kw)
            assert got == sqz_tpu.compress(data, **kw), (fmt, blocks)
            assert sqz_tpu_torch.decompress(got, engine="native") == data


def test_native_parse_policy_follows_the_reference(monkeypatch):
    """'auto' is the exact parse on the host engines (the torch engine's
    is fast); an explicit 'fast' and SQZ_PARSE are honoured; the oracle
    and sqz4 without LZ parse exactly whatever is asked."""
    data = corpus.texty(40000, seed=9)
    kw = dict(fmt="sqz4", blocks=True, blk_bits=13, win_bits=15)
    exact = sqz_tpu.compress(data, engine="native", parse="exact", **kw)
    fast = sqz_tpu.compress(data, engine="native", parse="fast", **kw)
    assert exact != fast
    assert sqz_tpu_torch.compress(data, engine="native", **kw) == exact
    assert sqz_tpu_torch.compress(data, engine="native", parse="fast",
                                  **kw) == fast
    monkeypatch.setenv("SQZ_PARSE", "fast")
    assert sqz_tpu_torch.compress(data, engine="native", **kw) == fast
    monkeypatch.setenv("SQZ_PARSE", "exact")
    assert sqz_tpu_torch.compress(data, engine="native", parse="fast",
                                  **kw) == exact
    monkeypatch.delenv("SQZ_PARSE")
    nolz = dict(kw, lz=False)
    assert (sqz_tpu_torch.compress(data, engine="native", parse="fast",
                                   **nolz)
            == sqz_tpu.compress(data, engine="native", parse="exact",
                                **nolz))
    small = data[:3000]
    skw = dict(fmt="squeeze", blocks=True, blk_bits=10, win_bits=10)
    assert (sqz_tpu_torch.compress(small, engine="oracle", parse="fast",
                                   **skw)
            == sqz_tpu.compress(small, engine="native", parse="exact",
                                **skw))


def _spans(n: int, bs: int):
    return [(0, n), (0, 1), (n - 1, 1), (bs - 1, 2), (bs, bs),
            (bs + 5, 100), (2 * bs - 3, bs + 6), (3 * bs, 0),
            (n - bs - 7, bs + 7)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fmt", ["sqz4", "squeeze"])
@pytest.mark.parametrize("warm", [False, True, "anchors"],
                         ids=["cold", "v2", "v3"])
def test_decompress_range_equals_the_reference(engine, fmt, warm):
    data = _data(6000)
    blob = sqz_tpu.compress(data, fmt=fmt, engine="native", win_bits=10,
                            blocks=True, blk_bits=10, warm=warm)
    for start, length in _spans(len(data), 1024):
        got = sqz_tpu_torch.decompress_range(blob, start, length,
                                             engine=engine)
        assert got == data[start:start + length], (start, length)
        assert got == sqz_tpu.decompress_range(blob, start, length,
                                               engine=engine)


def test_decompress_range_rejects_what_the_reference_rejects():
    data = _data(3000)
    blob = sqz_tpu_torch.compress(data, engine="native", blk_bits=10)
    with pytest.raises(ValueError, match="host feature"):
        sqz_tpu_torch.decompress_range(blob, 0, 10, engine="torch")
    with pytest.raises(ValueError, match="outside"):
        sqz_tpu_torch.decompress_range(blob, 2990, 20)
    with pytest.raises(ValueError, match="outside"):
        sqz_tpu_torch.decompress_range(blob, -1, 2)
    raw = sqz_tpu_torch.compress(data, engine="native", blocks=False)
    with pytest.raises(ValueError, match="sqzt"):
        sqz_tpu_torch.decompress_range(raw, 0, 10)


def test_host_engines_reject_bad_requests():
    data = _data(2000)
    with pytest.raises(ValueError, match="warm start requires"):
        sqz_tpu_torch.compress(data, engine="native", blocks=False,
                               warm=True)
    with pytest.raises(ValueError, match="parse applies"):
        sqz_tpu_torch.compress(data, engine="oracle", blocks=False,
                               parse="exact")
    with pytest.raises(ValueError, match="requires an sqzt"):
        sqz_tpu_torch.decompress(
            sqz_tpu.compress(data, fmt="sqz4", engine="native"),
            engine="torch", device="cpu")
    blob = bytearray(sqz_tpu_torch.compress(data, engine="native",
                                            blk_bits=10))
    blob[-40] ^= 0x5A
    for engine in ENGINES:
        with pytest.raises((ValueError, OSError)):
            sqz_tpu_torch.decompress(bytes(blob), engine=engine)
