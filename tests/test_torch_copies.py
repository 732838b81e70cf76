"""The port's own copies of the reference's JAX-free modules give the
reference's results: the native runtime (a verbatim copy of the C++,
built by the port), the sqzt container framing, the anchored warm-start
planner, the input generators, the format constants, the pure-Python
oracle and the telemetry."""

from pathlib import Path

import numpy as np
import pytest

from sqz_tpu import native as ref_native
from sqz_tpu.formats import constants as ref_constants
from sqz_tpu.formats import container as ref_container
from sqz_tpu.utils import corpus as ref_corpus
from sqz_tpu import oracle as ref_oracle
from sqz_tpu.utils import stats as ref_stats
from sqz_tpu_torch import native, oracle
from sqz_tpu_torch.formats import anchors, constants, container
from sqz_tpu_torch.utils import corpus, stats

ROOT = Path(__file__).resolve().parents[1]

INPUTS = {
    "texty": ref_corpus.texty(9 * 1024 + 311, seed=5),
    "mixed": (ref_corpus.rle4(3000) + ref_corpus.zeros(2000)
              + ref_corpus.random_bytes(3000, seed=6)
              + ref_corpus.texty(4000, seed=7)),
}


def _equal(got, want):
    for a, b in zip(got, want):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_native_source_is_the_references():
    assert ((ROOT / "sqz_tpu_torch" / "native" / "sqz_native.cpp")
            .read_bytes()
            == (ROOT / "sqz_tpu" / "native" / "sqz_native.cpp").read_bytes())


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("call", [
    lambda m, d: m.sqz4_plan_pack(d, 1 << 10, 10, True, 4, 2624),
    lambda m, d: m.sqz4_fast_plan(d, 1 << 10, 10, True, 2624),
    lambda m, d: m.sqz4_tok_plan(d, 1 << 10, 10, True, 96, 1024),
    lambda m, d: m.blocks_compress(d, 1, 10, 10),
    lambda m, d: m.blocks_compress(d, 1, 10, 10, parse="fast"),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160, warm=True),
    lambda m, d: m.squeeze_plan_pack(d, 10, 10, 4, 4160, parse="fast"),
    lambda m, d: m.blocks_compress(d, 0, 10, 10),
    lambda m, d: m.blocks_compress(d, 0, 10, 10, warm=True),
    lambda m, d: m.blocks_compress(d, 0, 10, 10, warm=True, parse="fast"),
    lambda m, d: [m.squeeze_compress_payload(d[:1024], 10, parse=p)
                  for p in ("exact", "fast")],
], ids=["plan_pack", "fast_plan", "tok_plan", "blocks_exact",
        "blocks_fast", "squeeze_plan", "squeeze_plan_warm",
        "squeeze_plan_fast", "squeeze_blocks", "squeeze_blocks_warm",
        "squeeze_blocks_warm_fast", "squeeze_payload"])
def test_native_copy_equals_reference(call, kind):
    _equal(call(native, INPUTS[kind]), call(ref_native, INPUTS[kind]))


def test_native_host_codec_and_checksum_equal_reference():
    data = INPUTS["mixed"]
    payloads = native.blocks_compress(data, 1, 10, 10)
    assert native.blocks_decompress(payloads, len(data), 1, 10) == data
    assert native.sqz4_decompress_payload(payloads[2], 1024) == \
        data[2048:3072]
    assert native.fnv1a64(data) == ref_native.fnv1a64(data)
    np.testing.assert_array_equal(
        native.sqz4_pack_payloads(payloads, 4, 320),
        ref_native.sqz4_pack_payloads(payloads, 4, 320))


def test_squeeze_seeded_payloads_and_states_equal_reference():
    data = INPUTS["texty"]
    blk0, rest = data[:1024], data[1024:3072]
    pay, seed = native.squeeze_compress_payload(blk0, 10, return_state=True)
    rpay, rseed = ref_native.squeeze_compress_payload(blk0, 10,
                                                      return_state=True)
    assert pay == rpay
    assert seed.tolist() == list(rseed.lit) + list(rseed.pos)
    dec, dseed = native.squeeze_decompress_payload(pay, 1024,
                                                   return_state=True)
    assert dec == blk0 and dseed.tolist() == seed.tolist()
    for parse in ("exact", "fast"):
        w = native.squeeze_compress_payload(rest, 10, seed=seed,
                                            dictionary=blk0, parse=parse)
        assert w == ref_native.squeeze_compress_payload(
            rest, 10, seed=rseed, dictionary=blk0, parse=parse)
        assert native.squeeze_decompress_payload(
            w, len(rest), seed=seed, dictionary=blk0) == rest
    with pytest.raises(ValueError):
        native.squeeze_compress_payload(blk0, 10, seed=seed[:-1])


def test_sqz4_seeded_payloads_and_states_equal_reference():
    data = INPUTS["texty"]
    blk0, rest = data[:1024], data[1024:4096]
    pay, seed = native.sqz4_compress_payload(blk0, 1 << 10,
                                             return_state=True)
    rpay, rseed = ref_native.sqz4_compress_payload(blk0, 1 << 10,
                                                   return_state=True)
    assert pay == rpay and seed.dtype == np.uint32
    assert seed.tolist() == rseed.flat
    dec, dseed = native.sqz4_decompress_payload(pay, 1024, return_state=True)
    assert dec == blk0 and dseed.tolist() == seed.tolist()
    for parse in ("exact", "fast"):
        for lz in (True, False):
            w = native.sqz4_compress_payload(rest, 1 << 10, lz=lz, seed=seed,
                                             dictionary=blk0, parse=parse)
            assert w == ref_native.sqz4_compress_payload(
                rest, 1 << 10, lz=lz, seed=rseed, dictionary=blk0,
                parse=parse)
            out, st = native.sqz4_decompress_payload(
                w, len(rest), seed=seed, dictionary=blk0, return_state=True)
            rout, rst = ref_native.sqz4_decompress_payload(
                w, len(rest), seed=rseed, dictionary=blk0, return_state=True)
            assert out == rout == rest and st.tolist() == rst.flat
    assert native.sqz4_compress_payload(rest, 1 << 10) == \
        ref_native.sqz4_compress_payload(rest, 1 << 10)
    with pytest.raises(ValueError):
        native.sqz4_compress_payload(blk0, 1 << 10, seed=seed[:-1])
    with pytest.raises(OSError):
        native.sqz4_decompress_payload(pay[:len(pay) // 2], 1024, seed=seed)


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_warm_plans_equal_reference(kind):
    data = INPUTS[kind]
    got = native.sqz4_plan_pack(data, 1 << 10, 10, True, 4, 2624, warm=True)
    want = ref_native.sqz4_plan_pack(data, 1 << 10, 10, True, 4, 2624,
                                     warm=True)
    _equal(got[:3], want[:3])
    assert got[3].tolist() == want[3].flat
    got = native.sqz4_fast_plan(data, 1 << 10, 10, True, 2624, warm=True)
    want = ref_native.sqz4_fast_plan(data, 1 << 10, 10, True, 2624,
                                     warm=True)
    _equal(got[:3], want[:3])
    assert got[3].tolist() == want[3].flat


def test_assemble_blocks_with_dictionary_equals_reference():
    # decoder records of blocks that match into a dictionary (the plain
    # decoder's, seeded), assembled by both copies
    import torch
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host
    data = INPUTS["texty"]
    blk0, parts = data[:1024], [data[1024:1536], data[1536:2000]]
    _, seed = native.sqz4_decompress_payload(
        native.sqz4_compress_payload(blk0, 1 << 10), 1024, return_state=True)
    payloads = [native.sqz4_compress_payload(p, 1 << 10, seed=seed,
                                             dictionary=blk0) for p in parts]
    sizes = [len(p) for p in parts]
    plan = host.plan_decode_dispatch(2, 9, lanes=2)
    buf, meta = host.pack_decode_chunk(payloads, sizes, 2, 1, plan["Pw"],
                                       len(blk0))
    pt, mt = convert.decoder_inputs(buf, meta, "cpu")
    torch.set_num_threads(1)
    lit, tok, mrec, cnt = (convert.to_numpy(x) for x in sqz4_cuda.decode(
        pt, mt, plan["t_max"], plan["lw"], plan["tw"], plan["mw"],
        seed=convert.to_device(host.seed_column(seed), "cpu")))
    assert cnt[0, 3].min() > 0   # matches in both blocks
    args = (np.ascontiguousarray(tok[0].T),
            np.ascontiguousarray(lit[0].T).astype(">u4").view(np.uint8),
            np.ascontiguousarray(mrec[0].T), cnt[0, 2].astype(np.int64),
            np.asarray(sizes, np.int64), 512)
    got = native.assemble_blocks(*args, dictionary=blk0)
    np.testing.assert_array_equal(
        got, ref_native.assemble_blocks(*args, dictionary=blk0))
    assert [got[i, :n].tobytes() for i, n in enumerate(sizes)] == parts


def test_model_stats_equal_reference():
    data = INPUTS["mixed"]
    mw, sw, _mx = native.sqz4_plan_pack(data, 1 << 10, 10, True, 4, 2624)
    m = mw[0, :, 1].astype(">u4").view(np.uint8)
    s = sw[0, :, 1].astype(">u4").view(np.uint8)
    _equal(native.sqz4_model_stats(m, s), ref_native.sqz4_model_stats(m, s))


@pytest.mark.parametrize("fmt", [0, 1])
def test_warm_blocks_decompress_equals_reference(fmt):
    data = INPUTS["texty"]
    payloads, fresh = ref_native.blocks_compress(data, fmt, 10, 10,
                                                 warm=True)
    assert not all(fresh)
    assert (native.blocks_decompress(payloads, len(data), fmt, 10,
                                     fresh_mask=fresh, win_bits=10)
            == data)
    with pytest.raises(ValueError):
        native.blocks_decompress(payloads, len(data), fmt, 10,
                                 fresh_mask=fresh[:-1], win_bits=10)


@pytest.mark.parametrize("kind", sorted(INPUTS) + ["tail", "tiny", "one"])
def test_warm_gate_copy_equals_reference(kind):
    if kind in INPUTS:
        parts = container.split_blocks(INPUTS[kind], 10)
    elif kind == "tail":
        parts = [INPUTS["texty"][:4096], ref_corpus.random_bytes(4096, 3),
                 INPUTS["texty"][:4096], b"abc"]
    elif kind == "tiny":
        parts = [b"ab", b"cd"]
    else:
        parts = [INPUTS["texty"]]
    for dictionary in (parts[0][-1024:], b"", parts[0][:3]):
        assert (constants.warm_gate_mask(parts, dictionary)
                == ref_constants.warm_gate_mask(parts, dictionary))
    for name in ("WARM_GATE_PROBE", "WARM_GATE_MIN_HITS",
                 "WARM_GATE_HASH_MUL", "WARM_GATE_BITS"):
        assert getattr(constants, name) == getattr(ref_constants, name)


@pytest.mark.parametrize("n,win_bits", [(0, 10), (3, 10), (1024, 10),
                                        (5000, 10), (40000, 15)])
def test_warm_dictionary_copy_equals_reference(n, win_bits):
    from sqz_tpu.api import _warm_dictionary
    block0 = ref_corpus.texty(n, seed=8)
    assert (constants.warm_dictionary(block0, win_bits)
            == _warm_dictionary(block0, win_bits))


def test_container_copy_equals_reference():
    data = INPUTS["texty"]
    payloads = native.blocks_compress(data, 1, 10, 10)
    csum = container.fnv1a64(data)
    blob = container.pack(1, 10, 10, len(data), payloads, csum)
    assert blob == ref_container.pack(1, 10, 10, len(data), payloads, csum)
    assert container.unpack(blob) == ref_container.unpack(blob)
    assert container.split_blocks(data, 10) == ref_container.split_blocks(
        data, 10)
    with pytest.raises(ValueError):
        container.unpack(blob[:-1])


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 3), (4097, 1),
                                    (1 << 20, 9)])
def test_corpus_copy_equals_reference(n, seed):
    assert corpus.texty(n, seed) == ref_corpus.texty(n, seed)
    assert corpus.random_bytes(n, seed) == ref_corpus.random_bytes(n, seed)
    assert corpus.rle4(n) == ref_corpus.rle4(n)
    assert corpus.zeros(n) == ref_corpus.zeros(n)
    assert corpus.hello() == ref_corpus.hello()


def test_anchor_planner_copy_is_the_references():
    assert ((ROOT / "sqz_tpu_torch" / "formats" / "anchors.py").read_bytes()
            == (ROOT / "sqz_tpu" / "formats" / "anchors.py").read_bytes())
    assert anchors.plan_anchored.__module__ == \
        "sqz_tpu_torch.formats.anchors"


@pytest.mark.parametrize("fresh,anch", [
    ([True], None), ([True, False, False], None),
    ([True, False, True, False, False], [False, False, False, True, False]),
    ([True, True, False, True, False, False, True, False],
     [False, False, True, False, True, False, False, True]),
])
def test_resolve_anchors_copy_equals_reference(fresh, anch):
    assert (container.resolve_anchors(fresh, anch)
            == ref_container.resolve_anchors(fresh, anch))


def _code(text: str, drop_docstring: bool) -> str:
    """The module's syntax tree (comments aside), without its docstring
    if asked."""
    import ast
    tree = ast.parse(text)
    if drop_docstring and ast.get_docstring(tree) is not None:
        tree.body = tree.body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("path", [
    "oracle/bitstream.py", "oracle/huffman.py", "oracle/match.py",
    "oracle/rangecoder.py", "oracle/squeeze.py", "oracle/sqz4.py",
    "oracle/__init__.py", "utils/stats.py"])
def test_oracle_and_stats_copies_are_the_references(path):
    """The copies are the reference's code with its import paths
    rewritten (comments may differ, and the package docstring of
    ``oracle``)."""
    want = (ROOT / "sqz_tpu" / path).read_text().replace(
        "sqz_tpu.", "sqz_tpu_torch.")
    got = (ROOT / "sqz_tpu_torch" / path).read_text()
    init = path.endswith("__init__.py")
    assert _code(got, init) == _code(want, init)


def test_constants_copy_equals_reference():
    for name in dir(ref_constants):
        if name.startswith("_") or not hasattr(constants, name):
            continue
        a, b = getattr(constants, name), getattr(ref_constants, name)
        if not callable(a):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("LEN_BASE", "LEN_XB", "POS_BASE", "POS_XB",
                 "SQUEEZE_MIN_WIN_BITS", "SQUEEZE_MAX_WIN_BITS",
                 "SQUEEZE_LEN_MIN", "SQUEEZE_LEN_MAX", "SQUEEZE_SYM_MIN",
                 "SQUEEZE_SYM_MAX", "SQUEEZE_LIT_NYT", "SQUEEZE_POS_MAX",
                 "SQUEEZE_POS_NYT", "SQUEEZE_LIT_TERMINALS",
                 "SQUEEZE_POS_TERMINALS", "SQZ4_MIN_LEN", "SQZ4_MAX_LEN",
                 "SQZ4_EOS", "SQZ4_MAGIC", "SQZ4_REJECT_MAX_LEN",
                 "SQZ4_REJECT_MAX_BITS"):
        assert hasattr(constants, name), name
    np.testing.assert_array_equal(constants.build_len_index(),
                                  ref_constants.build_len_index())
    np.testing.assert_array_equal(constants.build_pos_index(),
                                  ref_constants.build_pos_index())
    for length in range(1, 8):
        for dist in (1, 2, 7, 8, 9, 100, 1 << 14):
            assert (constants.sqz4_reject_short_far(length, dist)
                    == ref_constants.sqz4_reject_short_far(length, dist))


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_oracle_copy_equals_reference(kind):
    data = INPUTS[kind][:2500]
    for win_bits in (10, 15):
        sq = oracle.squeeze_compress(data, win_bits)
        assert sq == ref_oracle.squeeze_compress(data, win_bits)
        assert oracle.squeeze_decompress(sq) == data
    for lz in (True, False):
        s4 = oracle.sqz4_compress(data, window=1 << 10, lz=lz)
        assert s4 == ref_oracle.sqz4_compress(data, window=1 << 10, lz=lz)
        assert s4 == native.sqz4_compress(data, window=1 << 10, lz=lz)
        assert oracle.sqz4_decompress(s4) == data


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_stats_copy_equals_reference(kind):
    data = INPUTS[kind][:4000]
    for fmt, (lo, hi) in (("squeeze", (3, 257)), ("sqz4", (2, 254))):
        toks = native.tokenize(data, 1 << 10, lo, hi,
                               reject_short_far=fmt == "sqz4")
        np.testing.assert_array_equal(
            toks, ref_native.tokenize(data, 1 << 10, lo, hi,
                                      reject_short_far=fmt == "sqz4"))
        tokens = [("lit", int(a)) if k == 0 else ("match", int(a), int(b))
                  for k, a, b in toks]
        assert (stats.analyze_tokens(tokens).report()
                == ref_stats.analyze_tokens(tokens).report())
    # tokens of the sqz4 parse (lengths <= 254), as the CLI passes them
    assert (stats.sqz4_model_report(tokens)
            == ref_stats.sqz4_model_report(tokens))
    assert (stats.count_rejections(data, 1 << 10)
            == ref_stats.count_rejections(data, 1 << 10))
    assert stats.shannon_entropy([3, 1, 5, 0]) == \
        ref_stats.shannon_entropy([3, 1, 5, 0])


def _function(path: Path, name: str) -> str:
    import ast
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == name:
            return ast.dump(node)
    raise AssertionError(f"{name} not in {path}")


@pytest.mark.parametrize("name", ["pack_exchange_row",
                                  "unpack_exchange_rows"])
def test_exchange_helpers_are_the_references(name):
    """The multi-process exchange rows keep the reference's layout: the
    port's helpers are its code (comments aside)."""
    assert (_function(ROOT / "sqz_tpu_torch/parallel/multihost.py", name)
            == _function(ROOT / "sqz_tpu/parallel/multihost.py", name))


def test_microops_copy_equals_reference():
    from sqz_tpu.ops.sqz4_jax import microops_from_tokens as ref_microops
    from sqz_tpu_torch.parallel.shard import microops_from_tokens
    rng = np.random.default_rng(11)
    tokens = [("lit", int(b)) for b in rng.integers(0, 256, 50)]
    tokens += [("match", int(n), int(d)) for n, d in zip(
        rng.integers(2, 255, 30), rng.integers(1, 1 << 15, 30))]
    rng.shuffle(tokens)
    for toks in (tokens, [], tokens[:1]):
        for a, b in zip(microops_from_tokens(toks), ref_microops(toks)):
            np.testing.assert_array_equal(a, b)
