"""The slice as a whole: sqz_tpu_torch.compress / decompress on the torch
engine (plain PyTorch versions on the CPU) against the JAX package's
engines, byte for byte."""

import pytest
import torch

import sqz_tpu
import sqz_tpu_torch
from sqz_tpu.formats import container as sqzt
from sqz_tpu.utils import corpus

# the plain versions step over small tensors: one intra-op thread each,
# so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

TORCH_CPU = dict(engine="torch", device="cpu")


def _data() -> bytes:
    return (corpus.texty(2500, seed=4) + corpus.rle4(1000)
            + corpus.zeros(700) + corpus.random_bytes(600, seed=2))


def _sqz4(engine, **kw):
    return dict(fmt="sqz4", engine=engine, blocks=True, blk_bits=10, **kw)


def test_exact_container_equals_native_and_jax_engines():
    data = _data()
    got = sqz_tpu_torch.compress(data, parse="exact", device="cpu",
                                 **_sqz4("torch"))
    assert got == sqz_tpu.compress(data, **_sqz4("native"))
    assert got == sqz_tpu.compress(data, parse="exact", **_sqz4("tpu"))


def test_round_trip_and_containers_written_by_the_reference():
    data = _data()
    for parse in ("exact", "fast"):
        blob = sqz_tpu_torch.compress(data, parse=parse, device="cpu",
                                      **_sqz4("torch"))
        assert sqz_tpu_torch.decompress(blob, **TORCH_CPU) == data
        assert sqz_tpu.decompress(blob, engine="native") == data
    for blob in (sqz_tpu.compress(data, parse="exact", **_sqz4("tpu")),
                 sqz_tpu.compress(data, parse="fast", **_sqz4("native"))):
        assert sqz_tpu_torch.decompress(blob, **TORCH_CPU) == data


def test_empty_and_tiny_inputs_round_trip():
    for data in (b"", b"a", corpus.hello()):
        blob = sqz_tpu_torch.compress(data, parse="exact", device="cpu",
                                      **_sqz4("torch"))
        assert blob == sqz_tpu.compress(data, **_sqz4("native"))
        assert sqz_tpu_torch.decompress(blob, **TORCH_CPU) == data


def test_corrupt_payload_rejected():
    data = _data()
    blob = sqz_tpu.compress(data, **_sqz4("native"))
    code, win_bits, blk_bits, osize, payloads, csum, _f, _a = \
        sqzt.unpack(blob)
    p = bytearray(payloads[1])
    p[len(p) // 2] ^= 0xA5
    payloads[1] = bytes(p)
    bad = sqzt.pack(code, win_bits, blk_bits, osize, payloads, csum)
    with pytest.raises(ValueError):
        sqz_tpu_torch.decompress(bad, **TORCH_CPU)


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError):
        sqz_tpu_torch.compress(b"abc" * 100, device="cuda", **_sqz4("torch"))
    blob = sqz_tpu.compress(b"abc" * 100, **_sqz4("native"))
    with pytest.raises(RuntimeError):
        sqz_tpu_torch.decompress(blob, engine="torch", device="cuda")


def test_unported_requests_raise_not_implemented():
    # the resident paths are served on the card and over a mesh (here two
    # virtual CPU shards, whose container and restore equal the mesh-less
    # ones); anything but a Mesh raises TypeError, and a squeeze container
    # is no input of the resident restore (a ValueError, as the
    # reference's)
    from sqz_tpu_torch.parallel.mesh import make_mesh
    data = _data()
    sq_blob = sqz_tpu.compress(data, fmt="squeeze", engine="native",
                               blocks=True, blk_bits=10)
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=10, mode="lit",
                                           mesh=mesh)
    assert blob == sqz_tpu_torch.compress_resident(
        data, blk_bits=10, mode="lit", device="cpu")
    out = sqz_tpu_torch.decompress_resident(blob, mesh=mesh)
    assert out.numpy().tobytes() == data
    with pytest.raises(TypeError, match="Mesh"):
        sqz_tpu_torch.compress_resident(data, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        sqz_tpu_torch.decompress_resident(blob, mesh=object(),
                                          device="cpu")
    with pytest.raises(ValueError, match="cold sqz4"):
        sqz_tpu_torch.decompress_resident(sq_blob, device="cpu")


def test_resident_entry_points_run_on_the_card_by_default():
    # compress_resident / decompress_resident default to "cuda": without
    # a card they raise; on the CPU they round-trip
    data = _data()
    blob = sqz_tpu_torch.compress_resident(data, blk_bits=10, mode="lit",
                                           device="cpu")
    out = sqz_tpu_torch.decompress_resident(blob, device="cpu")
    assert out.dtype == torch.uint8 and out.numpy().tobytes() == data
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        sqz_tpu_torch.compress_resident(data, blk_bits=10)
    with pytest.raises(RuntimeError, match="cuda"):
        sqz_tpu_torch.decompress_resident(blob)


def test_invalid_requests_raise_value_error():
    with pytest.raises(ValueError):
        sqz_tpu_torch.compress(b"x" * 10, fmt="sqz4", engine="torch",
                               blocks=True, blk_bits=41, device="cpu")
    with pytest.raises(ValueError):
        sqz_tpu_torch.compress(b"x" * 10, fmt="sqz4", engine="torch",
                               blocks=False, device="cpu")
    with pytest.raises(ValueError):
        sqz_tpu_torch.compress(b"x" * 10, engine="tpu")
    with pytest.raises(ValueError):
        sqz_tpu_torch.decompress(b"squeeze4" + bytes(16), **TORCH_CPU)


@pytest.mark.parametrize("engine", ["native", "oracle"])
def test_host_engines_delegate_to_the_reference(engine):
    """The host engines are served by the port's own copies of the
    reference's (it imports nothing of the JAX package): the containers
    equal the reference engine's, and each side decodes the other's."""
    data = corpus.texty(1500, seed=5)
    kw = dict(fmt="sqz4", engine=engine, win_bits=10, blocks=True,
              blk_bits=10)
    blob = sqz_tpu.compress(data, **kw)
    assert sqz_tpu_torch.compress(data, **kw) == blob
    assert sqz_tpu_torch.decompress(blob, engine=engine) == data
    assert sqz_tpu.decompress(sqz_tpu_torch.compress(data, **kw),
                              engine=engine) == data


def test_defaults_select_the_torch_engine_on_the_card():
    """compress / decompress with no keyword run the torch engine on
    "cuda": sqz4 sqzt containers, and without a card a RuntimeError."""
    data = corpus.texty(3000, seed=8)
    blob = sqz_tpu_torch.compress(data, device="cpu")
    assert blob == sqz_tpu_torch.compress(data, fmt="sqz4", engine="torch",
                                          blocks=True, blk_bits=16,
                                          device="cpu")
    assert blob[:8] == sqzt.SQZT_MAGIC
    assert sqz_tpu_torch.decompress(blob, device="cpu") == data
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        sqz_tpu_torch.compress(data)
    with pytest.raises(RuntimeError, match="cuda"):
        sqz_tpu_torch.decompress(blob)
