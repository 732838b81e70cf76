"""The port's checkpoint (``sqz_tpu_torch.utils.checkpoint``) against the
JAX package's (``sqz_tpu.utils.checkpoint``, its Pallas kernels in
interpret mode): on the same tree both write the same sqzt container and
the same ``leaves`` metadata, and the port restores every leaf bit for
bit, on the CPU (the plain versions of the kernels)."""

import io
import os
import pickle
import struct
import subprocess
import sys
from collections import OrderedDict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sqz_tpu.utils import checkpoint as ref_ckpt
from sqz_tpu.utils import corpus
from sqz_tpu_torch.formats import container as sqzt
from sqz_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _split(path):
    """A checkpoint file -> (metadata dict, sqzt container bytes), the
    metadata unpickled in full (jaxlib classes included)."""
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<I", data[8:12])
    return pickle.loads(data[12:12 + n]), data[12 + n:]


def _reference_tree():
    """The reference test's tree (tests/test_resident.py): fp32, a sparse
    fp32 optimizer slot, int32, bool, bfloat16 and an empty leaf, as
    numpy arrays (bfloat16 as float32 values it holds exactly)."""
    rng = np.random.default_rng(5)
    sparse = np.zeros(700, np.float32)
    sparse[::97] = rng.normal(size=sparse[::97].shape)
    bf = np.asarray(jnp.asarray(rng.normal(size=33), dtype=jnp.bfloat16)
                    .astype(jnp.float32))
    return {
        "w": rng.normal(size=(20, 16)).astype(np.float32),
        "m": sparse,
        "emb": {"idx": np.arange(50, dtype=np.int32),
                "mask": rng.random(64) < 0.5,
                "bf": bf},
        "empty": np.zeros((0, 4), np.float32),
    }


def _to_jax(tree, bf16=("bf",)):
    def conv(path, a):
        name = getattr(path[-1], "key", None)
        return jnp.asarray(a, dtype=jnp.bfloat16 if name in bf16 else None)
    return jax.tree_util.tree_map_with_path(conv, tree)


def _to_torch(tree, bf16=("bf",)):
    def conv(path, a):
        t = torch.from_numpy(np.array(a))
        name = getattr(path[-1], "key", None)
        return t.to(torch.bfloat16) if name in bf16 else t
    return jax.tree_util.tree_map_with_path(conv, tree)


def _assert_same_file(tmp_path, jtree, ttree, **kw):
    rp, pp = tmp_path / "ref.ckpt", tmp_path / "port.ckpt"
    rstats = ref_ckpt.save_pytree(jtree, rp, interpret=True, **kw)
    pstats = ckpt.save_pytree(ttree, pp, device="cpu", **kw)
    assert pstats == rstats
    rmeta, rblob = _split(rp)
    pmeta, pblob = _split(pp)
    assert pblob == rblob
    assert pmeta["leaves"] == rmeta["leaves"]
    assert pmeta["blk_bits"] == rmeta["blk_bits"]
    assert Path(pp).read_bytes()[:8] == Path(rp).read_bytes()[:8]
    return pp


def _assert_restored(back, tree):
    flat_a, td_a = jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    flat_b, td_b = jax.tree_util.tree_flatten(
        back, is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert td_a == td_b
    for a, b in zip(flat_a, flat_b):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), a.dtype


@pytest.mark.parametrize("shuffle,delta", [(True, True), (False, False),
                                           (True, False)])
def test_reference_tree_file_equals_the_reference(tmp_path, shuffle, delta):
    tree = _reference_tree()
    pp = _assert_same_file(tmp_path, _to_jax(tree), _to_torch(tree),
                           blk_bits=10, shuffle=shuffle, delta=delta)
    _assert_restored(ckpt.load_pytree(pp, device="cpu"), _to_torch(tree))


def test_lit_mode_and_numpy_leaves(tmp_path):
    """mode="lit" writes the reference's container too, and numpy leaves
    upload like tensors and restore as tensors."""
    tree = _reference_tree()
    del tree["emb"]["bf"]
    pp = _assert_same_file(tmp_path, _to_jax(tree), tree, blk_bits=9,
                           mode="lit")
    _assert_restored(ckpt.load_pytree(pp, device="cpu"), _to_torch(tree))


def _gpt2_state(n_layer=2, n_embd=32, vocab=96, n_ctx=16, seed=3):
    """A GPT-2-shaped state_dict (an OrderedDict in the model's order):
    N(0, 0.02) weights, LayerNorm weights 1 and biases 0."""
    rng = np.random.default_rng(seed)
    sd = OrderedDict()

    def w(*shape):
        return (rng.normal(size=shape) * 0.02).astype(np.float32)

    sd["wte"] = w(vocab, n_embd)
    sd["wpe"] = w(n_ctx, n_embd)
    for i in range(n_layer):
        for ln in ("ln_1", "ln_2"):
            sd[f"h.{i}.{ln}.weight"] = np.ones(n_embd, np.float32)
            sd[f"h.{i}.{ln}.bias"] = np.zeros(n_embd, np.float32)
        for name, (a, b) in (("attn.c_attn", (n_embd, 3 * n_embd)),
                             ("attn.c_proj", (n_embd, n_embd)),
                             ("mlp.c_fc", (n_embd, 4 * n_embd)),
                             ("mlp.c_proj", (4 * n_embd, n_embd))):
            sd[f"h.{i}.{name}.weight"] = w(a, b)
            sd[f"h.{i}.{name}.bias"] = np.zeros(b, np.float32)
    sd["ln_f.weight"] = np.ones(n_embd, np.float32)
    sd["ln_f.bias"] = np.zeros(n_embd, np.float32)
    return sd


def test_gpt2_state_dict_keeps_insertion_order(tmp_path):
    """An OrderedDict flattens in insertion order, as JAX flattens it;
    sorting its keys would reorder the stream and change the bytes."""
    sd = _gpt2_state()
    assert list(sd) != sorted(sd)
    jtree = OrderedDict((k, jnp.asarray(v)) for k, v in sd.items())
    ttree = OrderedDict((k, torch.from_numpy(v)) for k, v in sd.items())
    pp = _assert_same_file(tmp_path, jtree, ttree, blk_bits=9)
    back = ckpt.load_pytree(pp, device="cpu")
    assert type(back) is OrderedDict and list(back) == list(sd)
    _assert_restored(back, ttree)


def test_dict_keys_inserted_out_of_order_are_sorted(tmp_path):
    """A dict flattens with its keys sorted, as JAX flattens it, whatever
    the insertion order; None is an empty subtree and lists and tuples
    keep their order."""
    rng = np.random.default_rng(8)
    tree = {"zeta": rng.normal(size=40).astype(np.float32),
            "alpha": [np.arange(7, dtype=np.int32),
                      (np.float32(2.5) * np.ones(3, np.float32), None)],
            "mid": {"b": np.full(5, 9, np.uint8),
                    "a": np.array(3, dtype=np.int64)},
            "step": None}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                   tree)
    pp = _assert_same_file(tmp_path, jtree, ttree, blk_bits=8)
    back = ckpt.load_pytree(pp, device="cpu")
    assert list(back) == sorted(tree) and back["step"] is None
    assert isinstance(back["alpha"], list)
    assert isinstance(back["alpha"][1], tuple)
    assert back["alpha"][1][1] is None
    assert back["mid"]["a"].shape == () and int(back["mid"]["a"]) == 3
    _assert_restored(back, ttree)


def test_undelta_exact_past_the_int32_cumsum_wrap():
    """The undelta's int32 cumulative sum wraps past 2^31 and stays exact
    mod 256: 16 Mi delta bytes biased high sum to about 3.2e9."""
    rng = np.random.default_rng(3)
    d = torch.from_numpy(rng.integers(128, 256, size=1 << 24,
                                      dtype=np.uint8))
    assert int(torch.cumsum(d, 0, dtype=torch.int64)[-1]) > 1 << 31
    flat = (torch.cumsum(d, 0, dtype=torch.int64) % 256).to(torch.uint8)
    assert torch.equal(ckpt.byte_delta(flat), d)
    assert torch.equal(ckpt.byte_undelta(d), flat)
    ref = ref_ckpt._undelta_device(ref_ckpt._delta_device(
        jnp.asarray(flat.numpy()[:1 << 16])))
    assert np.array_equal(np.asarray(ref), flat.numpy()[:1 << 16])
    assert np.array_equal(
        np.asarray(ref_ckpt._delta_device(jnp.asarray(flat.numpy()[:4096]))),
        d.numpy()[:4096])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64, torch.bool, torch.uint8,
                                   torch.float16, torch.int16])
def test_leaf_filters_equal_the_reference(dtype):
    """The byte view and the shuffle of every dtype equal the reference's,
    0-d and one-element leaves included."""
    rng = np.random.default_rng(11)
    for shape in ((), (1,), (7, 5)):
        x = torch.from_numpy(np.asarray(
            rng.normal(size=shape) * 100, dtype=np.float32)).to(dtype)
        jx = jnp.asarray(x.float().numpy()).astype(
            {torch.bfloat16: jnp.bfloat16}.get(dtype,
                                               str(dtype).split(".")[1]))
        for shuffle in (True, False):
            got, gs = ckpt.leaf_bytes(x, shuffle)
            want, ws = ref_ckpt._leaf_bytes_device(jx, shuffle)
            assert gs == ws and got.numpy().tobytes() == \
                np.asarray(want).tobytes(), (shape, shuffle)
        assert ckpt.dtype_name(x.dtype) == str(jx.dtype)


def test_jax_written_file_raises_without_importing_jax(tmp_path):
    tree = {"w": np.arange(300, dtype=np.float32)}
    rp = tmp_path / "ref.ckpt"
    ref_ckpt.save_pytree(jax.tree_util.tree_map(jnp.asarray, tree), rp,
                         blk_bits=10, interpret=True)
    with pytest.raises(ValueError, match="jax"):
        ckpt.load_pytree(rp, device="cpu")
    code = (
        "import sys\n"
        "from sqz_tpu_torch.utils import checkpoint\n"
        "try:\n"
        f"    checkpoint.load_pytree({str(rp)!r}, device='cpu')\n"
        "except ValueError as e:\n"
        "    print('ValueError', e)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'sqz_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ValueError") and "jaxlib" in res.stdout


def test_bad_files_and_requests_raise(tmp_path):
    p = tmp_path / "x.ckpt"
    ckpt.save_pytree({"a": torch.arange(10)}, p, blk_bits=8, device="cpu")
    # over a mesh of two virtual CPU shards: the same file, every leaf
    # back; anything but a Mesh raises TypeError
    from sqz_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    pm = tmp_path / "mesh.ckpt"
    ckpt.save_pytree({"a": torch.arange(10)}, pm, blk_bits=8, mesh=mesh)
    assert pm.read_bytes() == p.read_bytes()
    assert torch.equal(ckpt.load_pytree(pm, mesh=mesh)["a"],
                       torch.arange(10))
    with pytest.raises(TypeError, match="Mesh"):
        ckpt.save_pytree({"a": torch.arange(10)}, p, mesh=object(),
                         device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        ckpt.load_pytree(p, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="blk_bits"):
        ckpt.save_pytree({"a": torch.arange(10)}, p, blk_bits=17,
                         device="cpu")
    q = tmp_path / "y.ckpt"
    q.write_bytes(b"NOTACKPT" + p.read_bytes()[8:])
    with pytest.raises(ValueError, match="not a sqz-tpu checkpoint"):
        ckpt.load_pytree(q, device="cpu")
    # metadata naming a class outside builtins never reaches find_class's
    # import
    meta = pickle.dumps(dict(tree=io.BytesIO, leaves=[], blk_bits=8))
    blob = p.read_bytes()
    (n,) = struct.unpack("<I", blob[8:12])
    q.write_bytes(blob[:8] + struct.pack("<I", len(meta)) + meta
                  + blob[12 + n:])
    with pytest.raises(ValueError, match="_io.BytesIO"):
        ckpt.load_pytree(q, device="cpu")
    # a corrupt payload byte raises
    ckpt.save_pytree({"a": torch.from_numpy(np.frombuffer(
        corpus.texty(1500, seed=2), np.uint8).copy())}, p, blk_bits=9,
        device="cpu")
    meta, blob = ckpt.read_checkpoint(p)
    code, wb, bb, osize, payloads, csum, _f, _a = sqzt.unpack(blob)
    bad = bytearray(payloads[1])
    bad[len(bad) // 2] ^= 0xFF
    payloads[1] = bytes(bad)
    raw = p.read_bytes()
    q.write_bytes(raw[:len(raw) - len(blob)]
                  + sqzt.pack(code, wb, bb, osize, payloads, csum))
    with pytest.raises((ValueError, OSError)):
        ckpt.load_pytree(q, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ckpt.save_pytree({"a": torch.arange(10)}, p)
        with pytest.raises(RuntimeError, match="cuda"):
            ckpt.load_pytree(p)
