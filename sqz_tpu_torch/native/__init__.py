"""ctypes bindings for the native C++ host runtime (``sqz_native.cpp``).

``sqz_native.cpp`` is a verbatim copy of the reference package's native
runtime (``sqz_tpu/native/sqz_native.cpp``), so the planners, packers and
host codec here give the reference's bytes. The bindings below are the
reference's (``sqz_tpu/native/__init__.py``) trimmed to the functions
the port calls. The warm states of sqzt v2 stay the flat arrays the
native code reads and writes: a squeeze tree seed ``TREE_SEED_WORDS``
int64 words, an sqz4 model seed ``SEED4_WORDS`` uint32 words (the
reference's ``ModelSeed.flat``).

The library is built with g++ on first use into
``build/sqz_tpu_torch/libsqznative.so`` at the root of the checkout
(rebuilt when the source is newer); a missing compiler raises. Entry
points return the produced count or -errno.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

from sqz_tpu_torch.ops._build import BUILD_DIR, is_fresh

SRC = Path(__file__).resolve().parent / "sqz_native.cpp"
LIB = BUILD_DIR / "libsqznative.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
            "-shared")

_lock = threading.Lock()
_lib = None


def build(force: bool = False) -> Path:
    """Compile the runtime unless the library is newer than its source
    (atomically: a process-named file moved into place)."""
    if not force and is_fresh(LIB, [SRC]):
        return LIB
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found: the native host "
                           "runtime is built from source on first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SRC)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB)
    return LIB


def library() -> ctypes.CDLL:
    """The built runtime, with the bound functions' signatures declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64, u64, i32, u32 = (ctypes.c_int64, ctypes.c_uint64,
                                  ctypes.c_int32, ctypes.c_uint32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.sqz_sqz4_decompress.restype = i64
            lib.sqz_sqz4_decompress.argtypes = [u8p, u64, u64, u8p, u64]
            lib.sqz_sqz4_compress_s.restype = i64
            lib.sqz_sqz4_compress_s.argtypes = [u8p, u64, u32, i32, u32p,
                                                u32p, u8p, u64, u8p, u64]
            lib.sqz_sqz4_compress_f.restype = i64
            lib.sqz_sqz4_compress_f.argtypes = [u8p, u64, u32, i32, i32,
                                                u32p, u32p, u8p, u64, u8p,
                                                u64]
            lib.sqz_sqz4_decompress_s.restype = i64
            lib.sqz_sqz4_decompress_s.argtypes = [u8p, u64, u64, u32p, u32p,
                                                  u8p, u64, u8p, u64]
            lib.sqz_blocks_compress.restype = i64
            lib.sqz_blocks_compress.argtypes = [u8p, u64, i32, i32, i32, i32,
                                                i32, i32, i32, u8p, u64, i64p,
                                                u8p]
            lib.sqz_blocks_decompress.restype = i64
            lib.sqz_blocks_decompress.argtypes = [u8p, i64p, i64p, u64, i32,
                                                  i32, i32, i32, i32, u8p,
                                                  u8p, u64]
            lib.sqz_assemble_blocks.restype = i64
            lib.sqz_assemble_blocks.argtypes = [u32p, u64, u8p, u64, u32p,
                                                u64, i64p, i64p, u64, i32,
                                                u8p, u64, u8p, u64]
            lib.sqz4_plan_pack.restype = i64
            lib.sqz4_plan_pack.argtypes = [u8p, u64, u32, i32, i32, u64, u64,
                                           i32, i32, i32, u32p, u32p, u32p,
                                           i64p]
            lib.sqz4_fast_plan.restype = i64
            lib.sqz4_fast_plan.argtypes = [u8p, u64, u32, i32, i32, u64, i32,
                                           i32, i32, i32, u32p, u8p, u8p,
                                           i64p]
            lib.sqz4_tok_plan.restype = i64
            lib.sqz4_tok_plan.argtypes = [u8p, u64, u32, i32, i32, u64, u64,
                                          i32, i32, u32p, u8p, i64p]
            lib.sqz_fnv1a64.restype = u64
            lib.sqz_fnv1a64.argtypes = [u8p, u64]
            lib.sqz4_pack_payloads.restype = i64
            lib.sqz4_pack_payloads.argtypes = [u8p, i64p, i64p, u64, u64, u64,
                                               i32, u32p]
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.sqz_sqz4_model_stats.restype = i64
            lib.sqz_sqz4_model_stats.argtypes = [i32p, i32p, u64, u32p, u32p,
                                                 u32p, u32p]
            lib.sqz_squeeze_compress_s.restype = i64
            lib.sqz_squeeze_compress_s.argtypes = [u8p, u64, i32, i64p, i64p,
                                                   u8p, u64, u8p, u64]
            lib.sqz_squeeze_compress_f.restype = i64
            lib.sqz_squeeze_compress_f.argtypes = [u8p, u64, i32, i32, i64p,
                                                   i64p, u8p, u64, u8p, u64]
            lib.sqz_squeeze_decompress_s.restype = i64
            lib.sqz_squeeze_decompress_s.argtypes = [u8p, u64, u64, i64p,
                                                     i64p, u8p, u64, u8p, u64]
            lib.squeeze_plan_pack.restype = i64
            lib.squeeze_plan_pack.argtypes = [u8p, u64, i32, i32, u64, u64,
                                              i32, i32, i32, u32p]
            _lib = lib
        return _lib


def _u8(buf) -> ctypes.POINTER(ctypes.c_uint8):
    return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _src(data: bytes) -> np.ndarray:
    return (np.frombuffer(data, dtype=np.uint8) if data
            else np.zeros(1, np.uint8))


def _check(rc: int) -> int:
    if rc < 0:
        raise OSError(-rc, f"native codec error: {os.strerror(-rc)}")
    return rc


def _cap_for(n: int) -> int:
    return 2 * n + 4096


SEED4_WORDS = 610        # sqz4 ModelSeed flat u32 words (FORMAT.md §3.1)
TREE_SEED_WORDS = (3 + 6 * 1023) + (3 + 6 * 63)   # squeeze TreeSeed i64 words


def _seed4_in(seed):
    """A flat sequence or array of sqz4 model-seed words -> u32[610], or
    None."""
    if seed is None:
        return None
    a = np.ascontiguousarray(getattr(seed, "flat", seed), dtype=np.uint32)
    if a.size != SEED4_WORDS:   # native reads exactly this many words
        raise ValueError(f"sqz4 seed must be {SEED4_WORDS} u32 words")
    return a


def _treeseed_in(seed):
    """A squeeze tree seed (flat i64 words) -> i64[6522], or None."""
    if seed is None:
        return None
    a = np.ascontiguousarray(seed, dtype=np.int64)
    if a.size != TREE_SEED_WORDS:
        raise ValueError(f"tree seed must be {TREE_SEED_WORDS} i64 words")
    return a


def _dict_in(dictionary):
    if not dictionary:
        return None, 0
    d = np.frombuffer(dictionary, dtype=np.uint8)
    return d, d.size


def _opt(ptr, a):
    return ptr(a) if a is not None else None


def squeeze_compress_payload(data: bytes, win_bits: int, seed=None,
                             return_state: bool = False,
                             dictionary: bytes = b"", parse: str = "exact",
                             depth: int = 32):
    """One squeeze block payload; ``seed`` (flat tree-seed words) and
    ``dictionary`` warm-start it (sqzt v2). ``return_state``: also the
    final tree seed, a flat int64 array. ``parse="fast"``: the bounded
    approximate matcher (sqzt-contract paths only)."""
    out = np.empty(_cap_for(len(data)), dtype=np.uint8)
    sin = _treeseed_in(seed)
    sout = np.zeros(TREE_SEED_WORDS, dtype=np.int64) if return_state else None
    d, dn = _dict_in(dictionary)
    lib = library()
    if parse == "fast":
        rc = _check(lib.sqz_squeeze_compress_f(
            _u8(_src(data)), len(data), win_bits, depth, _opt(_i64p, sin),
            _opt(_i64p, sout), _opt(_u8, d), dn, _u8(out), out.size))
    else:
        rc = _check(lib.sqz_squeeze_compress_s(
            _u8(_src(data)), len(data), win_bits, _opt(_i64p, sin),
            _opt(_i64p, sout), _opt(_u8, d), dn, _u8(out), out.size))
    payload = out[:rc].tobytes()
    return (payload, sout) if return_state else payload


def squeeze_decompress_payload(payload: bytes, size: int, seed=None,
                               return_state: bool = False,
                               dictionary: bytes = b""):
    """One squeeze block payload -> its ``size`` original bytes (and, with
    ``return_state``, the final tree seed as flat int64 words)."""
    out = np.empty(max(size, 1), dtype=np.uint8)
    sin = _treeseed_in(seed)
    sout = np.zeros(TREE_SEED_WORDS, dtype=np.int64) if return_state else None
    d, dn = _dict_in(dictionary)
    rc = _check(library().sqz_squeeze_decompress_s(
        _u8(_src(payload)), len(payload), size, _opt(_i64p, sin),
        _opt(_i64p, sout), _opt(_u8, d), dn, _u8(out), out.size))
    data = out[:rc].tobytes()
    return (data, sout) if return_state else data


def sqz4_model_stats(m_ops: np.ndarray, s_ops: np.ndarray, seed=None):
    """Per-op (start, size, total) of the 36 adaptive sqz4 models, values
    taken before each op's update (one block's op stream); ops outside
    0..35 (flushes, pads) give (0, 0, 0). ``seed`` warm-starts the models
    (FORMAT.md §3.1)."""
    t = len(m_ops)
    m = np.ascontiguousarray(m_ops, dtype=np.int32)
    s = np.ascontiguousarray(s_ops, dtype=np.int32)
    start, size, total = (np.empty(t, dtype=np.uint32) for _ in range(3))
    i32p = ctypes.POINTER(ctypes.c_int32)
    _check(library().sqz_sqz4_model_stats(
        m.ctypes.data_as(i32p), s.ctypes.data_as(i32p), t,
        _opt(_u32p, _seed4_in(seed)), _u32p(start), _u32p(size),
        _u32p(total)))
    return start, size, total


def sqz4_compress_payload(data: bytes, window: int, lz: bool = True,
                          seed=None, return_state: bool = False,
                          dictionary: bytes = b"", parse: str = "exact",
                          depth: int = 32):
    """One sqz4 block payload; ``seed`` (the 610 model-seed words) and
    ``dictionary`` warm-start it (sqzt v2, FORMAT.md §3.1).
    ``return_state``: also the final rescaled model state, u32[610].
    ``parse="fast"`` (with ``lz``): the bounded approximate matcher
    (``depth`` hash-chain links; sqzt-contract paths only)."""
    out = np.empty(_cap_for(len(data)), dtype=np.uint8)
    sin = _seed4_in(seed)
    sout = np.zeros(SEED4_WORDS, dtype=np.uint32) if return_state else None
    d, dn = _dict_in(dictionary)
    lib = library()
    if parse == "fast" and lz:
        rc = _check(lib.sqz_sqz4_compress_f(
            _u8(_src(data)), len(data), window, int(lz), depth,
            _opt(_u32p, sin), _opt(_u32p, sout), _opt(_u8, d), dn, _u8(out),
            out.size))
    else:
        rc = _check(lib.sqz_sqz4_compress_s(
            _u8(_src(data)), len(data), window, int(lz), _opt(_u32p, sin),
            _opt(_u32p, sout), _opt(_u8, d), dn, _u8(out), out.size))
    payload = out[:rc].tobytes()
    return (payload, sout) if return_state else payload


def sqz4_decompress_payload(payload: bytes, size: int, seed=None,
                            return_state: bool = False,
                            dictionary: bytes = b""):
    """One sqz4 block payload -> its ``size`` original bytes; ``seed`` and
    ``dictionary`` as in ``sqz4_compress_payload``. ``return_state``: also
    the final rescaled model state, u32[610] (the seed of the blocks
    anchored on this one)."""
    out = np.empty(max(size, 1), dtype=np.uint8)
    lib = library()
    if seed is None and not return_state and not dictionary:
        rc = _check(lib.sqz_sqz4_decompress(
            _u8(_src(payload)), len(payload), size, _u8(out), out.size))
        return out[:rc].tobytes()
    sin = _seed4_in(seed)
    sout = np.zeros(SEED4_WORDS, dtype=np.uint32) if return_state else None
    d, dn = _dict_in(dictionary)
    rc = _check(lib.sqz_sqz4_decompress_s(
        _u8(_src(payload)), len(payload), size, _opt(_u32p, sin),
        _opt(_u32p, sout), _opt(_u8, d), dn, _u8(out), out.size))
    data = out[:rc].tobytes()
    return (data, sout) if return_state else data


def blocks_compress(data: bytes, fmt: int, win_bits: int, blk_bits: int,
                    lz: bool = True, nthreads: int = 0, warm: bool = False,
                    parse: str = "exact", depth: int = 32):
    """Compress independent 2^blk_bits blocks in parallel; returns the
    payloads (cold) or (payloads, fresh_mask) (warm, sqzt v2: each
    candidate block 1+ is coded both fresh and seeded from block 0's final
    state, and the smaller wins). ``parse="fast"``: the bounded
    approximate matcher."""
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    stride = _cap_for(bs)
    out = np.empty(nblocks * stride, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    flags = np.ones(nblocks, dtype=np.uint8)
    fast_depth = depth if (parse == "fast" and (fmt == 0 or lz)) else 0
    rc = _check(library().sqz_blocks_compress(
        _u8(_src(data)), n, fmt, win_bits, blk_bits, int(lz), nthreads,
        int(warm), fast_depth, _u8(out), stride, _i64p(sizes), _u8(flags)))
    assert rc == nblocks
    payloads = [out[b * stride:b * stride + int(sizes[b])].tobytes()
                for b in range(nblocks)]
    if warm:
        return payloads, [bool(f) for f in flags]
    return payloads


def blocks_decompress(payloads: List[bytes], total_size: int, fmt: int,
                      blk_bits: int, nthreads: int = 0, fresh_mask=None,
                      win_bits: int = 15) -> bytes:
    """The concatenated decoded blocks of a container's payloads.
    ``fresh_mask`` (list of bool, sqzt v2): per-block fresh/warm choice;
    None = cold container. ``win_bits`` sizes the warm shared
    dictionary."""
    warm = fresh_mask is not None
    if warm and len(fresh_mask) != len(payloads):
        raise ValueError("fresh mask must cover every block "
                         "(native reads one flag per block)")
    fl = (np.asarray([1 if f else 0 for f in fresh_mask], dtype=np.uint8)
          if warm else None)
    flat = b"".join(payloads)
    offsets = np.zeros(len(payloads), dtype=np.int64)
    sizes = np.array([len(p) for p in payloads], dtype=np.int64)
    if len(payloads) > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    out = np.empty(max(total_size, 1), dtype=np.uint8)
    rc = _check(library().sqz_blocks_decompress(
        _u8(_src(flat)), _i64p(offsets), _i64p(sizes), len(payloads), fmt,
        blk_bits, win_bits, nthreads, int(warm), _opt(_u8, fl), _u8(out),
        total_size))
    assert rc == total_size
    return out[:total_size].tobytes()


def assemble_blocks(tok: np.ndarray, lit: np.ndarray, mrec: np.ndarray,
                    ntok: np.ndarray, sizes: np.ndarray, out_stride: int,
                    nthreads: int = 0, dictionary: bytes = b"") -> np.ndarray:
    """Reconstruct decode-kernel record streams: [B, *] row-major arrays
    (tok u32 words, lit u8 bytes, mrec u32 records) -> [B, out_stride] u8.
    ``dictionary``: the shared warm preset history match records may reach
    into (FORMAT.md §3.1)."""
    B = tok.shape[0]
    tok = np.ascontiguousarray(tok, dtype=np.uint32)
    lit = np.ascontiguousarray(lit, dtype=np.uint8)
    mrec = np.ascontiguousarray(mrec, dtype=np.uint32)
    nt = np.ascontiguousarray(ntok, dtype=np.int64)
    sz = np.ascontiguousarray(sizes, dtype=np.int64)
    out = np.zeros((B, out_stride), dtype=np.uint8)
    d, dn = _dict_in(dictionary)
    _check(library().sqz_assemble_blocks(
        _u32p(tok), tok.shape[1], _u8(lit), lit.shape[1], _u32p(mrec),
        mrec.shape[1], _i64p(nt), _i64p(sz), B, nthreads, _opt(_u8, d), dn,
        _u8(out), out_stride))
    return out


def sqz4_plan_pack(data: bytes, window: int, blk_bits: int, lz: bool,
                   lanes: int, tp_cap: int, nthreads: int = 0,
                   warm: bool = False, paired: bool = False):
    """Tokenize + expand + pack the encoder op streams in one threaded
    pass (exact parse). Returns (m_words, s_words [G, tp_cap//4, lanes]
    u32, max_ops[, seed]). ``warm`` (sqzt v2): blocks 1+ tokenize against
    block 0's tail dictionary, and the seed (u32[610]) holds block 0's
    final rescaled model state. ``paired``: alignment pads for the fused
    pair grammar."""
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    G = -(-nblocks // lanes)
    tp_rows = tp_cap // 4
    m_words = np.full((G, tp_rows, lanes), 0xFFFFFFFF, dtype=np.uint32)
    s_words = np.zeros((G, tp_rows, lanes), dtype=np.uint32)
    counts = np.zeros(nblocks, dtype=np.int64)
    seed = np.zeros(SEED4_WORDS, dtype=np.uint32) if warm else None
    mx = _check(library().sqz4_plan_pack(
        _u8(_src(data)), n, window, blk_bits, int(lz), lanes, tp_cap,
        nthreads, int(warm), int(paired), _opt(_u32p, seed), _u32p(m_words),
        _u32p(s_words), _i64p(counts)))
    return (m_words, s_words, mx, seed) if warm else (m_words, s_words, mx)


def sqz4_fast_plan(data: bytes, window: int, blk_bits: int, lz: bool,
                   tp_cap: int, nthreads: int = 0, warm: bool = False,
                   paired: bool = False, depth: int = 32):
    """Fast approximate planning pass (bounded match search) with
    contiguous per-block op emission. Returns (m8, s8 [nblocks, tp_cap]
    u8, max_ops[, seed]), ``warm`` as in ``sqz4_plan_pack``. Streams are
    spec-valid sqz4 but not byte-identical to the exact parse."""
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    m8 = np.full((nblocks, tp_cap), 255, dtype=np.uint8)
    s8 = np.zeros((nblocks, tp_cap), dtype=np.uint8)
    counts = np.zeros(nblocks, dtype=np.int64)
    seed = np.zeros(SEED4_WORDS, dtype=np.uint32) if warm else None
    mx = _check(library().sqz4_fast_plan(
        _u8(_src(data)), n, window, blk_bits, int(lz), tp_cap, nthreads,
        int(warm), int(paired), depth, _opt(_u32p, seed), _u8(m8), _u8(s8),
        _i64p(counts)))
    return (m8, s8, mx, seed) if warm else (m8, s8, mx)


def sqz4_tok_plan(data: bytes, window: int, blk_bits: int, lz: bool,
                  tok_cap: int, lit_cap: int, nthreads: int = 0,
                  depth: int = 32):
    """Token-level fast planning for the token-input encoder: one u32
    token per parse decision + a dense literal byte stream.

    Returns (toks [nblocks, tok_cap] u32, lits [nblocks, lit_cap] u8,
    counts [nblocks, 3] i64 (n_tok, n_lit, n_pairs), max_pairs). A block
    that exceeds the caps gets counts[b, 2] == -1 (and does not contribute
    to max_pairs); callers route those blocks through the op-stream
    encoder."""
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    toks = np.zeros((nblocks, tok_cap), dtype=np.uint32)
    lits = np.zeros((nblocks, lit_cap), dtype=np.uint8)
    counts = np.zeros((nblocks, 3), dtype=np.int64)
    mx = _check(library().sqz4_tok_plan(
        _u8(_src(data)), n, window, blk_bits, int(lz), tok_cap, lit_cap,
        nthreads, depth, _u32p(toks), _u8(lits), _i64p(counts)))
    return toks, lits, counts, mx


def sqz4_pack_payloads(payloads, lanes: int, pw: int,
                       nthreads: int = 0) -> np.ndarray:
    """Pack block payloads into the decode kernel's [G, pw, lanes] words."""
    nblocks = len(payloads)
    G = -(-nblocks // lanes)
    sizes = np.asarray([len(p) for p in payloads], dtype=np.int64)
    offsets = np.zeros(nblocks, dtype=np.int64)
    if nblocks > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    words = np.zeros((G, pw, lanes), dtype=np.uint32)
    _check(library().sqz4_pack_payloads(
        _u8(_src(b"".join(payloads))), _i64p(offsets), _i64p(sizes),
        nblocks, lanes, pw, nthreads, _u32p(words)))
    return words


def squeeze_plan_pack(data: bytes, win_bits: int, blk_bits: int,
                      lanes: int, tw_cap: int, nthreads: int = 0,
                      warm: bool = False, parse: str = "exact",
                      depth: int = 32):
    """Adaptive-Huffman encode per block, recording the bitstream writes
    in the bit-packer's [G, tw_cap, lanes] u32 layout (one record a write:
    bit count in bits 25 and up, the value bit-reversed below; 0 = pad).
    Returns (words, max_writes). ``warm``: sqzt v2 tree seeding and shared
    dictionary for blocks 1+; ``parse="fast"``: the bounded approximate
    matcher. The array is zero-allocated (its untouched pages stay
    unmapped), so a large ``tw_cap`` costs only the rows written."""
    n = len(data)
    bs = 1 << blk_bits
    nblocks = max(1, (n + bs - 1) // bs)
    G = -(-nblocks // lanes)
    words = np.zeros((G, tw_cap, lanes), dtype=np.uint32)
    mx = _check(library().squeeze_plan_pack(
        _u8(_src(data)), n, win_bits, blk_bits, lanes, tw_cap, nthreads,
        int(warm), depth if parse == "fast" else 0, _u32p(words)))
    return words, mx


def fnv1a64(data: bytes) -> int:
    return int(library().sqz_fnv1a64(_u8(_src(data)), len(data)))
