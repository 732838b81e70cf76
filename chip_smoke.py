#!/usr/bin/env python3
"""Drive the PyTorch port's sqz4 main path once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: torch, card, nvcc, power limit;
  2. build: the native host runtime (make) and the CUDA kernels (nvcc),
     from the sources in the checkout;
  3. each kernel against its plain PyTorch version on the card, on the
     same inputs, first at 64 blocks of 1 KiB (a quick gate), then at the
     main path's shapes: outputs must be equal (tolerance 0, a lossless
     integer codec) and the payloads equal the native engine's;
  4. the main path at full size: 32 MiB of pseudo-text in 64 KiB blocks,
     compressed and decompressed through ``sqz_tpu_torch.compress`` /
     ``decompress`` on the card. The exact-parse container must equal the
     native engine's byte for byte; both parses must round-trip, and the
     native engine must decode the fast-parse container. Both kernels'
     launch counts over this run (and only this run) must be > 0;
  5. a corrupt payload byte must be rejected, naming its block.

The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SMALL_BLOCKS, SMALL_BITS = 64, 10
MAIN_BYTES, MAIN_BITS, MAIN_WIN_BITS = 32 << 20, 16, 15
CORRUPT_BLOCK = 100
REPS = 3


def log(*a):
    print(*a, flush=True)


def events_ms(fn, reps):
    """Best device time of ``reps`` calls of fn, by CUDA events."""
    import torch
    best = None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ms = a.elapsed_time(b)
        best = ms if best is None else min(best, ms)
    return best


def max_abs_err(xs, ys):
    import torch
    return max(int((x.view(torch.int32).to(torch.int64)
                    - y.view(torch.int32).to(torch.int64)).abs().max())
               for x, y in zip(xs, ys))


def probe():
    import torch
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)} count "
        f"{torch.cuda.device_count()}")
    from sqz_tpu_torch.ops import _build
    nv = subprocess.run([_build.nvcc_path(), "--version"],
                        capture_output=True, text=True, check=True)
    log("nvcc:", nv.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def build():
    t = time.perf_counter()
    make = subprocess.run(["make", "-B", "-C",
                           os.path.join(ROOT, "sqz_tpu", "native")],
                          capture_output=True, text=True)
    if make.returncode != 0:
        raise RuntimeError(f"native build failed:\n{make.stderr}")
    from sqz_tpu import native
    if not native.available():
        raise RuntimeError(f"native build failed: {native.build_error()}")
    t_native = time.perf_counter() - t
    from sqz_tpu_torch.ops import _build
    t = time.perf_counter()
    _build.build(force=True)
    _build.library()
    t_cuda = time.perf_counter() - t
    log(f"build: native {t_native:.1f} s, cuda {t_cuda:.1f} s")
    for line in (_build.BUILD_DIR / "nvcc.log").read_text().splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas:", line.strip())


def kernels_vs_plain(data, blk_bits, win_bits, lanes, reps):
    """Each kernel against its plain PyTorch version on the card, on the
    same inputs, at the shapes encode_data_full / decode_groups give them
    for ``data``: equal outputs (tolerance 0), the payloads equal the
    native engine's, the blocks restore. Returns per kernel (max_abs_err,
    kernel ms best of ``reps``, plain ms of one run)."""
    import torch
    from sqz_tpu import native
    from sqz_tpu_torch import convert
    from sqz_tpu_torch.ops import sqz4_cuda, sqz4_host as host, sqz4_ref
    dev = torch.device("cuda")
    bs = 1 << blk_bits
    nb = len(data) // bs
    mw, sw, mx = native.sqz4_plan_pack(data, 1 << win_bits, blk_bits, True,
                                       lanes, host.op_stream_cap(blk_bits))
    m, s = convert.encoder_inputs(mw, sw, -(-int(mx) // 4), dev)
    cw = host.cap_words_for(bs + 2048)
    enc = plain_vs_kernel(
        lambda: sqz4_cuda.encode_full(m, s, cw),
        lambda: sqz4_ref.encode_full_ref(m, s, cw), reps)
    words, lens = (convert.to_numpy(x) for x in enc[3])
    payloads = host.unpack_group_payloads(words, lens, nb)
    if payloads != native.blocks_compress(data, 1, win_bits, blk_bits):
        raise AssertionError("encoder payloads differ from native")

    plan = host.plan_decode_dispatch(nb, blk_bits, lanes=lanes)
    pw = min(plan["Pw"], host.payload_rows(max(map(len, payloads))))
    buf, meta = host.pack_decode_chunk(payloads, [bs] * nb, lanes,
                                       plan["G"], pw)
    pt, mt = convert.decoder_inputs(buf, meta, dev)
    args = (plan["t_max"], plan["lw"], plan["tw"], plan["mw"])
    dec = plain_vs_kernel(lambda: sqz4_cuda.decode(pt, mt, *args),
                          lambda: sqz4_ref.decode_ref(pt, mt, *args), reps)
    outs = host.postprocess_decode(*[convert.to_numpy(x) for x in dec[3]],
                                   payloads, [bs] * nb, bs)
    if b"".join(outs) != data:
        raise AssertionError("decoder kernel did not restore the blocks")
    shape = f"{nb} blocks x {bs} B"
    log(f"kernel vs plain at {shape}: encode {enc[1]:.3f} ms vs "
        f"{enc[2]:.1f} ms, decode {dec[1]:.3f} ms vs {dec[2]:.1f} ms, "
        f"max_abs_err {enc[0]} / {dec[0]}")
    return dict(enc=enc[:3], dec=dec[:3], shape=shape)


def plain_vs_kernel(kernel, plain, reps):
    """(max_abs_err, kernel ms, plain ms, kernel outputs); raises if the
    outputs differ."""
    import torch
    got = kernel()
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"kernel differs from its plain version "
                             f"(max_abs_err {err})")
    return err, events_ms(kernel, reps), plain_ms, got


def main_path():
    """Phase 4: the full-size main path through the public API."""
    import sqz_tpu
    import sqz_tpu_torch
    from sqz_tpu.utils import corpus
    from sqz_tpu_torch.ops import sqz4_cuda
    t = time.perf_counter()
    data = corpus.texty(MAIN_BYTES, seed=1)
    ref = sqz_tpu.compress(data, fmt="sqz4", engine="native", blocks=True,
                           blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS)
    log(f"input + native reference: {time.perf_counter() - t:.1f} s")
    kw = dict(fmt="sqz4", engine="torch", device="cuda", blocks=True,
              blk_bits=MAIN_BITS, win_bits=MAIN_WIN_BITS)

    sqz4_cuda.encode_full.launches = 0
    sqz4_cuda.decode.launches = 0
    t = time.perf_counter()
    blob = sqz_tpu_torch.compress(data, parse="exact", **kw)
    enc_s = time.perf_counter() - t
    t = time.perf_counter()
    out = sqz_tpu_torch.decompress(blob, engine="torch", device="cuda")
    dec_s = time.perf_counter() - t
    t = time.perf_counter()
    fblob = sqz_tpu_torch.compress(data, parse="fast", **kw)
    fenc_s = time.perf_counter() - t
    t = time.perf_counter()
    fout = sqz_tpu_torch.decompress(fblob, engine="torch", device="cuda")
    fdec_s = time.perf_counter() - t
    launches = {"sqz4_encode": sqz4_cuda.encode_full.launches,
                "sqz4_decode": sqz4_cuda.decode.launches}

    if blob != ref:
        raise AssertionError("exact-parse container differs from the "
                             "native engine's")
    if out != data or fout != data:
        raise AssertionError("round trip failed")
    if sqz_tpu.decompress(fblob, engine="native") != data:
        raise AssertionError("native engine cannot decode the fast-parse "
                             "container")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    mb = len(data) / 1e6
    log(f"main path, 32 MiB in 64 KiB blocks: exact enc {enc_s:.3f} s "
        f"({mb / enc_s:.1f} MB/s) dec {dec_s:.3f} s ({mb / dec_s:.1f} MB/s)"
        f" ratio {len(blob) / len(data):.4f}; fast enc {fenc_s:.3f} s "
        f"({mb / fenc_s:.1f} MB/s) dec {fdec_s:.3f} s "
        f"({mb / fdec_s:.1f} MB/s) ratio {len(fblob) / len(data):.4f}")
    log(f"launches over the main path: {launches}")
    return data, blob, launches, dict(
        exact_enc_MBps=mb / enc_s, exact_dec_MBps=mb / dec_s,
        fast_enc_MBps=mb / fenc_s, fast_dec_MBps=mb / fdec_s,
        exact_ratio=len(blob) / len(data), fast_ratio=len(fblob) / len(data))


def stage_times(data):
    """One run's host stage times of the exact encode and the decode."""
    from sqz_tpu_torch.ops import sqz4_cuda
    bs = 1 << MAIN_BITS
    enc_st, dec_st = {}, {}
    payloads = sqz4_cuda.encode_data_full(
        data, MAIN_BITS, 1 << MAIN_WIN_BITS, True, bs + 2048, parse="exact",
        stats=enc_st)
    sqz4_cuda.decode_groups(payloads, [bs] * len(payloads), MAIN_BITS,
                            stats=dec_st)
    log("stages (s): encode " + json.dumps(
        {k: round(v, 4) for k, v in enc_st.items()}) + " decode "
        + json.dumps({k: round(v, 4) for k, v in dec_st.items()}))


def corrupt_rejected(blob):
    """Phase 5: one flipped payload byte -> ValueError naming the block."""
    import sqz_tpu_torch
    from sqz_tpu.formats import container as sqzt
    code, win_bits, blk_bits, osize, payloads, csum, _f, _a = \
        sqzt.unpack(blob)
    p = bytearray(payloads[CORRUPT_BLOCK])
    p[len(p) // 2] ^= 0xFF
    payloads[CORRUPT_BLOCK] = bytes(p)
    bad = sqzt.pack(code, win_bits, blk_bits, osize, payloads, csum)
    try:
        sqz_tpu_torch.decompress(bad, engine="torch", device="cuda")
    except ValueError as e:
        if str(CORRUPT_BLOCK) not in str(e):
            raise AssertionError(f"rejection does not name block "
                                 f"{CORRUPT_BLOCK}: {e}") from e
        log(f"corrupt block {CORRUPT_BLOCK} rejected: {e}")
        return
    raise AssertionError("corrupt payload was not rejected")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import sqz_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the sqz_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    card = probe()
    build()
    from sqz_tpu.utils import corpus
    from sqz_tpu_torch.ops import sqz4_host
    kernels_vs_plain(corpus.texty(SMALL_BLOCKS << SMALL_BITS, seed=7),
                     SMALL_BITS, 10, SMALL_BLOCKS, 10)
    data, blob, launches, e2e = main_path()
    full = kernels_vs_plain(data, MAIN_BITS, MAIN_WIN_BITS, sqz4_host.LANES,
                            REPS)
    stage_times(data)
    corrupt_rejected(blob)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    pallas = "sqz_tpu/ops/sqz4_pallas.py"
    kernels = []
    for name, key, src, line in (
            ("sqz4_encode", "enc", "sqz4_encode.cu", 686),
            ("sqz4_decode", "dec", "sqz4_decode.cu", 1705)):
        err, ms, plain_ms = full[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sqz_tpu_torch/csrc/{src}",
            "replaces": f"{pallas}:{line}",
            "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "shape": full["shape"]})
    log(json.dumps({"card": card, **{k: round(v, 4) for k, v in e2e.items()}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
