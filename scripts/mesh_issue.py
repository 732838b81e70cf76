#!/usr/bin/env python3
"""How a process should issue the shards of a mesh of virtual shards on
one CUDA card: the package's way (the shards of one device one after
another from one host thread, each on its own stream) against a host
thread a shard, in turns.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/mesh_issue.py

On the resident mix of ``chip_smoke.py`` phase 12 (512 blocks of 64 KiB
of ``synthetic.resident_mix(seed=1)``, uploaded once), for meshes of 1,
2 and 4 virtual shards of ``cuda:0``, times ``compress_resident(mesh=)``
in mode lz and ``decompress_resident(mesh=)`` (auto) of the rle
container, each policy twice in the order package, thread, thread,
package; every output is checked against the mesh-less one. Prints one
line per run and, last, a JSON object of the walls (s) and the card's
name and power limit.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = (1, 2, 4)


def thread_per_shard(mesh, work):
    """``shard._on_shards`` with a host thread a shard (single process:
    no rank agreement)."""
    import torch
    for d, s in zip(mesh.devices, mesh.streams):
        s.wait_stream(torch.cuda.current_stream(d))

    def one(i):
        dev, stream = mesh.devices[i], mesh.streams[i]
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            out = work(i, dev)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    with ThreadPoolExecutor(mesh.local_size) as ex:
        futures = [ex.submit(one, i) for i in range(mesh.local_size)]
    results = [f.result() for f in futures]
    for (_out, done), d in zip(results, mesh.devices):
        torch.cuda.current_stream(d).wait_event(done)
    return [out for out, _ in results]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_issue: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import sqz_tpu_torch
    from sqz_tpu_torch.parallel import shard
    from sqz_tpu_torch.parallel.mesh import make_mesh
    from sqz_tpu_torch.utils import synthetic
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    data = synthetic.resident_mix(512, 16, seed=1)
    x = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    want_lz = sqz_tpu_torch.compress_resident(x, mode="lz")
    rle = sqz_tpu_torch.compress_resident(x, mode="rle")
    package = shard._on_shards
    walls = {}
    for n in SHARDS:
        mesh = make_mesh(n, devices=[dev] * n)
        for policy in ("package", "thread", "thread", "package"):
            shard._on_shards = package if policy == "package" \
                else thread_per_shard
            try:
                t = time.perf_counter()
                blob = sqz_tpu_torch.compress_resident(x, mode="lz",
                                                       mesh=mesh)
                enc = time.perf_counter() - t
                t = time.perf_counter()
                out = sqz_tpu_torch.decompress_resident(rle, mesh=mesh)
                torch.cuda.synchronize()
                dec = time.perf_counter() - t
            finally:
                shard._on_shards = package
            if blob != want_lz or out.cpu().numpy().tobytes() != data:
                raise AssertionError(f"{policy}, {n} shards: the output "
                                     f"differs from the mesh-less one")
            walls.setdefault(f"{n}_{policy}", []).append(
                {"enc_lz_s": enc, "dec_rle_s": dec})
            print(f"{n} shards, {policy}: enc lz {enc:.3f} s, dec rle "
                  f"{dec:.3f} s ({card})", flush=True)
    print(json.dumps({"card": card, "walls": walls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
