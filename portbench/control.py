"""The controls of the check, and the faults it has to catch.

A control puts in the program's place the step that would tempt a later
change, and has to come out not correct; each entry module holds its
own as ``Control`` (``portbench/entries/<entry>.py``):

- ``load_pytree``: the reference's restore in the precision below the
  configuration's float32, bfloat16 (every float leaf rounded to it);
- ``save_pytree``: the program's save of the state rounded to bfloat16;
- ``compress``: the program's own path without the checksum that the
  configuration guarantees (``checksum=False``);
- ``decompress``: the program's decode with the checksum's verification
  left out (flag and field taken off the container first).

``faulty`` breaks a call's output where it is produced, by each of
``faults.FAULTS``. One chip: no exchange between chips to leave out.

On the card, at the cell's own size, one process for all seeds:

    python3 -m portbench.control --workload <cell> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import entries, harness


def control(name: str):
    return entries.find(name, "Control")


def faulty(fault: str):
    """A finder of entries (as ``harness.run`` takes one) whose calls'
    outputs are broken by ``fault``."""

    def find(name: str):
        base = entries.find(name)

        class Faulty(base):
            def call(self, stats):
                return self.broken(super().call(stats), fault)

        return Faulty

    return find


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        try:
            r = harness.run(args.workload, seed, args.seconds, False,
                            find=control)
        except harness.NoDevice as e:
            print(f"portbench.control: {e}", file=sys.stderr)
            return 2
        print(json.dumps(dict(seed=seed, correct=r["correct"],
                              checks=r["checks"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
