"""Readings of a cell's compared numbers over many seeds in one process:
the program's (the lower readings of the limits) or the control's (the
configuration's plain reference computed in bfloat16 in the program's
place, which the comparison has to refuse).

    python3 -m benchmark.calibrate --workload NAME --system program \\
        --seeds 1,2,3 --seconds S

Each seed is one run of ``run.run`` (set-up, a window of S seconds, the
comparison) on the card; one JSON line a seed with every compared number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import registry, run
from .program import Program
from .reference.system import ReferenceSystem


def system_for(cell, which: str):
    if which == "program":
        return Program(cell.config)
    if which == "control":
        return ReferenceSystem(cell.config, cell.reference(), torch.bfloat16)
    raise ValueError(f"--system {which!r}: program or control")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate reads the card; none here", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = registry.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        system = system_for(cell, args.system)
        try:
            result = run.run(cell, seed, args.seconds, False, "cuda:0",
                             system=system)
            line = {"seed": seed, "system": args.system,
                    "correct": result["correct"],
                    "attempted": result["attempted"],
                    "failed": result["failed"],
                    "numbers": {k: c["value"]
                                for k, c in result["checks"].items()}}
        except Exception as e:  # noqa: BLE001 -- a crash is a reading too
            line = {"seed": seed, "system": args.system,
                    "error": f"{type(e).__name__}: {e}"[:400]}
        print(json.dumps(line), flush=True)
        del system
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
