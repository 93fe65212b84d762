"""The control of `ecoli.assembly`'s comparison: the reference put in the
program's place with one of the configuration's guarantees broken, the
"fill everything" shortcut that would tempt a later change. It fills
every gap with its planted bases, the open ones too (no open gap
filled, broken), and writes those picks where the entry keeps a unit's
outputs; the entry's own check judges them, as it judges the program's.

    python3 portbench/harness/control_assembly.py --seeds 1 2 3

prints, a seed, the numbers the cell's check reads for the control's
picks beside their limits, and whether the run would be correct, at
the cell's own size (the files are made as a run makes them; the
program is not started).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

CELL = "ecoli.assembly"


def assembly_control(ent, fill_open: bool = True) -> None:
    """The reference's picks, with the open gaps filled where
    `fill_open`, kept as the entry's one unit."""
    from portbench.reference import assembly as ref
    ent.make_files()
    dest = os.path.join(ent.root, "kept", "control")
    os.makedirs(dest)
    ref.write_fasta(os.path.join(dest, "picked_seqs.fa"), ref.truth_picks(
        ent.scenario, ent.run.config["parameters"], fill_open))
    ent.kept = [dest]


def readings(seed: int, device, scale=None, fill_open: bool = True) -> dict:
    """The cell's check of the control's picks: {"checks": {name:
    [value, limit]}, "correct": bool}."""
    from portbench.harness.control import entry_for
    ent = entry_for(CELL, seed, device, scale)
    assembly_control(ent, fill_open)
    checks, _n, _failed = ent.check()
    return {"checks": {n: [v, lim] for n, v, lim in checks},
            "correct": all(v <= lim for _n, v, lim in checks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/harness/control_assembly.py")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t = time.time()
        got = readings(seed, device)
        print(json.dumps({"control": CELL, "seed": seed,
                          "device": str(device), **got,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
