"""The control of each cell's comparison: the reference put in the
program's place with one of the configuration's guarantees broken, the
shortcut that would tempt a later change. Its outputs go where the
cell's entry keeps a unit's outputs, and the entry's own check judges
them, as it judges the program's:

  ecoli.collect  recruits without the low-mapq pass around the
                 discordant mates (every read the rules recruit,
                 broken): recruits.npz, both_unmapped.npz and the gap
                 FASTQs written from them
  chr14.step     block 4 as a banded alignment, |i - j| <= 64 (each
                 flank score the local alignment's, broken)

    python3 portbench/harness/control.py --workload <cell> --seeds 1 2 3

prints, a seed, the numbers the cell's check reads for the control's
outputs beside their limits, and whether the run would be correct, at
the cell's own size, on the card where there is one.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

BAND = 64


def entry_for(cell: str, seed: int, device, scale=None):
    """The cell's entry on a run at `seed` that never starts the
    program."""
    from portbench.harness import bench
    run = bench.Run(cell, seed, 0, 0, device, scale)
    return importlib.import_module(
        f"portbench.entries.{run.workload['entry']}").Entry(run)


def collect_control(ent) -> None:
    """The control's Collect outputs, kept as a unit's."""
    from portbench.entries.cli_chain import reference_recruits
    from portbench.reference import recruit
    ent.make_files()
    sc = ent.scenario
    rec, names = reference_recruits(ent.run.config, sc, low_mapq_pass=False)
    dest = os.path.join(ent.root, "kept", "control")
    os.makedirs(dest)
    np.savez(os.path.join(dest, "recruits.npz"), **rec)
    bu = np.array(sorted(recruit.both_unmapped(sc["libraries"])),
                  np.int64).reshape(-1, 3)
    np.savez(os.path.join(dest, "both_unmapped.npz"), lib=bu[:, 0],
             side=bu[:, 1], row=bu[:, 2])
    if ent.traffic.get("parity_files"):
        for sub, hq in (("gap_reads", False),
                        ("gap_reads_high_quality", True)):
            folder = os.path.join(dest, "merged", sub)
            os.makedirs(folder)
            for name, text in recruit.gap_fastqs(
                    rec, sc["libraries"], names, hq).items():
                with open(os.path.join(folder, name), "wb") as fh:
                    fh.write(text)
    ent.kept = [dest]


def step_control(ent) -> None:
    """The control's outputs of the batches a check compares, kept as
    the window's steps."""
    from portbench.entries.step import make_batches, step_params
    from portbench.reference import step as ref
    cfg = ent.cfg
    ent.batches = make_batches(cfg, ent.run.seed)
    n = ent.run.workload["traffic"]["checked_steps"]
    rng = np.random.default_rng(np.random.SeedSequence([ent.run.seed,
                                                        1 << 21]))
    for b in sorted(rng.choice(len(ent.batches), n, replace=False)):
        dims_np, args = ent.batches[b]
        out, known = ref.reference_outputs(
            args, ent.ref_dims(b), step_params(cfg), ent.run.device,
            band=BAND)
        ent.kept.append((b, out))
        ent.known[b] = known
        ent.records.append({})


def readings(cell: str, seed: int, device, scale=None) -> dict:
    """The cell's check of the control's outputs: {"checks": {name:
    [value, limit]}, "correct": bool}."""
    ent = entry_for(cell, seed, device, scale)
    (step_control if ent.run.workload["entry"] == "step"
     else collect_control)(ent)
    checks, _n, _failed = ent.check()
    return {"checks": {n: [v, lim] for n, v, lim in checks},
            "correct": all(v <= lim for _n, v, lim in checks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/harness/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t = time.time()
        got = readings(args.workload, seed, device)
        print(json.dumps({"control": args.workload, "seed": seed,
                          "device": str(device), **got,
                          "seconds": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
