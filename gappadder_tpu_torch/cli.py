"""CLI of the PyTorch/CUDA port (counterpart of gappadder_tpu/cli.py).

    python -m gappadder_tpu_torch.cli -c {Clean,All,Preprocess,Collect,
        Assembly,Patch,Evaluate} -g config.json [--device cpu]
    gappadder-tpu-torch -c All -g config.json

The same commands, JSON config, flags, printed lines and workspace
files as the JAX CLI, from one process on one device: the card unless
`--device cpu` is given. Without a card and without `--device cpu` it
stops at once; it never carries on on the CPU. Multi-process runs
(`--coordinator`) are refused with exit code 2: they wait for the
multi-GPU port. `--trace DIR` writes a `torch.profiler` Chrome trace of
the stages to DIR/trace.json.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from . import entry_device


def main(argv=None):
    p = argparse.ArgumentParser(prog="gappadder-tpu-torch",
                                description="gap closing on one GPU")
    p.add_argument("-c", "--command", required=True,
                   choices=["Clean", "All", "Preprocess", "Collect",
                            "Assembly", "Patch", "Evaluate"])
    p.add_argument("-g", "--config", required=True)
    p.add_argument("--parity-files", action="store_true",
                   help="also write reference-layout text/FASTA files")
    p.add_argument("--finished", metavar="FASTA", default=None,
                   help="finished genome for Evaluate (truth extraction)")
    p.add_argument("--force", action="store_true",
                   help="re-run stages even when the workspace manifest "
                        "marks them done for this config")
    p.add_argument("--trace", metavar="LOGDIR", default=None,
                   help="write a torch.profiler trace (LOGDIR/trace.json)")
    p.add_argument("--device", default="cuda",
                   help="torch device the stages run on (default: the "
                        "card; 'cpu' runs the plain versions of the "
                        "kernels on the CPU)")
    p.add_argument("--coordinator", default=os.environ.get(
        "GAPPADDER_DIST_COORD"), metavar="HOST:PORT",
        help="multi-process coordinator: not available in the port yet")
    p.add_argument("--num-processes", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_NPROCS", "0")))
    p.add_argument("--process-id", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_PROCID", "0")))
    p.add_argument("--cpu-devices", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_CPU_DEVICES", "0")))
    args = p.parse_args(argv)

    if args.coordinator:
        print("gappadder-tpu-torch: multi-process runs (--coordinator) are "
              "not ported yet; they wait for the multi-GPU port (ROADMAP "
              "Queue 1, multi-GPU). Run without --coordinator on one "
              "device.", file=sys.stderr)
        return 2
    device = entry_device(args.device, "gappadder-tpu-torch")

    from .config import load_config
    from .io import fasta
    from .pipeline import collect, patch, preprocess, run
    from .pipeline.workspace import Workspace, config_hash
    from .utils.meters import GLOBAL as METERS, device_trace

    cfg = load_config(args.config)
    ws = Workspace(cfg.workdir)
    cmd = args.command
    chash = config_hash(cfg)

    if cmd in ("Clean",):
        shutil.rmtree(cfg.workdir, ignore_errors=True)
        return 0

    def wants(stage, name):
        if cmd not in (stage, "All"):
            return False
        if not args.force and ws.is_done(name, chash):
            print(f"[{name}] up-to-date (use --force to re-run)")
            return False
        return True

    genome = fasta.read_fasta(cfg.draft_genome)
    with device_trace(args.trace, device):
        if wants("Preprocess", "preprocess"):
            with METERS.stage("preprocess") as m:
                table = preprocess.run_preprocess(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files, device=device)
                m["gaps"] = len(table["start"])
            print(f"[preprocess] {m['gaps']} gaps")
        if wants("Collect", "collect"):
            with METERS.stage("collect") as m:
                rec, _ = collect.run_collect(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files, device=device)
                m["recruits"] = len(rec["gap"])
            print(f"[collect] {m['recruits']} recruited read assignments")
        if wants("Assembly", "assembly"):
            with METERS.stage("assembly") as m:
                fills, exts, _ = run.run_assembly_and_pick(
                    cfg, ws, genome=genome, device=device)
                m["closed"] = len(fills)
                m["extended"] = len(exts)
            print(f"[assembly] {m['closed']} gaps closed, "
                  f"{m['extended']} extended -> "
                  f"{ws.path('picked_seqs.fa')}")
        if cmd == "Evaluate":
            if not args.finished:
                print("Evaluate needs --finished <genome.fa>",
                      file=sys.stderr)
                return 2
            with METERS.stage("evaluate"):
                _evaluate(cfg, ws, args.finished, device)
        if cmd in ("Patch", "All"):
            with METERS.stage("patch") as m:
                m["filled"] = patch.run_patch(cfg, ws, genome=genome)
            print(f"[patch] wrote {ws.path('filled_scaffolds.fa')} "
                  f"({m['filled']} gaps filled)")
    METERS.dump(ws.path("metrics.json"))
    if cfg.verbose:
        print(METERS.report())
    return 0


def _evaluate(cfg, ws, finished_path, device):
    """statistic_rslt.py equivalent: extract gap truths from a finished
    genome and score the picked fills; writes hit_list.txt and
    closed_gap_length.txt in the reference's spirit."""
    from .io import fasta
    from .pipeline.patch import fills_from_picked
    from .pipeline.preprocess import gap_ids
    from .tools import evaluate as ev
    gaps = ws.load_arrays("gaps")
    finished = fasta.read_fasta(finished_path)
    truths = ev.extract_true_gap_seqs(
        gaps, finished, gaps["flank_left"], gaps["flank_right"],
        (gaps["flank_left_len"], gaps["flank_right_len"]), device=device)
    fills = fills_from_picked(ws, gaps)
    stats = ev.closure_stats(fills, truths, device=device)
    ids = gap_ids(gaps)
    with open(ws.path("hit_list.txt"), "w") as fh:
        for g in stats["hit_list"]:
            fh.write(f"{ids[g]}\n")
    with open(ws.path("closed_gap_length.txt"), "w") as fh:
        for ln in stats["closed_lengths"]:
            fh.write(f"{ln}\n")
    print(f"[evaluate] {stats['n_closed']}/{len(fills)} picked fills "
          f"close their gap (truths for {len(truths)}/{len(ids)} gaps) "
          f"-> {ws.path('hit_list.txt')}")


if __name__ == "__main__":
    sys.exit(main())
