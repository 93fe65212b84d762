"""CLI of the PyTorch/CUDA port (counterpart of gappadder_tpu/cli.py).

    python -m gappadder_tpu_torch.cli -c {Clean,All,Preprocess,Collect,
        Assembly,Patch,Evaluate} -g config.json [--device cpu]
    gappadder-tpu-torch -c All -g config.json

The same commands, JSON config, flags, printed lines and workspace
files as the JAX CLI, on the card unless `--device cpu` is given.
Without a card and without `--device cpu` it stops at once; it never
carries on on the CPU. `--trace DIR` writes a `torch.profiler` Chrome
trace of the stages to DIR/trace.json.

Multi-process SPMD runs, as the JAX CLI's:

    python -m gappadder_tpu_torch.cli -c All -g config.json \
        --coordinator HOST:PORT --num-processes N --process-id I \
        [--cpu-devices M]

(or the GAPPADDER_DIST_* environment variables). Every process runs the
whole CLI; `tpu.mesh_shape` shards the device stages over the
processes' shards (see parallel/mp.py): with `--cpu-devices M` each
process holds M CPU shards and the collectives go over gloo; on cards
each process drives cuda:(I % device_count), over NCCL when no two
processes share a card and over gloo when they do. The backend chosen
is printed. Process 0 writes the files and metrics.json, with barriers
at the stage boundaries.
"""

from __future__ import annotations

import argparse
import contextlib
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
        help="torch.distributed rendezvous (process 0 listens there); "
             "enables multi-process SPMD execution of the pipeline (see "
             "parallel/mp.py)")
    p.add_argument("--num-processes", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_NPROCS", "0")))
    p.add_argument("--process-id", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_PROCID", "0")))
    p.add_argument("--cpu-devices", type=int, default=int(os.environ.get(
        "GAPPADDER_DIST_CPU_DEVICES", "0")),
        help="with --coordinator: this many CPU shards a process, gloo "
             "collectives (the CPU path)")
    args = p.parse_args(argv)

    # distributed init comes before the pipeline imports, as the JAX
    # CLI's does
    from .parallel import mp
    if args.coordinator and not 0 <= args.process_id < args.num_processes:
        print(f"gappadder-tpu-torch: --process-id {args.process_id} is not "
              f"in [0, --num-processes {args.num_processes})",
              file=sys.stderr)
        return 2
    device = entry_device("cpu" if args.coordinator and args.cpu_devices
                          else args.device, "gappadder-tpu-torch")
    if args.coordinator:
        name = mp.init_distributed(args.coordinator, args.num_processes,
                                   args.process_id,
                                   local_cpu_devices=args.cpu_devices)
        print(f"[dist] process {args.process_id}/{args.num_processes} "
              f"backend {name} shards {len(mp.local_devices(device))}",
              flush=True)

    from .config import load_config
    from .io import fasta
    from .pipeline import collect, patch, preprocess, run
    from .pipeline.workspace import Workspace, config_hash
    from .utils import meters

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

    @contextlib.contextmanager
    def stage(name):
        """A CLI stage's span, which records at its end the card's
        allocated bytes and the process's peak so far."""
        with meters.span(name) as s:
            yield s
            meters.memory(s, device)

    # this call's spans, written to metrics.json at the end
    with meters.Meters() as metered, \
            meters.device_trace(args.trace, device):
        with meters.span("cli.read_draft"):
            genome = fasta.read_fasta(cfg.draft_genome)
        if wants("Preprocess", "preprocess"):
            with stage("preprocess") as s:
                table = preprocess.run_preprocess(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files, device=device)
                n_gaps = len(table["start"])
                s.add(gaps=n_gaps)
            print(f"[preprocess] {n_gaps} gaps")
            mp.barrier("preprocess")   # later stages read process 0's files
        if wants("Collect", "collect"):
            with stage("collect") as s:
                rec, _ = collect.run_collect(
                    cfg, ws, genome=genome,
                    write_parity_files=args.parity_files, device=device)
                s.add(recruits=len(rec["gap"]))
            print(f"[collect] {len(rec['gap'])} recruited read assignments")
            mp.barrier("collect")
        if wants("Assembly", "assembly"):
            with stage("assembly") as s:
                fills, exts, _ = run.run_assembly_and_pick(
                    cfg, ws, genome=genome, device=device)
                s.add(closed=len(fills), extended=len(exts))
            print(f"[assembly] {len(fills)} gaps closed, "
                  f"{len(exts)} extended -> "
                  f"{ws.path('picked_seqs.fa')}")
            mp.barrier("assembly")
        if cmd == "Evaluate":
            if not args.finished:
                print("Evaluate needs --finished <genome.fa>",
                      file=sys.stderr)
                return 2
            with stage("evaluate"):
                _evaluate(cfg, ws, args.finished, device)
        if cmd in ("Patch", "All"):
            with stage("patch") as s:
                filled = patch.run_patch(cfg, ws, genome=genome)
                s.add(filled=filled)
            print(f"[patch] wrote {ws.path('filled_scaffolds.fa')} "
                  f"({filled} gaps filled)")
            mp.barrier("patch")
    if mp.is_primary():
        metered.dump(ws.path("metrics.json"))
    if cfg.verbose:
        print(metered.report())
    return 0


def _evaluate(cfg, ws, finished_path, device):
    """statistic_rslt.py equivalent: extract gap truths from a finished
    genome and score the picked fills; writes hit_list.txt and
    closed_gap_length.txt in the reference's spirit."""
    from .io import fasta
    from .pipeline.patch import fills_from_picked
    from .pipeline.preprocess import gap_ids
    from .tools import evaluate as ev
    from .parallel import mp
    if not mp.is_primary():
        return
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
