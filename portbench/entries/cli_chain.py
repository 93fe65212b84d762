"""A stage of the finisher's path through the program's CLI, in this
process: `cli.main(["-c", <command>, "-g", config.json, "--force",
...])` a unit, on one workspace.

Set-up writes the configuration's draft, BAMs and FASTQs under TMPDIR
from the seed (`traffic/genome_files.py`), and the CLI's JSON config
(GAPPadder's configuration.json layout) beside them; it runs Preprocess
once; then one unit warms up. After each unit the harness moves the
unit's outputs aside, so that the next unit writes them anew and every
unit's files can be held to the last one's, and the last one's to the
reference.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile
import time

import numpy as np

# the outputs of a command, moved aside after each unit
OUTPUTS = {"Collect": ("recruits.npz", "both_unmapped.npz", "merged")}
# host functions whose ranges label the traced unit's idle time
RANGES = (("pipeline.collect", "run_collect"),
          ("pipeline.collect", "collect_library"))


def sort_info(a, kw):
    """The planes a sort call moves, as (numel, itemsize); None for a
    call on the host."""
    ops = a[0] if a else kw["ops"]
    if not ops[0].is_cuda:
        return None
    return [(x.numel(), x.element_size()) for x in ops]


def sw_info(a, kw):
    """An SW call's query and target lengths (read after the traced
    section)."""
    return (a[1], a[3])


HAND = (("ops.psort", "bitonic_sort", "sort", sort_info),)


def cli_config(cfg: dict, sc: dict, workdir: str) -> dict:
    """The CLI's JSON config for the scenario: GAPPadder's
    configuration.json with the scenario's files."""
    kmers: list = []
    for k, sub in cfg["kmers"]:
        if not kmers or kmers[-1]["k"] != k:
            kmers.append({"k": k, "k_velvet": []})
        kmers[-1]["k_velvet"].append({"k": sub})
    return {
        "draft_genome": {"fa": sc["draft"]},
        "alignments": [{"bam": lib["bam"], "is": lib["insert"],
                        "std": lib["std"]} for lib in sc["libraries"]],
        "raw_reads": [{"left": lib["left"], "right": lib["right"]}
                      for lib in sc["libraries"]],
        "kmer_length": kmers,
        "parameters": dict(cfg["parameters"], working_folder=workdir)}


def same_outputs(a: str, b: str) -> bool:
    """Two units' outputs hold the same files with the same contents:
    .npz files array by array, every other file byte for byte."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    names = files(a)
    if names != files(b):
        return False
    for nm in names:
        pa, pb = os.path.join(a, nm), os.path.join(b, nm)
        if nm.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                if sorted(za.files) != sorted(zb.files) or not all(
                        np.array_equal(za[k], zb[k]) for k in za.files):
                    return False
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                if fa.read() != fb.read():
                    return False
    return True


class Entry:
    def __init__(self, run):
        self.run = run
        self.traffic = run.workload["traffic"]
        self.command = self.traffic["command"]
        self.records: list = []
        self.kept: list = []
        self.traced_count = 1

    def setup(self):
        r = self.run
        path = self.make_files()
        r.part("simulate_and_write")
        from gappadder_tpu_torch import cli
        self.cli = cli
        dev = [] if r.device.type == "cuda" else ["--device", "cpu"]
        self.argv = ["-c", self.command, "-g", path, "--force"] + \
            (["--parity-files"] if self.traffic.get("parity_files") else []) \
            + dev
        self._cli(["-c", "Preprocess", "-g", path, "--force"] + dev)
        r.part("preprocess")
        self._unit("warm_up")
        r.part("warm_up")

    def make_files(self) -> str:
        """The scenario's files and the CLI's config under TMPDIR;
        returns the config's path."""
        from portbench.traffic import genome_files
        self.root = tempfile.mkdtemp(prefix="portbench-")
        atexit.register(shutil.rmtree, self.root, ignore_errors=True)
        self.scenario = genome_files.write_scenario(
            os.path.join(self.root, "scenario"), self.run.seed,
            **self.run.config["scenario"])
        self.work = os.path.join(self.root, "work")
        path = os.path.join(self.root, "config.json")
        with open(path, "w") as fh:
            json.dump(cli_config(self.run.config, self.scenario, self.work),
                      fh)
        return path

    def _cli(self, argv):
        rc = self.cli.main(argv)
        if rc:
            raise RuntimeError(f"cli.main({argv}) returned {rc}")

    def _unit(self, tag):
        t0 = time.perf_counter()
        self._cli(self.argv)
        sync(self.run.device)
        wall = time.perf_counter() - t0
        dest = os.path.join(self.root, "kept", tag)
        os.makedirs(dest)
        # what the unit wrote (a unit that wrote nothing leaves nothing)
        for name in OUTPUTS[self.command]:
            if os.path.exists(os.path.join(self.work, name)):
                shutil.move(os.path.join(self.work, name), dest)
        self.kept.append(dest)
        return {"wall_s": wall}

    def unit(self):
        self.records.append(self._unit(str(len(self.records))))
        self.run.log(unit=len(self.records), **self.records[-1])

    def unit_records(self):
        return self.records

    def trace_targets(self):
        return HAND + tuple((m, a, f"{m.split('.')[-1]}.{a}", None)
                            for m, a in RANGES)

    def traced_units(self):
        self._unit("traced")

    def end_to_end(self, units, window_s):
        recs = sum(len(lib["records"]["flag"])
                   for lib in self.scenario["libraries"])
        return {"collect_records_per_s": recs * len(units) / window_s}

    def release(self):
        self.cli = None

    def check(self):
        """The last window unit's outputs against the reference, and
        every unit's (warm-up and traced ones too) against the last's.
        Returns (checks, units compared, units wrong)."""
        from portbench.reference import recruit as ref_rec
        sc = self.scenario
        last = self.kept[-2] if self.kept[-1].endswith("traced") \
            else self.kept[-1]
        others = sum(not same_outputs(k, last) for k in self.kept
                     if k != last)
        rec, names = reference_recruits(self.run.config, sc)
        checks = [("recruits", _recruits_off(
                       os.path.join(last, "recruits.npz"), rec), 0),
                  ("both_unmapped", _bu_off(
                       os.path.join(last, "both_unmapped.npz"),
                       ref_rec.both_unmapped(sc["libraries"])), 0)]
        if self.traffic.get("parity_files"):
            for sub, hq in (("gap_reads", False),
                            ("gap_reads_high_quality", True)):
                want = ref_rec.gap_fastqs(rec, sc["libraries"], names, hq)
                checks.append((sub, _files_off(
                    os.path.join(last, "merged", sub), want), 0))
        checks.append(("units_unlike_last", others, 0))
        wrong = any(v > lim for n, v, lim in checks
                    if n != "units_unlike_last")
        failed = len(self.kept) if wrong else others
        self.run.log(files_written_bytes=_tree_bytes(self.root))
        shutil.rmtree(self.root, ignore_errors=True)
        return checks, len(self.kept), failed


def reference_recruits(cfg: dict, sc: dict, low_mapq_pass: bool = True):
    """The reference's recruits of the scenario (every library), and the
    gaps' FASTQ names ('<scaffold>_<number>')."""
    from portbench.reference import chain as ref_chain
    from portbench.reference import recruit as ref_rec
    p = cfg["parameters"]
    table = ref_chain.gap_table(sc["draft_codes"], p["min_gap_size"])
    gaps = {"scaffold": table["scaffold"], "start": table["local_start"],
            "end": table["local_end"]}
    rec = ref_rec.recruits(
        sc["libraries"], gaps, clip_dist=p["clip_dist"],
        anchor_mapq=p["anchor_mapq"], hq_mapq=p["high_quality_mapq"],
        long_insert_threshold=p["long_insert_threshold"],
        low_mapq_pass=low_mapq_pass)
    names = [f"{s}_{n}" for s, n in zip(table["scaffold"], table["number"])]
    return rec, names


def sync(device):
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


MISSING = 1 << 30     # the count a missing output file reads


def _recruits_off(path, want: dict) -> int:
    """Recruit rows (gap, side, lib, row, hq) in one table and not the
    other."""
    cols = ("gap", "side", "lib", "row", "hq")
    if not os.path.exists(path):
        return MISSING
    with np.load(path) as z:
        got = set(zip(*(z[k].astype(np.int64).tolist() for k in cols)))
    ref = set(zip(*(want[k].astype(np.int64).tolist() for k in cols)))
    return len(got ^ ref)


def _bu_off(path, want: set) -> int:
    if not os.path.exists(path):
        return MISSING
    with np.load(path) as z:
        got = set(zip(*(z[k].astype(np.int64).tolist()
                        for k in ("lib", "side", "row"))))
    return len(got ^ want)


def _tree_bytes(root) -> int:
    """Bytes of the files under `root`: what the run wrote there."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def _files_off(folder, want: dict) -> int:
    """Files of `folder` missing, extra or unlike `want` ({name: bytes})."""
    have = set(os.listdir(folder)) if os.path.isdir(folder) else set()
    off = len(have ^ set(want))
    for name in have & set(want):
        with open(os.path.join(folder, name), "rb") as fh:
            off += fh.read() != want[name]
    return off
