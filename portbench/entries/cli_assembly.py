"""The Assembly stage through the program's CLI, in this process:
`cli.main(["-c", "Assembly", "-g", config.json, "--force"])` a unit, on
one workspace, as GAPPadder's `-c Assembly` runs it after Collect.

`cli_chain`'s entry with four changes: set-up writes the draft and the
reads of the traffic's fixed `layout_seed`, the FASTQs' pairs in an
order drawn from the run's seed (`traffic/layout_files.py`), and runs
Collect once after Preprocess; a
unit moves the Assembly stage's outputs aside (Collect's stay) and
keeps the stage's spans from the unit's metrics.json; the rate counts
gaps; and the last window unit's picks are held to the planted truth
(`reference/assembly.py`), every other unit's outputs, warm-up and
traced ones too, to the last one's byte for byte.
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import tempfile

from portbench.entries import cli_chain

# what `run.run_assembly_and_pick` writes, moved aside after each unit
# (cli_chain's units move their command's OUTPUTS)
cli_chain.OUTPUTS["Assembly"] = ("picked_seqs.fa", "picked_seqs.fa_ori.txt",
                                 "merge_info.txt")
METRICS = "metrics.json"
# the Assembly stage's parts, whose ranges label the traced unit's idle time
RANGES = (("pipeline.run", "_pick_gaps"),
          ("pipeline.run", "refine_contigs_multi"),
          ("pipeline.fused", "assemble_batch"),
          ("pipeline.rescue", "rescue_both_unmapped"),
          ("pipeline.rescue", "hq_pseudo_contigs"))
# the SW kernel as every alignment of the Assembly stage reaches it
HAND = cli_chain.HAND + (("ops.swutil", "sw_batch_cuda", "sw",
                          cli_chain.sw_info),)


class Entry(cli_chain.Entry):
    def setup(self):
        r = self.run
        path = self.make_files()
        r.part("simulate_and_write")
        from gappadder_tpu_torch import cli
        self.cli = cli
        dev = [] if r.device.type == "cuda" else ["--device", "cpu"]
        self.argv = ["-c", self.command, "-g", path, "--force"] + dev
        for stage in ("Preprocess", "Collect"):
            self._cli(["-c", stage, "-g", path, "--force"] + dev)
            r.part(stage.lower())
        self._unit("warm_up")
        r.part("warm_up")

    def make_files(self) -> str:
        """The scenario's files and the CLI's config under TMPDIR;
        returns the config's path."""
        from portbench.traffic import layout_files
        self.root = tempfile.mkdtemp(prefix="portbench-")
        atexit.register(shutil.rmtree, self.root, ignore_errors=True)
        self.scenario = layout_files.write_scenario_layout(
            os.path.join(self.root, "scenario"), self.traffic["layout_seed"],
            self.run.seed, **self.run.config["scenario"])
        self.work = os.path.join(self.root, "work")
        path = os.path.join(self.root, "config.json")
        with open(path, "w") as fh:
            json.dump(cli_chain.cli_config(self.run.config, self.scenario,
                                           self.work), fh)
        return path

    def _unit(self, tag):
        metrics = os.path.join(self.work, METRICS)
        if os.path.exists(metrics):
            os.remove(metrics)
        rec = super()._unit(tag)
        if os.path.exists(metrics):
            with open(metrics) as fh:
                rec["stages"] = json.load(fh)["stages"]
        return rec

    def trace_targets(self):
        return HAND + tuple((m, a, f"{m.split('.')[-1]}.{a}", None)
                            for m, a in RANGES)

    def end_to_end(self, units, window_s):
        gaps = len(self.scenario["gaps"])
        return {"assembly_gaps_per_s": gaps * len(units) / window_s}

    def check(self):
        """The last window unit's picks against the planted truth, and
        every unit's outputs (warm-up and traced ones too) against the
        last's. Returns (checks, units compared, units wrong)."""
        from portbench.reference import assembly as ref
        last = self.kept[-2] if self.kept[-1].endswith("traced") \
            else self.kept[-1]
        others = sum(not cli_chain.same_outputs(k, last) for k in self.kept
                     if k != last)
        got = ref.judge_picked(
            os.path.join(last, "picked_seqs.fa"), self.scenario,
            self.run.config["parameters"])
        checks = [(name, got[name], ref.LIMITS[name]) for name in ref.NUMBERS]
        checks.append(("units_unlike_last", others, 0))
        wrong = any(v > lim for n, v, lim in checks
                    if n != "units_unlike_last")
        failed = len(self.kept) if wrong else others
        self.run.log(files_written_bytes=cli_chain._tree_bytes(self.root))
        shutil.rmtree(self.root, ignore_errors=True)
        return checks, len(self.kept), failed
