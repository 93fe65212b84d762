"""The fused gap-batch step, `parallel/slice.run_step`, a unit: one
batch of gaps through blocks 1-4 with its 12 outputs brought to the
host, as the Assembly stage needs them.

Set-up makes the configuration's batches from the seed
(`traffic/gap_batches.py`), places them on the card, and runs each one
once (which also holds every batch to the program's capacity checks).
The window cycles through the batches in order. Every unit's outputs
are kept on the host; after the window a sample of the units, drawn
from the seed, is held to the reference.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.entries.cli_chain import sort_info, sw_info, sync

# the step's blocks, whose ranges label the traced steps' idle time
RANGES = (("parallel.slice", "_classify_extract"),
          ("parallel.slice", "_route_and_group"),
          ("parallel.slice", "gather_reads"),
          ("parallel.slice", "_assemble_block"),
          ("parallel.slice", "_pick_score_block"))
HAND = (("ops.psort", "bitonic_sort", "sort", sort_info),
        ("parallel.slice", "sw_batch_cuda", "sw", sw_info))


def step_params(cfg: dict) -> dict:
    """The classification settings of the configuration's library."""
    lib, p = cfg["library"], cfg["parameters"]
    return dict(dist1=lib["is"] - 3 * lib["std"],
                dist2=lib["is"] + 3 * lib["std"], clip_dist=p["clip_dist"],
                anchor_mapq=p["anchor_mapq"], hq_mapq=p["high_quality_mapq"],
                short_insert=lib["is"] < p["long_insert_threshold"])


def make_batches(cfg: dict, seed: int):
    """The configuration's batches from the seed: [(dims dict, args)],
    batch b drawn from the seed sequence (seed, b)."""
    from portbench.traffic import gap_batches
    b, lib = cfg["batch"], cfg["library"]
    traffic = {k: b[k] for k in ("gaps", "gap_len", "read_len", "coverage",
                                 "errors", "mapq", "chimeric",
                                 "foreign_len")}
    return [gap_batches.batch(
        np.random.SeedSequence([seed, i]), **traffic,
        flank_len=cfg["parameters"]["flank_length"], insert=lib["is"],
        std=lib["std"], dist2=step_params(cfg)["dist2"], caps=cfg["caps"],
        kset=cfg["kmers"]) for i in range(b["batches"])]


def slice_dims(sl, cfg: dict, dims: dict):
    """The program's SliceDims for a batch's sizes and the
    configuration's settings."""
    p = step_params(cfg)
    return sl.SliceDims(
        **dims, dist1=p["dist1"], dist2=p["dist2"], clip_dist=p["clip_dist"],
        anchor_mapq=p["anchor_mapq"], hq_mapq=p["hq_mapq"],
        short_insert=p["short_insert"],
        min_contig_len=cfg["parameters"]["min_contig_len"],
        max_unitigs=cfg["batch"]["max_unitigs"])


class Entry:
    def __init__(self, run):
        self.run = run
        self.cfg = run.config
        self.kept: list = []
        self.records: list = []
        # reference results already worked out, by batch
        self.known: dict = {}
        self.traced_count = run.workload["traffic"]["traced_steps"]

    def setup(self):
        r = self.run
        self.batches = make_batches(self.cfg, r.seed)
        r.part("simulate")
        from gappadder_tpu_torch.parallel import slice as sl
        self.sl = sl
        self.dims = [slice_dims(sl, self.cfg, d) for d, _a in self.batches]
        if len(set(self.dims)) != 1:
            raise ValueError("the batches' sizes differ")
        self.placed = [sl.inputs_from_numpy(a, r.device)
                       for _d, a in self.batches]
        sync(r.device)
        r.part("place")
        for b in range(len(self.batches)):
            out = self._step(b)
            sl.check_overflow(self.dims[b], out[0])
        r.part("warm_up")
        self.kept.clear()

    def _step(self, b):
        out = self.sl.run_step(self.dims[b], self.placed[b],
                               device=self.run.device)
        host = [o.cpu().numpy() for o in out]
        self.kept.append((b, host))
        return host

    def unit(self):
        t0 = time.perf_counter()
        self._step(len(self.records) % len(self.batches))
        self.records.append({"wall_s": time.perf_counter() - t0})

    def unit_records(self):
        return self.records

    def trace_targets(self):
        return HAND + tuple((m, a, f"slice.{a.lstrip('_')}", None)
                            for m, a in RANGES)

    def traced_units(self):
        for i in range(self.traced_count):
            self._step((len(self.records) + i) % len(self.batches))

    def end_to_end(self, units, window_s):
        gaps = self.cfg["batch"]["gaps"]
        ms = sorted((b - a) * 1e3 for a, b in units)
        return {"step_gaps_per_s": gaps * len(units) / window_s,
                "step_ms.p95": float(np.percentile(ms, 95))}

    def release(self):
        self.placed = None
        self.sl = None

    def ref_dims(self, b) -> dict:
        """Batch b's sizes and settings as the reference takes them."""
        return dict(self.batches[b][0],
                    min_contig_len=self.cfg["parameters"]["min_contig_len"],
                    max_unitigs=self.cfg["batch"]["max_unitigs"])

    def check(self):
        """A sample of the window's steps, drawn from the seed, against
        the reference. Returns (checks, steps compared, steps wrong)."""
        from portbench.reference import step as ref
        n = min(self.run.workload["traffic"]["checked_steps"],
                len(self.records))
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.run.seed, 1 << 20]))
        pick = sorted(rng.choice(len(self.records), n, replace=False))
        totals, wrong = {}, 0
        for i in pick:
            b, out = self.kept[i]
            got = ref.judge(self.batches[b][1], out, self.ref_dims(b),
                            step_params(self.cfg), self.run.device,
                            ref=self.known.get(b))
            wrong += any(got.values())
            for k, v in got.items():
                totals[k] = totals.get(k, 0) + v
        return [(k, v, 0) for k, v in totals.items()], n, wrong
