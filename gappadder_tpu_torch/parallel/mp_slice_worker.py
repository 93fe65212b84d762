"""Multi-process worker: the fused step over a mesh that spans processes
(counterpart of scripts/mp_slice_worker.py), under torch.distributed.

    python -m gappadder_tpu_torch.parallel.mp_slice_worker \\
        PROC_ID NPROC LOCAL_SHARDS PORT OUT [--device cpu|cuda]
        [--scenario JSON]

Each of the NPROC processes holds LOCAL_SHARDS shards (CPU shards with
gloo collectives for --device cpu; else that many shards on the
process's card, cuda:(PROC_ID % device_count)); the mesh has
NPROC * LOCAL_SHARDS shards. The scenario is `slice.example_data(n_shards,
**scenario)` (default: one gap a shard). Process 0 writes `summarize`'s
JSON of the run to OUT, with the collectives' backend, the step's
seconds and its hand-kernel launches (the launch counters of
`ops/sw_cuda.py` and `ops/psort.py`, 0 on the CPU), which the tests and
chip_smoke.py compare with a one-process run of the same scenario.
"""

from __future__ import annotations

import argparse
import json
import time


def summarize(dims, out) -> dict:
    """The step's outputs (`out`: the 12 global numpy arrays) as the
    per-gap JSON the JAX worker writes: each gap's read count, its
    contigs as sorted canonical strings and its best left and right
    flank scores; the counts, histogram and total received entries."""
    from .. import dna
    (counts, hist, n_recv, n_reads, _rowtab, _hqtab, useq, ulen, _ucnt,
     scores, _qend, _tend) = out
    N, Gl = dims.n_shards, dims.gaps_per_shard
    per_gap = {}
    for shard in range(N):
        for slot in range(Gl):
            g = shard + slot * N               # home_of's inverse
            i = shard * Gl + slot              # row of the global outputs
            contigs = []
            for u in range(useq.shape[1]):
                n = int(ulen[i, u])
                if n > 0:
                    s = dna.decode(useq[i, u, :n])
                    contigs.append(min(s, dna.decode(
                        dna.revcomp(useq[i, u, :n]))))
            per_gap[str(g)] = dict(
                n_reads=int(n_reads[i]), contigs=sorted(contigs),
                score=[int(scores[i, 0:2].max()), int(scores[i, 2:4].max())])
    return dict(counts=counts.tolist(), hist=hist.tolist(),
                total_recv=int(n_recv.sum()), per_gap=per_gap)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("proc_id", type=int)
    p.add_argument("nproc", type=int)
    p.add_argument("local_shards", type=int)
    p.add_argument("port", type=int)
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--scenario", default="{}",
                   help="JSON keyword arguments of slice.example_data")
    args = p.parse_args(argv)

    from . import mp
    cpu = args.device == "cpu"
    backend = mp.init_distributed(
        f"127.0.0.1:{args.port}", args.nproc, args.proc_id,
        local_cpu_devices=args.local_shards if cpu else 0)
    from ..ops import psort, sw_cuda
    from . import slice as sl
    from .mesh import make_mesh
    devices = mp.local_devices(args.device)
    if not cpu:
        devices = devices * args.local_shards
    n_shards = args.nproc * len(devices)
    mesh = make_mesh(shape=(n_shards,), axes=("dp",), devices=devices)
    kw = {"gaps_per_shard": 1, **json.loads(args.scenario)}
    if "kset" in kw:
        kw["kset"] = tuple(tuple(s) for s in kw["kset"])
    if "gap_len" in kw and isinstance(kw["gap_len"], list):
        kw["gap_len"] = tuple(kw["gap_len"])
    dims, step_args = sl.example_data(n_shards, **kw)
    step = sl.make_slice_step(mesh, dims)
    placed = sl.place_args(mesh, step_args)
    sw_cuda.launches = psort.launches = 0
    t = time.perf_counter()
    out = step(*placed)
    res = [mp.to_np(o) for o in out]
    seconds = time.perf_counter() - t
    launches = {"sw": sw_cuda.launches, "sort": psort.launches}
    if mp.is_primary():
        with open(args.out, "w") as fh:
            json.dump(dict(summarize(dims, res), backend=backend,
                           n_shards=n_shards, step_s=seconds,
                           launches=launches), fh)
    mp.barrier("done")
    print(f"proc {args.proc_id} done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
