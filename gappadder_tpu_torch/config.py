"""Configuration: the reference's JSON schema, as the JAX package loads
it (counterpart of gappadder_tpu/config.py).

The same JSON file loads into the same frozen dataclasses, field for
field, so a configuration written for the JAX package drives the port.
The `tpu` section is accepted unchanged. Of it `gap_batch` (gaps per
Assembly batch), `read_batch` (records per classification batch) and
`mesh_shape` (the shards Collect's classification and the Assembly
batches split over, when the processes hold that many; see
parallel/mesh.py) keep their meaning. `use_pallas` and `fused` mean
nothing to the port, which runs its hand-written kernels and one
Assembly batch; `mesh_axes` names the mesh's axes, which the steps
flatten into one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass(frozen=True)
class Library:
    """One read library: its BAM alignment + raw FASTQ pair.

    Mirrors the paired "alignments" / "raw_reads" records of the
    reference config (its configuration.json). bam=None
    selects the SELF-MAPPING mode: reads are placed on the draft by the
    built-in minimizer mapper (ops/minimap.py) instead of an externally
    produced `bwa mem` BAM — a capability the reference does not have
    (it requires pre-aligned BAMs, README.md:46-84)."""
    bam: str | None
    insert_size: int
    std: int
    left_fq: str | None = None
    right_fq: str | None = None


@dataclasses.dataclass(frozen=True)
class TpuParams:
    """The JAX package's device knobs (no reference equivalent), kept so
    the same JSON loads. `mesh_shape`, `read_batch` and `gap_batch` mean
    to the port what they mean to the JAX package; the other fields are
    accepted and ignored. `fused` among them: the port has one Assembly
    batch, the fused one, and `"fused": false` writes the same files as
    the JAX package's non-fused batch."""
    mesh_shape: tuple[int, ...] = (1,)
    mesh_axes: tuple[str, ...] = ("dp",)
    max_gaps: int = 1 << 16          # static bound for jitted gap scan
    read_batch: int = 1 << 17        # reads per classification batch
    gap_batch: int = 64              # gaps assembled per device batch
    gap_bucket_sizes: tuple[int, ...] = (1 << 10, 1 << 13, 1 << 16)
    use_pallas: bool = True
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class Config:
    draft_genome: str
    libraries: tuple[Library, ...] = ()
    kmers: tuple[tuple[int, int], ...] = ((40, 39),)  # (k, sub_k) pairs
    working_folder: str = "gappadder_work"
    min_gap_size: int = 100          # main.py reference default config
    flank_length: int = 300
    nthreads: int = 1
    verbose: bool = False
    # constants the reference hard-codes (SURVEY.md §5):
    anchor_mapq: int = 30            # main.py:215
    clip_dist: int = 250             # main.py:216
    flank_margin: int = 5            # gnrt_pos_true_seqs.py:95-99
    long_insert_threshold: int = 750  # collect_reads_for_gaps.py:276
    high_quality_mapq: int = 60      # run_multi_threads_discordant.py:476
    discordant_window: tuple[int, int] = (200, 300)  # collect_discordant_low_mapq_reads.py:21-25
    min_contig_len: int = 40         # velvetg -min_contig_lgth 40
    min_kmer_count: int = 0          # kmc -ci equivalent; -1 = adaptive
                                     # error filter (see ops/kmers.py)
    bubble_pop_rounds: int = 0       # coverage-guided DBG bubble popping
                                     # (tour-bus equivalent, ops/dbg.py)
    pick_min_score_round1: int = 30  # assemble_gaps.py:336
    pick_min_score_final: int = 15   # assemble_gaps.py:365
    pick_max_hits: int = 3           # bwa mem -a multi-hit parity
                                     # (pick_contigs.py:80-86): non-
                                     # overlapping local hits per
                                     # (flank, contig, strand)
    dedup_cutoff: float = 0.99       # MergeContigs.py:73-99
    merge_max_frac_score_loss: float = 0.4   # ContigsMerger -s
    merge_min_overlap_len: int = 12          # ContigsMerger -x
    merge_max_clip_len: int = 50             # ContigsMerger -y
    merge_kmer_len: int = 10                 # ContigsMerger -k
    merge_min_support_kmer: int = 1          # ContigsMerger -m
    # scale bounds: 0 = unbounded/auto — shapes grow with the data
    # (with loud warnings), matching Velvet/KMC's unbounded inputs
    # (the reference's assemble_gaps.py:96-118).
    max_reads_per_gap: int = 0        # >0 caps a gap's read set (warns)
    max_distinct_kmers: int = 0       # >0 fixes the k-mer table; 0 = auto-grow
    max_contig_len: int = 0           # >0 fixes unitig length; 0 = provably-sufficient auto
    max_unitigs: int = 64             # per (k,sub_k) setting; auto-doubles on saturation
    tpu: TpuParams = dataclasses.field(default_factory=TpuParams)

    @property
    def workdir(self) -> str:
        return self.working_folder.rstrip("/") + "/"


def load_config(path: str) -> Config:
    """Load a reference-schema JSON config (configuration.json layout)."""
    with open(path) as fh:
        data = json.load(fh)
    return config_from_dict(data, base_dir=os.path.dirname(os.path.abspath(path)))


def config_from_dict(data: dict[str, Any], base_dir: str = ".") -> Config:
    def _resolve(p):
        if p is None:
            return None
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    draft = _resolve(data["draft_genome"]["fa"])

    raw_reads = data.get("raw_reads", [])
    libs = []
    for i, rec in enumerate(data.get("alignments", [])):
        left = right = None
        if i < len(raw_reads):
            left = _resolve(raw_reads[i].get("left"))
            right = _resolve(raw_reads[i].get("right"))
        libs.append(Library(bam=_resolve(rec.get("bam")),
                            insert_size=int(rec["is"]),
                            std=int(rec["std"]), left_fq=left, right_fq=right))

    kmers = []
    for rec in data.get("kmer_length", []):
        k = int(rec["k"])
        for sub in rec.get("k_velvet", []):
            kmers.append((k, int(sub["k"])))
    if not kmers:
        kmers = [(40, 39)]

    params = data.get("parameters", {})
    tpu_raw = data.get("tpu", {})
    tpu = TpuParams(
        mesh_shape=tuple(tpu_raw.get("mesh_shape", (1,))),
        mesh_axes=tuple(tpu_raw.get("mesh_axes", ("dp",))),
        max_gaps=int(tpu_raw.get("max_gaps", TpuParams.max_gaps)),
        read_batch=int(tpu_raw.get("read_batch", TpuParams.read_batch)),
        gap_batch=int(tpu_raw.get("gap_batch", TpuParams.gap_batch)),
        gap_bucket_sizes=tuple(tpu_raw.get("gap_bucket_sizes",
                                           TpuParams.gap_bucket_sizes)),
        use_pallas=bool(tpu_raw.get("use_pallas", True)),
        fused=bool(tpu_raw.get("fused", True)),
    )

    kwargs: dict[str, Any] = {}
    for field in ("min_gap_size", "flank_length", "nthreads", "anchor_mapq",
                  "clip_dist", "flank_margin", "long_insert_threshold",
                  "high_quality_mapq", "min_contig_len", "min_kmer_count",
                  "bubble_pop_rounds", "max_reads_per_gap",
                  "max_distinct_kmers", "max_contig_len", "max_unitigs",
                  "pick_max_hits"):
        if field in params:
            kwargs[field] = int(params[field])
    if "verbose" in params:
        kwargs["verbose"] = bool(int(params["verbose"]))
    if "working_folder" in params:
        kwargs["working_folder"] = _resolve(params["working_folder"])

    return Config(draft_genome=draft, libraries=tuple(libs),
                  kmers=tuple(kmers), tpu=tpu, **kwargs)
