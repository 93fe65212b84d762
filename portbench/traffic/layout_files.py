"""The files of `genome_files.write_scenario` for a fixed `layout_seed`,
each library's read pairs in an order drawn from the run's seed: the
truth, the gaps, the open gaps and the reads are `layout_seed`'s, and
only the order of the pairs in the FASTQs follows the seed. So every
seed asks the same Assembly work of the same draft and reads, handed
over in another order. The BAMs stay as `write_scenario` sorts them:
Collect joins their records to the FASTQ rows by read name. No import of
the program.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import genome_files

ORDER = 1     # the pair order's stream beside the seed


def write_scenario_layout(root, layout_seed: int, seed: int,
                          **scenario) -> dict:
    """Write `write_scenario(root, layout_seed, ...)`'s files into
    `root`, each library's FASTQ pairs in an order drawn from `seed`;
    returns what `write_scenario` returns, each library's FASTQ rows
    ("names", "seq", "qual") and its records' "pair" in that order."""
    sc = genome_files.write_scenario(root, layout_seed, **scenario)
    rng = np.random.default_rng([seed, ORDER])
    for lib in sc["libraries"]:
        perm = rng.permutation(lib["pairs"])     # row i holds pair perm[i]
        lib["names"] = lib["names"][perm]
        lib["seq"], lib["qual"] = lib["seq"][:, perm], lib["qual"][:, perm]
        lib["records"]["pair"] = np.argsort(perm)[lib["records"]["pair"]]
        for m, path in ((1, lib["left"]), (2, lib["right"])):
            with open(path, "wb") as fh:
                fh.write(genome_files.fastq_bytes(
                    lib["names"], lib["seq"][m - 1], lib["qual"][m - 1], m))
    return sc
