"""CPU tests of the benchmark: the files, the generators, the metrics
arithmetic, each entry at a small size, the controls and the faults."""
