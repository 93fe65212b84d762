"""One reader a per-layer metric, `<metric>.py` with `read(ctx)`,
found by the metric's name in BENCHMARK.json; helpers start with _."""
