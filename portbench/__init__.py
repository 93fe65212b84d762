"""The benchmark of the PyTorch/CUDA port (`gappadder_tpu_torch`) on
one H100: `python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`. See BENCHMARK.json for the cells and
PERF.md for what each measures."""
