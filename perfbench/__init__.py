"""The benchmark of ratrack_tpu_torch, the PyTorch and CUDA port of
RaTrack, on NVIDIA GPUs. `python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` runs one cell of BENCHMARK.json;
PERF.md says what each cell and metric is for."""
