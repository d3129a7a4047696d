"""The benchmark of nngp_tpu_torch on an NVIDIA H100 (see BENCHMARK.json
at the repository root and PERF.md)."""
