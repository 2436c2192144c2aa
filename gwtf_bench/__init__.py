"""The benchmark of the PyTorch and CUDA port (`go_with_the_flows_tpu_torch`):
`python3 -m gwtf_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`; see run.py and BENCHMARK.json."""
