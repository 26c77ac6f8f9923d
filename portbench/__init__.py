"""The benchmark of the PyTorch and CUDA port (`repro_torch`): LUBM-style
graphs served through `SPARQLServer`, held to a plain NumPy reference.
`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json`."""
