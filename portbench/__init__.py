"""The benchmark of neko_tpu_torch: cells named in BENCHMARK.json, run by
`python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`.
See portbench/README.md."""
