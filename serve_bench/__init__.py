"""The serving benchmark of flashinfer_tpu_torch: run one cell with
``python3 serve_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
