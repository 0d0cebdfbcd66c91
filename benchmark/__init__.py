"""The benchmark of the PyTorch and CUDA port (`nerfail_tpu_torch`):
`python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line."""
