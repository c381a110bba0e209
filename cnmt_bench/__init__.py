"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
a run, ``python3 cnmt_bench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the repository's root."""
