"""The benchmark of zktpu_torch on NVIDIA H100 cards: ``python zkbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
