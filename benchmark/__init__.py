"""The benchmark of gaot3d_tpu_torch on one NVIDIA H100: `python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>` (see README.md)."""
