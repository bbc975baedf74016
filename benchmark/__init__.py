"""The benchmark of flexflow_tpu_torch, the PyTorch and CUDA port, on
NVIDIA H100 cards. `python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` runs one cell once; README.md says how cells,
traffic mixes and metrics are added as files."""
