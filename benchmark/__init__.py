"""The benchmark of the PyTorch/CUDA port ``ipcgen_tpu_torch`` on NVIDIA
H100 cards: ``python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``benchmark/run.py``)."""
