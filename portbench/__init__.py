"""The benchmark of the PyTorch/CUDA port (``zkfhe_tpu_torch``): proof time
and batch throughput on one card. See README.md."""
