"""PyTorch/CUDA port of zkfhe_tpu: BFV-encryption SNARK on an NVIDIA H100."""
