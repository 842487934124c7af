"""Device ops of the port: each module pairs a hand-written CUDA kernel
(``csrc/``) with the plain PyTorch version of the same function."""
